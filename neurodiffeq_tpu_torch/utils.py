"""Global configuration: default dtype and device, seeding, random generators.

Counterpart of ``neurodiffeq_tpu/utils.py``. The JAX package keeps a
splittable global PRNG key; here a seeded ``torch.Generator`` per device
takes its place (:func:`get_generator`). The port never changes torch's own
global default dtype: its default lives in this module and every
constructor and sampler also takes an explicit ``dtype`` and ``device``.
"""
import os
import random

import numpy as np
import torch

__all__ = ['set_tensor_type', 'set_seed', 'seed_value', 'get_default_dtype', 'get_default_device',
           'get_generator', 'resolve', 'full_precision_matmuls', 'safe_mkdir', 'get_residual_info', 'as_2d_column',
           'split_columns', 'hstack', 'vstack']

_DEFAULT_DTYPE = torch.float32
# the card: a caller without one asks for the CPU. Kept as a str, so that
# importing the port makes no torch.device and touches no CUDA.
_DEFAULT_DEVICE = 'cuda'
# this rank's card once make_mesh has placed it (cuda:<local rank> under NCCL,
# the named card under gloo): what the default 'cuda' resolves to
_RANK_DEVICE = None
_SEED = 0
# device -> torch.Generator seeded from _SEED; emptied by set_seed
_GENERATORS = {}


def set_tensor_type(device_type=None, float_bits=32):
    """Set the port's default floating dtype and (optionally) device.

    The default device is ``'cuda'``: nets, generators and solvers built
    without a ``device`` go to the card, and where there is none, torch's
    own error says so. Nothing falls back to the CPU; a caller without a GPU
    asks for it with ``set_tensor_type('cpu')`` or ``device='cpu'``.

    :param device_type: 'cpu', 'cuda' (or 'cuda:1', ...), or None to keep
        the current device.
    :param float_bits: 32 or 64.
    """
    global _DEFAULT_DTYPE, _DEFAULT_DEVICE
    if float_bits == 32:
        _DEFAULT_DTYPE = torch.float32
    elif float_bits == 64:
        _DEFAULT_DTYPE = torch.float64
    else:
        raise ValueError(f"float_bits must be 32 or 64, got {float_bits}")
    if device_type is not None:
        if not isinstance(device_type, str):
            raise TypeError(f"device_type must be a str, got {device_type}")
        _DEFAULT_DEVICE = str(torch.device(device_type))


def get_default_dtype():
    """The port's default floating dtype for new points and networks."""
    return _DEFAULT_DTYPE


def get_default_device():
    """The port's default device for new points and networks (``cuda``
    unless :func:`set_tensor_type` changed it; in a rank of a mesh, the
    rank's card)."""
    if _DEFAULT_DEVICE == 'cuda' and _RANK_DEVICE is not None:
        return _RANK_DEVICE
    return torch.device(_DEFAULT_DEVICE)


def _set_rank_device(device):
    """Record this rank's device (:func:`~neurodiffeq_tpu_torch.parallel.make_mesh`);
    None forgets it, once the process group is gone."""
    global _RANK_DEVICE
    _RANK_DEVICE = torch.device(device) if device is not None and torch.device(device).type == 'cuda' else None


def resolve(device=None, dtype=None):
    """``(device, dtype)`` with the port's defaults filled in: the device
    is ``cuda`` unless :func:`set_tensor_type` changed it, with no fallback
    to the CPU."""
    device = torch.device(device) if device is not None else get_default_device()
    return device, (dtype if dtype is not None else _DEFAULT_DTYPE)


def set_seed(seed_value, ignore_numpy=False, ignore_random=False, ignore_torch=False):
    """Seed ``numpy``, ``random``, torch's global RNG (network init) and the
    port's per-device generators (collocation sampling)."""
    global _SEED
    if not ignore_numpy:
        np.random.seed(seed_value)
    if not ignore_random:
        random.seed(seed_value)
    if not ignore_torch:
        torch.manual_seed(seed_value)
        _SEED = seed_value
        _GENERATORS.clear()


def seed_value():
    """The seed of the last :func:`set_seed` (0 before any): the stochastic
    operators' probe keys are a pure function of it and of their call's
    data (:func:`~neurodiffeq_tpu_torch.operators.stde_laplacian`)."""
    return _SEED


def get_generator(device=None):
    """The global ``torch.Generator`` on ``device``, seeded by :func:`set_seed`.

    Random draws for points on a device come from a generator on that same
    device (a CUDA generator for CUDA points)."""
    device, _ = resolve(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    gen = _GENERATORS.get(device)
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_SEED)
        _GENERATORS[device] = gen
    return gen


def full_precision_matmuls():
    """Keep float32 matrix products and convolutions on the card in full
    float32: TF32 keeps about three decimal digits, and the port's float32
    path is held against float64 references. The port calls this wherever
    it runs on a CUDA device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def safe_mkdir(path):
    """Create a directory, ignoring if it already exists."""
    os.makedirs(path, exist_ok=True)


def get_residual_info(solution_fields, coords, diff_eqs, highest_order=0, detach=True):
    """Equation residuals and their derivatives up to ``highest_order``.

    :param solution_fields: list of solution Fields (e.g. conditions
        enforced on networks over ``coords``).
    :param coords: list of coordinate Fields.
    :param diff_eqs: the equation system; maps (*funcs, *coords) to residuals.
    :param highest_order: how many derivative levels of the residuals to take.
    :param detach: if True, return the (N, 1) tensors (detached) instead of Fields.
    :return: ``[residuals, first_derivatives, ...]`` where level k >= 1 is a
        nested list ``[per-residual [per-coordinate derivative]]``.
    """
    from .fields import Field, diff

    residuals = diff_eqs(*solution_fields, *coords)
    if isinstance(residuals, Field):
        residuals = [residuals]

    def diff_level(entry):
        return [diff(entry, x) for x in coords] if isinstance(entry, Field) else [diff_level(e) for e in entry]

    ret = [list(residuals)]
    for _ in range(highest_order):
        ret.append([diff_level(e) for e in ret[-1]])
    if detach:
        def values(level):
            return level.value.detach() if isinstance(level, Field) else [values(e) for e in level]

        ret = [values(level) for level in ret]
    return ret


def as_2d_column(x, dtype=None, device=None):
    """Numpy or torch input as a 2-D tensor: (N,) and scalars become (N, 1)
    columns; wider arrays keep their shape."""
    device, dtype = resolve(device, dtype)
    arr = torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=dtype, device=device)
    return arr.reshape(-1, 1) if arr.ndim <= 1 else arr


def split_columns(mat):
    """The C columns, each of shape (N,), of an (N, C) matrix."""
    if len(mat.shape) != 2:
        raise ValueError(f'matrix must have 2 dimensions, but matrix shape = {mat.shape}')
    return [mat[:, j] for j in range(mat.shape[1])]


def hstack(tensors):
    """Stack a list of (N,) tensors into an (N, C) matrix."""
    return torch.stack(tensors, dim=1)


def vstack(tensors):
    """Stack a list of (N,) tensors into a (C, N) matrix."""
    return torch.stack(tensors, dim=0)
