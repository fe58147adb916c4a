r"""Fused Taylor-mode FCNN evaluation: the CUDA kernel, its plain twin, and
the autograd function around them.

Counterpart of ``neurodiffeq_tpu/ops/pallas_mlp.py``. For ``points`` (N, d)
and an FCNN given as ``layers = [(W, b), ...]`` (``W`` is ``(n_in, n_out)``,
the JAX package's layout; tanh or sin between layers, none after the last),
both paths return ``(c0, c1[, c2])``: the value ``(N, out)`` and the first
and second directional derivatives ``(D, N, out)`` along the D = d
coordinate axes.

- :func:`fcnn_taylor_reference` is the plain PyTorch twin of
  ``_pure_jax_taylor``: it runs on any device and is the backward below.
- :func:`fcnn_taylor` is the public entry. A CPU tensor goes to the twin;
  a CUDA tensor launches the hand-written kernel
  (``neurodiffeq_tpu_torch/csrc/taylor_mlp.cu``) or raises. Its gradient
  is :class:`_TaylorMLPFn`, whose backward re-runs the twin under autograd,
  as ``_fused_bwd`` re-derives it by ``jax.vjp`` over the pure-JAX twin.

``LAUNCHES`` counts kernel launches.
"""
import ctypes
import functools
import math

import torch

from ..utils import full_precision_matmuls

__all__ = ['fcnn_taylor', 'fcnn_taylor_reference', 'LAUNCHES']

LAUNCHES = 0

_ACTVS = {'tanh': 0, 'sin': 1}
_THREADS = 256
_MAX_TILE = 32
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
_MAX_LAYERS = 16       # kMaxLayers in the CUDA source
_MAX_DIMS = 8          # kMaxDims in the CUDA source


def _actv_chain(z, actv):
    """(value, f', f'') of the activation, reusing the forward value."""
    if actv == 'tanh':
        a = torch.tanh(z)
        f1 = 1 - a * a
        return a, f1, -2 * a * f1
    if actv == 'sin':
        a = torch.sin(z)
        return a, torch.cos(z), -a
    raise ValueError(f"unsupported activation {actv!r}; expected 'tanh' or 'sin'")


def fcnn_taylor_reference(points, layers, order, actv='tanh'):
    """Plain batched Taylor propagation through the FCNN (the kernel's twin).

    :param points: (N, d) collocation points.
    :param layers: ``[(W, b), ...]`` with ``W`` (n_in, n_out), ``b`` (n_out,).
    :param order: 0, 1 or 2.
    :param actv: 'tanh' or 'sin'.
    :return: ``(c0[, c1[, c2]])`` with c0 (N, out) and ck (D, N, out).
    """
    Ws = [W for W, _ in layers]
    bs = [b for _, b in layers]
    n, d = points.shape
    z0 = points @ Ws[0] + bs[0]
    if len(layers) == 1:
        c1 = Ws[0][:, None, :].expand(d, n, Ws[0].shape[1])
        return (z0, c1, torch.zeros_like(c1))[:order + 1]

    a, f1, f2 = _actv_chain(z0, actv)
    u1 = f1[None] * Ws[0][:, None, :]
    u2 = f2[None] * (Ws[0] * Ws[0])[:, None, :] if order >= 2 else None
    for W, b in zip(Ws[1:-1], bs[1:-1]):
        z0 = a @ W + b
        z1 = u1 @ W
        z2 = u2 @ W if order >= 2 else None
        a, f1, f2 = _actv_chain(z0, actv)
        if order >= 2:
            u2 = f1[None] * z2 + f2[None] * z1 * z1
        u1 = f1[None] * z1
    W, b = Ws[-1], bs[-1]
    outs = [a @ W + b]
    if order >= 1:
        outs.append(u1 @ W)
    if order >= 2:
        outs.append(u2 @ W)
    return tuple(outs)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _plan(n, d, dims, order, esize, device):
    """(tile, shared-memory bytes) for one launch. Each block keeps the
    1 + order*d streams of a tile's widest hidden layer in shared memory,
    in one buffer for a single hidden layer and two (read, write) for more.
    The tile is as large as fits, up to ``_MAX_TILE``, and no larger than
    spreads the batch over every SM."""
    n_layers = len(dims) - 1
    if n_layers == 1:
        return _MAX_TILE, 0
    per_point = (1 if n_layers == 2 else 2) * (1 + order * d) * max(dims[1:-1]) * esize
    fit = _SMEM_LIMIT // per_point
    if fit < 1:
        raise ValueError(
            f"fcnn_taylor kernel: one point needs {per_point} bytes of shared memory for "
            f"hidden widths {dims[1:-1]} at order {order} with d={d}, more than the "
            f"{_SMEM_LIMIT} a block may use")
    n_sm = _sm_count(device.index if device.index is not None else torch.cuda.current_device())
    tile = max(1, min(fit, _MAX_TILE, math.ceil(n / n_sm)))
    return tile, tile * per_point


def _launch(points, layers, order, actv):
    """Check the inputs, allocate the outputs and launch the CUDA kernel on
    the current stream. Weights may be any (n_in, n_out) view: the kernel
    reads them in ``nn.Linear``'s (n_out, n_in) row-major layout, which for
    ``nn.Linear`` weights costs no copy."""
    global LAUNCHES
    from ._build import load_library

    dtype, device = points.dtype, points.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fcnn_taylor kernel takes float32 or float64, got {dtype}")
    if points.ndim != 2 or not points.is_contiguous():
        raise ValueError(f"points must be a contiguous (N, d) tensor, got shape {tuple(points.shape)}")
    if order not in (1, 2):
        raise ValueError(f"fcnn_taylor kernel supports order 1 or 2, got {order}")
    if actv not in _ACTVS:
        raise ValueError(f"unsupported activation {actv!r}; expected 'tanh' or 'sin'")
    n, d = points.shape
    if not 1 <= d <= _MAX_DIMS or not 1 <= len(layers) <= _MAX_LAYERS:
        raise ValueError(f"kernel takes 1-{_MAX_DIMS} inputs and 1-{_MAX_LAYERS} layers, "
                         f"got d={d} and {len(layers)} layers")
    dims = [d]
    Wk, bk = [], []
    for i, (W, b) in enumerate(layers):
        for name, t in (('W', W), ('b', b)):
            if t.dtype != dtype or t.device != device:
                raise TypeError(f"layer {i} {name} is {t.dtype} on {t.device}; "
                                f"points are {dtype} on {device}")
        if W.ndim != 2 or W.shape[0] != dims[-1] or b.shape != (W.shape[1],):
            raise ValueError(f"layer {i}: W {tuple(W.shape)} and b {tuple(b.shape)} do not "
                             f"chain from width {dims[-1]}")
        dims.append(W.shape[1])
        Wk.append(W.t().contiguous())
        bk.append(b.contiguous())

    n_out = dims[-1]
    c0 = torch.empty((n, n_out), dtype=dtype, device=device)
    c1 = torch.empty((d, n, n_out), dtype=dtype, device=device)
    c2 = torch.empty((d, n, n_out), dtype=dtype, device=device) if order == 2 else None
    if n == 0:
        return (c0, c1, c2)[:order + 1]
    esize = points.element_size()
    tile, smem = _plan(n, d, dims, order, esize, device)

    lib = load_library()
    fn = lib.taylor_mlp_forward_f32 if dtype == torch.float32 else lib.taylor_mlp_forward_f64
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_W = (ctypes.c_void_p * len(Wk))(*[w.data_ptr() for w in Wk])
    c_b = (ctypes.c_void_p * len(bk))(*[t.data_ptr() for t in bk])
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(ctypes.c_void_p(points.data_ptr()), n, d, len(layers), c_dims, c_W, c_b,
                 order, _ACTVS[actv], tile, _THREADS, smem,
                 ctypes.c_void_p(c0.data_ptr()), ctypes.c_void_p(c1.data_ptr()),
                 ctypes.c_void_p(c2.data_ptr() if c2 is not None else None),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"taylor_mlp kernel launch failed: CUDA error {err} "
                           f"(n={n}, dims={dims}, order={order}, tile={tile}, smem={smem})")
    LAUNCHES += 1
    return (c0, c1, c2)[:order + 1]


class _TaylorMLPFn(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd over the plain twin,
    re-run on the saved inputs (a rematerialized backward)."""

    @staticmethod
    def forward(ctx, points, order, actv, *flat):
        ctx.order, ctx.actv = order, actv
        ctx.save_for_backward(points, *flat)
        return _launch(points, list(zip(flat[0::2], flat[1::2])), order, actv)

    @staticmethod
    def backward(ctx, *grads):
        points, *flat = ctx.saved_tensors
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[3:])
        result = [None] * len(need)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(f) for t, f in zip([points, *flat], need)]
            outs = fcnn_taylor_reference(leaves[0], list(zip(leaves[1::2], leaves[2::2])),
                                         ctx.order, ctx.actv)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [leaf for leaf, f in zip(leaves, need) if f]
            if pairs and wrt:
                got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                               [g for _, g in pairs], allow_unused=True))
                result = [next(got) if f else None for f in need]
        return (result[0], None, None, *result[1:])


def fcnn_taylor(points, layers, order, actv='tanh'):
    """Fused Taylor evaluation of a tanh or sin FCNN on ``points``.

    A CPU tensor runs :func:`fcnn_taylor_reference`. A CUDA tensor launches
    the CUDA kernel (order 1 or 2, float32 or float64) or raises; it never
    falls back to the twin.

    :param points: (N, d) collocation points (the directions are the d axes).
    :param layers: ``[(W, b), ...]`` with ``W`` (n_in, n_out), ``b`` (n_out,).
    :param order: series order.
    :param actv: 'tanh' or 'sin'.
    :return: ``(c0, c1[, c2])`` with c0 (N, out) and ck (D, N, out).
    """
    if points.device.type == 'cpu':
        return fcnn_taylor_reference(points, layers, order, actv)
    if points.device.type != 'cuda':
        raise TypeError(f"fcnn_taylor runs on 'cpu' or 'cuda' tensors, got {points.device}")
    full_precision_matmuls()  # the backward's float32 matmuls must not drop to TF32
    flat = [t for W, b in layers for t in (W, b)]
    return _TaylorMLPFn.apply(points, order, actv, *flat)
