r"""Mesh construction and sharding helpers (counterpart of
``neurodiffeq_tpu/parallel/sharding.py``).

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the default process group, with one axis, ``'points'``: data parallelism
over the collocation batch. Each rank owns one contiguous block of the rows
of every global batch (:func:`points_sharding`); the blocks may be uneven.

The collectives the solvers issue are ``all_reduce`` (a sum) and
``broadcast`` only, the two that every backend runs on CUDA tensors (gloo
included). A gather of rows is an ``all_reduce`` of a zero buffer into which
each rank writes its block (:meth:`RowShard.gather_rows`): exact, since
adding zeros changes no bit.

The ``'model'`` axis of the JAX package (Megatron tensor parallelism over
hidden units) is not ported: the port's kernels evaluate a whole FCNN in one
launch, and a layer pair split over ranks needs a kernel entry that takes
input Taylor streams. It is queued as ``ROADMAP.md`` §1 item 23b.
"""
import os

import torch
import torch.distributed as dist

__all__ = ['make_mesh', 'points_sharding', 'replicated_sharding', 'shard_points',
           'megatron_param_shardings', 'shard_params']

MODEL_AXIS_ITEM = "ROADMAP.md §1 item 23b, the 'model' axis"


def _model_axis_error(what):
    return NotImplementedError(
        f"{what}: the 'model' (Megatron tensor-parallel) axis is not ported. The port's kernels evaluate a whole "
        f"FCNN in one launch, and a layer pair split over ranks needs a taylor_mlp entry that takes input Taylor "
        f"streams ({MODEL_AXIS_ITEM}). Use a 1-D mesh over the points.")


def _device_type(devices):
    """'cpu' or 'cuda': what ``devices`` names, else the port's default device's type."""
    from ..utils import get_default_device

    if devices is None:
        return get_default_device().type
    names = [devices] if isinstance(devices, (str, torch.device)) else list(devices)
    kinds = {torch.device(d).type for d in names}
    if len(kinds) != 1 or not kinds <= {'cpu', 'cuda'}:
        raise ValueError(f"devices must all be 'cpu' or all CUDA devices, got {devices!r}")
    return kinds.pop()


def _init_from_env(backend):
    """The default process group from the ``torchrun`` environment."""
    missing = [k for k in ('MASTER_ADDR', 'MASTER_PORT', 'RANK', 'WORLD_SIZE') if k not in os.environ]
    if missing:
        raise RuntimeError(f"make_mesh: torch.distributed is not initialized and the environment lacks "
                           f"{', '.join(missing)}; start the ranks with `torchrun --nproc_per_node=N`, with "
                           f"neurodiffeq_tpu_torch.parallel.launch, or call init_process_group first")
    dist.init_process_group(backend, init_method='env://')


def make_mesh(n_devices=None, devices=None, axis_name='points', model_axis_size=None, backend=None):
    """Build the mesh over the collocation-point axis for this rank.

    The mesh spans every rank of the default process group; if that group
    is not initialized, it is initialized from the ``torchrun`` environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). The rank's
    device becomes the port's default device
    (:func:`~neurodiffeq_tpu_torch.utils.get_default_device`) where that
    default is the card.

    :param n_devices: number of ranks; must equal the world size if given.
    :param devices: ``'cpu'``, a CUDA device (``'cuda:0'``: every rank on
        that card, under gloo) or one device per rank. Defaults to the
        port's default device: the card, one per rank under NCCL (the rank's
        ``LOCAL_RANK``). The CPU is used only when asked for here or through
        :func:`~neurodiffeq_tpu_torch.utils.set_tensor_type`.
    :param axis_name: name of the batch axis, defaults to ``'points'``.
    :param model_axis_size: must be None or 1: the ``'model'`` axis raises
        ``NotImplementedError``.
    :param backend: ``'nccl'`` or ``'gloo'``; defaults to NCCL on the card
        and gloo on the CPU, or to the initialized group's. Under NCCL each
        rank needs a card of its own.
    :return: a ``torch.distributed.device_mesh.DeviceMesh`` with
        ``mesh_dim_names == (axis_name,)``.
    """
    from torch.distributed.device_mesh import DeviceMesh
    from ..utils import _set_rank_device

    if model_axis_size is not None and model_axis_size > 1:
        raise _model_axis_error(f"make_mesh(model_axis_size={model_axis_size})")
    device_type = _device_type(devices)
    if backend is not None and backend not in ('nccl', 'gloo'):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device_type == 'cpu' and backend == 'nccl':
        raise ValueError("NCCL runs on CUDA devices only; use backend='gloo' on the CPU")
    if not dist.is_initialized():
        _init_from_env(backend or ('nccl' if device_type == 'cuda' else 'gloo'))
    used = dist.get_backend()
    if backend is not None and backend != used:
        raise ValueError(f"the process group runs {used!r}, not the backend={backend!r} asked for")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} ranks: a mesh spans them all")
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    if device_type == 'cuda':
        n_cards = torch.cuda.device_count()
        if devices is None or isinstance(devices, (str, torch.device)):
            named = None if devices is None else torch.device(devices)
            device = named if named is not None and named.index is not None else None
        else:
            if len(devices) != world:
                raise ValueError(f"{len(devices)} devices given for {world} ranks")
            device = torch.device(devices[rank])
        if used == 'nccl':
            if int(os.environ.get('LOCAL_WORLD_SIZE', world)) > n_cards:
                raise ValueError(f"NCCL needs one card per rank: {world} ranks, {n_cards} cards; run "
                                 f"backend='gloo' with devices='cuda:0' to put several ranks on one card")
            device = device if device is not None else torch.device('cuda', local_rank)
        elif device is None:
            device = torch.device('cuda', local_rank % n_cards)
        torch.cuda.set_device(device)
    else:
        device = torch.device('cpu')
    _set_rank_device(device)
    return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis_name,))


def _check_mesh(mesh, axis_name='points'):
    names = getattr(mesh, 'mesh_dim_names', None)
    if names is None or tuple(names) != (axis_name,):
        raise ValueError(f"expected a 1-D mesh over {axis_name!r} (make_mesh), got {mesh!r}")


def points_sharding(mesh, n, axis_name='points'):
    """The rows ``range(lo, hi)`` of an ``n``-row batch that this rank owns:
    one contiguous block per rank, the first ``n % world`` blocks one row
    longer. Needs ``n >= world``."""
    _check_mesh(mesh, axis_name)
    world, rank = mesh.size(), mesh.get_local_rank()
    if n < world:
        raise ValueError(f"a batch of {n} points cannot be sharded over {world} ranks (each needs a row)")
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return range(lo, lo + base + (rank < extra))


def shard_points(points, mesh, axis_name='points'):
    """This rank's rows of an ``(N, d)`` batch of points (a view)."""
    rows = points_sharding(mesh, points.shape[0], axis_name)
    return points[rows.start:rows.stop]


def _comm_device(group):
    """The device a collective of ``group`` runs on: the current card under
    NCCL; None (each tensor's own device) under gloo."""
    if dist.get_backend(group) == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return None


def _collective(op, tensor, group, **kwargs):
    """``op(tensor, group=group, ...)`` in place, through the comm device
    when ``tensor`` lies elsewhere (a CPU tensor under NCCL)."""
    dev = _comm_device(group)
    if dev is None or tensor.device == dev:
        op(tensor, group=group, **kwargs)
        return tensor
    buf = tensor.to(dev)
    op(buf, group=group, **kwargs)
    tensor.copy_(buf)
    return tensor


def all_reduce_(tensor, group):
    """Sum ``tensor`` over the ranks of ``group``, in place; returns it."""
    return _collective(dist.all_reduce, tensor, group)


def broadcast_(tensor, group):
    """Replace ``tensor`` by the group's first rank's, in place; returns it."""
    return _collective(dist.broadcast, tensor, group, src=dist.get_global_rank(group, 0))


def replicated_sharding(mesh):
    """The replicated layout: a function that makes a tensor equal on every
    rank of ``mesh`` (rank 0's value, broadcast in place) and returns it."""
    _check_mesh(mesh)
    group = mesh.get_group()
    return lambda tensor: broadcast_(tensor, group)


def _tensors(params):
    if torch.is_tensor(params):
        return [params]
    if isinstance(params, torch.nn.Module):
        return list(params.parameters()) + list(params.buffers())
    if isinstance(params, dict):
        return [t for v in params.values() for t in _tensors(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _tensors(v)]
    return []


@torch.no_grad()
def shard_params(params, mesh):
    """Replicate parameters on a 1-D mesh: every tensor of ``params`` (a
    module, its parameters and buffers; a state dict; a list of either)
    takes rank 0's value, in place. Returns ``params``. As in the JAX
    package on a 1-D mesh, nothing is split."""
    replicate = replicated_sharding(mesh)
    for t in _tensors(params):
        replicate(t)
    return params


def megatron_param_shardings(params, mesh):
    """Not ported: the ``'model'`` axis raises ``NotImplementedError``."""
    raise _model_axis_error("megatron_param_shardings")


class _GatherRows(torch.autograd.Function):
    """All ranks' blocks stacked in row order; the backward keeps this
    rank's rows of the incoming gradient."""

    @staticmethod
    def forward(ctx, block, shard):
        ctx.rows = (shard.lo, shard.hi)
        out = block.new_zeros((shard.n,) + tuple(block.shape[1:]))
        out[shard.lo:shard.hi] = block
        return all_reduce_(out, shard.group)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None


class RowShard:
    """This rank's block ``[lo, hi)`` of the rows of one ``n``-row global
    batch on ``mesh``: the context that a sharded loss, metric or
    stochastic operator needs."""

    __slots__ = ('group', 'rank', 'lo', 'hi', 'n')

    def __init__(self, mesh, n):
        rows = points_sharding(mesh, n)
        self.group, self.rank = mesh.get_group(), mesh.get_local_rank()
        self.lo, self.hi, self.n = rows.start, rows.stop, n

    @property
    def weight(self):
        """This block's share of a mean over the batch, ``(hi - lo) / n``."""
        return (self.hi - self.lo) / self.n

    def all_reduce(self, tensor):
        """``tensor`` summed over the ranks, in place."""
        return all_reduce_(tensor, self.group)

    def gather_rows(self, block):
        """The global ``(n, ...)`` tensor from every rank's ``(hi - lo, ...)``
        block; differentiable, its gradient flowing to this rank's rows."""
        return _GatherRows.apply(block, self)
