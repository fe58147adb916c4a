r"""Mesh construction and sharding helpers (counterpart of
``neurodiffeq_tpu/parallel/sharding.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the default process group. Its first axis, ``'points'``, is data
parallelism over the collocation batch: each rank owns one contiguous block
of the rows of every global batch (:func:`points_sharding`); the blocks may
be uneven. An optional second axis, ``'model'``, is Megatron tensor
parallelism over hidden units (``make_mesh(model_axis_size=m)``: rank ``p *
m + q`` is points index p and model index q): each rank of a model group
evaluates its slice of every FCNN layer pair (even layers split their
output columns, odd layers their input rows; :func:`megatron_param_shardings`)
and one ``all_reduce`` over the group per pair sums the partial Taylor
streams (:class:`ModelSplit`). Each rank stores only its blocks of those
split leaves (:func:`device_put_params`), and the optimizer state follows
them; reading a split leaf gathers it, and :func:`full_state` gives the
full-size tensors that solutions and saved files hold.

The collectives the solvers issue are ``all_reduce`` (a sum) and
``broadcast`` only, the two that every backend runs on CUDA tensors (gloo
included); over a group of one rank they are skipped. A gather of rows, or
of the blocks of a leaf, is an ``all_reduce`` of a zero buffer into which
each rank writes its block (:meth:`RowShard.gather_rows`, :class:`_Block`):
exact, since adding zeros changes no value.
"""
import contextlib
import os
from collections import namedtuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.utils import parametrize

__all__ = ['make_mesh', 'points_sharding', 'replicated_sharding', 'shard_points',
           'megatron_param_shardings', 'shard_params', 'device_put_params', 'full_state', 'ModelSplit']


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
    :param model_axis_size: if given (> 1), the mesh becomes 2-D with shape
        ``(world // model_axis_size, model_axis_size)`` and axes
        ``(axis_name, 'model')``; it must divide the world size
        (``ValueError`` otherwise).
    :param backend: ``'nccl'`` or ``'gloo'``; defaults to NCCL on the card
        and gloo on the CPU, or to the initialized group's. Under NCCL each
        rank needs a card of its own.
    :return: a ``torch.distributed.device_mesh.DeviceMesh`` with
        ``mesh_dim_names == (axis_name,)``, or ``(axis_name, 'model')``.
    """
    from torch.distributed.device_mesh import DeviceMesh
    from ..utils import _set_rank_device

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
    m = model_axis_size if model_axis_size is not None and model_axis_size > 1 else 1
    if world % m:
        raise ValueError(f"model_axis_size={model_axis_size} must divide the device count {world}")
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
    if m == 1:
        return DeviceMesh(device_type, list(range(world)), mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, torch.arange(world).reshape(world // m, m).tolist(),
                      mesh_dim_names=(axis_name, 'model'))


def _check_mesh(mesh, axis_name='points'):
    names = getattr(mesh, 'mesh_dim_names', None)
    if names is None or tuple(names) not in ((axis_name,), (axis_name, 'model')):
        raise ValueError(f"expected a mesh over {axis_name!r}, or over ({axis_name!r}, 'model') (make_mesh), "
                         f"got {mesh!r}")


Axes = namedtuple('Axes', 'points model')
_AXES = {}  # id(mesh) -> (mesh, Axes): slicing a DeviceMesh costs about 0.4 ms


def mesh_axes(mesh):
    """The 1-D meshes of ``mesh``'s axes, ``Axes(points, model)``: ``model``
    is None on a 1-D mesh, whose points axis is the mesh. Cached per mesh."""
    hit = _AXES.get(id(mesh))
    if hit is None or hit[0] is not mesh:
        names = tuple(mesh.mesh_dim_names)
        axes = Axes(mesh, None) if len(names) == 1 else Axes(mesh[names[0]], mesh['model'])
        hit = _AXES[id(mesh)] = (mesh, axes)
    return hit[1]


def world_group(mesh):
    """The process group of every rank of ``mesh`` (a mesh spans the
    default group)."""
    return mesh.get_group() if mesh_axes(mesh).model is None else dist.group.WORLD


def points_sharding(mesh, n, axis_name='points'):
    """The rows ``range(lo, hi)`` of an ``n``-row batch that this rank owns:
    one contiguous block per points index, the first ``n % P`` blocks one
    row longer, P the size of the points axis (the model ranks of one points
    index share a block). Needs ``n >= P``."""
    _check_mesh(mesh, axis_name)
    points = mesh_axes(mesh).points
    world, rank = points.size(), points.get_local_rank()
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
    when ``tensor`` lies elsewhere (a CPU tensor under NCCL); nothing over a
    group of one rank."""
    if dist.get_world_size(group) == 1:
        return tensor
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
    group = world_group(mesh)
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
    """Make parameters equal on every rank: every tensor of ``params`` (a
    module, its parameters and buffers; a state dict; a list of either)
    takes rank 0's value, in place. Returns ``params``. On a 1-D mesh, as in
    the JAX package, that is the whole layout. On a 2-D mesh the solvers
    then keep only each rank's blocks of the split leaves
    (:func:`device_put_params`): the two calls together are the JAX
    package's ``shard_params``."""
    replicate = replicated_sharding(mesh)
    for t in _tensors(params):
        replicate(t)
    return params


def divides(width, m):
    """Whether a dimension of ``width`` splits over ``m`` model ranks: the
    JAX package's rule, a multiple of ``m`` and at least ``m``."""
    return width % m == 0 and width >= m


def _layer_specs(linears, m):
    """Per ``nn.Linear`` (W its ``(n_in, n_out)`` view): even layers split
    W's output dimension and the bias with it, odd layers W's input
    dimension; a dimension that does not divide stays replicated. Reads
    the layers' sizes only."""
    specs = []
    for i, lin in enumerate(linears):
        w_spec, b_spec = (), ()
        if i % 2 == 0 and divides(lin.out_features, m):
            w_spec, b_spec = (None, 'model'), ('model',)
        elif i % 2 == 1 and divides(lin.in_features, m):
            w_spec = ('model', None)
        specs.append({'W': w_spec, 'b': b_spec})
    return specs


def megatron_param_shardings(params, mesh):
    """The Megatron layout of parameters on a 2-D ``(points, model)`` mesh,
    per leaf the JAX package's ``PartitionSpec`` as a tuple: ``(None,
    'model')`` splits the second dimension over the model axis, ``('model',)``
    or ``('model', None)`` the first, ``()`` replicates.

    For an FCNN or a SIREN (a module with ``linears``), ``{'layers': [{'W':
    spec, 'b': spec}, ...]}``, W meaning the ``(n_in, n_out)`` view that
    ``FCNN.layers()`` gives (the JAX package's layout): even layers split
    their output dimension and their bias with it, odd layers their input
    dimension (the bias replicated), and a dimension that does not divide
    the model axis, or is smaller than it, stays replicated. Any other
    module is replicated whole: ``()``. ``params`` may be a list of modules.
    """
    axis = mesh_axes(mesh).model
    if axis is None:
        raise ValueError("megatron_param_shardings needs a mesh with a 'model' axis")
    m = axis.size()

    def one(net):
        linears = getattr(net, 'linears', None)
        if not isinstance(net, torch.nn.Module) or linears is None:
            return ()
        return {'layers': _layer_specs(linears, m)}

    return [one(p) for p in params] if isinstance(params, (list, tuple)) else one(params)


def _chunk(width, m, q):
    """Model rank ``q``'s contiguous block of a ``width`` split over ``m``."""
    size = width // m
    return q * size, (q + 1) * size


def model_blocks(nets, mesh):
    """``{(linear, name): (dim, lo, hi)}``: the block of each split leaf of
    ``nets`` (an ``nn.Linear``'s ``'weight'`` or ``'bias'``) that this
    rank's model index owns, in ``nn.Linear``'s layout (weight ``(n_out,
    n_in)``); a leaf not listed is replicated."""
    axis = mesh_axes(mesh).model
    m, q = axis.size(), axis.get_local_rank()
    out = {}
    for net, layout in zip(nets, megatron_param_shardings(list(nets), mesh)):
        if not layout:
            continue
        for lin, spec in zip(net.linears, layout['layers']):
            if spec['W']:
                dim = 0 if spec['W'] == (None, 'model') else 1  # W (n_in, n_out) is weight (n_out, n_in)
                out[lin, 'weight'] = (dim, *_chunk((lin.out_features, lin.in_features)[dim], m, q))
            if spec['b']:
                out[lin, 'bias'] = (0, *_chunk(lin.out_features, m, q))
    return out


class _GatherBlocks(torch.autograd.Function):
    """A split leaf's full tensor from every model rank's block; the
    backward keeps this rank's block of the gradient (every model rank
    computes the same whole-net gradient, so nothing is summed)."""

    @staticmethod
    def forward(ctx, block, spec):
        ctx.spec = spec
        out = block.new_zeros(spec.shape)
        out.narrow(spec.dim, spec.lo, spec.hi - spec.lo).copy_(block)
        return all_reduce_(out, spec.split.group)

    @staticmethod
    def backward(ctx, grad):
        spec = ctx.spec
        return grad.narrow(spec.dim, spec.lo, spec.hi - spec.lo), None


class _Block(torch.nn.Module):
    """The parametrization of a split leaf (``torch.nn.utils.parametrize``,
    registered by :func:`device_put_params`): the module stores this
    rank's block ``[lo, hi)`` along ``dim`` of the full ``shape`` as the
    leaf's ``original``, and reading the leaf gathers the full tensor over
    the model group (a collective: every model rank reads it alike)."""

    def __init__(self, split, dim, shape):
        super().__init__()
        self.split, self.dim, self.shape = split, dim, tuple(shape)
        self.lo, self.hi = split.chunk(self.shape[dim])

    def forward(self, block):
        return _GatherBlocks.apply(block, self)

    def right_inverse(self, full):
        """This rank's block of the full-size ``full``, in storage of its own."""
        if tuple(full.shape) != self.shape:
            raise ValueError(f"expected the full-size leaf {self.shape}, got {tuple(full.shape)}")
        return full.narrow(self.dim, self.lo, self.hi - self.lo).clone(memory_format=torch.contiguous_format)

    def __deepcopy__(self, memo):  # a copy shares the process group
        return type(self)(self.split, self.dim, self.shape)


def _blocks_of(module):
    """``{name: (stored block, _Block)}`` of ``module``'s split leaves."""
    plist = getattr(module, 'parametrizations', None)
    return {} if plist is None else {name: (p.original, p[0]) for name, p in plist.items()
                                     if isinstance(p[0], _Block)}


@torch.no_grad()
def device_put_params(nets, mesh):
    """Keep on this rank only its blocks of the split leaves of ``nets``
    (:func:`megatron_param_shardings`, the JAX package's
    ``jax.device_put(params, megatron_param_shardings(params, mesh))``):
    each becomes a ``torch.nn.utils.parametrize`` parametrization
    (:class:`_Block`) whose ``original`` is the rank's block, in storage of
    its own. The parameter objects stay the same, so an optimizer made over
    them keeps them; ``parameters()`` then yields the blocks, and reading
    the leaf (``lin.weight``) gathers the full tensor. Every other leaf
    stays as it is. ``nets`` hold full-size leaves, equal on every rank
    (:func:`shard_params`). Returns ``nets``."""
    split = ModelSplit(mesh)
    for (lin, name), (dim, _, _) in model_blocks(nets, mesh).items():
        parametrize.register_parametrization(lin, name, _Block(split, dim, getattr(lin, name).shape), unsafe=True)
    return nets


def stored_blocks(nets):
    """``{stored block: _Block}`` of every split leaf of ``nets``."""
    return {block: spec for net in nets for mod in net.modules() for block, spec in _blocks_of(mod).values()}


def net_parameters(net):
    """``net.parameters()`` in the order that they have without a model
    mesh, each split leaf's stored block where the full leaf was (a module
    lists its parametrized leaves after its own, and ``nn.Linear``'s split
    leaves, the weight or the weight and the bias, come first in its own
    order)."""
    out = []
    for mod in net.modules():
        if not isinstance(mod, parametrize.ParametrizationList):
            out += [block for block, _ in _blocks_of(mod).values()] + list(mod.parameters(recurse=False))
    return list({id(p): p for p in out}.values())


def _block_keys(net):
    """``{state-dict key of a stored block: (the full leaf's key, _Block)}``."""
    out = {}
    for prefix, mod in net.named_modules():
        prefix = prefix + '.' if prefix else ''
        for name, (_, spec) in _blocks_of(mod).items():
            out[f'{prefix}parametrizations.{name}.original'] = (prefix + name, spec)
    return out


@torch.no_grad()
def full_state(net, state=None):
    """``net.state_dict()`` (or ``state``, a dict with its keys) with each
    stored block gathered into its full-size leaf, under the leaf's own key
    and in its place: what the net's state dict is without a model mesh.
    Every rank of the model group calls it alike."""
    keys = _block_keys(net)
    state = net.state_dict() if state is None else state
    items = []
    for k, v in state.items():
        full_key, spec = keys.get(k, (k, None))
        items.append((full_key, v if spec is None else _GatherBlocks.apply(v, spec), spec is None))
    # in the order without a mesh: a module's split leaves (the first of its own) before its other tensors
    modules = {}
    for full_key, _, _ in items:
        modules.setdefault(full_key.rpartition('.')[0], len(modules))
    items.sort(key=lambda item: (modules[item[0].rpartition('.')[0]], item[2]))
    return {k: v for k, v, _ in items}


def placed_state(net, full):
    """The state dict of ``net``'s keys from the full-size ``full`` (keys
    as :func:`full_state` gives them): this rank's block of each split
    leaf. No collective."""
    keys = _block_keys(net)
    out = {}
    for k in net.state_dict():
        full_key, spec = keys.get(k, (k, None))
        out[k] = full[full_key] if spec is None else spec.right_inverse(full[full_key])
    return out


def stored_leaf(lin, name):
    """What this rank stores of ``lin``'s leaf ``name``: its block where a
    model mesh splits the leaf (:func:`device_put_params`), else the leaf."""
    return lin.parametrizations[name].original if parametrize.is_parametrized(lin, name) else getattr(lin, name)


@torch.no_grad()
def load_leaf(lin, name, value):
    """Copy the full-size array ``value`` into ``lin``'s leaf ``name``; a
    split leaf keeps this rank's block. No collective."""
    stored = stored_leaf(lin, name)
    value = torch.tensor(np.asarray(value), dtype=stored.dtype, device=stored.device)
    if parametrize.is_parametrized(lin, name):
        setattr(lin, name, value)  # through _Block.right_inverse, which checks the shape
    elif value.shape != stored.shape:
        raise ValueError(f"shape {tuple(value.shape)} does not match {tuple(stored.shape)}")
    else:
        stored.copy_(value)


def squared_norms(rows, params, nets, mesh):
    """The squared L2 norm of each row of ``rows`` (``(k, n)``, each row a
    gradient over ``params`` flattened and concatenated) as the whole net's
    gradient has it: under a model axis each stored block's squares summed
    over the model group, and each replicated leaf, whose gradient every
    model rank holds alike, counted once (a collective)."""
    squares = rows * rows
    axis = mesh_axes(mesh).model
    if axis is None:
        return squares.sum(dim=1)
    blocks, first = stored_blocks(nets), axis.get_local_rank() == 0
    counted = torch.cat([torch.full((p.numel(),), float(p in blocks or first), dtype=squares.dtype,
                                    device=squares.device) for p in params])
    return all_reduce_((squares * counted).sum(dim=1), axis.get_group())


def plain_copies(nets, states):
    """Deep copies of the list ``nets`` (one deepcopy: a net listed twice
    stays shared) with no blocks: every split leaf a full-size parameter
    again, and each distinct copy loaded with ``states`` (one full-size
    state dict per distinct net, in order of first appearance). The live
    nets are not touched."""
    from copy import deepcopy

    copies = deepcopy(nets)
    unique = list({id(n): n for n in copies}.values())
    for net, state in zip(unique, states):
        for mod in net.modules():
            stored = _blocks_of(mod)
            if not stored:
                continue
            # the parametrized class is the plain one's subclass, shared with the live module: the copy leaves it
            mod.__class__ = type(mod).__bases__[0]
            del mod._modules['parametrizations']
            mod._parameters = {**{name: torch.nn.Parameter(block.new_empty(spec.shape), block.requires_grad)
                                  for name, (block, spec) in stored.items()}, **mod._parameters}
        net.load_state_dict(state)
    return copies


class _SumOverModel(torch.autograd.Function):
    """Megatron's g: the partial streams ``(c0, c1[, c2])`` stacked and
    summed over the model group, plus ``bias`` on the value stream; the
    backward is the identity (and the bias's gradient)."""

    @staticmethod
    def forward(ctx, bias, group, *parts):
        ctx.sizes = [1] + [p.shape[0] for p in parts[1:]]
        out = all_reduce_(torch.cat([parts[0][None], *parts[1:]]), group)
        out[0] += bias
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad[0].sum(0), None, *[g[0] if i == 0 else g
                                        for i, g in enumerate(torch.split(grad, ctx.sizes))])


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity; the backward sums the gradient over the
    model group (each rank's slice of the next pair reads all the streams)."""

    @staticmethod
    def forward(ctx, streams, group):
        ctx.group = group
        return streams.view_as(streams)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


class ModelSplit:
    """This rank's part of the ``'model'`` axis of ``mesh``: the group, its
    size ``m`` and this rank's index ``q`` in it."""

    __slots__ = ('group', 'size', 'rank')

    def __init__(self, mesh):
        axis = mesh_axes(mesh).model
        self.group, self.size, self.rank = axis.get_group(), axis.size(), axis.get_local_rank()

    def chunk(self, width):
        """This rank's block ``(lo, hi)`` of a ``width`` split over the axis."""
        return _chunk(width, self.size, self.rank)

    def reduce(self, parts, bias):
        """The ``(1 + order D, N, h)`` stack of the partial streams ``parts``
        summed over the group, ``bias`` added to the value; differentiable."""
        return _SumOverModel.apply(bias, self.group, *parts)

    def enter(self, streams):
        """``streams`` as the input of a split pair: the gradient that comes
        back is summed over the group."""
        return _CopyToModel.apply(streams, self.group)


_SPLITS = {}  # id(module) -> (module, ModelSplit) while split_scope is active


@contextlib.contextmanager
def split_scope(nets, split):
    """Within the block, the Taylor evaluations of ``nets`` run split over
    ``split``'s model group (:func:`active_split`), and a split leaf that a
    whole-net path reads is gathered once (``parametrize.cached``); None:
    nothing changes."""
    if split is None:
        yield
        return
    added = {id(n): (n, split) for n in nets if id(n) not in _SPLITS}
    _SPLITS.update(added)
    try:
        with parametrize.cached():
            yield
    finally:
        for k in added:
            del _SPLITS[k]


def active_split(module):
    """The :class:`ModelSplit` that ``module``'s Taylor evaluation runs
    over, or None."""
    hit = _SPLITS.get(id(module))
    return hit[1] if hit is not None and hit[0] is module else None


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
    stochastic operator needs. Its collectives run over the ``'points'``
    axis: the model ranks of one points index hold the same rows."""

    __slots__ = ('group', 'rank', 'lo', 'hi', 'n')

    def __init__(self, mesh, n):
        rows = points_sharding(mesh, n)
        points = mesh_axes(mesh).points
        self.group, self.rank = points.get_group(), points.get_local_rank()
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
