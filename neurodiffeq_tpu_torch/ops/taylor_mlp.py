r"""Fused Taylor-mode FCNN evaluation: the CUDA kernels, their plain twin,
and the autograd function around them.

Counterpart of ``neurodiffeq_tpu/ops/pallas_mlp.py``. For ``points`` (N, d)
and an FCNN given as ``layers = [(W, b), ...]`` (``W`` is ``(n_in, n_out)``,
the JAX package's layout; tanh or sin between layers, none after the last),
both paths return ``(c0, c1[, c2])``: the value ``(N, out)`` and the first
and second directional derivatives ``(D, N, out)`` along the D = d
coordinate axes.

- :func:`fcnn_taylor_reference` is the plain PyTorch twin of
  ``_pure_jax_taylor``: it runs on any device and is the backward below.
- :func:`fcnn_taylor` is the public entry. A CPU tensor goes to the twin;
  a CUDA tensor launches one of the hand-written kernels of
  ``neurodiffeq_tpu_torch/csrc/taylor_mlp.cu`` or raises:
  ``taylor_mlp_1h`` for a net with one hidden layer, ``taylor_mlp`` for
  every other depth (:func:`_plan` picks). The kernels take any input
  width, 1-128 layers and any hidden width, as the TPU kernel does. Its gradient is
  :class:`_TaylorMLPFn`, rematerialized from the saved inputs: for one hidden
  layer of at most 128 outputs the hand-written ``taylor_mlp_1h_bwd`` kernel
  (:func:`_plan_bwd`; its plain version is
  :func:`taylor_mlp_1h_backward_reference`), for any other net autograd over
  the twin, as ``_fused_bwd`` re-derives it by ``jax.vjp`` over the pure-JAX
  twin.

:func:`fcnn_taylor_streams` is the same evaluation on input Taylor streams
``(1 + order D, N, h_in)`` (the layout the kernels write: the value, then
the D first and the D second coefficients), after an optional input
activation: the layer pairs of a net split over a ``'model'`` mesh axis
(:mod:`~neurodiffeq_tpu_torch.parallel`) after the first. A CUDA tensor
launches ``taylor_mlp_streams`` or raises: the tensor-core kernel of
``csrc/taylor_mlp_streams.cu`` with the weights resident in shared memory,
or, where they do not fit there, its staged instance in ``csrc/taylor_mlp.cu``
(:func:`_plan_streams` routes by shape). A CPU tensor runs its twin
:func:`fcnn_taylor_streams_reference`, which is its backward too.

``LAUNCHES`` counts launches per kernel, ``STREAM_DESIGNS`` the
``taylor_mlp_streams`` launches per design, ``TWIN_BACKWARDS`` the
one-hidden-layer backwards that ran the twin, by shape; :func:`reset_launches`
zeroes them.

The switch has the JAX package's names (``pallas_mlp.py``): while
:func:`pallas_enabled`, a network takes the fused call where it applies;
after :func:`disable_pallas` a network on CPU tensors goes layer by layer
and launches nothing. On the card the kernels launch or the call raises,
whatever the switch says: a network on CUDA tensors raises while the
switch is off, and the three entries raise on CUDA tensors under
``enable_pallas(interpret=True)`` (CPU tensors run the twins either way).
Unlike the JAX package's, the switch is on by default: the card is the
port's platform. ``tile`` is checked and otherwise ignored: :func:`_plan`
sizes the launches. :func:`fcnn_taylor_pallas` takes the JAX package's
arguments.
"""
import ctypes
import functools
import math
from collections import namedtuple

import torch

from ..utils import full_precision_matmuls

__all__ = ['fcnn_taylor', 'fcnn_taylor_reference', 'fcnn_taylor_streams', 'fcnn_taylor_streams_reference',
           'taylor_mlp_1h_backward_reference', 'fcnn_taylor_pallas', 'enable_pallas', 'disable_pallas',
           'pallas_enabled', 'pallas_config', 'LAUNCHES', 'TWIN_BACKWARDS', 'reset_launches']

LAUNCHES = {'taylor_mlp_1h': 0, 'taylor_mlp': 0, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}
STREAM_DESIGNS = {'resident': 0, 'staged': 0}
# backward calls of a one-hidden-layer net (a taylor_mlp_1h forward) that ran the
# twin, by (layer widths, order): the shapes past _MAX_BWD_OUT outputs
TWIN_BACKWARDS = {}
_CONFIG = {'enabled': True, 'interpret': False}

_ACTVS = {'tanh': 0, 'sin': 1}
_IN_ACTVS = {None: -1, **_ACTVS}  # taylor_mlp_streams' input activation
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
# the CUDA source's constants
_MAX_LAYERS, _MAX_DIMS, _MAX_THREADS = 128, 8, 256   # _MAX_DIMS: directions of one chunk
_MAX_GRID_YZ = 65535   # CUDA's bound on a grid's y and z extents: output units, direction chunks
_K_TILE, _CHUNK = 16, 128   # kKTile, kChunk: one staged weight tile is kKTile x (kChunk + 1)
# taylor_mlp_streams.cu's constants: threads of a block, points of a unit's tile and depth of
# an mma k step by element size, weight rows padded to a multiple of _ROW_TILE, the mbarriers
_RESIDENT_THREADS, _RESIDENT_TILE, _MMA_K, _ROW_TILE, _BAR_BYTES = 512, {4: 16, 8: 8}, {4: 8, 8: 4}, 16, 16
_NARROW_OUT, _NARROW_IN, _NARROW_MACS = 8, 64, 2048   # _narrow: where the staged instance is the faster
# taylor_mlp_1h_bwd: the widest output layer it takes, its output tiles (kBwdOut's instances), threads
# of a block (kBwdThreads), bytes of a staged sub-tile (kBwdStage), and warps per SM that _plan_bwd aims at
# and the sum pass's lanes per element (kSumLanes)
_MAX_BWD_OUT, _BWD_OUT_TILES, _BWD_THREADS, _BWD_STAGE, _BWD_WARPS_PER_SM = 128, (1, 4, 16), 128, 24576, 32
_SUM_LANES = 16


def reset_launches():
    """Set every kernel's launch count to 0, and forget the twin backwards."""
    for counts in (LAUNCHES, STREAM_DESIGNS):
        for name in counts:
            counts[name] = 0
    TWIN_BACKWARDS.clear()


def enable_pallas(interpret=False, tile=256):
    """Turn on the fused path for FCNN Taylor evaluation (the default).

    :param interpret: the JAX package's interpreter mode: the twins, which
        CPU tensors run anyway; on CUDA tensors the fused entries then raise.
    :param tile: the JAX package's points per tile, a positive int, checked
        and otherwise ignored (the launches size their own).
    """
    _check_tile(tile)
    _CONFIG.update(enabled=True, interpret=bool(interpret))


def disable_pallas():
    """Send networks layer by layer: no fused call, no launch. On CPU
    tensors only: a network on CUDA tensors raises until
    :func:`enable_pallas`."""
    _CONFIG['enabled'] = False


def pallas_enabled():
    """Whether networks take the fused path where it applies."""
    return _CONFIG['enabled']


def pallas_config():
    """A copy of the switch: ``{'enabled', 'interpret'}``."""
    return dict(_CONFIG)


def _check_tile(tile):
    if tile is not None and not (isinstance(tile, int) and tile > 0):
        raise ValueError(f"tile must be a positive int, got {tile!r}")


def _use_kernels(tensor):
    """Whether a network takes the fused call on ``tensor``: while the switch
    is on. Off, CPU tensors go layer by layer and CUDA tensors raise."""
    if _CONFIG['enabled']:
        return True
    if tensor.device.type == 'cuda':
        raise RuntimeError("the kernel switch is off (disable_pallas()), and on a CUDA tensor a network launches the "
                           "kernels or raises: call enable_pallas(), or evaluate on CPU tensors")
    return False


def _runs_twin(tensor, entry, interpret):
    """Whether ``entry`` runs its twin on ``tensor``: on a CPU tensor it
    does; on a CUDA tensor it launches its kernel, and raises where
    ``interpret`` asks for the twin; on any other device it raises."""
    if tensor.device.type == 'cpu':
        return True
    if tensor.device.type != 'cuda':
        raise TypeError(f"{entry} runs on 'cpu' or 'cuda' tensors, got {tensor.device}")
    if interpret:
        raise RuntimeError(f"{entry}: interpret=True runs the twin on CPU tensors only, and on a CUDA tensor the "
                           f"kernel launches or the call raises: call enable_pallas(), or pass CPU tensors")
    return False


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


def taylor_mlp_1h_backward_reference(points, layers, order, actv, grads, need_points=True):
    """The gradient of a one-hidden-layer net's Taylor series in closed form:
    what the ``taylor_mlp_1h_bwd`` kernel computes, in plain PyTorch (the
    backward's stand-in for the launch on CPU tensors, and the kernel's
    yardstick on the card). With p = g W2^T for each cotangent,
    ``dz = f' p0 + f'' sum_k W1[k] p1[k] + f''' sum_k W1[k]^2 p2[k]`` is the
    hidden pre-activation's cotangent; every other term follows from it.

    :param points: (N, d).
    :param layers: ``[(W1, b1), (W2, b2)]`` with ``W`` (n_in, n_out).
    :param order: 1 or 2.
    :param actv: 'tanh' or 'sin'.
    :param grads: the cotangents ``(g0, g1[, g2])`` of ``(c0, c1[, c2])``,
        (N, m) and (d, N, m); None where an output was not used.
    :param need_points: whether to return the points' gradient.
    :return: ``(gx, gW1, gb1, gW2, gb2)`` in the inputs' shapes; gx is None
        unless ``need_points``.
    """
    (W1, b1), (W2, b2) = layers
    g0, g1, g2 = (list(grads) + [None] * 3)[:3]
    z = points @ W1 + b1
    a, f1, f2 = _actv_chain(z, actv)
    f3 = -2 * (f1 * f1 + a * f2) if actv == 'tanh' else -f1
    dz, gW1, gW2, gb2 = torch.zeros_like(z), torch.zeros_like(W1), torch.zeros_like(W2), torch.zeros_like(b2)
    if g0 is not None:
        dz = dz + f1 * (g0 @ W2.t())
        gW2 = gW2 + a.t() @ g0
        gb2 = g0.sum(0)
    # c1 = (f' W1[k]) W2 and c2 = (f'' W1[k]^2) W2: through f' (f'') and through W1 itself
    for k_order, g, f, f_next, w in ((1, g1, f1, f2, W1), (2, g2, f2, f3, W1 * W1)):
        if g is None or k_order > order:
            continue
        p = g @ W2.t()  # (d, N, h)
        dz = dz + f_next * (w[:, None, :] * p).sum(0)
        through_w = (f[None] * p).sum(1)
        gW1 = gW1 + (through_w if k_order == 1 else 2 * W1 * through_w)
        gW2 = gW2 + sum(w[k][:, None] * (f.t() @ g[k]) for k in range(points.shape[1]))
    gW1 = gW1 + points.t() @ dz
    return (dz @ W1.t() if need_points else None), gW1, dz.sum(0), gW2, gb2


def _stream_dirs(streams, order):
    """The directions D of ``(1 + order D, N, h)`` input streams."""
    if order not in (1, 2):
        raise ValueError(f"the Taylor streams entry supports order 1 or 2, got {order}")
    if streams.ndim != 3 or streams.shape[0] < 1 + order or (streams.shape[0] - 1) % order:
        raise ValueError(f"streams must be (1 + order * D, N, h) with D >= 1 at order {order}, "
                         f"got shape {tuple(streams.shape)}")
    return (streams.shape[0] - 1) // order


def _unstack(out, order, d):
    """``(c0, c1[, c2])``: views of a ``(1 + order d, N, m)`` stream stack."""
    return (out[0], out[1:1 + d], out[1 + d:])[:order + 1]


def _stream_actv(z, order, d, actv):
    """Stacked streams through the activation: a = f(z0), u1 = f' z1,
    u2 = f' z2 + f'' z1^2."""
    a, f1, f2 = _actv_chain(z[0], actv)
    z1 = z[1:1 + d]
    parts = [a[None], f1[None] * z1]
    if order == 2:
        parts.append(f1[None] * z[1 + d:] + f2[None] * z1 * z1)
    return torch.cat(parts)


def _streams_stacked_reference(streams, layers, order, actv, input_actv):
    d = _stream_dirs(streams, order)
    s = streams if input_actv is None else _stream_actv(streams, order, d, input_actv)
    for i, (W, b) in enumerate(layers):
        z = s @ W
        s = torch.cat([(z[0] + b)[None], z[1:]])
        if i + 1 < len(layers):
            s = _stream_actv(s, order, d, actv)
    return s


def fcnn_taylor_streams_reference(streams, layers, order, actv='tanh', input_actv=None):
    """Plain Taylor propagation of input streams through an FCNN (the
    ``taylor_mlp_streams`` kernel's twin).

    :param streams: ``(1 + order * D, N, h_in)``: the value, then the D
        first-order and (order 2) the D second-order coefficients.
    :param layers: ``[(W, b), ...]`` with ``W`` (n_in, n_out), ``b`` (n_out,).
    :param order: 1 or 2.
    :param actv: 'tanh' or 'sin', between the layers.
    :param input_actv: None, 'tanh' or 'sin': applied to the streams first.
    :return: ``(c0, c1[, c2])`` with c0 (N, out) and ck (D, N, out): views
        of one ``(1 + order * D, N, out)`` stack.
    """
    out = _streams_stacked_reference(streams, layers, order, actv, input_actv)
    return _unstack(out, order, _stream_dirs(streams, order))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index):
    return torch.cuda.get_device_properties(device_index).multi_processor_count


Plan = namedtuple('Plan', 'kernel tile threads smem hstride blocks scratch')


def _streams(d, order):
    """Streams of one launch's direction chunk: the value and ``order``
    coefficients for each of ``min(d, 8)`` directions."""
    return 1 + order * min(d, _MAX_DIMS)


def _max_tile_1h(s):
    """``max_tile_1h`` of the CUDA source: points a block of the 1h kernel
    keeps accumulators for, ``s`` = 1 + order*d registers each, 32 in all."""
    return 32 // s


def _points_per_warp(s):
    """``points_per_warp`` of the CUDA source (general kernel)."""
    return 2 if s <= 5 else 1


def _plan(n, dims, order, esize, n_sm):
    """How to launch the kernel for ``n`` points through widths ``dims`` at
    ``order``, with ``esize``-byte floats on a card of ``n_sm`` SMs. Inputs
    past 8 run as chunks of 8 directions on a grid axis of their own.

    - One hidden layer and at most 65,535 outputs: ``taylor_mlp_1h``. The
      tile is as small as puts two blocks on every SM, up to
      ``_max_tile_1h``; the block has as many warps (1-8, at most one per 32
      hidden units) as give the card about 32 warps per SM, so that at
      large N each lane owns more units and the warp sums weigh less. Its
      shared memory is static.
    - Any other net: ``taylor_mlp``. A warp owns ``_points_per_warp``
      points; the block has as many warps (8, 4, 2 or 1) as fit the
      streams' two buffers and two staged weight tiles in shared memory and
      still give every other SM a block: more warps share each staged
      weight tile, and on the card that outweighs idle SMs down to about
      half of them busy. Where not even one warp's streams fit, they go to
      a global scratch of ``scratch`` elements: 8 warps, about one block
      per SM, each looping over point tiles.
    """
    d, n_layers, s = dims[0], len(dims) - 1, _streams(dims[0], order)
    chunks = math.ceil(d / _MAX_DIMS)
    if n_layers == 2 and dims[-1] <= _MAX_GRID_YZ:
        tile = max(1, min(_max_tile_1h(s), math.ceil(n / (2 * n_sm))))
        blocks = math.ceil(n / tile)
        warps = max(1, min(_MAX_THREADS // 32, math.ceil(dims[1] / 32), 32 * n_sm // (blocks * chunks)))
        return Plan('taylor_mlp_1h', tile, 32 * warps, 0, 0, blocks, 0)
    if n_layers == 1:
        return Plan('taylor_mlp', 32, 128, 0, 0, math.ceil(n / 32), 0)
    return _staged_plan('taylor_mlp', n, s, chunks, max(dims[1:-1]), esize, n_sm)


StreamPlan = namedtuple('StreamPlan', 'design tile threads smem hstride blocks scratch buffers')


def _hstride(width, esize):
    """``hstride`` of ``taylor_mlp_streams.cu``: the shared-memory row
    stride of a width-``width`` operand, whole mma k steps and 4 mod 8
    elements (the fragment loads' 8 rows x 4 columns in distinct banks)."""
    k = -(-width // _MMA_K[esize]) * _MMA_K[esize]
    return k if k % 8 == 4 else k + 4


def _stage_in_operand(dims, esize):
    """Whether the resident kernel stages a unit's outputs in the first
    layer's operand buffer: the output layer does not read it, and the
    outputs fit."""
    return len(dims) > 2 and dims[-1] <= _hstride(dims[0], esize)


def _resident_smem(dims, s, buffers, esize):
    """Bytes of the resident kernel's shared memory (``layout`` of the CUDA
    source): the mbarriers, every layer's weights and bias, ``buffers`` raw input
    buffers, the first layer's operand, up to two buffers of hidden
    streams and, unless it is the operand buffer, the output stage, for
    ``s`` streams of one tile."""
    tile = _RESIDENT_TILE[esize]
    elems = sum(-(-b // _ROW_TILE) * _ROW_TILE * _hstride(a, esize) + -(-b // 4) * 4
                for a, b in zip(dims[:-1], dims[1:]))
    elems += buffers * s * tile * dims[0] + s * tile * _hstride(dims[0], esize)
    hidden = dims[1:-1]
    if hidden:
        elems += min(2, len(hidden)) * s * tile * max(_hstride(h, esize) for h in hidden)
    if not _stage_in_operand(dims, esize):
        elems += s * tile * dims[-1]
    return _BAR_BYTES + elems * esize


def _bulk_rows(width, esize):
    """Whether a tile's input streams of ``width`` elements per point can
    come by bulk copy (one per stream), not element by element: a bulk copy
    moves a whole number of 16 bytes between 16-byte aligned addresses (the
    launch checks the input's own alignment)."""
    return width * esize % 16 == 0


def _narrow(dims):
    """Whether ``taylor_mlp_streams``' staged instance outruns the resident
    kernel at widths ``dims`` (both timed at shapes on each side of each
    bound, ``chip_smoke.py`` phase 6): where every weak part of the staged
    design is small, so that the resident kernel's fixed latency per tile
    (the copies, the operand pass, three barriers, chains of mma on unit
    tiles padded to 16) is not hidden. Its output layer, one warp reduction
    per (point, output unit), is narrower than one mma n tile; its input,
    loaded element by element through the input activation, is at most
    ``_NARROW_IN`` wide; and its products, on CUDA cores, take at most
    ``_NARROW_MACS`` multiply-adds per point and stream."""
    return (dims[-1] < _NARROW_OUT and dims[0] <= _NARROW_IN
            and sum(a * b for a, b in zip(dims[:-1], dims[1:])) <= _NARROW_MACS)


def _plan_streams(n, d, dims, order, esize, n_sm, design=None):
    """The launch of ``taylor_mlp_streams`` for ``n`` points with ``d``
    directions through widths ``dims`` (``dims[0]`` the streams' width);
    ``design`` ``'resident'`` or ``'staged'`` takes that design whatever
    the shape (``chip_smoke.py`` times one against the other), and
    ``'resident'`` raises ``ValueError`` where it does not fit.

    - ``'resident'`` (``csrc/taylor_mlp_streams.cu``) where every layer's
      weights stay in shared memory beside the tile's buffers with one raw
      input buffer; two where they fit, so that the next tile's copies
      start before this tile's input is read. Tiles of ``_RESIDENT_TILE``
      points; persistent blocks of 16 warps, one on each SM (two would not
      fit an SM's registers), none without a (tile, direction chunk) unit.
    - ``'staged'`` otherwise: for a narrow net (:func:`_narrow`; the
      default FCNN's trailing 32 -> 1 layer), and where the weights do not
      fit (the reach shape 2800 -> 64 -> 1, whose weights take 717 KB in
      float32; in float64 the cavity's 128 -> 64 -> 128 pair, 137 KB of
      weights beside 105 KB of buffers): ``taylor_mlp_kernel``'s stream
      instance in ``csrc/taylor_mlp.cu``, on staged weight tiles
      (:func:`_staged_plan`).
    """
    if design not in (None, 'resident', 'staged'):
        raise ValueError(f"unknown taylor_mlp_streams design {design!r}")
    s, chunks = _streams(d, order), math.ceil(d / _MAX_DIMS)
    tile = _RESIDENT_TILE[esize]
    for buffers in (2, 1) if design == 'resident' or (design is None and not _narrow(dims)) else ():
        smem = _resident_smem(dims, s, buffers, esize)
        if smem <= _SMEM_LIMIT:
            blocks = min(math.ceil(n / tile) * chunks, n_sm)
            return StreamPlan('resident', tile, _RESIDENT_THREADS, smem, _hstride(dims[0], esize), blocks, 0,
                              buffers)
    if design == 'resident':
        raise ValueError(f"taylor_mlp_streams' resident design does not fit widths {dims} at {s} streams")
    staged = _staged_plan('taylor_mlp_streams', n, s, chunks, max(dims[:-1]), esize, n_sm)
    return StreamPlan('staged', *staged[1:], 0)


def _staged_plan(kernel, n, s, chunks, hstride, esize, n_sm):
    """The general kernel's plan (:func:`_plan`) for ``s`` streams of width
    at most ``hstride``."""
    per_warp, w_tiles = _points_per_warp(s), _weight_tiles(esize)
    fits = [w for w in (8, 4, 2, 1) if 2 * s * w * per_warp * hstride * esize + w_tiles <= _SMEM_LIMIT]
    if not fits:
        tile = 8 * per_warp
        blocks = min(math.ceil(n / tile), max(1, math.ceil(n_sm / chunks)))
        return Plan(kernel, tile, 256, w_tiles, hstride, blocks, blocks * chunks * 2 * s * tile * hstride)
    warps = next((w for w in fits if math.ceil(n / (w * per_warp)) * chunks >= n_sm // 2), fits[-1])
    tile = warps * per_warp
    return Plan(kernel, tile, 32 * warps, 2 * s * tile * hstride * esize + w_tiles, hstride,
                math.ceil(n / tile), 0)


def _weight_tiles(esize):
    """Bytes of the general kernel's two staged weight tiles."""
    return 2 * _K_TILE * (_CHUNK + 1) * esize


_PLANS = {}  # (kernel family, dtype, device index, dims, order, n, d[, design]) -> Plan, StreamPlan or BwdPlan

BwdPlan = namedtuple('BwdPlan', 'out_tile threads blocks span tile unit_tiles out_tiles')


def _bwd_tile(rec, esize):
    """``bwd_tile`` of the CUDA source: points of a staged sub-tile of the
    backward, for ``rec`` elements a point."""
    tp = 64
    while tp > 1 and tp * rec * esize > _BWD_STAGE:
        tp //= 2
    return tp


def _bwd_kernel_takes(dims):
    """Whether ``taylor_mlp_1h_bwd`` takes the gradient through widths
    ``dims``: one hidden layer and at most ``_MAX_BWD_OUT`` outputs."""
    return len(dims) == 3 and dims[-1] <= _MAX_BWD_OUT


def _plan_bwd(n, dims, order, esize, n_sm):
    """How to launch ``taylor_mlp_1h_bwd`` for the gradient of ``n``
    points through a one-hidden-layer net of widths ``dims``; None where the
    backward runs the twin: any other depth, and output layers wider than
    ``_MAX_BWD_OUT`` (whose per-output work is a matrix product).

    A thread owns a hidden unit, a block up to ``_BWD_THREADS`` of them, and
    the grid's y axis the unit tiles times the output tiles (1, 4 or 16
    columns of W2: the fewest that hold the output layer, 16 past it); d past
    8 puts the direction chunks on z. The points are split into ``blocks``
    spans of ``span`` points, as many as give the card about
    ``_BWD_WARPS_PER_SM`` warps per SM, but no shorter than
    sqrt(N x output tiles / (4 ``_SUM_LANES``)): a thread walks its block's
    span in order, and a lane of the sum pass the block x output tile slabs
    a sixteenth of them, so that at small N neither chain runs much longer
    than the other. A span is whole staged sub-tiles of ``tile`` points
    where it is longer than one.
    """
    if not _bwd_kernel_takes(dims):
        return None
    d, h, m = dims
    out_tile = next((t for t in _BWD_OUT_TILES if t >= m), _BWD_OUT_TILES[-1])
    dirs = min(d, _MAX_DIMS)
    tile = _bwd_tile(dirs + out_tile + order * dirs * out_tile, esize)
    threads = min(_BWD_THREADS, 32 * math.ceil(h / 32))
    unit_tiles, out_tiles = math.ceil(h / threads), math.ceil(m / out_tile)
    blocks_per_span = unit_tiles * out_tiles * math.ceil(d / _MAX_DIMS)  # the direction chunks on z
    spans = max(1, math.ceil(n_sm * _BWD_WARPS_PER_SM * 32 / threads / blocks_per_span))
    span = max(math.ceil(n / spans), math.ceil(math.sqrt(n * out_tiles / (4 * _SUM_LANES))))
    if span > tile:
        span = tile * math.ceil(span / tile)
    blocks = math.ceil(n / span)
    return BwdPlan(out_tile, threads, blocks, span, tile, unit_tiles, out_tiles)


def _check(points, layers, order, actv, d=None):
    """Raise on what the kernels do not take; return the widths. ``d``
    given: ``points`` are contiguous ``(1 + order d, N, h)`` input streams
    (``_stream_dirs`` checked their shape)."""
    dtype, device = points.dtype, points.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fcnn_taylor kernel takes float32 or float64, got {dtype}")
    if d is None and (points.ndim != 2 or not points.is_contiguous()):
        raise ValueError(f"points must be a contiguous (N, d) tensor, got shape {tuple(points.shape)}")
    if d is not None and not points.is_contiguous():
        raise ValueError("input streams must be contiguous")
    if order not in (1, 2):
        raise ValueError(f"fcnn_taylor kernel supports order 1 or 2, got {order}")
    if actv not in _ACTVS:
        raise ValueError(f"unsupported activation {actv!r}; expected 'tanh' or 'sin'")
    width = points.shape[-1]
    d = width if d is None else d
    if not 1 <= len(layers) <= _MAX_LAYERS or not 1 <= math.ceil(d / _MAX_DIMS) <= _MAX_GRID_YZ:
        raise ValueError(f"the kernels take 1-{_MAX_LAYERS} layers and 1-{_MAX_DIMS * _MAX_GRID_YZ} "
                         f"directions, got {len(layers)} layers and d={d}")
    dims = [width]
    for i, (W, b) in enumerate(layers):
        for name, t in (('W', W), ('b', b)):
            if t.dtype != dtype or t.device != device:
                raise TypeError(f"layer {i} {name} is {t.dtype} on {t.device}; "
                                f"points are {dtype} on {device}")
        if W.ndim != 2 or W.shape[0] != dims[-1] or b.shape != (W.shape[1],):
            raise ValueError(f"layer {i}: W {tuple(W.shape)} and b {tuple(b.shape)} do not "
                             f"chain from width {dims[-1]}")
        dims.append(W.shape[1])
    return tuple(dims)


def _row_major(t):
    """``t`` itself where its data are already row-major, else a copy."""
    return t if t.is_contiguous() else t.contiguous()


def _call(fn, args, index):
    """``fn(*args, stream)`` with the current stream of device ``index``, on
    that device: the C entry's error code. The raw handle is read as torch's
    inductor-generated code reads it: ``torch.cuda.current_stream()`` builds a
    Stream object per call."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def _launch(points, layers, order, actv):
    """Check the inputs, allocate the outputs and launch the CUDA kernel on
    the current stream. Weights may be any (n_in, n_out) view: the kernels
    read them in ``nn.Linear``'s (n_out, n_in) row-major layout, which for
    ``nn.Linear`` weights costs no copy."""
    from ._build import load_library

    dims = _check(points, layers, order, actv)
    dtype, device = points.dtype, points.device
    n, d = points.shape
    n_out = dims[-1]
    out = torch.empty((1 + order * d, n, n_out), dtype=dtype, device=device)  # one allocation
    c0, c1, c2 = out[0], out[1:1 + d], (out[1 + d:] if order == 2 else None)
    if n == 0:
        return (c0, c1, c2)[:order + 1]
    index = points.get_device()
    key = ('points', dtype, index, dims, order, n, d)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(n, dims, order, points.element_size(), _sm_count(index))
    Wk = [_row_major(W.t()) for W, _ in layers]  # kept alive until the launch is enqueued
    bk = [_row_major(b) for _, b in layers]

    lib = load_library()
    suffix = '_f32' if dtype == torch.float32 else '_f64'
    p0, stride = out.data_ptr(), n * n_out * points.element_size()
    outs = [points.data_ptr(), p0, p0 + stride, p0 + (1 + d) * stride if order == 2 else None]
    if plan.kernel == 'taylor_mlp_1h':
        args = (outs[0], n, d, dims[1], n_out, Wk[0].data_ptr(), bk[0].data_ptr(),
                Wk[1].data_ptr(), bk[1].data_ptr(), order, _ACTVS[actv], plan.tile, plan.threads,
                *outs[1:])
    else:
        # streams that do not fit shared memory: a scratch, freed to the stream's pool after the launch
        scratch = torch.empty(plan.scratch, dtype=dtype, device=device) if plan.scratch else None
        args = (outs[0], n, d, len(layers), (ctypes.c_int * len(dims))(*dims),
                (ctypes.c_void_p * len(Wk))(*[w.data_ptr() for w in Wk]),
                (ctypes.c_void_p * len(bk))(*[t.data_ptr() for t in bk]),
                order, _ACTVS[actv], plan.tile, plan.threads, plan.smem, plan.hstride, plan.blocks,
                None if scratch is None else scratch.data_ptr(), *outs[1:])
    err = _call(getattr(lib, plan.kernel + suffix), args, index)
    if err != 0:
        raise RuntimeError(f"{plan.kernel} kernel launch failed: CUDA error {err} "
                           f"(n={n}, dims={dims}, order={order}, plan={plan})")
    LAUNCHES[plan.kernel] += 1
    return (c0, c1, c2)[:order + 1]


def _launch_streams(streams, layers, order, actv, input_actv, design=None):
    """:func:`_launch` for input streams: ``taylor_mlp_streams`` on the
    current stream, in the design :func:`_plan_streams` picks (or
    ``design``); returns the ``(1 + order d, N, out)`` stack."""
    from ._build import load_library

    d = _stream_dirs(streams, order)
    if input_actv not in _IN_ACTVS:
        raise ValueError(f"unsupported input activation {input_actv!r}; expected None, 'tanh' or 'sin'")
    dims = _check(streams, layers, order, actv, d)
    dtype, device, n = streams.dtype, streams.device, streams.shape[1]
    out = torch.empty((1 + order * d, n, dims[-1]), dtype=dtype, device=device)
    if n == 0:
        return out
    index = streams.get_device()
    key = ('streams', dtype, index, dims, order, n, d, design)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan_streams(n, d, dims, order, streams.element_size(), _sm_count(index), design)
    Wk = [_row_major(W.t()) for W, _ in layers]  # kept alive until the launch is enqueued
    bk = [_row_major(b) for _, b in layers]
    net = (streams.data_ptr(), n, d, len(layers), (ctypes.c_int * len(dims))(*dims),
           (ctypes.c_void_p * len(Wk))(*[w.data_ptr() for w in Wk]),
           (ctypes.c_void_p * len(bk))(*[t.data_ptr() for t in bk]),
           order, _ACTVS[actv], _IN_ACTVS[input_actv])
    if plan.design == 'resident':
        bulk = _bulk_rows(dims[0], streams.element_size()) and streams.data_ptr() % 16 == 0
        name, args = 'taylor_mlp_streams', (*net, plan.buffers, int(bulk), plan.blocks, out.data_ptr())
    else:
        scratch = torch.empty(plan.scratch, dtype=dtype, device=device) if plan.scratch else None
        p0, stride = out.data_ptr(), n * dims[-1] * streams.element_size()
        name, args = 'taylor_mlp_streams_staged', (*net, plan.tile, plan.threads, plan.smem, plan.hstride,
                                                   plan.blocks, None if scratch is None else scratch.data_ptr(),
                                                   p0, p0 + stride, p0 + (1 + d) * stride if order == 2 else None)
    err = _call(getattr(load_library(), name + ('_f32' if dtype == torch.float32 else '_f64')), args, index)
    if err != 0:
        raise RuntimeError(f"taylor_mlp_streams kernel launch failed: CUDA error {err} "
                           f"(n={n}, d={d}, dims={dims}, order={order}, plan={plan})")
    LAUNCHES['taylor_mlp_streams'] += 1
    STREAM_DESIGNS[plan.design] += 1
    return out


def _launch_bwd(points, layers, order, actv, grads, need_points):
    """Launch ``taylor_mlp_1h_bwd`` (the partial sums and their fixed-order
    sum pass) on the current stream: :func:`taylor_mlp_1h_backward_reference`
    on the card. The caller routes by :func:`_plan_bwd`."""
    from ._build import load_library

    dims = _check(points, layers, order, actv)
    (W1, b1), (W2, _) = layers
    dtype, device = points.dtype, points.device
    (n, d), h, m = points.shape, dims[1], dims[2]
    g0, g1, g2 = (list(grads) + [None] * 3)[:3]
    gs = []
    for g, shape in ((g0, (n, m)), (g1, (d, n, m)), (g2 if order == 2 else None, (d, n, m))):
        if g is not None and (g.shape != shape or g.dtype != dtype or g.device != device):
            raise ValueError(f"taylor_mlp_1h_bwd: a cotangent of shape {tuple(g.shape)} ({g.dtype} on {g.device}) "
                             f"where {shape} ({dtype} on {device}) is expected")
        gs.append(None if g is None else _row_major(g))
    hd, mh = h * d, m * h
    out = torch.empty(hd + h + mh + m, dtype=dtype, device=device)
    gx = torch.empty((n, d), dtype=dtype, device=device) if need_points else None
    grad = (gx, out[:hd].view(h, d).t(), out[hd:hd + h], out[hd + h:hd + h + mh].view(m, h).t(), out[hd + h + mh:])
    if n == 0:
        out.zero_()
        return grad
    index = points.get_device()
    key = ('backward', dtype, index, dims, order, n)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan_bwd(n, dims, order, points.element_size(), _sm_count(index))
    slab = hd + h + plan.out_tile * h + plan.out_tile
    # partial sums, freed to the stream's pool after the launch (the sum pass reads them first)
    part = torch.empty(plan.blocks * plan.out_tiles * slab, dtype=dtype, device=device)
    gxp = torch.empty(plan.unit_tiles * plan.out_tiles * n * d, dtype=dtype, device=device) if need_points else None
    Wk = [_row_major(W1.t()), _row_major(W2.t())]  # kept alive until the launch is enqueued
    b1k = _row_major(b1)
    args = (points.data_ptr(), n, d, h, m, Wk[0].data_ptr(), b1k.data_ptr(), Wk[1].data_ptr(), order, _ACTVS[actv],
            plan.out_tile, plan.threads, plan.blocks, plan.span, int(need_points),
            *[None if g is None else g.data_ptr() for g in gs], part.data_ptr(),
            None if gxp is None else gxp.data_ptr(), out.data_ptr(), None if gx is None else gx.data_ptr())
    err = _call(getattr(load_library(), 'taylor_mlp_1h_bwd' + ('_f32' if dtype == torch.float32 else '_f64')),
                args, index)
    if err != 0:
        raise RuntimeError(f"taylor_mlp_1h_bwd kernel launch failed: CUDA error {err} "
                           f"(n={n}, dims={dims}, order={order}, plan={plan})")
    LAUNCHES['taylor_mlp_1h_bwd'] += 1
    return grad


class _TaylorStreamsFn(torch.autograd.Function):
    """Forward: ``taylor_mlp_streams``, one ``(1 + order d, N, out)``
    stack. Backward: autograd over the plain twin on the saved inputs, to
    the input streams and the parameters."""

    @staticmethod
    def forward(ctx, streams, order, actv, input_actv, *flat):
        ctx.args = (order, actv, input_actv)
        ctx.save_for_backward(streams, *flat)
        return _launch_streams(streams, list(zip(flat[0::2], flat[1::2])), order, actv, input_actv)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[4:])
        result = [None] * len(need)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(f) for t, f in zip(saved, need)]
            out = _streams_stacked_reference(leaves[0], list(zip(leaves[1::2], leaves[2::2])), *ctx.args)
            wrt = [leaf for leaf, f in zip(leaves, need) if f]
            if wrt and out.requires_grad:
                got = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True))
                result = [next(got) if f else None for f in need]
        return (result[0], None, None, None, *result[1:])


class _TaylorMLPFn(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward, rematerialized from the saved
    inputs: for a net with one hidden layer and at most ``_MAX_BWD_OUT``
    outputs (:func:`_plan_bwd`) the ``taylor_mlp_1h_bwd`` kernel (on CPU
    tensors its plain version, :func:`taylor_mlp_1h_backward_reference`);
    otherwise autograd over the plain twin, which ``TWIN_BACKWARDS`` counts
    for one-hidden-layer nets. Outputs that were not used get no cotangent
    (None, not zeros)."""

    @staticmethod
    def forward(ctx, points, order, actv, *flat):
        ctx.order, ctx.actv = order, actv
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(points, *flat)
        return _launch(points, list(zip(flat[0::2], flat[1::2])), order, actv)

    @staticmethod
    def backward(ctx, *grads):
        points, *flat = ctx.saved_tensors
        need = [ctx.needs_input_grad[0]] + list(ctx.needs_input_grad[3:])
        dims = (points.shape[1],) + tuple(W.shape[1] for W in flat[0::2])
        if len(dims) == 3:
            if _bwd_kernel_takes(dims):
                layers = [(flat[0], flat[1]), (flat[2], flat[3])]
                run = _launch_bwd if points.device.type == 'cuda' else taylor_mlp_1h_backward_reference
                got = run(points, layers, ctx.order, ctx.actv, grads, need[0])
                return (got[0], None, None, *[g if f else None for g, f in zip(got[1:], need[1:])])
            TWIN_BACKWARDS[(dims, ctx.order)] = TWIN_BACKWARDS.get((dims, ctx.order), 0) + 1
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


@functools.lru_cache(maxsize=None)
def _precision_once():
    full_precision_matmuls()  # the backward's float32 matmuls must not drop to TF32


def fcnn_taylor(points, layers, order, actv='tanh'):
    """Fused Taylor evaluation of a tanh or sin FCNN on ``points``.

    A CPU tensor runs :func:`fcnn_taylor_reference`. A CUDA tensor launches
    a CUDA kernel (order 1 or 2, float32 or float64) or raises, and it
    raises under ``enable_pallas(interpret=True)``; it never falls back to
    the twin. Where no gradient is needed, the kernel is launched without the
    autograd function around it.

    :param points: (N, d) collocation points (the directions are the d axes).
    :param layers: ``[(W, b), ...]`` with ``W`` (n_in, n_out), ``b`` (n_out,).
    :param order: series order.
    :param actv: 'tanh' or 'sin'.
    :return: ``(c0, c1[, c2])`` with c0 (N, out) and ck (D, N, out).
    """
    if _runs_twin(points, 'fcnn_taylor', _CONFIG['interpret']):
        return fcnn_taylor_reference(points, layers, order, actv)
    _precision_once()
    flat = [t for W, b in layers for t in (W, b)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [points, *flat]):
        return _TaylorMLPFn.apply(points, order, actv, *flat)
    return _launch(points, layers, order, actv)


def fcnn_taylor_streams(streams, layers, order, actv='tanh', input_actv=None):
    """Fused Taylor evaluation of a tanh or sin FCNN on input Taylor streams.

    A CPU tensor runs :func:`fcnn_taylor_streams_reference`. A CUDA tensor
    launches ``taylor_mlp_streams`` (order 1 or 2, float32 or float64,
    1-128 layers, any widths; more than 8 directions as chunks of 8) or
    raises, and it raises under ``enable_pallas(interpret=True)``; it never
    falls back to the twin. The gradient reaches the input streams and the
    parameters.

    :param streams: contiguous ``(1 + order * D, N, h_in)``: the value, the
        D first-order and (order 2) the D second-order coefficients.
    :param layers: ``[(W, b), ...]`` with ``W`` (n_in, n_out), ``b`` (n_out,).
    :param order: 1 or 2.
    :param actv: 'tanh' or 'sin', between the layers.
    :param input_actv: None, 'tanh' or 'sin': applied to the streams first.
    :return: ``(c0, c1[, c2])`` with c0 (N, out) and ck (D, N, out): views
        of one ``(1 + order * D, N, out)`` stack.
    """
    if _runs_twin(streams, 'fcnn_taylor_streams', _CONFIG['interpret']):
        return fcnn_taylor_streams_reference(streams, layers, order, actv, input_actv)
    _precision_once()
    flat = [t for W, b in layers for t in (W, b)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [streams, *flat]):
        out = _TaylorStreamsFn.apply(streams, order, actv, input_actv, *flat)
    else:
        out = _launch_streams(streams, layers, order, actv, input_actv)
    return _unstack(out, order, _stream_dirs(streams, order))


def fcnn_taylor_pallas(points, layer_params, order, n_dirs, tile=None, interpret=None, actv='tanh'):
    """:func:`fcnn_taylor` with the JAX package's arguments
    (``pallas_mlp.fcnn_taylor_pallas``): the same entry, so on a CUDA tensor
    the same kernel and launch count.

    :param points: (N, d) collocation points (the probe directions are the d
        coordinate axes).
    :param layer_params: ``[{'W': (n_in, n_out), 'b': (n_out,)}, ...]`` (the
        activation between layers, none after the last); points and
        parameters are promoted to one dtype.
    :param order: series order.
    :param n_dirs: number of directions; must equal d.
    :param tile: None or a positive int, checked and otherwise ignored (the
        launch sizes its own).
    :param interpret: True raises on a CUDA tensor, as the switch's does
        (None: the switch's); a CPU tensor runs the twin either way.
    :param actv: 'tanh' or 'sin'.
    :return: ``(c0, c1[, c2])`` with c0 (N, out) and ck (D, N, out).
    """
    if n_dirs != points.shape[1]:
        raise ValueError(f"the probe directions must be the {points.shape[1]} coordinate axes, got n_dirs={n_dirs}")
    _check_tile(tile)
    _runs_twin(points, 'fcnn_taylor_pallas', interpret)
    dtype = functools.reduce(torch.promote_types, [t.dtype for lp in layer_params for t in (lp['W'], lp['b'])],
                             points.dtype)
    layers = [(lp['W'].to(dtype), lp['b'].to(dtype)) for lp in layer_params]
    return fcnn_taylor(points.to(dtype), layers, order, actv)
