"""The PyTorch port's fused Taylor-MLP module against the JAX package.

The plain twin ``fcnn_taylor_reference`` is held against ``_pure_jax_taylor``
and against the Pallas kernel run in interpret mode, in float64, on the same
numpy inputs. Tolerance: 1e-12 relative to the largest entry of each output
(both sides do the same float64 arithmetic in other summation orders). The
CUDA kernel itself is held against the twin by the ``cuda`` test below,
which skips without a GPU. The GPU machine has no JAX, so the JAX side is
imported inside the tests that use it; there the ``cuda`` tests run with
``python -m pytest --noconftest tests/test_torch_taylor_mlp.py -m cuda``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.ops.taylor_mlp import fcnn_taylor, fcnn_taylor_reference
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64 if dtype == torch.float64 else 32)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)

# (layer widths, activation, order): the chip check's shapes at small widths
CASES = [
    ((2, 32, 1), 'tanh', 2),
    ((2, 16, 16, 1), 'tanh', 2),
    ((2, 16, 16, 1), 'tanh', 1),
    ((1, 16, 16, 1), 'sin', 1),
    ((1, 16, 16, 1), 'sin', 2),
    ((3, 16, 2), 'tanh', 2),
    ((3, 8, 8, 8, 2), 'sin', 2),
    ((2, 1), 'tanh', 2),
    ((2, 1), 'tanh', 1),
]


def _inputs(dims, n=37, seed=0):
    rng = np.random.RandomState(seed)
    layers = [(rng.uniform(-1, 1, (a, b)) / np.sqrt(a), rng.uniform(-1, 1, (b,)) / np.sqrt(a))
              for a, b in zip(dims[:-1], dims[1:])]
    return rng.rand(n, dims[0]), layers


def _jax():
    """The JAX reference: ``(jax, jnp, _pure_jax_taylor, fcnn_taylor_pallas)``."""
    jax = pytest.importorskip('jax')
    from neurodiffeq_tpu.ops.pallas_mlp import _pure_jax_taylor, fcnn_taylor_pallas
    return jax, jax.numpy, _pure_jax_taylor, fcnn_taylor_pallas


def _jax_flat(layers):
    jnp = _jax()[1]
    return tuple(jnp.asarray(x) for W, b in layers for x in (W, b))


def _torch_layers(layers, requires_grad=False):
    return [(torch.tensor(W, requires_grad=requires_grad), torch.tensor(b, requires_grad=requires_grad))
            for W, b in layers]


def _assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize('dims,actv,order', CASES)
def test_reference_matches_pure_jax_and_pallas(dims, actv, order):
    _, jnp, _pure_jax_taylor, fcnn_taylor_pallas = _jax()
    pts, layers = _inputs(dims)
    d = dims[0]
    want = _pure_jax_taylor(jnp.asarray(pts), _jax_flat(layers), len(layers), order, d, actv)
    pallas = fcnn_taylor_pallas(jnp.asarray(pts), [{'W': jnp.asarray(W), 'b': jnp.asarray(b)}
                                                   for W, b in layers],
                                order, d, interpret=True, actv=actv)
    got = fcnn_taylor_reference(torch.tensor(pts), _torch_layers(layers), order, actv)
    assert len(got) == len(want) == len(pallas) == order + 1
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == torch.float64
        _assert_close(g, w)
        _assert_close(g, p)


def test_cpu_entry_is_the_reference():
    pts, layers = _inputs((2, 16, 1))
    launches = dict(taylor_mlp.LAUNCHES)
    a = fcnn_taylor(torch.tensor(pts), _torch_layers(layers), 2)
    b = fcnn_taylor_reference(torch.tensor(pts), _torch_layers(layers), 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert taylor_mlp.LAUNCHES == launches  # the CPU path launches no kernel


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(o)) for o in outs]


@pytest.mark.parametrize('dims,actv', [((2, 32, 1), 'tanh'), ((2, 16, 16, 1), 'sin'), ((3, 8, 2), 'tanh')])
def test_gradients_match_jax_vjp(dims, actv):
    """Autograd over the twin against ``jax.vjp`` over the pure-JAX twin on
    the same cotangents; at one hidden layer the closed form (what
    ``taylor_mlp_1h_bwd`` computes) too."""
    jax, jnp, _pure_jax_taylor, _ = _jax()
    pts, layers = _inputs(dims, n=20)
    d, order = dims[0], 2
    outs, vjp = jax.vjp(lambda p, fp: _pure_jax_taylor(p, fp, len(layers), order, d, actv),
                        jnp.asarray(pts), _jax_flat(layers))
    cts = _cotangents(outs)
    d_pts, d_flat = vjp(tuple(jnp.asarray(c) for c in cts))

    t_pts = torch.tensor(pts, requires_grad=True)
    t_layers = _torch_layers(layers, requires_grad=True)
    t_outs = fcnn_taylor_reference(t_pts, t_layers, order, actv)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(t_outs, cts))
    routes = [torch.autograd.grad(loss, [t_pts] + [x for W, b in t_layers for x in (W, b)])]
    if _one_hidden(dims):
        routes.append(taylor_mlp.taylor_mlp_1h_backward_reference(
            torch.tensor(pts), _torch_layers(layers), order, actv, [torch.tensor(c) for c in cts]))
    for grads in routes:
        _assert_close(grads[0], d_pts)
        for g, w in zip(grads[1:], d_flat, strict=True):
            _assert_close(g, w)


@pytest.mark.parametrize('dims,route', [((2, 16, 16, 1), 'twin'), ((2, 16, 3), 'closed form')])
def test_autograd_function_backward_is_the_twin(monkeypatch, dims, route):
    """``_TaylorMLPFn`` with the kernel launch stood in for by the twin: its
    rematerialized backward must give the twin's own autograd gradients,
    with ``None`` where an input needs none. A net of two hidden layers
    differentiates the twin; one hidden layer takes the closed form (on CPU
    tensors the plain version stands in for ``taylor_mlp_1h_bwd``)."""
    monkeypatch.setattr(taylor_mlp, '_launch', lambda p, layers, order, actv: tuple(
        o.detach().contiguous() for o in fcnn_taylor_reference(p, layers, order, actv)))
    closed = []
    plain = taylor_mlp.taylor_mlp_1h_backward_reference
    monkeypatch.setattr(taylor_mlp, 'taylor_mlp_1h_backward_reference', lambda *a: closed.append(1) or plain(*a))
    pts, layers = _inputs(dims, n=20)
    cts = [torch.tensor(c) for c in _cotangents([np.zeros((20, dims[-1])), np.zeros((2, 20, dims[-1])),
                                                  np.zeros((2, 20, dims[-1]))])]

    def grads(fn, pts_grad):
        t_pts = torch.tensor(pts, requires_grad=pts_grad)
        t_layers = _torch_layers(layers, requires_grad=True)
        flat = [x for W, b in t_layers for x in (W, b)]
        outs = fn(t_pts, t_layers)
        loss = sum((o * c).sum() for o, c in zip(outs, cts))
        wrt = ([t_pts] if pts_grad else []) + flat
        return torch.autograd.grad(loss, wrt)

    via_fn = lambda p, ls: taylor_mlp._TaylorMLPFn.apply(p, 2, 'tanh', *[x for W, b in ls for x in (W, b)])
    via_twin = lambda p, ls: fcnn_taylor_reference(p, ls, 2, 'tanh')
    for pts_grad in (True, False):
        for g, w in zip(grads(via_fn, pts_grad), grads(via_twin, pts_grad), strict=True):
            assert torch.allclose(g, w, rtol=1e-13, atol=1e-15)
    assert len(closed) == (2 if route == 'closed form' else 0)
    assert taylor_mlp.TWIN_BACKWARDS == {}  # only one-hidden-layer nets past the width rule count


# (input width d, output width m): the closed form's cases; d = 9 is two direction chunks on the card
CLOSED_FORM_WIDTHS = [(d, m) for d in (1, 2, 3, 9) for m in (1, 3, 128)]


@pytest.mark.parametrize('order,absent', [(order, absent) for order in (1, 2) for absent in (None, 0, 1, 2)
                                          if absent is None or absent <= order])
@pytest.mark.parametrize('need_points', [True, False])
@pytest.mark.parametrize('actv', ['tanh', 'sin'])
@pytest.mark.parametrize('d,m', CLOSED_FORM_WIDTHS)
def test_closed_form_backward_matches_twin_autograd(d, m, actv, order, need_points, absent):
    """``taylor_mlp_1h_backward_reference`` (the ``taylor_mlp_1h_bwd``
    kernel's plain version) against autograd over the twin in float64, with
    the cotangent of output ``absent`` (c0, c1 or c2) left out (None)."""
    pts, layers = _inputs((d, 11, m), n=17, seed=d + m)
    outs = fcnn_taylor_reference(torch.tensor(pts), _torch_layers(layers), order, actv)
    cts = [None if i == absent else torch.tensor(c) for i, c in enumerate(_cotangents(outs, seed=order))]
    t_pts = torch.tensor(pts, requires_grad=need_points)
    t_layers = _torch_layers(layers, requires_grad=True)
    flat = [x for W, b in t_layers for x in (W, b)]
    pairs = [(o, c) for o, c in zip(fcnn_taylor_reference(t_pts, t_layers, order, actv), cts) if c is not None]
    wrt = ([t_pts] if need_points else []) + flat
    want = torch.autograd.grad([o for o, _ in pairs], wrt, [c for _, c in pairs], allow_unused=True)
    got = taylor_mlp.taylor_mlp_1h_backward_reference(torch.tensor(pts), _torch_layers(layers), order, actv, cts,
                                                      need_points)
    assert (got[0] is None) != need_points
    for g, w in zip([x for x in got if x is not None], want, strict=True):
        assert g.shape == (w if w is not None else g).shape
        _assert_close(g, np.zeros(g.shape) if w is None else w.numpy())


def test_unsupported_device_raises():
    pts, layers = _inputs((2, 8, 1))
    with pytest.raises(TypeError):
        fcnn_taylor(torch.tensor(pts, device='meta'),
                    [(W.to('meta'), b.to('meta')) for W, b in _torch_layers(layers)], 2)


def test_port_imports_without_nvcc_or_jax():
    """Importing the port builds nothing and needs no ``nvcc``; its sources
    never import jax."""
    code = (
        "import sys; import neurodiffeq_tpu_torch as p; "
        "from neurodiffeq_tpu_torch.ops import _build, taylor_mlp; "
        "assert _build._LIB is None and 'jax' not in sys.modules; "
        "import torch; assert not torch.cuda.is_initialized(); "
        "from neurodiffeq_tpu_torch.networks import FCNN; "
        "print(FCNN(2, 1, hidden_units=(4,), device='cpu')(torch.zeros(3, 2)).shape)")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME='/nonexistent')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'torch.Size([3, 1])' in out.stdout
    pattern = re.compile(r'^\s*(import jax|from jax)', re.M)
    for src in (REPO / 'neurodiffeq_tpu_torch').rglob('*.py'):
        assert not pattern.search(src.read_text()), src


# (layer widths, activation, order, N): the chip check's table of shapes
KERNEL_SHAPES = [
    ((2, 512, 1), 'tanh', 2, 1024),
    ((2, 512, 1), 'tanh', 2, 10201),
    ((2, 512, 1), 'tanh', 2, 65536),
    ((8, 64, 1), 'tanh', 2, 1023),
    ((2, 50, 3), 'sin', 1, 37),
    ((2, 50, 3), 'sin', 2, 1),
    ((2, 50, 3), 'sin', 2, 37),
    ((2, 32, 32, 1), 'tanh', 2, 1024),
    ((3, 64, 64, 1), 'tanh', 2, 512),
    ((2, 128, 128, 128, 128, 128, 3), 'tanh', 2, 16384),
    ((2, 64, 64, 1), 'tanh', 2, 1000),
    ((1, 32, 32, 1), 'sin', 1, 37),
    ((1, 32, 32, 1), 'sin', 2, 37),
    ((3, 16, 2), 'tanh', 2, 37),
    ((2, 1), 'tanh', 2, 37),
    ((2, 32, 32, 1), 'tanh', 1, 1024),
    # the edges of the kernels' reach: more than 8 inputs (direction chunks),
    # 20 layers, streams past shared memory (a global scratch), and a
    # one-hidden-layer net of more outputs than the 1h kernel's grid holds
    ((9, 32, 32, 1), 'tanh', 2, 1000),
    ((20, 64, 1), 'tanh', 2, 333),
    ((10, 1), 'sin', 2, 37),
    ((2,) + (16,) * 19 + (1,), 'tanh', 2, 100),
    ((2, 2800, 2800, 1), 'tanh', 2, 300),
    ((12, 1000, 1000, 2), 'sin', 2, 200),
    ((3, 32, 70000), 'tanh', 1, 5),
    # the high-dimensional Poisson nets at their 768 points: d = 10 (two
    # direction chunks) and the d = 100 exact laplacian's forward (13 chunks)
    ((10, 64, 64, 1), 'sin', 2, 768),
    ((100, 64, 64, 1), 'sin', 2, 768),
]
H100_SMS = 132


def _kernel_of(dims):
    return 'taylor_mlp_1h' if len(dims) == 3 and dims[-1] <= 65535 else 'taylor_mlp'


@pytest.mark.parametrize('esize', [4, 8])
@pytest.mark.parametrize('dims,actv,order,n', KERNEL_SHAPES)
def test_plan_picks_the_kernel_and_covers_the_batch(dims, actv, order, n, esize):
    """One hidden layer (of at most 65,535 outputs) takes the 1h kernel and
    nothing else does; every plan fits a block's shared memory and launches
    whole warps. Streams in shared memory: the blocks cover N (ragged N
    included) with no block past the end. Streams in the global scratch: at
    most one block per SM and direction chunk, each looping over tiles."""
    plan = taylor_mlp._plan(n, dims, order, esize, H100_SMS)
    s, chunks = 1 + order * min(dims[0], 8), -(-dims[0] // 8)
    assert plan.kernel == _kernel_of(dims)
    assert 0 <= plan.smem <= 232448
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    if plan.scratch:
        assert plan.blocks * chunks < H100_SMS + chunks and (plan.blocks - 1) * plan.tile < n
        assert plan.scratch == plan.blocks * chunks * 2 * s * plan.tile * plan.hstride
    else:
        assert plan.blocks * plan.tile >= n > (plan.blocks - 1) * plan.tile
    if plan.kernel == 'taylor_mlp_1h':
        assert 1 <= plan.tile <= taylor_mlp._max_tile_1h(s) and plan.smem == 0
    elif len(dims) > 2:
        assert plan.tile == plan.threads // 32 * taylor_mlp._points_per_warp(s)
        assert plan.hstride == max(dims[1:-1])
        streams = 0 if plan.scratch else 2 * s * plan.tile * plan.hstride
        assert plan.smem == esize * (streams + 2 * 16 * 129)


def test_plan_fills_the_card_at_the_flagship():
    """N = 1024 through 2-512-1: two blocks on every SM, not 128 blocks of 8 points."""
    plan = taylor_mlp._plan(1024, (2, 512, 1), 2, 4, H100_SMS)
    assert plan.blocks >= H100_SMS and plan.threads == 256 and plan.tile == 4
    # larger N: the registers cap the tile at 32 // 5 points, and fewer
    # warps per block give each lane more units per warp sum
    for n, threads in ((10201, 64), (65536, 32)):
        big = taylor_mlp._plan(n, (2, 512, 1), 2, 4, H100_SMS)
        assert (big.tile, big.threads) == (6, threads)
    deep = taylor_mlp._plan(16384, (2,) + (128,) * 5 + (3,), 2, 4, H100_SMS)
    assert deep.blocks >= 2 * H100_SMS and deep.threads == 256


def test_plan_raises_where_one_warp_cannot_fit():
    """Where not even one warp's streams fit shared memory the plan no longer
    raises: they go to a global scratch, 8 warps a block."""
    plan = taylor_mlp._plan(64, (8, 4096, 4096, 1), 2, 8, H100_SMS)
    assert (plan.kernel, plan.threads, plan.tile, plan.blocks) == ('taylor_mlp', 256, 8, 8)
    assert plan.scratch == 8 * 2 * 17 * 8 * 4096 and plan.smem == 8 * 2 * 16 * 129
    one = taylor_mlp._plan(64, (8, 4096, 1), 2, 8, H100_SMS)  # one hidden layer keeps no streams
    assert one.kernel == 'taylor_mlp_1h' and one.scratch == 0


# the chip check's taylor_mlp_streams shapes: (widths, d, activation, input activation, order, N)
STREAM_SHAPES = [
    ((128, 64, 128), 2, 'tanh', 'tanh', 2, 16384),  # one model rank's slice of the cavity's pair 1
    ((128, 64, 3), 2, 'tanh', 'tanh', 2, 16384),    # its pair 2
    ((32, 1), 2, 'tanh', 'tanh', 2, 1024),          # the default FCNN's trailing layer
    ((20, 10, 20), 2, 'tanh', 'tanh', 2, 8192),     # Burgers' pairs 1-3 on one of 2 model ranks (the polish)
    ((20, 1), 2, 'tanh', 'tanh', 2, 8192),          # its trailing layer
    ((128, 64, 128), 2, 'sin', 'sin', 1, 1024),
    ((32, 16, 32), 10, 'tanh', 'tanh', 2, 1000),    # two direction chunks
    ((2800, 64, 1), 2, 'tanh', 'tanh', 2, 300),     # weights past shared memory
    ((16, 16, 2), 3, 'sin', None, 2, 37),
    ((128, 64, 128), 3, 'tanh', 'tanh', 2, 4097),  # 7 streams: one raw input buffer in float32
]


def test_stream_shapes_are_the_chip_checks():
    import chip_smoke

    assert STREAM_SHAPES == chip_smoke.STREAM_SHAPES


# STREAM_SHAPES that the staged instance takes, by element size: the narrow
# nets (the trailing 32 -> 1 and 20 -> 1 layers, 16 -> 16 -> 2) and
# 2800 -> 64 -> 1, whose weights do not fit shared memory; in float64 also
# 128 -> 64 -> 128 at order 2, whose 137 KB of weights pass a block's shared
# memory beside its buffers
STAGED_STREAM_SHAPES = {4: {2, 4, 7, 8}, 8: {0, 2, 4, 7, 8, 9}}


@pytest.mark.parametrize('esize', [4, 8])
@pytest.mark.parametrize('index', range(len(STREAM_SHAPES)))
def test_plan_streams_routes_by_shape(index, esize):
    """The tensor-core kernel with resident weights takes every stream shape
    but the narrow nets and those whose weights do not fit shared memory
    (``STAGED_STREAM_SHAPES``), with two raw input buffers where they fit
    and one otherwise. Its shared memory fits a block; its tiles cover N;
    its persistent blocks walk every (tile, direction chunk) unit once and
    are no more than the card's SMs."""
    dims, d, _, _, order, n = STREAM_SHAPES[index]
    plan = taylor_mlp._plan_streams(n, d, dims, order, esize, H100_SMS)
    s, chunks = 1 + order * min(d, 8), -(-d // 8)
    assert plan.design == ('staged' if index in STAGED_STREAM_SHAPES[esize] else 'resident')
    assert 0 < plan.smem <= 232448
    if plan.design == 'staged':
        assert plan == taylor_mlp.StreamPlan('staged', *taylor_mlp._staged_plan(
            'taylor_mlp_streams', n, s, chunks, max(dims[:-1]), esize, H100_SMS)[1:], 0)
        return
    two = taylor_mlp._resident_smem(dims, s, 2, esize)
    assert plan.buffers == (2 if two <= 232448 else 1)
    assert plan.smem == taylor_mlp._resident_smem(dims, s, plan.buffers, esize)
    assert (plan.tile, plan.threads) == ({4: 16, 8: 8}[esize], 512)
    tiles = -(-n // plan.tile)
    assert tiles * plan.tile >= n > (tiles - 1) * plan.tile
    assert plan.blocks == min(tiles * chunks, H100_SMS)  # one block on each SM at most
    walked = sorted(u for b in range(plan.blocks) for u in range(b, tiles * chunks, plan.blocks))
    assert walked == list(range(tiles * chunks))


def test_resident_layout_at_the_cavity_pairs():
    """Shared memory of the cavity's stream pairs, counted by hand: 16 bytes
    of mbarriers; weights (rows padded to 16, stride 132 or 68) and biases
    (padded to a multiple of 4); two raw
    input buffers of 5 x 16 x 128; the first layer's operand, 5 x 16 rows
    of 132; one hidden buffer of 5 x 16 rows of 68; the outputs staged in
    the operand buffer. The trailing (32, 1) layer stages its own. In
    float64 pair 2 keeps two raw buffers of 5 x 8 x 128, and pair 1 does
    not fit even with one."""
    weights = 64 * 132 + 128 * 68 + 64 + 128
    raw, operand, hidden = 5 * 16 * 128, 5 * 16 * 132, 5 * 16 * 68
    assert taylor_mlp._resident_smem((128, 64, 128), 5, 2, 4) == 16 + 4 * (weights + 2 * raw + operand + hidden)
    assert taylor_mlp._resident_smem((128, 64, 3), 5, 2, 4) == 16 + 4 * (
        64 * 132 + 16 * 68 + 64 + 4 + 2 * raw + operand + hidden)
    assert taylor_mlp._resident_smem((32, 1), 5, 2, 4) == 16 + 4 * (
        16 * 36 + 4 + 2 * 5 * 16 * 32 + 5 * 16 * 36 + 5 * 16)
    assert taylor_mlp._plan_streams(16384, 2, (128, 64, 3), 2, 8, H100_SMS).buffers == 2
    assert taylor_mlp._resident_smem((128, 64, 128), 5, 1, 8) > 232448


@pytest.mark.parametrize('dims,narrow', [
    ((32, 1), True), ((32, 8), False),            # the output: under one mma n tile, or not
    ((64, 1), True), ((128, 3), False),           # the input: at most 64 wide, or not
    ((32, 32, 1), True), ((64, 64, 1), False),    # the products: 1,056 or 4,160 multiply-adds per point
    ((16, 16, 2), True), ((256, 1), False), ((128, 64, 3), False), ((32, 32), False),
])
def test_plan_streams_sends_narrow_nets_to_the_staged_instance(dims, narrow):
    """Phase 6 of ``chip_smoke.py`` times both designs on each side of each
    bound of ``_narrow``: the staged instance takes a net whose output is
    narrower than 8 units, whose input is at most 64 wide and whose layers
    take at most 2,048 multiply-adds per point and stream, at any N and in
    either type; every other net that fits runs the resident kernel."""
    assert taylor_mlp._narrow(dims) is narrow
    for n in (256, 1024, 65536):
        for esize in (4, 8):
            plan = taylor_mlp._plan_streams(n, 2, dims, 2, esize, H100_SMS)
            assert plan.design == ('staged' if narrow else 'resident')


def test_plan_streams_takes_one_raw_buffer_where_two_do_not_fit():
    """7 streams (d = 3, order 2) of 128 -> 64 -> 128 in float32: two raw
    input buffers take 273,680 bytes, past a block's shared memory, and one
    216,336, so the resident kernel runs with one (its next unit's copies
    start once the operand is built); in float64 not even one fits."""
    assert taylor_mlp._resident_smem((128, 64, 128), 7, 2, 4) == 273680
    plan = taylor_mlp._plan_streams(4097, 3, (128, 64, 128), 2, 4, H100_SMS)
    assert (plan.design, plan.buffers, plan.smem) == ('resident', 1, 216336)
    assert taylor_mlp._plan_streams(4097, 3, (128, 64, 128), 2, 8, H100_SMS).design == 'staged'


@pytest.mark.parametrize('shape', STREAM_SHAPES)
def test_plan_streams_takes_the_design_asked_for(shape):
    """``design`` forces the staged instance at every shape, and the
    resident kernel wherever it fits (the same plan as when the planner
    picks it); where it does not fit, asking for it raises."""
    dims, d, _, _, order, n = shape
    s, chunks = 1 + order * min(d, 8), -(-d // 8)
    staged = taylor_mlp._plan_streams(n, d, dims, order, 4, H100_SMS, 'staged')
    assert staged == taylor_mlp.StreamPlan('staged', *taylor_mlp._staged_plan(
        'taylor_mlp_streams', n, s, chunks, max(dims[:-1]), 4, H100_SMS)[1:], 0)
    if taylor_mlp._resident_smem(dims, s, 1, 4) > 232448:
        with pytest.raises(ValueError, match='does not fit'):
            taylor_mlp._plan_streams(n, d, dims, order, 4, H100_SMS, 'resident')
        return
    resident = taylor_mlp._plan_streams(n, d, dims, order, 4, H100_SMS, 'resident')
    assert resident.design == 'resident'
    assert resident.buffers == (2 if taylor_mlp._resident_smem(dims, s, 2, 4) <= 232448 else 1)
    with pytest.raises(ValueError, match='unknown'):
        taylor_mlp._plan_streams(n, d, dims, order, 4, H100_SMS, 'fast')


@pytest.mark.parametrize('esize', [4, 8])
@pytest.mark.parametrize('width,bulk', [(3, False), (16, True), (128, True)])
def test_bulk_copy_predicate(width, bulk, esize):
    """A tile's input streams come by bulk copy where a point's row is a
    whole number of 16 bytes, else element by element; the operand's padded
    rows in shared memory stay 16-byte aligned and hold whole mma k
    steps."""
    assert taylor_mlp._bulk_rows(width, esize) is bulk
    hs = taylor_mlp._hstride(width, esize)
    assert hs * esize % 16 == 0 and hs >= -(-width // {4: 8, 8: 4}[esize]) * {4: 8, 8: 4}[esize]


@pytest.mark.parametrize('esize', [4, 8])
def test_fragment_loads_are_free_of_bank_conflicts(esize):
    """At every width up to 300 a fragment load's 8 rows x 4 columns (lane
    4 g + q reads row g, column q) fall in distinct 4-byte banks: all 32
    lanes in float32; each half warp, which float64's 8-byte loads serve
    per wavefront, in float64."""
    for width in range(1, 301):
        hs = taylor_mlp._hstride(width, esize)
        words = esize // 4
        for lanes in ([range(32)] if esize == 4 else [range(16), range(16, 32)]):
            banks = [((lane // 4 * hs + lane % 4) * words + w) % 32 for lane in lanes for w in range(words)]
            assert len(set(banks)) == len(banks), (width, hs)


def test_build_compiles_each_source_with_its_own_entries():
    """Each CUDA source is compiled only with the NDTORCH_ENTRY values it
    defines, numbered as ``SOURCE_ENTRIES`` lists them; every entry has its
    ctypes argument types."""
    from neurodiffeq_tpu_torch.ops import _build

    sources = sorted(p.name for p in _build._CSRC.glob('*.cu'))
    assert sources == sorted(_build.SOURCE_ENTRIES)
    for name, entries in _build.SOURCE_ENTRIES.items():
        text = (_build._CSRC / name).read_text()
        found = re.findall(r'#if NDTORCH_ENTRY == 0 \|\| NDTORCH_ENTRY == (\d+)\nint (\w+)\(', text)
        assert found == [(str(i), e) for i, e in enumerate(entries, 1)]
        assert all(e[:-4] in _build._ARGTYPES for e in entries)


def _bad_inputs(case):
    """(points, layers, order, actv) that the kernels do not take, one fault each."""
    pts, layers = _inputs((2, 8, 1))
    pts, layers, order, actv = torch.tensor(pts), _torch_layers(layers), 2, 'tanh'
    if case == 'points dtype':
        pts = pts.half()
    elif case == 'points not (N, d)':
        pts = pts[None]
    elif case == 'points not contiguous':
        pts = pts.t().contiguous().t()
    elif case == 'layer dtype':
        layers[1] = (layers[1][0].float(), layers[1][1])
    elif case == 'widths do not chain':
        layers[1] = (layers[1][0][:4], layers[1][1])
    elif case == 'bias shape':
        layers[0] = (layers[0][0], layers[0][1][:3])
    elif case == 'order':
        order = 3
    elif case == 'activation':
        actv = 'relu'
    elif case == 'too many inputs':  # more direction chunks than a grid axis holds
        pts = torch.zeros(1, 8 * 65535 + 1, dtype=torch.float64)
    elif case == 'too many layers':
        layers = layers[:1] + [(torch.rand(8, 8, dtype=torch.float64), layers[0][1])] * 127 + layers[1:]
    return pts, layers, order, actv


@pytest.mark.parametrize('case,error', [
    ('points dtype', TypeError), ('points not (N, d)', ValueError),
    ('points not contiguous', ValueError), ('layer dtype', TypeError),
    ('widths do not chain', ValueError), ('bias shape', ValueError), ('order', ValueError),
    ('activation', ValueError), ('too many inputs', ValueError), ('too many layers', ValueError)])
def test_kernel_checks_raise(case, error):
    """The wrapper raises on what the kernels do not take, before any launch."""
    with pytest.raises(error):
        taylor_mlp._check(*_bad_inputs(case))
    pts, layers, order, actv = _bad_inputs(None)
    assert taylor_mlp._check(pts, layers, order, actv) == (2, 8, 1)


@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('dims,actv', [((2, 64, 1), 'tanh'), ((3, 16, 2), 'sin')])
def test_folded_output_layer_matches_pure_jax(dims, actv, order):
    """The 1h kernel's fold, in float64 numpy: with v = W2[j, o], unit j adds
    a_j v to c0, f'_j (W1[d, j] v) to c1_d and f''_j (W1[d, j]^2 v) to c2_d."""
    _, jnp, _pure_jax_taylor, _ = _jax()
    pts, layers = _inputs(dims, n=29, seed=3)
    (W1, b1), (W2, b2) = layers
    z = pts @ W1 + b1
    if actv == 'tanh':
        a = np.tanh(z)
        f1 = 1 - a * a
        f2 = -2 * a * f1
    else:
        a, f1, f2 = np.sin(z), np.cos(z), -np.sin(z)
    wv = W1[:, :, None] * W2[None]                # (d, h, out): W1[d, j] v
    wwv = (W1 * W1)[:, :, None] * W2[None]        # (d, h, out): W1[d, j]^2 v
    folded = [a @ W2 + b2, np.einsum('nj,djo->dno', f1, wv), np.einsum('nj,djo->dno', f2, wwv)]
    want = _pure_jax_taylor(jnp.asarray(pts), _jax_flat(layers), 2, order, dims[0], actv)
    assert len(want) == order + 1
    for got, w in zip(folded, want):
        _assert_close(got, w)


def _cuda_inputs(dims, n, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts, layers = _inputs(dims, n=n)
    # weights in nn.Linear's (out, in) storage, seen through (in, out) views
    return (torch.tensor(pts, dtype=dtype, device='cuda'),
            [(torch.tensor(W.T, dtype=dtype, device='cuda').t(), torch.tensor(b, dtype=dtype, device='cuda'))
             for W, b in layers])


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rtol', [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize('dims,actv,order,n', KERNEL_SHAPES)
def test_cuda_kernel_matches_reference(dims, actv, order, n, dtype, rtol):
    """Kernel against twin on the card. float32 tolerance: the kernel sums
    in another order than cuBLAS."""
    p, ls = _cuda_inputs(dims, n, dtype)
    name = _kernel_of(dims)
    launches = dict(taylor_mlp.LAUNCHES)
    got = fcnn_taylor(p, ls, order, actv)
    torch.cuda.synchronize()
    assert taylor_mlp.LAUNCHES == {**launches, name: launches[name] + 1}
    want = fcnn_taylor_reference(p, ls, order, actv)
    assert len(got) == order + 1
    for g, w in zip(got, want):
        _assert_close(g, w.cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('dims,actv,order,n', [((2, 512, 1), 'tanh', 2, 10201),
                                               ((2, 50, 3), 'sin', 2, 37),
                                               ((2, 128, 128, 128, 128, 128, 3), 'tanh', 2, 16384)])
def test_cuda_kernel_is_deterministic(dims, actv, order, n, dtype):
    """No atomics: two launches on the same inputs give bitwise-equal outputs."""
    p, ls = _cuda_inputs(dims, n, dtype)
    first = fcnn_taylor(p, ls, order, actv)
    second = fcnn_taylor(p, ls, order, actv)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# (layer widths, order, dtype, where the streams live): the limits of
# csrc/taylor_mlp.cu (a direction chunk of kMaxDims = 8, the shared memory of
# a block and the grid's y extent for taylor_mlp_1h's output units)
TAKES = [
    ((8, 16, 16, 1), 2, torch.float32, 'shared'), ((9, 16, 16, 1), 2, torch.float32, 'shared'),
    ((8, 16, 1), 2, torch.float64, '1h'), ((9, 16, 1), 1, torch.float64, '1h'),
    ((2,) + (8,) * 15 + (1,), 2, torch.float32, 'shared'), ((2,) + (8,) * 16 + (1,), 2, torch.float32, 'shared'),
    ((2, 2699, 2699, 1), 2, torch.float32, 'shared'), ((2, 2700, 2700, 1), 2, torch.float32, 'global'),
    ((2, 1246, 1246, 1), 2, torch.float64, 'shared'), ((2, 1247, 1247, 1), 2, torch.float64, 'global'),
    ((8, 4096, 4096, 1), 2, torch.float64, 'global'), ((8, 4096, 1), 2, torch.float64, '1h'),
    ((2, 32, 65535), 2, torch.float32, '1h'), ((2, 32, 65536), 2, torch.float32, 'shared'),
    ((2, 1), 2, torch.float32, 'affine'), ((17, 600, 600, 1), 2, torch.float64, 'shared'),
    ((17, 800, 800, 1), 2, torch.float64, 'global'), ((100, 64, 64, 1), 1, torch.float32, 'shared'),
]


@pytest.mark.parametrize('dims,order,dtype,where', TAKES)
def test_kernel_takes_at_its_limits(dims, order, dtype, where):
    """Every shape at the old limits has a plan (the kernels take any input
    width and hidden width): a direction chunk's streams count at most 8
    directions, and where one warp's streams overflow a block's shared
    memory they go to the global scratch; the checks pass them."""
    esize = torch.finfo(dtype).bits // 8
    plan = taylor_mlp._plan(1000, dims, order, esize, H100_SMS)
    got = ('1h' if plan.kernel == 'taylor_mlp_1h' else 'affine' if len(dims) == 2
           else 'global' if plan.scratch else 'shared')
    assert got == where
    pts = torch.zeros(3, dims[0], dtype=dtype)
    layers = [(torch.zeros(a, b, dtype=dtype), torch.zeros(b, dtype=dtype)) for a, b in zip(dims[:-1], dims[1:])]
    assert taylor_mlp._check(pts, layers, order, 'tanh') == tuple(dims)


@pytest.mark.parametrize('dims', [(9, 16, 16, 1), (8, 16, 16, 1), (3, 16, 1), (2,) + (4,) * 17 + (1,)])
def test_wide_or_deep_nets_route_by_the_predicate(monkeypatch, dims):
    """An FCNN of more inputs or layers than the kernels took before goes to
    the fused entry like any other (on the card: one launch); the series
    agrees with torch's double backward on the module."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.networks import FCNN

    calls = []
    fused_entry = taylor_mlp.fcnn_taylor
    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', lambda *a, **k: calls.append(a[0].shape) or fused_entry(*a, **k))
    torch.manual_seed(0)
    net = FCNN(dims[0], dims[-1], hidden_units=dims[1:-1], device='cpu', dtype=torch.float64)
    pts = torch.rand(20, dims[0], generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    cs = F.coords_from_points(pts)
    u = F.network_field(net, cs)
    got = [F.diff(u, c, 2).value[:, 0] for c in cs] + [F.diff(u, cs[-1]).value[:, 0]]
    assert calls == [(20, dims[0])]
    leaf = pts.clone().requires_grad_()
    (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
    want = [torch.autograd.grad(g[:, i].sum(), leaf, retain_graph=True)[0][:, i] for i in range(dims[0])]
    for a, b in zip(got, want + [g[:, -1]], strict=True):
        _assert_close(a, b.detach(), rtol=1e-12)


def _one_hidden(dims):
    return len(dims) == 3 and dims[-1] <= 65535


@pytest.mark.parametrize('esize', [4, 8])
@pytest.mark.parametrize('dims,actv,order,n', [s for s in KERNEL_SHAPES if _one_hidden(s[0])]
                         + [((2, 512, 1), 'tanh', 2, 262144), ((2, 64, 128), 'tanh', 2, 16384),
                            ((2, 10, 20), 'tanh', 2, 8192), ((2, 256, 3), 'tanh', 2, 1024)])
def test_backward_plan_covers_the_points_and_fits_a_block(dims, actv, order, n, esize):
    """``_plan_bwd`` for a one-hidden-layer shape: None past ``_MAX_BWD_OUT``
    outputs; else whole warps of at most 128 threads, an output tile of 1, 4
    or 16 columns, unit tiles and output tiles that cover the widths and
    fit the grid's y axis, spans that cover N with no block past its end, and a block's
    static shared memory (the staged sub-tile and the warps' sums) under 48 KB."""
    plan = taylor_mlp._plan_bwd(n, dims, order, esize, H100_SMS)
    d, h, m = dims
    if m > 128:
        assert plan is None
        return
    dirs = min(d, 8)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 128
    assert plan.out_tile in (1, 4, 16) and (plan.out_tile >= m or plan.out_tile == 16)
    assert plan.unit_tiles * plan.threads >= h > (plan.unit_tiles - 1) * plan.threads
    assert plan.out_tiles * plan.out_tile >= m > (plan.out_tiles - 1) * plan.out_tile
    assert plan.unit_tiles * plan.out_tiles <= 65535
    assert plan.blocks * plan.span >= n > (plan.blocks - 1) * plan.span
    assert plan.span ** 2 * 64 >= n * plan.out_tiles  # the sum pass's chain of slabs stays short
    rec = dirs + plan.out_tile + order * dirs * plan.out_tile
    assert plan.tile == taylor_mlp._bwd_tile(rec, esize) and (plan.span <= plan.tile or plan.span % plan.tile == 0)
    assert esize * (plan.tile * rec + 4 * plan.tile * dirs) <= 48 * 1024


def test_backward_plan_fills_the_card_at_the_flagship():
    """2-512-1 at the benchmark's 262,144 points: 4 unit tiles of 128 units,
    spans of whole 64-point sub-tiles, about 32 warps for each SM."""
    plan = taylor_mlp._plan_bwd(262144, (2, 512, 1), 2, 4, H100_SMS)
    assert (plan.threads, plan.unit_tiles, plan.out_tiles, plan.tile) == (128, 4, 1, 64)
    warps = plan.blocks * plan.unit_tiles * plan.threads // 32
    assert 24 * H100_SMS <= warps <= 36 * H100_SMS and plan.span % 64 == 0


@pytest.mark.parametrize('dims,route', [
    ((2, 512, 1), 'kernel'), ((2, 64, 128), 'kernel'), ((20, 64, 1), 'kernel'), ((3, 16, 129), 'twin'),
    ((2, 16, 16, 1), 'twin'), ((2, 1), 'twin')])
def test_backward_routes_by_shape_and_counts(monkeypatch, dims, route):
    """One hidden layer of at most 128 outputs takes ``taylor_mlp_1h_bwd``
    (its plain version on CPU tensors, no launch counted); wider outputs
    and other depths take the twin, and ``TWIN_BACKWARDS`` counts the
    one-hidden-layer ones by shape. The rule reads the widths alone."""
    monkeypatch.setattr(taylor_mlp, '_launch', lambda p, layers, order, actv: tuple(
        o.detach().contiguous() for o in fcnn_taylor_reference(p, layers, order, actv)))
    assert taylor_mlp._bwd_kernel_takes(dims) == (route == 'kernel')
    assert (taylor_mlp._plan_bwd(64, dims, 2, 4, H100_SMS) is not None) == (route == 'kernel')
    taylor_mlp.reset_launches()
    launches = dict(taylor_mlp.LAUNCHES)
    pts, layers = _inputs(dims, n=9)
    t_layers = _torch_layers(layers, requires_grad=True)
    outs = taylor_mlp._TaylorMLPFn.apply(torch.tensor(pts), 2, 'tanh', *[x for W, b in t_layers for x in (W, b)])
    torch.autograd.grad(sum(o.sum() for o in outs), [W for W, _ in t_layers])
    assert taylor_mlp.LAUNCHES == launches
    one_hidden_twin = route == 'twin' and len(dims) == 3
    assert taylor_mlp.TWIN_BACKWARDS == ({(dims, 2): 1} if one_hidden_twin else {})
    taylor_mlp.reset_launches()
    assert taylor_mlp.TWIN_BACKWARDS == {}


# one-hidden-layer shapes whose backward the card checks: the 1h rows of KERNEL_SHAPES
# and the flagship at the benchmark's batch (N, float64 too)
BWD_SHAPES = [s for s in KERNEL_SHAPES if _one_hidden(s[0]) and s[0][-1] <= 128] + [((2, 512, 1), 'tanh', 2, 262144)]


def _cuda_cotangents(outs, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    return [torch.randn(o.shape, generator=g, dtype=o.dtype, device='cuda') for o in outs]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rtol', [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize('dims,actv,order,n', BWD_SHAPES)
def test_cuda_backward_kernel_matches_closed_form(dims, actv, order, n, dtype, rtol):
    """``taylor_mlp_1h_bwd`` against its plain version on the card, every
    gradient relative to its largest entry; the points' gradient where they
    need one (every other shape), each cotangent left out in turn (c2's
    where there is one, c0's at N = 37, c1's at N = 1). float32: the
    kernel sums in another order than cuBLAS."""
    p, ls = _cuda_inputs(dims, n, dtype)
    need_points = BWD_SHAPES.index((dims, actv, order, n)) % 2 == 0
    outs = fcnn_taylor_reference(p, ls, order, actv)
    cts = _cuda_cotangents(outs, seed=n)
    absent = {37: 0, 1: 1}.get(n, 2)
    if absent <= order:
        cts[absent] = None
    launches = dict(taylor_mlp.LAUNCHES)
    got = taylor_mlp._launch_bwd(p, ls, order, actv, cts, need_points)
    torch.cuda.synchronize()
    assert taylor_mlp.LAUNCHES == {**launches, 'taylor_mlp_1h_bwd': launches['taylor_mlp_1h_bwd'] + 1}
    want = taylor_mlp.taylor_mlp_1h_backward_reference(p, ls, order, actv, cts, need_points)
    assert (got[0] is None) != need_points
    for g, w in zip(got, want, strict=True):
        if w is not None:
            _assert_close(g, w.cpu().numpy(), rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('dims,actv,order,n', [((2, 512, 1), 'tanh', 2, 262144), ((2, 50, 3), 'sin', 2, 37),
                                               ((20, 64, 1), 'tanh', 2, 333), ((2, 64, 128), 'tanh', 2, 16384)])
def test_cuda_backward_kernel_is_deterministic(dims, actv, order, n, dtype):
    """No atomics: partial sums per block and a fixed-order sum pass, so two
    launches on the same inputs give bitwise-equal gradients."""
    p, ls = _cuda_inputs(dims, n, dtype)
    cts = _cuda_cotangents(fcnn_taylor_reference(p, ls, order, actv), seed=5)
    first = taylor_mlp._launch_bwd(p, ls, order, actv, cts, True)
    second = taylor_mlp._launch_bwd(p, ls, order, actv, cts, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flagship_backward_launches_the_kernel():
    """The autograd function at the flagship's shape on the card: one
    ``taylor_mlp_1h_bwd`` launch per backward, no twin, and the twin's
    gradients (float64, 1e-10)."""
    p, ls = _cuda_inputs((2, 512, 1), 4096, torch.float64)
    leaves = [t.clone().requires_grad_() for W, b in ls for t in (W, b)]
    taylor_mlp.reset_launches()
    outs = fcnn_taylor(p, list(zip(leaves[0::2], leaves[1::2])), 2)
    cts = _cuda_cotangents(outs, seed=9)
    got = torch.autograd.grad(outs, leaves, cts)
    torch.cuda.synchronize()
    assert taylor_mlp.LAUNCHES['taylor_mlp_1h_bwd'] == 1 and taylor_mlp.TWIN_BACKWARDS == {}
    twin_leaves = [t.detach().clone().requires_grad_() for t in leaves]
    twin = fcnn_taylor_reference(p, list(zip(twin_leaves[0::2], twin_leaves[1::2])), 2)
    for g, w in zip(got, torch.autograd.grad(twin, twin_leaves, cts), strict=True):
        _assert_close(g, w.cpu().numpy(), rtol=1e-10)
