"""The PyTorch port's temporal subsystem against the JAX package's, in float64.

The four samplers draw from numpy's global stream in the JAX package's
order, so after the same ``np.random.seed`` both give the same points, bit
for bit. Each of the four approximators, given the JAX parameters
(``load_jax_params``), the same points and the same boundary samples, gives
the JAX ``_loss`` and every parameter gradient of ``jax.grad`` to 1e-10
relative. The training routines (torch Adam against ``optax.adam``) give
the JAX histories to 1e-8 relative. Also: the initial conditions exact, one
network pass per collocation set for a system's columns, the metrics'
bookkeeping and the four monitors under Agg.
"""
import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu import fields as JF, temporal as JT
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu_torch import diff, fields as F, temporal as T
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

matplotlib.use('Agg')
torch.set_num_threads(2)
HIDDEN = (8, 8)
K_HEAT, L, T_MAX = 0.3, 2.0, 3.0


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    plt.close('all')
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _segments(mod, size, form, random=False):
    return [mod.BoundaryCondition(form=form, points_generator=mod.generator_2dspatial_segment(size, s, e, random))
            for s, e in [((0, 0), (1, 0)), ((1, 0), (1, 1)), ((1, 1), (0, 1)), ((0, 1), (0, 0))]]


def _problem(kind, mod, fields, d, net):
    """The approximator of ``kind`` in the package ``mod`` (temporal module,
    its fields and diff) on ``net``."""
    if kind == '1d_temporal':
        ic = mod.FirstOrderInitialCondition(u0=lambda x: fields.sin(np.pi / L * x))
        bcs = [mod.BoundaryCondition(form=lambda u, x, t: u,
                                     points_generator=mod.generator_1dspatial(4, a, a, random=False))
               for a in (0.0, L)]
        return mod.SingleNetworkApproximator1DSpatialTemporal(
            single_network=net, pde=lambda u, x, t: d(u, t) - K_HEAT * d(u, x, 2), initial_condition=ic,
            boundary_conditions=bcs, boundary_strictness=2.0)
    if kind == '2d':
        return mod.SingleNetworkApproximator2DSpatial(
            single_network=net, pde=lambda u, x, y: d(u, x, 2) + d(u, y, 2),
            boundary_conditions=_segments(mod, 6, lambda u, x, y: u - x * y), boundary_strictness=10.0)
    if kind == '2d_system':
        return mod.SingleNetworkApproximator2DSpatialSystem(
            single_network=net, pde=lambda u, v, x, y: [d(u, x) - v, d(v, y) + u * v],
            boundary_conditions=_segments(mod, 6, lambda u, v, x, y: u * v - x))
    ic = mod.SecondOrderInitialCondition(u0=lambda x, y: fields.sin(np.pi * x) * fields.sin(np.pi * y),
                                         u0dot=lambda x, y: x * y)
    bcs = [mod.BoundaryCondition(form=lambda u, x, y, t: u,
                                 points_generator=mod.generator_2dspatial_segment(5, (0, 0), (1, 0), False))]
    return mod.SingleNetworkApproximator2DSpatialTemporal(
        single_network=net, pde=lambda u, x, y, t: d(u, t, 2) - d(u, x, 2) - d(u, y, 2), initial_condition=ic,
        boundary_conditions=bcs)


SHAPES = {'1d_temporal': (2, 1), '2d': (2, 1), '2d_system': (2, 2), '2d_temporal': (3, 1)}


def _pair(kind):
    """The JAX and the port's approximators of ``kind`` on the same parameters."""
    n_in, n_out = SHAPES[kind]
    japprox = _problem(kind, JT, JF, JF.diff, JFCNN(n_in, n_out, hidden_units=HIDDEN))
    japprox.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), japprox.params)
    tapprox = _problem(kind, T, F, diff, FCNN(n_in, n_out, hidden_units=HIDDEN))
    assert tapprox.load_jax_params(jax.tree.map(np.asarray, japprox.params)) is tapprox
    return japprox, tapprox


def test_samplers_match_jax_bit_for_bit():
    def draws(mod):
        gens = [mod.generator_1dspatial(7, -1.0, 2.0), mod.generator_temporal(5, 0.0, 3.0),
                mod.generator_2dspatial_segment(6, (0.0, 1.0), (2.0, -1.0)),
                mod.generator_2dspatial_rectangle((3, 4), 0.0, 1.0, -2.0, 2.0),
                mod.generator_1dspatial(7, -1.0, 2.0, random=False), mod.generator_temporal(5, 0.0, 3.0, random=False),
                mod.generator_2dspatial_segment(6, (0.0, 1.0), (2.0, -1.0), random=False),
                mod.generator_2dspatial_rectangle((3, 4), 0.0, 1.0, -2.0, 2.0, random=False)]
        np.random.seed(11)
        out = []
        for _ in range(2):
            for g in gens:
                v = next(g)
                out.extend(v if isinstance(v, tuple) else [v])
        return out

    jdraws, tdraws = draws(JT), draws(T)
    assert len(jdraws) == len(tdraws) == 2 * 12
    for j, t in zip(jdraws, tdraws):
        assert t.dtype == torch.float64 and t.device.type == 'cpu'
        assert np.array_equal(t.numpy(), np.asarray(j))
    assert not np.array_equal(tdraws[0].numpy(), tdraws[12].numpy())  # random draws change
    assert np.array_equal(tdraws[7].numpy(), tdraws[19].numpy())      # fixed ones do not


def _points(kind, seed=5):
    """Paired collocation arrays and boundary samples (numpy) for ``kind``."""
    rng = np.random.RandomState(seed)
    if kind == '1d_temporal':
        x, t = rng.rand(9) * L, rng.rand(7) * T_MAX
        xx, tt = np.repeat(x, 7), np.tile(t, 9)
        bs = tuple((np.repeat(np.full(4, a), 7), np.tile(t, 4)) for a in (0.0, L))
        return (xx, tt), bs
    if kind == '2d_temporal':
        xy, t = rng.rand(2, 12), rng.rand(5)
        cols = (np.repeat(xy[0], 5), np.repeat(xy[1], 5), np.tile(t, 12))
        bx = rng.rand(5)
        bs = ((np.repeat(bx, 5), np.zeros(25), np.tile(t, 5)),)
        return cols, bs
    pts = rng.rand(2, 40)
    bs = tuple((rng.rand(6), rng.rand(6)) for _ in range(4))
    return (pts[0], pts[1]), bs


@pytest.mark.parametrize('kind', list(SHAPES))
def test_loss_and_gradients_match_jax(kind):
    japprox, tapprox = _pair(kind)
    cols, bs = _points(kind)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, c, b: japprox._loss(p, *c, b)))(
        japprox.params, tuple(map(jnp.asarray, cols)), tuple(tuple(map(jnp.asarray, s)) for s in bs))
    tloss = tapprox._loss(*map(torch.tensor, cols), tuple(tuple(map(torch.tensor, s)) for s in bs))
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    assert _rel(tloss, jloss) < 1e-10
    for lin, lp in zip(tapprox.single_network.linears, jgrads['layers'], strict=True):
        assert _rel(lin.weight.grad.numpy().T, lp['W']) < 1e-10
        assert _rel(lin.bias.grad.numpy(), lp['b']) < 1e-10
    # the boundary samples the conditions' generators give, and calculate_loss on them
    t = cols[-1][:5] if kind == '2d_temporal' else cols[-1][:7]
    sample_args = () if kind in ('2d', '2d_system') else (t,)
    jsamples = japprox._boundary_samples(*map(jnp.asarray, sample_args))
    tsamples = tapprox._boundary_samples(*map(torch.tensor, sample_args))
    for js, ts in zip(jsamples, tsamples, strict=True):
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(ts, js, strict=True))
    args = (cols + (None, t) if kind == '1d_temporal' else cols + (None, None, t) if kind == '2d_temporal' else cols)
    with torch.no_grad():
        want = tapprox._loss(*map(torch.tensor, cols), tsamples)
        assert tapprox.calculate_loss(*(None if a is None else torch.tensor(a) for a in args)) == want


def test_initial_conditions_hold_exactly():
    _, heat = _pair('1d_temporal')
    xs = np.linspace(0, L, 15)
    assert np.abs(heat(xs, np.zeros(15)) - np.sin(np.pi * xs / L)).max() < 1e-12
    _, wave = _pair('2d_temporal')
    xs, ys = np.random.RandomState(1).rand(2, 9)
    assert np.abs(wave(xs, ys, np.zeros(9)) - np.sin(np.pi * xs) * np.sin(np.pi * ys)).max() < 1e-12
    x, y, t = F.coordinates(xs, ys, np.zeros(9))
    u_t = diff(wave._solution((x, y, t)), t).value.detach().numpy().ravel()
    assert np.abs(u_t - xs * ys).max() < 1e-12  # u0dot
    first = T.SingleNetworkApproximator2DSpatialTemporal(
        FCNN(3, 1, hidden_units=HIDDEN), lambda u, x, y, t: diff(u, t),
        T.FirstOrderInitialCondition(u0=lambda x, y: x + y), [])
    assert np.abs(first(xs, ys, np.zeros(9)) - (xs + ys)).max() < 1e-12


def _solve(mod, kind, approx, opt, metrics, epochs=3):
    """Train ``approx`` through ``mod``'s routine for ``kind`` with numpy seeded."""
    np.random.seed(3)
    g1, gt = mod.generator_1dspatial, mod.generator_temporal
    rect = mod.generator_2dspatial_rectangle
    if kind == '1d_temporal':
        return mod._solve_1dspatial_temporal(g1(6, 0, L), gt(6, 0, T_MAX), g1(6, 0, L, random=False),
                                             gt(6, 0, T_MAX, random=False), approx, opt, batch_size=12,
                                             max_epochs=epochs, shuffle=True, metrics=metrics, monitor=None)
    if kind == '2d_temporal':
        return mod._solve_2dspatial_temporal(rect((3, 3), 0, 1, 0, 1), gt(3, 0, 1), rect((3, 3), 0, 1, 0, 1, False),
                                             gt(3, 0, 1, random=False), approx, opt, batch_size=9,
                                             max_epochs=epochs, shuffle=True, metrics=metrics, monitor=None)
    return mod._solve_2dspatial(rect((5, 5), 0, 1, 0, 1), rect((5, 5), 0, 1, 0, 1, random=False), approx, opt,
                                batch_size=5, max_epochs=epochs, shuffle=kind == '2d', metrics=metrics,
                                monitor=None)


@pytest.mark.parametrize('kind', list(SHAPES))
def test_training_history_matches_jax(kind):
    """The routines draw their points and shuffles from numpy's stream in the
    JAX order, so both packages train on the same points: torch Adam against
    optax.adam, the train loss recomputed on the epoch's points, validation."""
    japprox, tapprox = _pair(kind)
    japprox._loss = jax.jit(japprox._loss)  # the JAX epoch losses compiled: the same values, sooner
    metrics = {'mean_abs': lambda u, *rest: float(np.abs(u).mean())}
    _, jhist = _solve(JT, kind, japprox, optax.adam(1e-3), metrics)
    approx, thist = _solve(T, kind, tapprox, torch.optim.Adam(tapprox.parameters(), lr=1e-3), metrics)
    assert approx is tapprox
    assert set(thist) == set(jhist) == {'train_loss', 'valid_loss', 'train_mean_abs', 'valid_mean_abs'}
    for key in jhist:
        assert len(thist[key]) == 3 and all(isinstance(v, float) for v in thist[key])
        assert _rel(thist[key], jhist[key]) < 1e-8
    for lin, lp in zip(tapprox.single_network.linears, japprox.params['layers'], strict=True):
        assert _rel(lin.weight.detach().numpy().T, lp['W']) < 1e-8


def test_system_columns_share_one_network_pass(monkeypatch):
    """The columns of a system are slices of one network Field: one Taylor
    pass per collocation set (one kernel launch on the card), and the
    order-0 boundary reads run the plain forward, no Taylor-MLP call."""
    calls = []
    inner = taylor_mlp.fcnn_taylor

    def counting(points, layers, order, *args, **kwargs):
        calls.append((points.shape[0], order))
        return inner(points, layers, order, *args, **kwargs)

    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', counting)
    _, approx = _pair('2d_system')
    cols, bs = _points('2d_system')
    approx._loss(*map(torch.tensor, cols), tuple(tuple(map(torch.tensor, s)) for s in bs)).backward()
    assert calls == [(40, 1)]
    calls.clear()
    _, heat = _pair('1d_temporal')
    _solve(T, '1d_temporal', heat, torch.optim.Adam(heat.parameters(), lr=1e-3), {}, epochs=2)
    # per epoch: 36 points in 3 steps of 12, the epoch loss and validation
    assert calls == [(12, 2), (12, 2), (12, 2), (36, 2), (36, 2)] * 2
    assert F.taylor_fallback_count() == 0


def test_metrics_bookkeeping_and_outputs():
    _, approx = _pair('2d')
    out = approx.calculate_metrics(np.random.rand(6), torch.rand(6, dtype=torch.float64),
                                   {'m': lambda uu, xx, yy: float(np.max(uu)), 'x': lambda uu, xx, yy: xx.sum()})
    assert set(out) == {'m', 'x'} and np.isfinite(out['m'])
    _, system = _pair('2d_system')
    u, v = system(np.random.rand(4), np.random.rand(4))
    assert isinstance(u, np.ndarray) and u.shape == v.shape == (4,)
    assert list(system.parameters()) == list(system.single_network.parameters())
    _, heat = _pair('1d_temporal')
    _, hist = _solve(T, '1d_temporal', heat, torch.optim.Adam(heat.parameters(), lr=1e-3),
                     {'a': lambda uu, xx, tt: np.abs(uu).mean(), 'b': lambda uu, xx, tt: tt.max()}, epochs=4)
    assert list(hist) == ['train_loss', 'valid_loss', 'train_a', 'valid_a', 'train_b', 'valid_b']
    assert all(len(v) == 4 and np.isfinite(v).all() for v in hist.values())


def test_monitors_draw_under_agg():
    history = {'train_loss': [1.0, 0.5], 'valid_loss': [1.1, 0.6], 'train_m': [0.2, 0.1], 'valid_m': [0.3, 0.2]}
    _, heat = _pair('1d_temporal')
    _, plane = _pair('2d')
    _, wave = _pair('2d_temporal')
    monitors = [(T.MonitorMinimal(check_every=1), heat),
                (T.Monitor1DSpatialTemporal(np.linspace(0, L, 8), np.linspace(0, T_MAX, 3), check_every=1), heat),
                (T.Monitor2DSpatial(np.linspace(0, 1, 5), np.linspace(0, 1, 5), check_every=1), plane),
                (T.Monitor2DSpatialTemporal(np.linspace(0, 1, 4), np.linspace(0, 1, 4), np.linspace(0, 1, 3),
                                            check_every=1), wave)]
    for monitor, approx in monitors:
        assert monitor.using_non_gui_backend and monitor.check_every == 1
        monitor.check(approx, history)
        monitor.check(approx, history)  # the second draw updates the colorbars
    lines = monitors[1][0].ax1.get_lines()
    assert len(lines) == 3
    want = heat(*map(np.asarray, T._np_cartesian(np.linspace(0, L, 8), np.linspace(0, T_MAX, 3))))[1::3]
    assert np.array_equal(lines[1].get_ydata(), want)
    assert len(monitors[3][0].axs) == 5 and all(cb is not None for cb in monitors[3][0].cbs)
    # through a training routine: drawn every check_every epochs
    drawn = []

    class Recorder:
        check_every = 2

        def check(self, approx, hist):
            drawn.append(len(hist['train_loss']))

    np.random.seed(0)
    T._solve_2dspatial(T.generator_2dspatial_rectangle((3, 3), 0, 1, 0, 1),
                       T.generator_2dspatial_rectangle((3, 3), 0, 1, 0, 1, random=False), plane,
                       torch.optim.Adam(plane.parameters(), lr=1e-3), batch_size=9, max_epochs=5, shuffle=False,
                       metrics={}, monitor=Recorder())
    assert drawn == [1, 3, 5]
