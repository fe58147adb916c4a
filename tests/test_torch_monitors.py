"""The PyTorch port's monitors against the JAX package's, under Agg.

Each monitor of both packages draws the same nets (the same parameters,
``load_jax_params``, float64) and the same history; the arrays they plot
(solution curves, the heatmap's mesh, the triangulated values of an
irregular domain, the spherical curves and values, the streamlines'
components and the history lines) agree to 1e-10. Also: ``to_callback``,
``fit(monitor=...)``, a shared net, the history lines' upkeep and the
validation errors.
"""
import warnings

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import monitors as jmon
from neurodiffeq_tpu.conditions import (DirichletBVPSphericalBasis as JBasis, IrregularBoundaryCondition as JIrregular,
                                        IVP as JIVP, NoCondition as JNoCondition)
from neurodiffeq_tpu.function_basis import RealSphericalHarmonics as JRealSphericalHarmonics
from neurodiffeq_tpu.generators import Generator2D as JGenerator2D
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu_torch import diff, fields as F, monitors as mon
from neurodiffeq_tpu_torch.conditions import (DirichletBVPSphericalBasis, IrregularBoundaryCondition, IVP,
                                              NoCondition)
from neurodiffeq_tpu_torch.function_basis import RealSphericalHarmonics
from neurodiffeq_tpu_torch.generators import Generator2D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver1D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

matplotlib.use('Agg')
torch.set_num_threads(2)
TOL = 1e-10
HISTORY = {'train_loss': [1.0, 0.5, 0.25], 'valid_loss': [1.1, 0.6, 0.3],
           'train__err': [0.3, 0.2, 0.1], 'valid__err': [0.4, 0.3, 0.2]}


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


def _nets(n_in, n_out, count, hidden=(8,)):
    """JAX nets with float64 parameters and the port's nets loaded with them."""
    jnets, tnets, params = [], [], []
    for i in range(count):
        jnet, tnet = JFCNN(n_in, n_out, hidden_units=hidden), FCNN(n_in, n_out, hidden_units=hidden)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(10 + i)))
        tnet.load_jax_params(jax.tree.map(np.asarray, p))
        jnets.append(jnet), tnets.append(tnet), params.append(p)
    return jnets, tnets, params


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float), np.asarray(b, dtype=float), rtol=0, atol=TOL)


def _same_lines(ax, jax_ax):
    assert len(ax.lines) == len(jax_ax.lines) > 0
    for line, jline in zip(ax.lines, jax_ax.lines):
        _close(line.get_xdata(), jline.get_xdata())
        _close(line.get_ydata(), jline.get_ydata())


def test_monitor_1d_plots_the_jax_arrays():
    jnets, tnets, params = _nets(1, 1, 2)
    jconds, tconds = [JIVP(0.0, 1.0), JIVP(0.0, 2.0)], [IVP(0.0, 1.0), IVP(0.0, 2.0)]
    jm, m = jmon.Monitor1D(0, 2, check_every=1), mon.Monitor1D(0, 2, check_every=1)
    jm.check(jnets, jconds, HISTORY, params=params)
    m.check(tnets, tconds, HISTORY)
    for ax, jax_ax in ((m.ax1, jm.ax1), (m.ax2, jm.ax2), (m.ax3, jm.ax3)):
        _same_lines(ax, jax_ax)
    assert m.ax1.lines[0].get_ydata()[0] == pytest.approx(1.0)


@pytest.mark.parametrize('style', ['heatmap', 'curves'])
def test_monitor_2d_plots_the_jax_arrays(style):
    jnets, tnets, params = _nets(2, 1, 3)
    jm = jmon.Monitor2D((0, 0), (1, 1), check_every=1, solution_style=style)
    m = mon.Monitor2D((0, 0), (1, 1), check_every=1, solution_style=style)
    jm.check(jnets, [JNoCondition()] * 3, HISTORY, params=params)
    m.check(tnets, [NoCondition()] * 3, HISTORY)
    for ax, jax_ax in zip(m.axs[:-2], jm.axs[:-2]):
        if style == 'heatmap':
            _close(ax.collections[0].get_array(), jax_ax.collections[0].get_array())
        else:
            _same_lines(ax, jax_ax)
    for ax, jax_ax in zip(m.axs[-2:], jm.axs[-2:]):
        _same_lines(ax, jax_ax)
    with pytest.raises(ValueError):
        mon.Monitor2D((0, 0), (1, 1), solution_style='bogus')


def test_monitor_2d_valid_generator_and_irregular_domain(monkeypatch):
    """Plotting points from a generator, and a condition's domain mask: the
    triangulated values and the mask equal the JAX monitor's."""
    class JHalf(JIrregular):
        def parameterize(self, out, x, y):
            return out

        def in_domain(self, x, y):
            return np.asarray(x).flatten() < 0.5

    class Half(IrregularBoundaryCondition):
        def parameterize(self, out, x, y):
            return out

        def in_domain(self, x, y):
            return np.asarray(x).flatten() < 0.5

    seen = {}

    def recorder(name, original):
        def record(self, ax, xs, ys, zs, condition):
            contour = original(self, ax, xs, ys, zs, condition)
            seen[name] = (xs, ys, zs, contour.get_array() if hasattr(contour, 'get_array') else None)
            return contour
        return record

    monkeypatch.setattr(jmon.Monitor2D, '_create_contour', recorder('jax', jmon.Monitor2D._create_contour))
    monkeypatch.setattr(mon.Monitor2D, '_create_contour', recorder('torch', mon.Monitor2D._create_contour))
    jnets, tnets, params = _nets(2, 1, 1)
    jm = jmon.Monitor2D((0, 0), (1, 1), valid_generator=JGenerator2D((9, 9), method='equally-spaced'))
    m = mon.Monitor2D((0, 0), (1, 1), valid_generator=Generator2D((9, 9), method='equally-spaced'))
    jm.check(jnets, [JHalf()], HISTORY, params=params)
    m.check(tnets, [Half()], HISTORY)
    for a, b in zip(seen['torch'][:3], seen['jax'][:3]):
        _close(a, b)
    assert len(m.fig.axes[0].collections) > 0


@pytest.mark.parametrize('r_scale', ['linear', 'log'])
def test_monitor_spherical_plots_the_jax_arrays(r_scale):
    jnets, tnets, params = _nets(3, 1, 1)
    jm = jmon.MonitorSpherical(0.5, 2.0, check_every=1, shape=(4, 4, 4), r_scale=r_scale)
    m = mon.MonitorSpherical(0.5, 2.0, check_every=1, shape=(4, 4, 4), r_scale=r_scale)
    for a, b in ((m.r_label, jm.r_label), (m.theta_label, jm.theta_label), (m.phi_label, jm.phi_label)):
        _close(a, b)
    for a, b in zip(m._compute_us(tnets, [NoCondition()]), jm._compute_us(jnets, params, [JNoCondition()])):
        _close(a, b)
    jm.check(jnets, [JNoCondition()], dict(HISTORY), params=params)
    m.check(tnets, [NoCondition()], dict(HISTORY))
    for col in range(2):
        _same_lines(m.axs[0][col], jm.axs[0][col])
    _same_lines(m.ax_loss, jm.ax_loss)
    _same_lines(m.ax_metrics, jm.ax_metrics)


def test_monitor_spherical_harmonics_plots_the_jax_arrays():
    K = 9
    R = np.linspace(0.1, 0.9, K)
    jnets, tnets, params = _nets(1, K, 1)
    jm = jmon.MonitorSphericalHarmonics(0.5, 2.0, check_every=1, shape=(4, 4, 4),
                                        harmonics_fn=JRealSphericalHarmonics(max_degree=2))
    m = mon.MonitorSphericalHarmonics(0.5, 2.0, check_every=1, shape=(4, 4, 4),
                                      harmonics_fn=RealSphericalHarmonics(max_degree=2))
    for a, b in zip(m._compute_us(tnets, [DirichletBVPSphericalBasis(0.5, R)]),
                    jm._compute_us(jnets, params, [JBasis(0.5, R)])):
        _close(a, b)
    m.check(tnets, [DirichletBVPSphericalBasis(0.5, R)], {'train_loss': [1.0], 'valid_loss': [1.0]})
    assert m.max_degree == 2
    with pytest.raises(ValueError):
        mon.MonitorSphericalHarmonics(0.5, 2.0, shape=(4, 4, 4))


def test_streamplot_monitor_plots_the_jax_arrays(monkeypatch):
    seen = {'jax': [], 'torch': []}

    def recorder(name, original):
        def record(self, ax, us, vs, norms, cb_idx, is_grad=False):
            seen[name].append((us, vs, norms, is_grad))
            return original(self, ax, us, vs, norms, cb_idx, is_grad)
        return record

    monkeypatch.setattr(jmon.StreamPlotMonitor2D, '_plot_streamlines',
                        recorder('jax', jmon.StreamPlotMonitor2D._plot_streamlines))
    monkeypatch.setattr(mon.StreamPlotMonitor2D, '_plot_streamlines',
                        recorder('torch', mon.StreamPlotMonitor2D._plot_streamlines))
    jnets, tnets, params = _nets(2, 1, 2)
    kwargs = dict(xy_min=(0, 0), xy_max=(1, 1), pairs=[(0, 1), 0], nx=8, ny=8, field_names=['velocity', 'potential'],
                  mask_fn=lambda x, y: x < 0.8)
    jmon.StreamPlotMonitor2D(**kwargs).check(jnets, [JNoCondition()] * 2, HISTORY, params=params)
    m = mon.StreamPlotMonitor2D(**kwargs)
    m.check(tnets, [NoCondition()] * 2, HISTORY)
    m.check(tnets, [NoCondition()] * 2, HISTORY)  # the colorbars are replaced
    assert len(seen['torch']) == 4 and len(seen['jax']) == 2
    for got, want in zip(seen['torch'], seen['jax']):
        for a, b in zip(got[:3], want[:3]):
            _close(a, b)
        assert got[3] == want[3]
    with pytest.raises(ValueError):
        mon.StreamPlotMonitor2D(xy_min=(0, 0), xy_max=(1, 1), pairs=[(0, 1)], field_names=['a', 'b'])


def test_metrics_monitor_plots_the_jax_histories():
    jm, m = jmon.MetricsMonitor(check_every=1), mon.MetricsMonitor(check_every=1)
    jm.check([], [], HISTORY, params=[])
    m.check([], [], HISTORY)
    _same_lines(m.ax1, jm.ax1)
    _same_lines(m.ax2, jm.ax2)


def _solver(**kwargs):
    return Solver1D(ode_system=lambda u, t: [diff(u, t) + u], conditions=[IVP(0.0, 1.0)], t_min=0.0, t_max=2.0,
                    nets=[FCNN(hidden_units=(8,))], **kwargs)


def test_monitor_to_callback_and_fit_monitor(tmp_path):
    solver = _solver()
    m = mon.Monitor1D(0, 2, check_every=2)
    calls = []
    check = m.check
    m.check = lambda *a, **k: (calls.append(solver.local_epoch), check(*a, **k))
    solver.fit(max_epochs=3, callbacks=[m.to_callback(fig_dir=str(tmp_path))], tqdm_file=None)
    assert calls == [2, 3]
    assert sorted(p.name for p in tmp_path.iterdir()) == ['epoch-2.png', 'epoch-3.png']
    with pytest.warns(UserWarning, match='MonitorCallback'):
        solver.fit(max_epochs=2, monitor=m, tqdm_file=None)
    assert calls == [2, 3, 2]
    line = m.ax1.lines[0]
    _close(line.get_ydata(), solver.get_solution(best=False)(m.ts_plt, to_numpy=True))


def test_monitor_callback_with_shared_net():
    net = FCNN(n_input_units=1, n_output_units=2, hidden_units=(8,))
    conds = [IVP(t_0=0.0, u_0=1.0), IVP(t_0=0.0, u_0=2.0)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    s = Solver1D(ode_system=lambda u, v, t: [diff(u, t) + u, diff(v, t) + v], conditions=conds, nets=[net, net],
                 t_min=0.0, t_max=2.0)
    m = mon.Monitor1D(0, 2, check_every=1)
    s.fit(max_epochs=2, tqdm_file=None, callbacks=[m.to_callback()])
    assert [line.get_ydata()[0] for line in m.ax1.lines] == pytest.approx([1.0, 2.0])


def test_plot_history_drops_stale_series_and_survives_clear():
    fig, ax = plt.subplots()
    hist_a = {'train_loss': [1.0, 0.5], 'valid_loss': [1.1, 0.6]}
    mon.BaseMonitor._plot_history(ax, hist_a, losses=True)
    assert set(ax._ndq_history_lines) == {'train_loss', 'valid_loss'}
    mon.BaseMonitor._plot_history(ax, {'train_loss': [2.0, 1.0]}, losses=True)
    assert set(ax._ndq_history_lines) == {'train_loss'}
    ax.clear()
    mon.BaseMonitor._plot_history(ax, hist_a, losses=True)
    lines = ax._ndq_history_lines
    assert set(lines) == {'train_loss', 'valid_loss'} and all(line.axes is ax for line in lines.values())
    np.testing.assert_allclose(lines['train_loss'].get_ydata(), [1.0, 0.5])
