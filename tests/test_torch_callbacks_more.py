"""The callbacks that came with persistence and the monitors, and the
solver faults F8 and F9, against the JAX package where it has numbers.

- ``MonitorCallback``: its counts, its deprecated arguments, background
  draws (one in flight, busy fires skipped, the last epoch drawn in
  place, ``fit`` joining the worker), the frozen copies a background draw
  gets (a parameter change after the fire does not reach the drawn data)
  and the fallback for a GUI backend;
- ``CheckpointCallback`` in both formats and ``restore``;
- ``AutoResidualWeightCallback``: its gradient norms equal the JAX
  package's to 1e-10 on the same parameters and points, its weight
  sequence equals the JAX package's for a scripted sequence of norms, and
  its freezing, warning and argument checks;
- ``SimpleTensorboardCallback`` with a recording writer;
- F8: ``criterion``, ``batch`` and ``_batch_examples``, and FutureWarnings
  shown always; F9: ``fit(pipeline=False)`` and ``fit(profile_dir=...)``,
  whose trace holds the solver loop's spans.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import diff as jdiff
from neurodiffeq_tpu.callbacks import AutoResidualWeightCallback as JAutoResidualWeightCallback
from neurodiffeq_tpu.conditions import IVP as JIVP
from neurodiffeq_tpu.networks import FCNN as JFCNN, SinActv as JSinActv
from neurodiffeq_tpu.solvers import Solver1D as JSolver1D
from neurodiffeq_tpu_torch import callbacks as cb, diff, fields as F
from neurodiffeq_tpu_torch.conditions import IVP
from neurodiffeq_tpu_torch.losses import _losses
from neurodiffeq_tpu_torch.networks import FCNN, SinActv
from neurodiffeq_tpu_torch.solvers import Solver1D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _solver(**kwargs):
    kwargs.setdefault('nets', [FCNN(hidden_units=(8,))])
    return Solver1D(ode_system=lambda u, t: [diff(u, t) + u], conditions=[IVP(0.0, 1.0)], t_min=0.0, t_max=2.0,
                    **kwargs)


def _stiff(jax_too=False, hidden=(16,)):
    """u' = v, v' = -100 u (``benchmarks/balancing_ab.py``), the port's
    solver and, if asked, the JAX package's on the same parameters."""
    tsolver = Solver1D(ode_system=lambda u, v, t: [diff(u, t) - v, diff(v, t) + 100.0 * u],
                       conditions=[IVP(0.0, 1.0), IVP(0.0, 0.0)], t_min=0.0, t_max=1.0,
                       nets=[FCNN(hidden_units=hidden, actv=SinActv) for _ in range(2)])
    if not jax_too:
        return tsolver
    jsolver = JSolver1D(ode_system=lambda u, v, t: [jdiff(u, t) - v, jdiff(v, t) + 100.0 * u],
                        conditions=[JIVP(0.0, 1.0), JIVP(0.0, 0.0)], t_min=0.0, t_max=1.0,
                        nets=[JFCNN(hidden_units=hidden, actv=JSinActv) for _ in range(2)])
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    return jsolver, tsolver


class _Stub:
    """A monitor that records what it is asked to draw."""
    fig = None
    using_non_gui_backend = True

    def __init__(self, block=None):
        self.calls = []
        self.block = block

    def check(self, nets, conditions, history, params=None, solver=None):
        self.calls.append((nets, len(history['train_loss']), solver))
        if self.block is not None:
            self.block.wait(timeout=5)


def test_monitor_callback_counts_and_deprecated_kwargs():
    m = _Stub()
    solver = _solver()
    mc = cb.MonitorCallback(m)
    solver.fit(3, callbacks=[mc], tqdm_file=None)
    assert [c[1] for c in m.calls] == [1, 2, 3] and all(c[0] is solver.nets for c in m.calls)
    for kw in ('check_against_local', 'check_against', 'repaint_last'):
        with pytest.warns(FutureWarning):
            cb.MonitorCallback(_Stub(), **{kw: True})
    with pytest.raises(ValueError):
        cb.MonitorCallback(_Stub(), bogus=1)


def test_monitor_callback_background_mode():
    release = threading.Event()
    m = _Stub(block=release)
    solver = _solver()
    solver.fit(1, tqdm_file=None)
    solver._max_local_epoch = 10
    mc = cb.MonitorCallback(m, background=True)
    mc(solver)  # the worker starts and blocks
    solver.fit(1, tqdm_file=None)
    solver._max_local_epoch = 10
    mc(solver)  # busy: skipped
    assert [c[1] for c in m.calls] == [1]
    release.set()
    mc.flush()
    solver.fit(1, tqdm_file=None)  # local epoch 1 of 1: the last, drawn in place
    mc(solver)
    assert [c[1] for c in m.calls] == [1, 3] and m.calls[-1][2] is solver
    assert mc._worker is None


def test_background_draws_get_frozen_copies():
    """A parameter change after the fire does not reach the drawn data."""
    release, values = threading.Event(), []
    ts = torch.linspace(0, 2, 5, dtype=torch.float64).reshape(-1, 1)

    class Snap(_Stub):
        def check(self, nets, conditions, history, params=None, solver=None):
            release.wait(timeout=5)
            with torch.no_grad():
                values.append(nets[0](ts).clone())
            self.calls.append((nets, solver))

    solver = _solver()
    solver.fit(2, tqdm_file=None)
    solver._max_local_epoch = 10
    with torch.no_grad():
        before = solver.nets[0](ts).clone()
    mc = cb.MonitorCallback(Snap(), background=True)
    mc(solver)
    with torch.no_grad():
        for p in solver._parameters():
            p.add_(1.0)
    solver.metrics_history['train_loss'].append(0.0)
    release.set()
    mc.flush()
    assert torch.equal(values[0], before)
    nets, snapshot = mc.monitor.calls[0]
    assert nets[0] is not solver.nets[0] and all(not p.requires_grad for p in nets[0].parameters())
    assert snapshot is not solver and len(snapshot.metrics_history['train_loss']) == 2


def test_monitor_callback_gui_backend_falls_back():
    m = _Stub()
    m.using_non_gui_backend = False
    solver = _solver()
    solver.fit(1, tqdm_file=None)
    solver._max_local_epoch = 10
    mc = cb.MonitorCallback(m, background=True)
    with pytest.warns(UserWarning, match='non-GUI'):
        mc(solver)
    assert mc._worker is None and m.calls[0][2] is solver


def test_fit_flushes_background_worker_on_return():
    drawing, done = threading.Event(), []

    class Slow(_Stub):
        def check(self, nets, conditions, history, params=None, solver=None):
            drawing.set()
            time.sleep(0.3)
            done.append(len(history['train_loss']))

    mc = cb.MonitorCallback(Slow(), background=True)
    _solver().fit(5, callbacks=[mc.conditioned_on(cb.PeriodLocal(period=2))], tqdm_file=None)
    assert drawing.is_set() and mc._worker is None and len(done) >= 1


def test_checkpoint_internals(tmp_path):
    import dill
    solver = _solver()
    solver.fit(3, tqdm_file=None)
    cb.CheckpointCallback(str(tmp_path))(solver)
    files = [f for f in os.listdir(tmp_path) if f.endswith('.internals')]
    assert len(files) == 1
    with open(os.path.join(tmp_path, files[0]), 'rb') as f:
        internals = dill.load(f)
    assert internals['global_epoch'] == 3
    leaf = internals['params'][0]['linears.0.weight']
    assert isinstance(leaf, np.ndarray)
    np.testing.assert_array_equal(leaf, solver.nets[0].linears[0].weight.detach().numpy())
    assert isinstance(internals['best_params'][0]['linears.0.bias'], np.ndarray)
    assert internals['optimizer']['type'] == 'Adam'
    assert isinstance(internals['optimizer']['state_dict']['state'][0]['exp_avg'], np.ndarray)


def test_checkpoint_state_dict_and_restore(tmp_path):
    solver = _solver()
    ckpt = cb.CheckpointCallback(str(tmp_path), format='state_dict')
    solver.fit(6, callbacks=[ckpt.conditioned_on(cb.PeriodLocal(3))], tqdm_file=None)
    assert sorted(os.listdir(tmp_path)) == ['step_3.meta.json', 'step_3.pt', 'step_6.meta.json', 'step_6.pt']
    with open(tmp_path / 'step_6.meta.json') as f:
        assert json.load(f)['global_epoch'] == 6
    fresh = _solver()
    cb.CheckpointCallback.restore(fresh, str(tmp_path), step=6)
    assert fresh.global_epoch == 6 and fresh.metrics_history == solver.metrics_history
    assert fresh.lowest_loss == solver.lowest_loss
    for p, q in zip(solver._parameters(), fresh._parameters()):
        assert torch.equal(p, q)
        sp, sq = solver.optimizer.state[p], fresh.optimizer.state[q]
        assert all(torch.equal(sp[k], sq[k]) for k in sp)
    for a, b in zip(solver.best_params, fresh.best_params):
        assert all(torch.equal(a[k], b[k]) for k in a)
    solver.rng.manual_seed(5)
    solver.fit(1, tqdm_file=None)
    fresh.rng.manual_seed(5)
    fresh.fit(1, tqdm_file=None)
    assert solver.metrics_history['train_loss'][-1] == fresh.metrics_history['train_loss'][-1]
    with pytest.raises(ValueError, match='state_dict'):
        cb.CheckpointCallback(str(tmp_path), format='orbax')
    with pytest.raises(ValueError):
        cb.CheckpointCallback(str(tmp_path), format='bogus')


def test_auto_residual_weight_norms_equal_jax():
    jsolver, tsolver = _stiff(jax_too=True)
    cols = [np.linspace(0.0, 1.0, 32).reshape(-1, 1)]
    jab = JAutoResidualWeightCallback()
    want = np.asarray(jab._build_norms_fn(jsolver, 2)(jsolver.params, [jnp.asarray(c) for c in cols]))
    got = cb.AutoResidualWeightCallback._grad_norms(tsolver, [torch.as_tensor(c) for c in cols])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=0)
    assert got[1] > 10 * got[0]
    assert all(p.grad is None for p in tsolver._parameters())


def test_auto_residual_weight_sequence_equals_jax():
    """The same scripted norms give the same weights, freezing included."""
    norms = [[1.0, 100.0], [1.0, 80.0], [2.0, 10.0], [1.0, 0.5]] + [[1.0, 1.0]] * 16
    jsolver, tsolver = _stiff(jax_too=True)
    jab, tab = JAutoResidualWeightCallback(), cb.AutoResidualWeightCallback()
    script_j, script_t = iter(norms), iter(norms)
    jab._norms_fn, jab._norms_solver = (lambda params, cols: np.asarray(next(script_j))), jsolver
    tab._grad_norms = lambda solver, cols: np.asarray(next(script_t))
    for _ in norms:
        jab(jsolver)
        tab(tsolver)
        assert tab.frozen == jab.frozen
        assert tsolver.residual_weights == jsolver.residual_weights
    assert [h[1:] for h in tab.weight_history] == [h[1:] for h in jab.weight_history]
    assert tab.frozen and len(tab.weight_history) < len(norms)


def test_auto_residual_weight_balances_the_stiff_system():
    tsolver = _stiff()
    ab = cb.AutoResidualWeightCallback()
    tsolver.fit(201, callbacks=[ab.conditioned_on(cb.OnFirstLocal() | cb.PeriodLocal(period=100))],
                tqdm_file=None)
    assert [h[0] for h in ab.weight_history] == [1, 100, 200]
    w = tsolver.residual_weights
    assert w[0] == 1.0 and w[1] < 0.5 and w[1] >= ab.min_weight


def test_auto_residual_weight_freezes_single_equation_and_validates():
    solver = _stiff()
    ab = cb.AutoResidualWeightCallback(freeze_tol=1e9, freeze_patience=2)
    solver.fit(4, callbacks=[ab], tqdm_file=None)
    assert ab.frozen and len(ab.weight_history) == 2
    w_frozen = list(solver.residual_weights)
    solver.fit(2, callbacks=[ab], tqdm_file=None)
    assert solver.residual_weights == w_frozen
    single = _solver()
    ab = cb.AutoResidualWeightCallback()
    with pytest.warns(UserWarning, match='single'):
        single.fit(2, callbacks=[ab], tqdm_file=None)
    assert ab.frozen and single.residual_weights is None
    for kwargs in ({'rate': 0.0}, {'rate': 1.5}, {'clip': 1.0}, {'min_weight': 0.0}):
        with pytest.raises(ValueError):
            cb.AutoResidualWeightCallback(**kwargs)


def test_simple_tensorboard_callback_with_a_recording_writer():
    class Writer:
        def __init__(self):
            self.records = []

        def add_scalar(self, tag, scalar_value, global_step):
            self.records.append((tag, float(scalar_value), global_step))

    w = Writer()
    solver = _solver(metrics={'u0': lambda u, t: u.mean()})
    solver.fit(3, callbacks=[cb.SimpleTensorboardCallback(writer=w)], tqdm_file=None)
    assert len(w.records) == 3 * len(solver.metrics_history)
    for epoch in (1, 2, 3):
        step = {tag: v for tag, v, s in w.records if s == epoch}
        assert step == {k: v[epoch - 1] for k, v in solver.metrics_history.items()}


def test_f8_criterion_and_batch_follow_jax():
    solver = _solver()
    with pytest.warns(UserWarning, match='deprecated alias'):
        assert solver.criterion is solver.loss_fn
    with pytest.warns(UserWarning, match='deprecated alias'):
        solver.criterion = 'l1'
    assert solver.loss_fn is _losses['l1']
    assert solver.batch == {'train': None, 'valid': None}
    solver.fit(1, tqdm_file=None)
    assert solver.batch['train'][0].shape == (32, 1) and solver.batch['valid'][0].shape == (32, 1)
    with pytest.warns(FutureWarning):
        assert solver._batch_examples is solver.batch
    # importing the port makes FutureWarnings always shown (pytest resets the
    # filters per test, so this runs in a fresh interpreter)
    code = ("import warnings, neurodiffeq_tpu_torch\n"
            "for _ in range(2):\n    warnings.warn('twice', FutureWarning)\n")
    out = subprocess.run([sys.executable, '-W', 'default', '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stderr.count('FutureWarning: twice') == 2, out.stderr


def test_f9_fit_takes_pipeline_and_profile_dir(tmp_path):
    a, b = _solver(generator=torch.Generator().manual_seed(1)), _solver(generator=torch.Generator().manual_seed(1))
    b.nets[0].load_state_dict(a.nets[0].state_dict())
    a.fit(3, pipeline=False, tqdm_file=None)
    b.fit(3, pipeline=True, tqdm_file=None)
    assert a.metrics_history == b.metrics_history
    a.fit(2, profile_dir=str(tmp_path / 'trace'), tqdm_file=None)
    assert a.global_epoch == 5
    traces = os.listdir(tmp_path / 'trace')
    assert len(traces) == 1 and traces[0].endswith('.pt.trace.json')
    with open(tmp_path / 'trace' / traces[0]) as f:
        events = json.load(f)['traceEvents']
    spans = ['solver.batch', 'solver.forward', 'solver.residual', 'solver.backward', 'solver.readback', 'solver.best']
    assert {name: sum(e.get('name') == name for e in events) for name in spans} == {
        'solver.batch': 10, 'solver.forward': 10, 'solver.residual': 10, 'solver.backward': 2, 'solver.readback': 2,
        'solver.best': 2}  # 2 epochs of a train batch and 4 validation batches
