"""The PyTorch port's callbacks against the JAX package's.

Each condition callback is evaluated on both packages' ``Solver1D`` in the
same sequence of states (local epoch and loss histories, those of
``tests/test_callbacks.py``): the truth tables are equal. ``StopCallback``
ends ``fit`` at the same epoch in both. The action callbacks act on the
port's solver as the JAX ones do on theirs.
"""
import io
import logging
import random

import numpy as np
import pytest

import torch

from neurodiffeq_tpu import callbacks as jcb, diff as jdiff
from neurodiffeq_tpu.conditions import IVP as JIVP
from neurodiffeq_tpu.generators import Generator1D as JGenerator1D
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import Solver1D as JSolver1D
from neurodiffeq_tpu_torch import callbacks as cb, diff, solvers
from neurodiffeq_tpu_torch.conditions import IVP
from neurodiffeq_tpu_torch.generators import Generator1D
from neurodiffeq_tpu_torch.losses import _losses
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver1D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _jax_solver():
    return JSolver1D(ode_system=lambda u, t: [jdiff(u, t) + u], conditions=[JIVP(0.0, 1.0)],
                     t_min=0.0, t_max=2.0, nets=[JFCNN(hidden_units=(4,))],
                     train_generator=JGenerator1D(8, 0.0, 2.0, method='equally-spaced'),
                     valid_generator=JGenerator1D(8, 0.0, 2.0, method='equally-spaced'))


def _torch_solver(**kwargs):
    return Solver1D(ode_system=lambda u, t: [diff(u, t) + u], conditions=[IVP(0.0, 1.0)],
                    t_min=0.0, t_max=2.0, nets=[FCNN(hidden_units=(4,))],
                    train_generator=Generator1D(8, 0.0, 2.0, method='equally-spaced'),
                    valid_generator=Generator1D(8, 0.0, 2.0, method='equally-spaced'), **kwargs)


# the loss histories of tests/test_callbacks.py
HISTORIES = [[1.0, 0.8], [1.0], [1.0, 0.9], [1.0, 0.9, 0.8], [1.0, 1.1], [1.0, 1.005], [1.0, 2.0],
             [1.0, 0.4], [1.0, 0.7], [0.5], [0.5, 0.4], [0.1] * 4, [0.01], [1e-9]]
STATES = [(epoch, h) for h in HISTORIES for epoch in range(1, 13)]

# name -> factory(callbacks module): the same condition built from either package
CONDITIONS = {
    'true': lambda m: m.TrueCallback(),
    'false': lambda m: m.FalseCallback(),
    'and': lambda m: m.TrueCallback() & m.PeriodLocal(period=2),
    'or': lambda m: m.PeriodLocal(period=3) | m.OnFirstLocal(),
    'not': lambda m: ~m.PeriodLocal(period=2),
    'xor': lambda m: m.PeriodLocal(period=2) ^ m.PeriodLocal(period=3),
    'nested': lambda m: (m.ClosedIntervalLocal(min=3) & ~m.OnLastLocal()) | m.OnFirstGlobal(),
    'on-first-local': lambda m: m.OnFirstLocal(),
    'on-first-global': lambda m: m.OnFirstGlobal(),
    'on-last-local': lambda m: m.OnLastLocal(),
    'period-local': lambda m: m.PeriodLocal(period=3),
    'period-local-offset': lambda m: m.PeriodLocal(period=4, offset=5),
    'period-global': lambda m: m.PeriodGlobal(period=2, offset=1),
    'interval-local': lambda m: m.ClosedIntervalLocal(min=3, max=7),
    'interval-local-min': lambda m: m.ClosedIntervalLocal(min=6),
    'interval-local-max': lambda m: m.ClosedIntervalLocal(max=5),
    'interval-global': lambda m: m.ClosedIntervalGlobal(min=2, max=3),
    'random-1': lambda m: m.Random(1.0),
    'random-0': lambda m: m.Random(0.0),
    'random-half': lambda m: m.Random(0.5),
    'metric-down': lambda m: m.RepeatedMetricDown(at_least_by=0.05, repetition=2),
    'metric-up': lambda m: m.RepeatedMetricUp(at_least_by=0.05),
    'metric-converge': lambda m: m.RepeatedMetricConverge(epsilon=0.01),
    'metric-diverge': lambda m: m.RepeatedMetricDiverge(gap=0.5),
    'metric-below': lambda m: m.RepeatedMetricBelow(threshold=0.5),
    'metric-above-valid': lambda m: m.RepeatedMetricAbove(threshold=0.5, use_train=False, repetition=2),
}


def _truth_table(solver, condition):
    random.seed(0)
    table = []
    solver._max_local_epoch = 10
    for epoch, history in STATES:
        solver.local_epoch = epoch
        solver.metrics_history['train_loss'] = list(history)
        solver.metrics_history['valid_loss'] = [2 * x for x in history]
        table.append(bool(condition.condition(solver)))
    return table


@pytest.mark.parametrize('name', sorted(CONDITIONS))
def test_condition_truth_tables_match_jax(name):
    want = _truth_table(_jax_solver(), CONDITIONS[name](jcb))
    got = _truth_table(_torch_solver(), CONDITIONS[name](cb))
    assert got == want
    assert name in ('false', 'random-0') or any(got)


@pytest.mark.parametrize('name', ['period-local', 'interval-local-min', 'metric-below', 'on-last-local', 'false'])
def test_stop_callback_stops_at_the_jax_epoch(name):
    make = {**CONDITIONS, 'metric-below': lambda m: m.RepeatedMetricBelow(threshold=1e9, repetition=3)}[name]
    jsolver, tsolver = _jax_solver(), _torch_solver()
    jsolver.fit(9, callbacks=[jcb.StopCallback().conditioned_on(make(jcb))], tqdm_file=None)
    tsolver.fit(9, callbacks=[cb.StopCallback().conditioned_on(make(cb))], tqdm_file=None)
    assert (tsolver.local_epoch, tsolver.global_epoch) == (jsolver.local_epoch, jsolver.global_epoch)
    assert tsolver.global_epoch == {'period-local': 3, 'interval-local-min': 6, 'metric-below': 4,
                                    'on-last-local': 9, 'false': 9}[name]


def test_condition_runs_its_action():
    calls = []

    class Record(cb.ActionCallback):
        def __call__(self, solver):
            calls.append(solver.local_epoch)

    solver = _torch_solver()
    solver.fit(7, callbacks=[Record().conditioned_on(cb.PeriodLocal(period=3)), cb.FalseCallback()],
               tqdm_file=None)
    assert calls == [3, 6]
    with pytest.raises(TypeError):
        Record().conditioned_on(Record())
    with pytest.raises(TypeError):
        cb.TrueCallback().set_action_callback(cb.TrueCallback())


def test_set_loss_fn_and_optimizer():
    solver = _torch_solver()
    once = cb.SetLossFn('l1')
    once(solver)
    assert solver.loss_fn is _losses['l1']
    solver.loss_fn = 'sentinel'
    once(solver)
    assert solver.loss_fn == 'sentinel'
    cb.SetLossFn('h1 semi', reset=True)(solver)
    assert solver.loss_fn is _losses['h1 semi']
    with pytest.warns(FutureWarning):
        cb.SetLossFn(criterion='l2')(solver)
    assert solver.loss_fn is _losses['l2']

    # an instance is used as is; a class is called with the nets' parameters
    sgd = torch.optim.SGD(solver.nets[0].parameters(), lr=1e-2)
    cb.SetOptimizer(sgd)(solver)
    assert solver.optimizer is sgd and not solver._closure_style
    cb.SetOptimizer(torch.optim.Adam, optimizer_args=(1e-3,), optimizer_kwargs={'eps': 1e-7})(solver)
    opt = solver.optimizer
    assert isinstance(opt, torch.optim.Adam) and opt.defaults['lr'] == 1e-3 and opt.defaults['eps'] == 1e-7
    assert opt.param_groups[0]['params'] == list(solver.nets[0].parameters())
    solver.fit(2, tqdm_file=None)
    with pytest.raises(TypeError):
        cb.SetOptimizer(3)(solver)


def test_eve_callback_doubles_batches():
    solver = _torch_solver()
    eve = cb.EveCallback(base_value=1.0, double_at=0.1, n_0=1, n_max=16)
    solver.metrics_history['train_loss'] = [0.01]  # two decades below base
    eve(solver)
    assert solver.n_batches['train'] == 4
    solver.metrics_history['train_loss'] = [1e-9]
    eve(solver)
    assert solver.n_batches['train'] == 16  # capped at n_max
    solver.metrics_history['train_loss'] = []
    solver.fit(1, tqdm_file=None)  # trains with 16 batches
    assert solver.global_epoch == 1


def test_report_progress_and_deprecated_aliases(caplog, capsys):
    solver = _torch_solver()
    with caplog.at_level(logging.INFO, logger='root'):
        cb.ReportCallback()(solver)
    assert 'train size = 8 x 1 = 8' in caplog.text
    solver.local_epoch, solver._max_local_epoch = 5, 10
    cb.ProgressBarCallBack()(solver)
    assert capsys.readouterr().out.startswith('#' * 50 + '.')
    with pytest.warns(FutureWarning):
        assert isinstance(cb.ReportOnFitCallback(), cb.ReportCallback)
    with pytest.warns(FutureWarning):
        assert isinstance(cb.SetCriterion('l2'), cb.SetLossFn)
    with pytest.raises(ValueError):
        cb.Random(1.5)


def test_fit_shows_a_progress_bar_only_when_asked(capsys):
    buf = io.StringIO()
    _torch_solver().fit(3, tqdm_file=buf)
    assert ('Training Progress' in buf.getvalue()) == (solvers.tqdm is not None)
    _torch_solver().fit(3, tqdm_file=None)
    assert capsys.readouterr().err == ''


def test_metric_history_drives_stop_on_the_port():
    """A real fit: stop once the training loss has fallen three epochs running."""
    solver = _torch_solver()
    solver.fit(200, callbacks=[cb.StopCallback().conditioned_on(cb.RepeatedMetricDown(repetition=3))],
               tqdm_file=None)
    h = np.array(solver.metrics_history['train_loss'])
    assert solver.global_epoch < 200 and (np.diff(h[-4:]) <= 0).all()
