"""The solver loop's spans (``neurodiffeq_tpu_torch/tracing.py``) under
``torch.profiler`` on the CPU:

- a ``fit`` gives each span once per epoch, in the loop's order, with no
  parent but the profiler's top range; the nets run under
  ``solver.residual``, in training and in ``get_residuals``, since the
  fields are lazy; a closure-style optimizer's passes nest under its
  ``Optimizer.step#...``;
- each span carries ``'<phase> <epoch>'`` as its ``args``, and with no
  profiler on the spans enter no ``record_function`` at all;
- a profiler and a slice range started and stopped from ``fit``'s
  callbacks, as the benchmark's ``portbench/harness.py::Window`` does, leave
  the range without a parent, and every span inside it reaches the
  outermost host ranges that ``portbench/devtrace.py`` keeps.
"""
from contextlib import nullcontext

import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from neurodiffeq_tpu_torch import diff, fields as F, tracing
from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
from neurodiffeq_tpu_torch.generators import Generator2D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type
from portbench import devtrace, harness

EPOCHS = 3
TRAIN = ['solver.batch', 'solver.forward', 'solver.residual', 'solver.backward']
VALID = ['solver.batch', 'solver.forward', 'solver.residual']
CLOSE = ['solver.readback', 'solver.best']


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _solver(n_batches_valid=1, optimizer=None):
    zero = lambda t: 0 * t
    grid = Generator2D((6, 6), (0, 0), (1, 1))
    net = FCNN(2, 1, hidden_units=(8,))
    return Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2) + F.sin(x)],
                    conditions=[DirichletBVP2D(0.0, zero, 1.0, zero, 0.0, zero, 1.0, zero)], nets=[net],
                    train_generator=grid, valid_generator=grid, n_batches_valid=n_batches_valid,
                    optimizer=optimizer(net.parameters()) if optimizer else None,
                    generator=torch.Generator().manual_seed(0))


def _spans(events):
    """``(name, parent's name or None)`` of every solver span, by start."""
    spans = sorted((e for e in events if e.name in tracing.SPANS), key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent is not None else None) for e in spans]


def _loop(n_batches_valid):
    return TRAIN + (VALID if n_batches_valid else []) + CLOSE


@pytest.mark.parametrize('n_batches_valid', [0, 1])
def test_each_epoch_runs_each_span_once_in_loop_order_at_the_top(n_batches_valid):
    solver = _solver(n_batches_valid)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.fit(EPOCHS, tqdm_file=None)
    spans = _spans(prof.events())
    assert [name for name, _ in spans] == _loop(n_batches_valid) * EPOCHS
    assert {parent for _, parent in spans} == {None}


@pytest.mark.parametrize('run', ['fit', 'get_residuals'])
def test_the_nets_run_under_the_residual_span(run):
    solver = _solver()
    solver.fit(1, tqdm_file=None)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if run == 'fit':
            solver.fit(1, tqdm_file=None)
        else:
            solver.get_residuals(torch.rand(5), torch.rand(5))

    def spans_above(e):
        while e is not None:
            if e.name in tracing.SPANS:
                yield e.name
            e = e.cpu_parent

    tanh = [list(spans_above(e)) for e in prof.events() if e.name == 'aten::tanh']
    assert tanh and all(names[-1] == 'solver.residual' for names in tanh)  # the fields are lazy


def test_a_closure_optimizers_passes_nest_under_its_step():
    solver = _solver(optimizer=lambda params: torch.optim.LBFGS(params, max_iter=3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        solver.fit(2, tqdm_file=None)
    spans = _spans(prof.events())
    inner = {name for name, parent in spans if parent == 'Optimizer.step#LBFGS.step'}
    assert inner == {'solver.forward', 'solver.residual', 'solver.backward'}
    assert sum(parent == 'Optimizer.step#LBFGS.step' for _, parent in spans) > 2 * 3  # more than one call a step
    top = [name for name, parent in spans if parent is None]
    assert top == (['solver.batch'] + VALID + CLOSE) * 2


@pytest.mark.parametrize('traced', [False, True])
def test_spans_carry_phase_and_epoch_and_cost_no_range_untraced(monkeypatch, traced):
    entered = []

    def counted(name, args=None):
        entered.append((name, args))
        return record_function(name, args)

    monkeypatch.setattr(tracing, 'record_function', counted)
    solver = _solver()
    solver.fit(1, tqdm_file=None)
    with profile(activities=[ProfilerActivity.CPU]) if traced else nullcontext():
        solver.fit(EPOCHS, tqdm_file=None)
        solver.get_residuals(torch.rand(5), torch.rand(5))
    if not traced:
        assert entered == []
        return
    want = [(name, f'{phase} {epoch}') for epoch in range(2, EPOCHS + 2)
            for phase, names in (('train', TRAIN), ('valid', VALID), ('train', ['solver.readback']),
                                 ('valid', ['solver.best']))
            for name in names]
    want += [(name, f'eval {EPOCHS + 1}') for name in ('solver.copy_nets', 'solver.forward', 'solver.residual')]
    assert entered == want


def test_a_window_opened_from_callbacks_keeps_every_span_outermost():
    solver = _solver()
    window = harness.Window('cpu', 0.0, {'trace_start': 1, 'trace_steps': 2}, trace=True)

    def tick(s):
        if window.tick():
            s._stop_training = True

    window.open()
    solver.fit(10, callbacks=[tick], tqdm_file=None)
    window.close(0.0, window.times)
    assert window.steps == 3
    events = window.profiler.events()
    assert [e.cpu_parent for e in events if e.name == devtrace.SLICE_RANGE] == [None]
    assert {parent for _, parent in _spans(events)} == {devtrace.SLICE_RANGE}
    lo, hi, _, _, host_ops = devtrace.reduce_events(events)
    inside = [name for name, start, end in host_ops if name in tracing.SPANS and lo <= start and end <= hi]
    assert inside == _loop(1) * 2
