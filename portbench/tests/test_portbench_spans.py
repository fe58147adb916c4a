"""The host-side readers of the program's solver spans (``spans.py`` and
``metrics/*host_ms_per_epoch.train.py``) on synthetic slices, and on a
traced run of each training cell at a small size on the CPU."""
import time

import pytest

from portbench import devtrace, harness
from portbench.tests.cells import BENCH, small

READERS = ['host_ms_per_epoch.train', 'forward_host_ms_per_epoch.train', 'backward_host_ms_per_epoch.train']


def reader(name):
    return harness.load_module(harness.HERE / 'metrics' / f'{name}.py')


def slice_with(host_ops, lo=1.0, hi=9.0, steps=2):
    return devtrace.Slice(steps=steps, lo=lo, hi=hi, kernels=[], backward_s=0.0, forward_bound_s=1.0,
                          forward_patterns=[], host_ops=host_ops)


# two epochs about the slice [1, 9]: it opens in the first residual and closes in the second read-back
EPOCHS = [('solver.batch', 0.0, 0.25), ('solver.forward', 0.25, 0.5), ('solver.residual', 0.5, 3.0),
          ('solver.backward', 3.0, 4.0), ('Optimizer.step#Adam.step', 4.0, 4.25), ('solver.readback', 4.25, 5.0),
          ('solver.best', 5.0, 5.25), ('solver.batch', 5.25, 5.5), ('solver.forward', 5.5, 6.0),
          ('solver.residual', 6.0, 7.5), ('solver.backward', 7.5, 8.0), ('solver.readback', 8.0, 9.5)]


@pytest.mark.parametrize('name, seconds', [
    ('host_ms_per_epoch.train', 8.0 - (0.75 + 1.0)),  # the slice less the read-backs, the second clipped at 9
    ('forward_host_ms_per_epoch.train', 2.0 + 0.5 + 1.5),  # the first forward lies outside the slice
    ('backward_host_ms_per_epoch.train', 1.0 + 0.5),
])
def test_readers_sum_their_spans_clipped_to_the_slice_per_epoch(name, seconds):
    assert reader(name).read(slice_with(EPOCHS)) == pytest.approx(1e3 * seconds / 2)
    assert reader(name).read(slice_with(EPOCHS, steps=4)) == pytest.approx(1e3 * seconds / 4)


def test_host_time_and_the_read_back_make_up_the_slice():
    s = slice_with(EPOCHS)
    readback = 1e3 * sum(min(e, s.hi) - max(b, s.lo) for name, b, e in EPOCHS if name == 'solver.readback')
    assert reader('host_ms_per_epoch.train').read(s) + readback / s.steps == pytest.approx(1e3 * s.window_s / s.steps)


@pytest.mark.parametrize('name', READERS)
def test_readers_find_nothing_in_a_program_without_spans(name):
    assert reader(name).read(slice_with([])) is None
    assert reader(name).read(slice_with([('aten::mul', 1.0, 2.0), ('Optimizer.step#Adam.step', 3.0, 4.0)])) is None
    assert reader(name).read(slice_with([('solver.best', 2.0, 3.0)])) is not None


def test_the_readers_are_entries_of_the_training_cells():
    entries = {m['name']: m for m in BENCH['per_layer']}
    for name in READERS:
        assert reader(name).MOVES == entries[name]['moves'] == 'train_points_per_s'
        assert entries[name]['workloads'] == [w['name'] for w in BENCH['workloads'] if '.train.' in w['name']]


@pytest.mark.parametrize('name', [w['name'] for w in BENCH['workloads']])
def test_a_traced_run_on_the_cpu_reads_the_spans(name):
    result = harness.run(name, 2 ** 31 + 7, 0.2, True, device='cpu', cell=small(name), t_start=time.perf_counter())
    host = {n: result['metrics'][n]['value'] for n in READERS}
    window_ms = 1e3 * result['device']['window_s'] / small(name).traffic['trace_steps']
    assert 0 < host['backward_host_ms_per_epoch.train'] and 0 < host['forward_host_ms_per_epoch.train']
    assert host['forward_host_ms_per_epoch.train'] + host['backward_host_ms_per_epoch.train'] < \
        host['host_ms_per_epoch.train'] <= window_ms
