"""Small copies of the benchmark's cells for the CPU tests: the traffic cut
to a few hundred points, everything else as committed."""
import copy

from portbench import harness

BENCH = harness.load_json(harness.HERE.parent / 'BENCHMARK.json')
# the evaluation cell, calibrated (limits/) and run on the card, is kept out of
# BENCHMARK.json while get_residuals strands its memo in reference cycles and
# its runs swing past any bound (PERF.md, Open questions); the tests keep its path
KEPT = [{"name": "cavity.eval.b1048576", "config": "cavity-re100-fcnn128x5", "traffic": "eval.uniform.b1048576",
         "chips": 1}]
CELLS = [w['name'] for w in BENCH['workloads'] + KEPT]


def load(name):
    """The cell ``name`` of ``BENCHMARK.json`` or ``KEPT``."""
    return harness.Cell.load(name, bench=dict(BENCH, workloads=BENCH['workloads'] + KEPT))


def small(name, points=256, dtype=None, hidden=None):
    """The cell ``name`` with ``points`` points a batch or a request."""
    cell = load(name)
    spec = copy.deepcopy(cell.traffic)
    if spec['kind'] == 'train':
        gen = spec['generator']
        for g in gen.get('product', [gen]):
            if 'size' in g:
                g['size'] = points
            if 'grid' in g:
                side = int(round(points ** 0.5))
                g['grid'] = [side, side]
        spec.update(warmup_steps=1)
    else:
        spec.update(points_per_request=points, warmup_requests=1)
    cell.traffic = spec
    cell.cfg = dict(cell.cfg, **({'dtype': dtype} if dtype else {}), **({'hidden_units': hidden} if hidden else {}))
    return cell
