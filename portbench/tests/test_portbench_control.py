"""The control, on the card: the plain reference computed in float32 with
TF32 products, put in the program's place, fails the committed limits
where the program passes them (at an eighth of each cell's points)."""
import math
import time

import pytest
import torch

from portbench import compare, harness
from portbench.tests.cells import CELLS, load, small

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize('name', CELLS)
def test_the_control_fails_where_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    full = load(name)
    gen = full.traffic.get('generator', {})
    n = (full.traffic['points_per_request'] if full.traffic['kind'] == 'eval'
         else math.prod(gen['grid']) if 'grid' in gen else gen.get('product', [gen])[0]['size'])
    cell = small(name, points=n // 8)
    device = torch.device('cuda', torch.cuda.current_device())
    run = harness.RUNNERS[cell.traffic['kind']](cell, 2 ** 31 + 3, 1.0, False, device, time.perf_counter())
    ev, limits = run['evidence'], cell.limits()
    if cell.traffic['kind'] == 'train':
        ref = compare.reference_train(cell, ev['p0'], ev['batches'])
        control = compare.reference_train(cell, ev['p0'], ev['batches'], torch.float32, tf32=True)
        program = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], ev['program'], ref)
        control = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], control, ref)
    else:
        pts = {i: harness.request_points(cell, ev['seed'], i, device) for i in ev['answers']}
        refs = {i: compare.reference_eval(cell, ev['params'], p) for i, p in pts.items()}
        program = compare.eval_readings(cell, ev['answers'], refs)
        control = compare.eval_readings(cell, {i: compare.reference_eval(cell, ev['params'], p, torch.float32,
                                                                         tf32=True) for i, p in pts.items()}, refs)
    assert compare.judge(program, limits)[0] is True, program
    assert compare.judge(control, limits)[0] is False, control
