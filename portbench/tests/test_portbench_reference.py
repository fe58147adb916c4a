"""The plain reference against the port, in float64 on the CPU at the
published widths and a few hundred points: the loss of each checked step,
the first gradient, one Adam step (and three), and the residuals."""
import time

import pytest
import torch

from portbench import compare, harness
from portbench.tests.cells import CELLS, load, small

CONFIGS = sorted({load(name).entry['config'] for name in CELLS})


def cell_of(config, kind):
    return next(small(name, points=256, dtype='float64') for name in CELLS
                if load(name).entry['config'] == config and load(name).traffic['kind'] == kind)


@pytest.mark.parametrize('config', CONFIGS)
def test_training_steps_match_the_reference(config):
    cell = cell_of(config, 'train')
    run = harness.RUNNERS['train'](cell, 2 ** 31 + 17, 0.0, False, torch.device('cpu'), time.perf_counter())
    ev = run['evidence']
    ref = compare.reference_train(cell, ev['p0'], ev['batches'])
    got = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], ev['program'], ref)
    assert got['batch_rows'] == 0
    assert got['loss_gap'] < 1e-12
    assert got['grad_gap'] < 1e-12
    assert got['change_gap'] < 1e-10


@pytest.mark.parametrize('config', CONFIGS)
def test_one_adam_step_matches_the_reference_leaf_by_leaf(config):
    cell = cell_of(config, 'train')
    cell.traffic = dict(cell.traffic, check_steps=1)
    run = harness.RUNNERS['train'](cell, 2 ** 31 + 18, 0.0, False, torch.device('cpu'), time.perf_counter())
    ev = run['evidence']
    losses, grads, after = compare.reference_train(cell, ev['p0'], ev['batches'])
    assert ev['program'][0][0] == pytest.approx(losses[0], rel=1e-12)
    for got_g, want_g, got_p, want_p in zip(ev['program'][1], grads, ev['program'][2], after):
        assert torch.allclose(got_g, want_g, rtol=1e-10, atol=1e-14 * want_g.abs().max())
        assert torch.allclose(got_p.double(), want_p, rtol=0, atol=1e-12)


@pytest.mark.parametrize('config', CONFIGS)
def test_residuals_match_the_reference(config):
    cell = cell_of(config, 'train')
    params = harness.make_params(cell, 5, 'cpu', torch.float64)
    built = cell.builder.build(cell.cfg, harness.build_weights(cell, params), None, torch.Generator().manual_seed(5),
                               torch.device('cpu'), torch.float64)
    pts = torch.rand(2, 300, generator=torch.Generator().manual_seed(6), dtype=torch.float64)
    got = built['solver'].get_residuals(*pts, best=False)
    got = got if isinstance(got, list) else [got]
    want = compare.reference_eval(cell, params, pts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-10 * w.abs().max()
