"""A configuration, a traffic mix, a per-layer metric and a kernel's names
added as new files only, in a copy of the benchmark: the harness finds,
lists and runs them, and no file that was there changes."""
import hashlib
import json
import shutil
import time

import torch

from portbench import harness

ROOT = harness.HERE.parent

NEW_CONFIG = {
    "name": "poisson2d-fcnn64x2", "problem": "u_xx + u_yy = -2 pi^2 sin(pi x) sin(pi y), u = 0 on the sides",
    "domain": [[0.0, 1.0], [0.0, 1.0]], "n_input_units": 2, "hidden_units": [64, 64], "n_output_units": 1,
    "activation": "tanh", "dtype": "float64",
    "optimizer": {"name": "Adam", "lr": 0.001, "betas": [0.9, 0.999], "eps": 1e-08}, "loss": "l2",
    "n_batches_valid": 0, "taylor_order": 2, "reference_block_rows": {"train": 64, "eval": 64},
}
NEW_BUILDER = '''
import math
from portbench import port


def build(cfg, layers, train_generator, rng, device, dtype):
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.fields import diff
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.solvers import Solver2D
    zero = lambda t: 0 * t
    cond = DirichletBVP2D(0.0, zero, 1.0, zero, 0.0, zero, 1.0, zero)
    net = port.fcnn(cfg, layers, device, dtype)
    src = lambda x, y: 2 * math.pi ** 2 * F.sin(math.pi * x) * F.sin(math.pi * y)
    grid = Generator2D((8, 8), (0, 0), (1, 1), device=device, dtype=dtype)
    solver = Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2) + src(x, y)], conditions=[cond],
                      nets=[net], train_generator=train_generator or grid, valid_generator=grid,
                      optimizer=port.optimizer(cfg, net.parameters()), n_batches_valid=0, device=device, dtype=dtype,
                      generator=rng)
    return {'solver': solver, 'net': net, 'callbacks': []}
'''
NEW_REFERENCE = '''
import math
import torch
from portbench.reference.plain import d, mlp


def residuals(cfg, layers, x, y):
    u = x * (1 - x) * y * (1 - y) * mlp(layers, torch.cat([x, y], 1))
    return [d(d(u, x), x) + d(d(u, y), y) + 2 * math.pi ** 2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)]
'''
NEW_TRAFFIC = {"kind": "train", "generator": {"class": "Generator2D", "grid": [12, 12], "xy_min": [0.0, 0.0],
                                              "xy_max": [1.0, 1.0], "method": "equally-spaced-noisy"},
               "check_steps": 3, "warmup_steps": 1, "trace_start": 1, "trace_steps": 2}
NEW_METRIC = '''
MOVES = 'train_points_per_s'


def read(s):
    return float(len(s.kernels) + len(s.host_ops)) / s.steps
'''


def digests(folder):
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob('*')) if p.is_file() and '__pycache__' not in p.parts}


def test_new_files_alone_add_a_configuration_mix_metric_and_kernel(tmp_path):
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    pb = tmp_path / 'portbench'
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns('__pycache__'))
    before = digests(pb)

    (pb / 'configs' / 'poisson2d-fcnn64x2.json').write_text(json.dumps(NEW_CONFIG))
    (pb / 'configs' / 'poisson2d-fcnn64x2.py').write_text(NEW_BUILDER)
    (pb / 'reference' / 'poisson2d-fcnn64x2.py').write_text(NEW_REFERENCE)
    (pb / 'traffic' / 'train.grid.b144.json').write_text(json.dumps(NEW_TRAFFIC))
    (pb / 'metrics' / 'host_ops_per_epoch.train.py').write_text(NEW_METRIC)
    (pb / 'kernels.d' / 'poisson_fused.txt').write_text('# a later kernel of the forward\n\\bpoisson_fused_kernel\\b\n')
    (pb / 'limits' / 'poisson.train.b144.json').write_text(json.dumps(
        {"batch_rows": 0, "loss_gap": 1e-9, "grad_gap": 1e-9, "change_gap": 1e-6}))
    bench['configs'].append({"name": "poisson2d-fcnn64x2", "source": "a test configuration",
                             "file": "portbench/configs/poisson2d-fcnn64x2.json", "reduced": [], "why": "a test"})
    bench['workloads'].append({"name": "poisson.train.b144", "config": "poisson2d-fcnn64x2",
                               "traffic": "train.grid.b144", "chips": 1, "why": "a test"})
    for m in bench['end_to_end']:
        if m['name'] in ('train_points_per_s', 'epoch_ms_p95'):
            m['workloads'].append('poisson.train.b144')
    bench['per_layer'].append({"name": "host_ops_per_epoch.train", "unit": "ops", "better": "lower",
                               "source": "device_trace", "layer": "solver loop and residual engine",
                               "moves": "train_points_per_s", "workloads": ["poisson.train.b144"]})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))

    after = digests(pb)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed

    found = harness.discover(pb)
    assert 'poisson2d-fcnn64x2' in found['configs'] and 'train.grid.b144' in found['traffic']
    assert 'host_ops_per_epoch.train' in found['metrics'] and 'poisson_fused' in found['kernels']
    assert any(p.pattern == r'\bpoisson_fused_kernel\b' for p in harness.kernel_patterns(pb))

    cell = harness.Cell.load('poisson.train.b144', root=pb)
    assert [m['name'] for m in cell.end_to_end()] == ['train_points_per_s', 'epoch_ms_p95', 'setup_s']
    assert [m['name'] for m in cell.per_layer()] == ['host_ops_per_epoch.train']

    plain = harness.run('poisson.train.b144', 11, 0.2, False, device='cpu', cell=cell)
    assert plain['correct'] is True, plain['checks']
    assert set(plain['metrics']) == {'train_points_per_s', 'epoch_ms_p95', 'setup_s'}
    traced = harness.run('poisson.train.b144', 11, 0.2, True, device='cpu', cell=cell, t_start=time.perf_counter())
    assert set(traced['metrics']) == {'host_ops_per_epoch.train'} and traced['metrics']['host_ops_per_epoch.train']['value'] > 0
    assert list(traced)[-1] == 'checks' and torch.isfinite(torch.tensor(traced['device']['window_s']))
