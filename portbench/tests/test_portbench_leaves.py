"""Leaves declared as data.

The two FCNN configurations get what they got before a configuration could
declare its leaves: the same weights to the bit, the same forward count,
and the same names listed. A net that is not an FCNN, added as new files
alone in a copy of the benchmark, runs through ``harness.run`` on the CPU
and reads correct: the port's ``Resnet`` (trainable leaves that do not
chain, a bias-free skip among them) and its ``FourierFCNN`` (a frozen leaf).
A net that leaves out a leaf or swaps two makes the harness raise, and
leaf lists of unequal length make the comparison raise."""
import json
import math
import shutil
import time

import pytest
import torch

from portbench import compare, cost, harness, traffic
from portbench.tests.cells import load

ROOT = harness.HERE.parent
FCNN_CELLS = {'cavity-re100-fcnn128x5': 'cavity.train.b262144', 'laplace2d-fcnn512': 'laplace2d.train.b16777216'}
LISTED = {  # what the harness listed before leaves could be declared, and the flagship's 4096^2 mix and limits
    'configs': ['cavity-re100-fcnn128x5', 'laplace2d-fcnn512'],
    'traffic': ['eval.uniform.b1048576', 'eval.uniform.b4194304', 'train.grid-noisy.b16777216',
                'train.grid-noisy.b262144', 'train.uniform.b262144'],
    'metrics': ['backward_host_ms_per_epoch.train', 'backward_ms_per_epoch.train', 'device_idle_pct.eval',
                'device_idle_pct.train', 'forward_host_ms_per_epoch.train', 'fwd_roofline_pct.eval',
                'fwd_roofline_pct.train', 'host_ms_per_epoch.train', 'launches_per_epoch.train',
                'launches_per_request.eval', 'request_mfu_pct.eval', 'step_mfu_pct.train'],
    'kernels': ['taylor_mlp', 'taylor_mlp_1h', 'taylor_mlp_streams'],
    'limits': ['cavity.eval.b1048576', 'cavity.train.b262144', 'laplace2d.train.b16777216',
               'laplace2d.train.b262144'],
}


# ---------------------------------------------------------------- the FCNN path, unchanged

def weights_before(dims, seed, device, dtype):
    """The FCNN's weights as the harness drew them before leaves could be
    declared (its ``make_layers``, flattened): one ``torch.rand`` over every
    W and b in order, then ``* 2 - 1``, then each slice ``* 1/sqrt(n_in)``."""
    g = torch.Generator(device=device)
    g.manual_seed(traffic.derive(seed, 'weights'))
    shapes = list(zip(dims[1:], dims[:-1]))
    u = torch.rand(sum(o * i + o for o, i in shapes), generator=g, device=device, dtype=dtype) * 2 - 1
    layers, k = [], 0
    for o, i in shapes:
        bound = 1.0 / math.sqrt(i)
        layers.append((u[k:k + o * i].view(o, i) * bound, u[k + o * i:k + o * i + o] * bound))
        k += o * i + o
    return [t for W, b in layers for t in (W, b)]


@pytest.mark.parametrize('seed', [2 ** 31 + 5, 7])
@pytest.mark.parametrize('config', sorted(FCNN_CELLS))
def test_an_fcnn_gets_the_weights_it_got_before(config, seed):
    cell = load(FCNN_CELLS[config])
    assert 'leaves' not in cell.cfg
    assert [leaf['init'] for leaf in cell.leaves] == [{'kind': 'uniform', 'fan_in': n} for n in cell.dims[:-1]
                                                      for _ in 'Wb']
    want = weights_before(cell.dims, seed, 'cpu', torch.float32)
    got = harness.make_params(cell, seed, 'cpu', torch.float32)
    assert len(got) == len(want) and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert [list(t.shape) for t in got] == [leaf['shape'] for leaf in cell.leaves]
    assert cell.trainable == list(range(len(got)))
    # build still takes the (W, b) pairs, the very tensors
    pairs = harness.build_weights(cell, got)
    assert len(pairs) == len(cell.dims) - 1
    assert all(W is a and b is c for (W, b), a, c in zip(pairs, got[0::2], got[1::2]))


@pytest.mark.parametrize('n', [256, 262144, 1048576])
@pytest.mark.parametrize('config', sorted(FCNN_CELLS))
def test_an_fcnn_gets_the_forward_count_it_got_before(config, n):
    cell = load(FCNN_CELLS[config])
    args = (cell.dims, cell.cfg['activation'], cell.cfg['taylor_order'], n, 4)
    assert cost.config_forward_cost(cell.cfg, n, 4) == cost.forward_cost(*args)
    # to the bit: the parent's traced_slice took bound_seconds(*forward_cost(dims, ...))[0]
    assert cost.config_bound_seconds(cell.cfg, n, 4) == cost.bound_seconds(*cost.forward_cost(*args), 4)[0]


def test_the_harness_lists_what_it_listed_before():
    found = harness.discover()
    assert found == LISTED


# ---------------------------------------------------------------- declared leaves

def test_declared_leaves_are_drawn_in_two_calls_split_in_their_order():
    specs = [{'name': 'a', 'shape': [2, 3], 'init': {'kind': 'uniform', 'fan_in': 3}, 'trainable': True},
             {'name': 'b', 'shape': [4], 'init': {'kind': 'normal', 'mean': 1.0, 'std': 2.0}, 'trainable': False},
             {'name': 'c', 'shape': [], 'init': {'kind': 'const', 'value': 0.5}, 'trainable': True},
             {'name': 'd', 'shape': [5], 'init': {'kind': 'uniform', 'bound': 0.1}, 'trainable': True},
             {'name': 'e', 'shape': [3], 'init': {'kind': 'normal', 'mean': 0.0, 'std': 1.0}, 'trainable': True}]
    cell = load('cavity.train.b262144')
    cell.cfg = dict(cell.cfg, leaves=specs)
    seed = 2 ** 31 + 40
    got = harness.make_params(cell, seed, 'cpu', torch.float64)
    g = torch.Generator().manual_seed(traffic.derive(seed, 'weights'))
    u = torch.rand(11, generator=g, dtype=torch.float64)
    z = torch.randn(7, generator=g, dtype=torch.float64)
    want = [((u[:6] * 2 - 1) * (1 / math.sqrt(3))).view(2, 3), z[:4] * 2 + 1, torch.tensor(0.5, dtype=torch.float64),
            (u[6:] * 2 - 1) * 0.1, z[4:]]
    assert all(a.shape == b.shape and torch.equal(a, b) for a, b in zip(got, want))
    assert cell.trainable == [0, 2, 3, 4]
    assert list(harness.build_weights(cell, got)) == ['a', 'b', 'c', 'd', 'e']
    cell.cfg = dict(cell.cfg, leaves=specs + [{'name': 'f', 'shape': [1], 'init': {'kind': 'xavier'},
                                               'trainable': True}])
    with pytest.raises(ValueError, match='xavier'):
        harness.make_params(cell, seed, 'cpu', torch.float64)


def test_a_weight_factorised_layer_starts_from_the_drawn_weight():
    # jaxpi's Dense with weight_fact: W drawn, s ~ N(mean, std), V = W / exp(s) by output unit
    specs = [{'name': 's', 'shape': [3], 'init': {'kind': 'normal', 'mean': 1.0, 'std': 0.1}, 'trainable': True},
             {'name': 'V', 'shape': [3, 2], 'init': {'kind': 'normal', 'mean': 0.0, 'std': 0.5, 'over_exp': 's'},
              'trainable': True},
             {'name': 'Vt', 'shape': [2, 3], 'init': {'kind': 'normal', 'mean': 0.0, 'std': 0.5, 'over_exp': 's',
                                                      'axis': 1}, 'trainable': True}]
    cell = load('cavity.train.b262144')
    cell.cfg = dict(cell.cfg, leaves=specs)
    seed = 2 ** 31 + 41
    s, V, Vt = harness.make_params(cell, seed, 'cpu', torch.float64)
    z = torch.randn(15, generator=torch.Generator().manual_seed(traffic.derive(seed, 'weights')), dtype=torch.float64)
    assert torch.equal(s, z[:3] * 0.1 + 1.0)
    assert torch.equal(V, (z[3:9] * 0.5).view(3, 2) / s.exp().view(3, 1))
    assert torch.equal(Vt, (z[9:] * 0.5).view(2, 3) / s.exp().view(1, 3))
    assert torch.allclose(torch.diag(s.exp()) @ V, (z[3:9] * 0.5).view(3, 2), rtol=1e-15, atol=0)
    for over in ['t', 'V']:  # no leaf, a leaf that is no 1-D draw of its own
        cell.cfg = dict(cell.cfg, leaves=[specs[0], dict(specs[1], init=dict(specs[1]['init'], over_exp=over))])
        with pytest.raises(ValueError, match=f"exp of '{over}'"):
            harness.make_params(cell, seed, 'cpu', torch.float64)


def linear_leaves(prefix, widths):
    """``nn.Linear`` leaves (weight, bias) of the chain ``widths``, as ``nn.Linear`` draws them."""
    return [leaf for i, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:]))
            for leaf in ({'name': f'{prefix}{i}.weight', 'shape': [n_out, n_in],
                          'init': {'kind': 'uniform', 'fan_in': n_in}, 'trainable': True},
                         {'name': f'{prefix}{i}.bias', 'shape': [n_out],
                          'init': {'kind': 'uniform', 'fan_in': n_in}, 'trainable': True})]


COMMON = {"problem": "u_xx + u_yy = -2 pi^2 sin(pi x) sin(pi y), u = 0 on the sides",
          "domain": [[0.0, 1.0], [0.0, 1.0]], "n_input_units": 2, "n_output_units": 1, "activation": "tanh",
          "dtype": "float64", "optimizer": {"name": "Adam", "lr": 0.001, "betas": [0.9, 0.999], "eps": 1e-08},
          "loss": "l2", "n_batches_valid": 0, "taylor_order": 2, "reference_block_rows": {"train": 64, "eval": 64}}
CONFIGS = {
    'poisson2d-resnet16x2': dict(COMMON, name='poisson2d-resnet16x2', hidden_units=[16, 16], leaves=[
        *linear_leaves('residual.linears.', [2, 16, 16, 1]),
        {'name': 'skip.weight', 'shape': [1, 2], 'init': {'kind': 'uniform', 'fan_in': 2}, 'trainable': True}]),
    'poisson2d-fourier8-fcnn16': dict(COMMON, name='poisson2d-fourier8-fcnn16', hidden_units=[16], n_features=8,
                                      sigma=1.0, leaves=[
        {'name': 'B', 'shape': [2, 8], 'init': {'kind': 'normal', 'mean': 0.0, 'std': 2 * math.pi},
         'trainable': False},
        *linear_leaves('fcnn.linears.', [16, 16, 1])]),
}
NETS = {
    'poisson2d-resnet16x2': "networks.Resnet(n_input_units=2, n_output_units=1, "
                            "hidden_units=tuple(cfg['hidden_units']), device=device, dtype=dtype)",
    'poisson2d-fourier8-fcnn16': "networks.FourierFCNN(n_input_units=2, n_output_units=1, "
                                 "n_features=cfg['n_features'], sigma=cfg['sigma'], "
                                 "hidden_units=tuple(cfg['hidden_units']), device=device, dtype=dtype)",
}
LOAD = "net.load_state_dict(leaves)"
BUILDER = '''
import math
from portbench import port


def build(cfg, leaves, train_generator, rng, device, dtype):
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch import networks
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.fields import diff
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.solvers import Solver2D
    net = {net}
    {load}
    zero = lambda t: 0 * t
    cond = DirichletBVP2D(0.0, zero, 1.0, zero, 0.0, zero, 1.0, zero)
    src = lambda x, y: 2 * math.pi ** 2 * F.sin(math.pi * x) * F.sin(math.pi * y)
    grid = Generator2D((8, 8), (0, 0), (1, 1), device=device, dtype=dtype)
    solver = Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2) + src(x, y)], conditions=[cond],
                      nets=[net], train_generator=train_generator or grid, valid_generator=grid,
                      optimizer=port.optimizer(cfg, net.parameters()), n_batches_valid=0, device=device, dtype=dtype,
                      generator=rng)
    return {{'solver': solver, 'net': net, 'callbacks': []}}
'''
REFERENCES = {
    'poisson2d-resnet16x2': '''
import math
import torch
from portbench.reference.plain import as_layers, d, mlp


def unpack(cfg, params):
    return {'layers': as_layers(params[:-1]), 'skip': params[-1]}


def residuals(cfg, net, x, y):
    xy = torch.cat([x, y], 1)
    u = x * (1 - x) * y * (1 - y) * (xy @ net['skip'].t() + mlp(net['layers'], xy))
    return [d(d(u, x), x) + d(d(u, y), y) + 2 * math.pi ** 2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)]
''',
    'poisson2d-fourier8-fcnn16': '''
import math
import torch
from portbench.reference.plain import as_layers, d, mlp


def unpack(cfg, params):
    return {'B': params[0], 'layers': as_layers(params[1:])}


def residuals(cfg, net, x, y):
    z = torch.cat([x, y], 1) @ net['B']
    u = x * (1 - x) * y * (1 - y) * mlp(net['layers'], torch.cat([torch.cos(z), torch.sin(z)], 1))
    return [d(d(u, x), x) + d(d(u, y), y) + 2 * math.pi ** 2 * torch.sin(math.pi * x) * torch.sin(math.pi * y)]
''',
}
MIX = {"kind": "train", "generator": {"class": "Generator2D", "grid": [16, 16], "xy_min": [0.0, 0.0],
                                      "xy_max": [1.0, 1.0], "method": "equally-spaced-noisy"},
       "check_steps": 3, "warmup_steps": 1, "trace_start": 1, "trace_steps": 2}
LIMITS = {"batch_rows": 0, "batch_outside": 0, "batch_repeats": 0, "batch_law": 10.0, "loss_gap": 1e-9,
          "grad_gap": 1e-9, "change_gap": 1e-6}
SEED = 2 ** 31 + 123


def added(tmp_path, config, net=None, load_line=LOAD):
    """A copy of the benchmark with ``config``'s cell ``<config>.train.b256``
    added as new files alone (its builder holding ``net`` loaded by
    ``load_line``); the cell, loaded from the copy."""
    pb = tmp_path / 'portbench'
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in pb.rglob('*') if p.is_file()}
    (pb / 'configs' / f'{config}.json').write_text(json.dumps(CONFIGS[config]))
    (pb / 'configs' / f'{config}.py').write_text(BUILDER.format(net=net or NETS[config], load=load_line))
    (pb / 'reference' / f'{config}.py').write_text(REFERENCES[config])
    (pb / 'traffic' / 'train.grid-noisy.b256.json').write_text(json.dumps(MIX))
    name = f'{config}.train.b256'
    (pb / 'limits' / f'{name}.json').write_text(json.dumps(LIMITS))
    bench = json.loads((ROOT / 'BENCHMARK.json').read_text())
    bench['configs'].append({"name": config, "source": "a test configuration",
                             "file": f"portbench/configs/{config}.json", "reduced": [], "why": "a test"})
    bench['workloads'].append({"name": name, "config": config, "traffic": "train.grid-noisy.b256", "chips": 1,
                               "why": "a test"})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing that was there changed
    assert config in harness.discover(pb)['configs']
    return harness.Cell.load(name, root=pb)


@pytest.mark.parametrize('config', sorted(CONFIGS))
def test_a_net_that_is_not_an_fcnn_runs_from_new_files_and_reads_correct(tmp_path, config):
    cell = added(tmp_path, config)
    assert [leaf['name'] for leaf in cell.leaves] == [leaf['name'] for leaf in CONFIGS[config]['leaves']]
    result = harness.run(cell.name, SEED, 0.2, False, device='cpu', cell=cell)
    assert result['correct'] is True, result['checks']
    assert result['attempted'] > 0 and set(result['checks']) == set(LIMITS)


FAULTS = {
    'a leaf left out': (  # the residual FCNN alone: no skip
        'poisson2d-resnet16x2',
        "networks.FCNN(n_input_units=2, n_output_units=1, hidden_units=tuple(cfg['hidden_units']), "
        "device=device, dtype=dtype)",
        "net.load_state_dict({k[9:]: v for k, v in leaves.items() if k.startswith('residual.')})",
        "no parameter for the trainable leaf 'skip.weight'"),
    'two leaves of one shape swapped': (  # the two hidden biases, both (16,)
        'poisson2d-resnet16x2', None,
        "net.load_state_dict(dict(leaves, **{'residual.linears.0.bias': leaves['residual.linears.1.bias'], "
        "'residual.linears.1.bias': leaves['residual.linears.0.bias']}))",
        r"parameter 1 \(residual.linears.0.bias\) does not hold the trainable leaf 'residual.linears.0.bias'"),
}


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_a_net_that_does_not_hold_the_leaves_makes_the_harness_raise(tmp_path, fault):
    config, net, load_line, message = FAULTS[fault]
    cell = added(tmp_path, config, net, load_line)
    with pytest.raises(ValueError, match=message):
        harness.run(cell.name, SEED, 0.2, False, device='cpu', cell=cell)


def test_a_frozen_leaf_the_program_does_not_take_makes_the_run_incorrect(tmp_path):
    # the Fourier net keeps the frequencies it drew itself in place of the harness's B
    cell = added(tmp_path, 'poisson2d-fourier8-fcnn16',
                 load_line="net.load_state_dict({k: v for k, v in leaves.items() if k != 'B'}, strict=False)")
    result = harness.run(cell.name, SEED, 0.2, False, device='cpu', cell=cell)
    assert result['correct'] is False
    assert result['checks']['loss_gap']['value'] > LIMITS['loss_gap']


def test_leaf_lists_of_unequal_length_make_the_comparison_raise(tmp_path):
    cell = added(tmp_path, 'poisson2d-fourier8-fcnn16')
    ev = harness.RUNNERS['train'](cell, SEED, 0.0, False, torch.device('cpu'), time.perf_counter())['evidence']
    assert len(ev['p0']) == 5 and len(ev['program'][1]) == len(ev['program'][2]) == 4  # B is frozen
    ref = compare.reference_train(cell, ev['p0'], ev['batches'])
    assert len(ref[1]) == len(ref[2]) == 4
    good = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], ev['program'], ref)
    assert all(good[k] <= LIMITS[k] for k in LIMITS), good
    losses, grads, final = ev['program']
    for program, reference in [((losses, grads[:-1], final), ref),  # the program's gradient one short
                               ((losses, grads, final + final[:1]), ref),  # its parameters one long
                               (ev['program'], (ref[0], ref[1], ref[2][:-1]))]:  # the reference's one short
        with pytest.raises(ValueError):
            compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], program, reference)
    with pytest.raises(ValueError, match='the program has 2 leaves, the reference 1'):
        compare.leaf_gaps(grads[:2], grads[:1])


def test_each_trainable_leaf_gradient_gap_is_read_and_judged_only_where_named(tmp_path):
    cell = added(tmp_path, 'poisson2d-fourier8-fcnn16')
    ev = harness.RUNNERS['train'](cell, SEED, 0.0, False, torch.device('cpu'), time.perf_counter())['evidence']
    ref = compare.reference_train(cell, ev['p0'], ev['batches'])
    got = compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], ev['program'], ref)
    names = [f"grad_gap.{cell.leaves[i]['name']}" for i in cell.trainable]
    assert [k for k in got if k.startswith('grad_gap.')] == names and 'grad_gap.B' not in got  # B is frozen
    assert [got[k] for k in names] == compare.leaf_gaps(ev['program'][1], ref[1])
    assert got['grad_gap'] == max(got[k] for k in names)
    assert compare.judge(got, LIMITS) == (True, {k: {'value': got[k], 'limit': v} for k, v in LIMITS.items()})
    # a leaf's own limit, once named, is judged: the worst leaf's gap cannot stand in for it
    worst = max(names, key=got.get)
    assert compare.judge(got, dict(LIMITS, **{worst: got[worst] / 2}))[0] is False
    assert compare.judge(got, dict(LIMITS, **{'grad_gap.no_such_leaf': 1.0}))[0] is False
