"""The public surface of the PyTorch port's ``ops`` package against the JAX
package's, on the CPU in float64.

``neurodiffeq_tpu_torch.ops`` exports the JAX package's names (the Taylor
engine and the kernel switch) plus ``pallas_config``, each the port's own
object. A custom Taylor rule written once against the JAX package's
documented API (``trule(ctx) -> TSeries``, ``elementwise_series``,
``concat_series`` and ``sum_series`` with their JAX arguments,
``constant_series``, ``ctx.stacked``) gives a 2-D field whose value and
order-2 series equal the JAX package's. ``fcnn_taylor_pallas`` takes the
JAX calling convention and equals the JAX package's Pallas kernel run in
interpret mode in the cases of ``tests/test_pallas_mlp.py``, gradients
included. After ``disable_pallas()`` an FCNN and a SIREN go layer by layer
(no fused call) and equal both the JAX package with Pallas off and the
port's fused path. Tolerance 1e-12 relative to the largest entry: both
sides do the same float64 arithmetic in other orders. The switch never
sends a CUDA tensor to a twin: the checks that decide it raise for a
tensor on the card where the switch asks for the twin or the layer-by-layer
path.

The switch is global to the process in both packages, so the fixture puts
both back as they were around every test.
"""
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import neurodiffeq_tpu.ops as jops
from neurodiffeq_tpu import fields as JF, networks as JN
from neurodiffeq_tpu.conditions import NoCondition as JNoCondition
from neurodiffeq_tpu.ops import pallas_mlp as jpallas, taylor as jtaylor
import neurodiffeq_tpu_torch.ops as ops
from neurodiffeq_tpu_torch import fields as F, networks as N
from neurodiffeq_tpu_torch.conditions import NoCondition
from neurodiffeq_tpu_torch.ops import taylor, taylor_mlp
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
TOL = 1e-12
EXPORTS = {'TSeries': taylor, 'TContext': taylor, 'teval': taylor, 'elementwise_series': taylor,
           'constant_series': taylor, 'enable_pallas': taylor_mlp, 'disable_pallas': taylor_mlp,
           'pallas_enabled': taylor_mlp, 'pallas_config': taylor_mlp, 'fcnn_taylor_pallas': taylor_mlp}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU, and each
    starts and ends with the kernel switch at its default."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    jax_config = jpallas.pallas_config()
    ops.enable_pallas()
    yield
    ops.enable_pallas()
    jpallas._CONFIG.update(jax_config)
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _close(got, want, tol=TOL):
    got, want = (x.detach().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# ------------------------------------------------------------ the names
@pytest.mark.parametrize('name', sorted(EXPORTS))
def test_export_is_the_ports_own_definition(name):
    assert getattr(ops, name) is getattr(EXPORTS[name], name)
    assert getattr(ops, name).__module__.startswith('neurodiffeq_tpu_torch.')


def test_all_is_the_jax_packages_plus_pallas_config():
    assert ops.__all__ == jops.__all__ + ['pallas_config']
    assert set(ops.__all__) == set(EXPORTS)


def test_switch_is_on_in_a_fresh_process():
    code = ('import neurodiffeq_tpu_torch.ops as o; '
            'print(o.pallas_enabled(), o.pallas_config() == {"enabled": True, "interpret": False})')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert out == ['True', 'True']


def test_switch_follows_the_jax_semantics():
    config = ops.pallas_config()
    config['enabled'] = False  # a copy: the switch does not move
    assert ops.pallas_enabled() and ops.pallas_config()['enabled']
    ops.disable_pallas()
    assert not ops.pallas_enabled()
    assert ops.pallas_config() == {'enabled': False, 'interpret': False}
    ops.enable_pallas(interpret=True, tile=64)
    assert ops.pallas_config() == {'enabled': True, 'interpret': True}
    jpallas.enable_pallas(interpret=True, tile=64)
    assert ops.pallas_config() == {k: jpallas.pallas_config()[k] for k in ('enabled', 'interpret')}
    for bad in (0, -64, 64.0):  # tile is checked, and otherwise ignored
        with pytest.raises(ValueError, match='tile'):
            ops.enable_pallas(tile=bad)
        with pytest.raises(ValueError, match='tile'):
            ops.fcnn_taylor_pallas(torch.rand(4, 2, dtype=torch.float64),
                                   [{'W': torch.ones(2, 1, dtype=torch.float64), 'b': torch.zeros(1, dtype=torch.float64)}],
                                   1, 2, tile=bad)
    assert ops.pallas_config() == {'enabled': True, 'interpret': True}


# (what the switch asks for, the check, what a CUDA tensor must get)
CARD_RULES = [
    ('kernels-on', lambda t: taylor_mlp._use_kernels(t), True),
    ('kernels-off', lambda t: ops.disable_pallas() or taylor_mlp._use_kernels(t), 'disable_pallas'),
    ('entry-launches', lambda t: taylor_mlp._runs_twin(t, 'fcnn_taylor', False), False),
    ('entry-interpreted', lambda t: taylor_mlp._runs_twin(t, 'fcnn_taylor', True), 'interpret=True'),
]


@pytest.mark.parametrize('case,check,card', CARD_RULES, ids=[c[0] for c in CARD_RULES])
def test_card_tensors_never_reach_a_twin(case, check, card):
    """The checks read only the tensor's device: a stand-in on 'cuda' gets
    the kernel or an error, never the twin or the layer-by-layer path, which
    a CPU tensor gets."""
    on_card = SimpleNamespace(device=torch.device('cuda', 0))
    if isinstance(card, str):
        with pytest.raises(RuntimeError, match=re.escape(card)):
            check(on_card)
    else:
        assert check(on_card) is card
    assert check(torch.zeros(1)) is (case == 'kernels-on' or case.startswith('entry'))
    with pytest.raises(TypeError, match="'cpu' or 'cuda'"):
        taylor_mlp._runs_twin(torch.zeros(1, device='meta'), 'fcnn_taylor', False)


# ------------------------------------------------------------ the Taylor engine with JAX arguments
def _jax_api_rule(pkg, series_ops, xp, u_field, x_field):
    """A custom Taylor rule written once against the JAX package's
    documented API: g = sum(cat(2 tanh(u) x, u)), each derivative
    materialized over the batch in the layout the context uses."""

    def trule(ctx):
        u, x = pkg.teval(u_field, ctx), pkg.teval(x_field, ctx)
        n = ctx.points.shape[0]
        two = pkg.constant_series(2.0, ctx, n)
        prod = pkg.elementwise_series(lambda a, b, c: c * xp.tanh(a) * b, [u, x, two], ctx.order, ctx.n_dirs)
        both = series_ops.concat_series([prod, u], ctx.order, ctx.n_dirs)
        total = series_ops.sum_series(both, True)
        if ctx.stacked:  # each derivs[k] one (D, N|1, m) array
            derivs = [xp.broadcast_to(d, (ctx.n_dirs, n, 1)) for d in total.derivs]
        else:            # D-tuples of (N|1, m)
            derivs = [tuple(xp.broadcast_to(di, (n, 1)) for di in d) for d in total.derivs]
        return pkg.TSeries(total.c0, derivs)

    return trule


def _rule_family(mod, g, x, y):
    return [g] + [mod.diff(g, z, k) for z in (x, y) for k in (1, 2)]


def test_custom_rule_written_for_jax_runs_in_the_port():
    pts = np.random.RandomState(2).rand(24, 2) * 2 - 1

    jx, jy = JF.coords_from_points(jnp.asarray(pts))
    ju = JF.sin(3 * jx) * jy + jx * jx
    jg = JF.Field(lambda xs: jnp.sum(jnp.stack([2 * jnp.tanh(jnp.sin(3 * xs[0]) * xs[1] + xs[0] ** 2) * xs[0],
                                                jnp.sin(3 * xs[0]) * xs[1] + xs[0] ** 2])),
                  jx.coords, trule=_jax_api_rule(jops, jtaylor, jnp, ju, jx))

    tx, ty = F.coords_from_points(torch.tensor(pts))
    tu = F.sin(3 * tx) * ty + tx * tx

    def fn(p):
        u = torch.sin(3 * p[:, :1]) * p[:, 1:2] + p[:, :1] ** 2
        return 2 * torch.tanh(u) * p[:, :1] + u

    tg = F.Field(tx.coords, 1, fn, trule=_jax_api_rule(ops, taylor, torch, tu, tx))
    for t, j in zip(_rule_family(F, tg, tx, ty), _rule_family(JF, jg, jx, jy), strict=True):
        _close(t.value, j.value)
    assert F.taylor_fallback_count() == 0  # the rule served every derivative


def test_series_functions_take_and_check_the_jax_arguments():
    tx, ty = F.coords_from_points(torch.tensor(np.random.RandomState(3).rand(5, 2)))
    ctx = tx.coords.get_ctx(2)
    x, y = taylor.teval(tx, ctx), taylor.teval(ty, ctx)
    assert ctx.stacked and ctx.aux_for((0, 1), 2).stacked and ctx.at_order(1).stacked
    for s in (ops.elementwise_series(torch.mul, [x, y], 2, 2), taylor.concat_series([x, y], 2, 2),
              taylor.sum_series(taylor.concat_series([x, y], 2), True)):
        assert s.order == 2 and s.derivs[0].shape[0] == 2
    with pytest.raises(ValueError, match='n_dirs=3'):
        ops.elementwise_series(torch.mul, [x, y], 2, 3)
    with pytest.raises(ValueError, match='n_dirs=1'):
        taylor.concat_series([x, y], 2, 1)
    with pytest.raises(ValueError, match='keeps the column'):
        taylor.sum_series(x, False)


# ------------------------------------------------------------ fcnn_taylor_pallas
def _jax_layers(n_in, n_out, hidden, seed, actv=None):
    net = JN.FCNN(n_in, n_out, hidden_units=hidden, **({} if actv is None else {'actv': actv}))
    params = net.init(jax.random.PRNGKey(seed))
    return [{k: np.asarray(v, np.float64) for k, v in lp.items()} for lp in params['layers']]


def _torch_layers(layers, dtype=torch.float64):
    return [{k: torch.tensor(v, dtype=dtype) for k, v in lp.items()} for lp in layers]


# (case, (n_in, n_out, hidden), N, order, extra keyword arguments): tests/test_pallas_mlp.py's cases
PALLAS_CASES = [
    ('hidden-32-o2', (2, 3, (32,)), 100, 2, {}),
    ('hidden-32x16-o2', (2, 3, (32, 16)), 100, 2, {}),
    ('hidden-8x8x8-o2', (2, 3, (8, 8, 8)), 100, 2, {}),
    ('hidden-32-o1', (2, 3, (32,)), 100, 1, {}),
    ('single-linear-3-dirs', (3, 2, ()), 50, 2, {}),
    ('ragged-tile-64', (2, 1, (16,)), 173, 2, {'tile': 64}),
    ('sin', (1, 1, (16, 16)), 32, 2, {'actv': 'sin'}),
    ('float32-points', (2, 3, (32,)), 100, 2, {'points': np.float32}),
]


@pytest.mark.parametrize('case,widths,n,order,extra', PALLAS_CASES, ids=[c[0] for c in PALLAS_CASES])
def test_fcnn_taylor_pallas_matches_jax(case, widths, n, order, extra):
    extra = dict(extra)
    n_in, n_out, hidden = widths
    points_dtype = extra.pop('points', np.float64)
    layers = _jax_layers(n_in, n_out, hidden, 0, JN.SinActv if extra.get('actv') == 'sin' else None)
    pts = np.random.RandomState(1).rand(n, n_in).astype(points_dtype)
    want = jpallas.fcnn_taylor_pallas(jnp.asarray(pts), [{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers],
                                      order, n_in, interpret=True, **extra)
    got = ops.fcnn_taylor_pallas(torch.tensor(pts), _torch_layers(layers), order, n_in, **extra)
    assert len(got) == len(want) == order + 1
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float64
        _close(g, w)


def test_fcnn_taylor_pallas_gradients_match_jax():
    layers = _jax_layers(2, 1, (16, 16), 0)
    pts = np.random.RandomState(4).rand(64, 2)

    def jloss(lp):
        c0, c1, c2 = jpallas.fcnn_taylor_pallas(jnp.asarray(pts), lp, 2, 2, interpret=True)
        return ((c2.sum(0) + c0) ** 2).mean()

    want = jax.grad(jloss)([{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers])
    tl = _torch_layers(layers)
    for lp in tl:
        for v in lp.values():
            v.requires_grad_()
    c0, c1, c2 = ops.fcnn_taylor_pallas(torch.tensor(pts), tl, 2, 2)
    ((c2.sum(0) + c0) ** 2).mean().backward()
    for g, w in zip(tl, want, strict=True):
        for k in ('W', 'b'):
            _close(g[k].grad, w[k])


def test_n_dirs_other_than_the_inputs_raises_in_both_packages():
    layers = _jax_layers(2, 1, (8,), 0)
    pts = np.random.RandomState(5).rand(10, 2)
    with pytest.raises(AssertionError):
        jpallas.fcnn_taylor_pallas(jnp.asarray(pts), [{k: jnp.asarray(v) for k, v in lp.items()} for lp in layers],
                                   2, 3, interpret=True)
    with pytest.raises(ValueError, match='n_dirs=3'):
        ops.fcnn_taylor_pallas(torch.tensor(pts), _torch_layers(layers), 2, 3)


def test_fcnn_taylor_pallas_is_the_fused_entry(monkeypatch):
    """It calls ``fcnn_taylor`` (so on the card the same kernel and launch
    count); on the CPU ``interpret=True`` runs the twin, as every call does."""
    calls = []
    inner = taylor_mlp.fcnn_taylor

    def counted(points, layers, order, actv='tanh'):
        calls.append((len(layers), order, actv))
        return inner(points, layers, order, actv)

    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', counted)
    layers = _torch_layers(_jax_layers(2, 1, (8,), 0))
    ops.fcnn_taylor_pallas(torch.rand(10, 2, dtype=torch.float64), layers, 2, 2)
    ops.fcnn_taylor_pallas(torch.rand(10, 2, dtype=torch.float64), layers, 1, 2, interpret=True, actv='sin')
    assert calls == [(2, 2, 'tanh'), (2, 1, 'sin')]


# ------------------------------------------------------------ the switch in the networks
SWITCHED = {
    'fcnn': lambda: (JN.FCNN(2, 1, hidden_units=(8, 8)), N.FCNN(2, 1, hidden_units=(8, 8))),
    'siren': lambda: (JN.SIREN(2, 1, hidden_units=(8, 8), w0=5.0), N.SIREN(2, 1, hidden_units=(8, 8), w0=5.0)),
}


def _family(mod, u, x, y):
    return [u] + [mod.diff(u, z, k) for z in (x, y) for k in (1, 2)]


@pytest.mark.parametrize('kind', sorted(SWITCHED))
def test_disabled_network_goes_layer_by_layer(monkeypatch, kind):
    jnet, tnet = SWITCHED[kind]()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(6)))
    tnet.load_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float64), params))
    pts = np.random.RandomState(7).rand(40, 2)
    jpallas.disable_pallas()
    jx, jy = JF.coords_from_points(jnp.asarray(pts))
    want = [f.value for f in _family(JF, JNoCondition().enforce(jnet, params, jx, jy), jx, jy)]

    calls = []
    inner = taylor_mlp.fcnn_taylor
    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', lambda *a, **k: calls.append(1) or inner(*a, **k))

    def port_values():
        tx, ty = F.coords_from_points(torch.tensor(pts))
        return [f.value for f in _family(F, NoCondition().enforce(tnet, tx, ty), tx, ty)]

    ops.disable_pallas()
    plain = port_values()
    assert calls == [] and F.taylor_fallback_count() == 0
    ops.enable_pallas()
    fused = port_values()
    assert calls  # one fused call per context order the family reads
    for p, f, w in zip(plain, fused, want, strict=True):
        _close(p, w)
        _close(p, f)
