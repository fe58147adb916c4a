"""The PyTorch port's loss registry and cartesian operators against the JAX
package, in float64 on the same numpy points and parameters (carried across
with ``load_jax_params``). Tolerance: 1e-10 relative to the largest entry.

The losses are taken on the Lotka-Volterra residual of two IVP-enforced
sin nets; the H1 norms differentiate that residual, which reaches the
fused Taylor-MLP path at order 2.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, losses as JL, operators as JO
from neurodiffeq_tpu.conditions import IVP as JIVP, NoCondition as JNoCondition
from neurodiffeq_tpu.networks import FCNN as JFCNN, SinActv as JSinActv
from neurodiffeq_tpu_torch import fields as F, losses as L, operators as O
from neurodiffeq_tpu_torch.conditions import IVP, NoCondition
from neurodiffeq_tpu_torch.networks import FCNN, SinActv
from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
F64 = torch.float64


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _nets(n_in, n, hidden, actv, seed):
    """``n`` JAX nets, their float64 parameters, and the port's nets loaded with them."""
    jnets, params, tnets = [], [], []
    for k in range(n):
        jnet = JFCNN(n_in, 1, hidden_units=hidden, actv=JSinActv if actv == 'sin' else None)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed + k)))
        tnet = FCNN(n_in, 1, hidden_units=hidden, actv=SinActv if actv == 'sin' else None)
        tnet.load_jax_params(jax.tree.map(np.asarray, p))
        jnets.append(jnet), params.append(p), tnets.append(tnet)
    return jnets, params, tnets


def _lv(mod, u, v, t):
    return mod.cat([mod.diff(u, t) - (u - u * v), mod.diff(v, t) - (u * v - v)])


LOSSES = ['l1', 'l2', 'infinity', 'h1', 'h1 semi', 'variational', 'causal']


def _loss(pkg, name):
    if name == 'causal':
        return pkg.causal(epsilon=2.0, n_bins=5)
    return pkg._losses[name]


@pytest.mark.parametrize('name', LOSSES)
def test_losses_match_jax(name):
    jnets, params, tnets = _nets(1, 2, (8, 8), 'sin', seed=0)
    ts = np.random.RandomState(0).rand(23, 1) * 5 + 0.1
    conds = [(JIVP(0.1, 1.5), IVP(0.1, 1.5)), (JIVP(0.1, 1.0, 0.5), IVP(0.1, 1.0, 0.5))]

    def jloss(ps):
        (jt,) = JF.coords_from_points(jnp.asarray(ts))
        u, v = [c[0].enforce(n, p, jt) for c, n, p in zip(conds, jnets, ps)]
        return _loss(JL, name)(_lv(JF, u, v, jt), [u, v], [jt])

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    (tt,) = F.coords_from_points(torch.tensor(ts))
    u, v = [c[1].enforce(n, tt) for c, n in zip(conds, tnets)]
    F.reset_taylor_fallback_count()
    tval = _loss(L, name)(_lv(F, u, v, tt), [u, v], [tt])
    tval.backward()
    assert F.taylor_fallback_count() == 0
    _close(tval, jval)
    for tnet, jg in zip(tnets, jgrads):
        for lin, lp in zip(tnet.linears, jg['layers']):
            _close(lin.weight.grad.T, lp['W'])
            _close(lin.bias.grad, lp['b'])


def test_linear_losses_declare_their_power():
    for name in ('l1', 'infinity', 'variational'):
        assert L._losses[name].residual_power == 1 == JL._losses[name].residual_power
    for name in ('l2', 'h1', 'h1 semi'):
        assert not hasattr(L._losses[name], 'residual_power')


def test_h1_reaches_the_fused_path_at_order_2(monkeypatch):
    orders = []
    real = taylor_mlp.fcnn_taylor

    def counted(points, layers, order, actv='tanh'):
        orders.append(order)
        return real(points, layers, order, actv)

    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', counted)
    _, _, tnets = _nets(1, 2, (8, 8), 'sin', seed=0)
    (t,) = F.coords_from_points(torch.rand(9, 1, dtype=F64))
    u, v = [IVP(0.0, 1.0).enforce(n, t) for n in tnets]
    L._losses['h1'](_lv(F, u, v, t), [u, v], [t])
    assert orders == [2, 2]


def test_causal_weights_are_detached():
    """Only the bins' losses carry gradient: the weights are constants."""
    r = torch.tensor([[1.0], [2.0], [0.5], [3.0]], dtype=F64, requires_grad=True)
    (t,) = F.coords_from_points(torch.tensor([[0.3], [0.1], [0.2], [0.4]], dtype=F64))
    loss = L.causal(epsilon=1.0, n_bins=2)(r, [], [t])
    loss.backward()
    # sorted by t: bins {2.0, 0.5} then {1.0, 3.0}; w = (1, exp(-mean(4, .25)))
    w2 = np.exp(-(4.0 + 0.25) / 2)
    want = np.array([w2 * 1.0, 2.0, 0.5, w2 * 3.0]) / 2  # d/dr of mean_i w_i mean(r^2) = w r / 2
    _close(r.grad[:, 0], want, tol=1e-14)


def _operators(mod, ops, fields3, coords):
    (ux, uy, uz), (x, y, z) = fields3, coords
    g = ops.grad(ux, x, y, z)
    return (g + [ops.div(ux, uy, uz, x, y, z), ops.div(ux, uy, x, y)]
            + list(ops.curl(ux, uy, uz, x, y, z)) + [ops.laplacian(ux, x, y, z), ops.laplacian(uy, x, z)]
            + list(ops.vector_laplacian(ux, uy, uz, x, y, z)))


@pytest.mark.parametrize('actv', ['tanh', 'sin'])
def test_cartesian_operators_match_jax(actv):
    jnets, params, tnets = _nets(3, 3, (8,), actv, seed=5)
    pts = np.random.RandomState(6).rand(31, 3) * 2 - 1

    @jax.jit
    def jax_values(p):
        coords = JF.coords_from_points(p)
        us = [JNoCondition().enforce(n, q, *coords) for n, q in zip(jnets, params)]
        return [f.value for f in _operators(JF, JO, us, coords)]

    coords = F.coords_from_points(torch.tensor(pts))
    us = [NoCondition().enforce(n, *coords) for n in tnets]
    F.reset_taylor_fallback_count()
    got = _operators(F, O, us, coords)
    want = jax_values(jnp.asarray(pts))
    assert len(got) == len(want) == 13
    for t, j in zip(got, want):
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0


def test_operators_check_their_inputs():
    x, y = F.coords_from_points(torch.rand(4, 2, dtype=F64))
    with pytest.raises(TypeError):
        O.grad(x.value, x)
    with pytest.raises(TypeError):
        O.grad(x * y, x * 1.0)
    with pytest.raises(RuntimeError):
        O.div(x, y, x)
    # a field without a Taylor rule composes when evaluated, counting one
    # fallback per derivative field (ReLU's second derivative is 0)
    relu = FCNN(2, 1, hidden_units=(4,), actv=torch.nn.ReLU)
    F.reset_taylor_fallback_count()
    assert torch.equal(O.laplacian(F.network_field(relu, (x, y)), x, y).value, torch.zeros(4, 1, dtype=F64))
    assert F.taylor_fallback_count() == 2
    F.reset_taylor_fallback_count()
