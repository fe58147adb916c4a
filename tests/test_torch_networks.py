"""The PyTorch port's networks against the JAX package, in float64.

Each network gets the JAX network's parameters through ``load_jax_params``
and both evaluate the same numpy points: the value and every first and
second pure partial of each output column agree to 1e-10 relative to the
largest entry. SIREN folds ``w0`` into its layers and reaches
``fcnn_taylor`` (the CUDA kernel's entry; its plain twin on the CPU).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, networks as JN
from neurodiffeq_tpu.conditions import NoCondition as JNoCondition
from neurodiffeq_tpu_torch import fields as F, networks as N
from neurodiffeq_tpu_torch.conditions import NoCondition
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


def _numpy_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), params)


# (name, JAX network, port network): the same architecture in both packages
NETS = {
    'fcnn-tanh': lambda: (JN.FCNN(2, 1, hidden_units=(8, 8)), N.FCNN(2, 1, hidden_units=(8, 8))),
    'fcnn-sin-2out': lambda: (JN.FCNN(2, 2, hidden_units=(6,), actv=JN.SinActv),
                              N.FCNN(2, 2, hidden_units=(6,), actv=N.SinActv)),
    'fcnn-swish-trainable': lambda: (JN.FCNN(2, 1, hidden_units=(6, 5), actv=lambda: JN.Swish(1.3, trainable=True)),
                                     N.FCNN(2, 1, hidden_units=(6, 5), actv=lambda: N.Swish(1.3, trainable=True))),
    'fcnn-swish': lambda: (JN.FCNN(2, 1, hidden_units=(6,), actv=JN.Swish),
                           N.FCNN(2, 1, hidden_units=(6,), actv=N.Swish)),
    'fcnn-aptx-trainable': lambda: (
        JN.FCNN(2, 1, hidden_units=(6, 5), actv=lambda: JN.APTx(0.9, 1.2, 0.4, trainable=True)),
        N.FCNN(2, 1, hidden_units=(6, 5), actv=lambda: N.APTx(0.9, 1.2, 0.4, trainable=True))),
    'resnet': lambda: (JN.Resnet(2, 1, hidden_units=(8,)), N.Resnet(2, 1, hidden_units=(8,))),
    'fourier': lambda: (JN.FourierFCNN(2, 1, n_features=5, sigma=0.7, hidden_units=(8,)),
                        N.FourierFCNN(2, 1, n_features=5, sigma=0.7, hidden_units=(8,))),
    'siren-1h': lambda: (JN.SIREN(2, 1, hidden_units=(16,), w0=30.0), N.SIREN(2, 1, hidden_units=(16,), w0=30.0)),
    'siren-2h': lambda: (JN.SIREN(2, 1, hidden_units=(8, 8), w0=5.0, w0_first=12.0),
                         N.SIREN(2, 1, hidden_units=(8, 8), w0=5.0, w0_first=12.0)),
    'monomial': lambda: (JN.MonomialNN([1, 2, 3]), N.MonomialNN([1, 2, 3])),
}


def _pair(name, seed=0):
    jnet, tnet = NETS[name]()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    if params is not None:
        tnet.load_jax_params(_numpy_tree(params))
    return jnet, params, tnet


def _family(mod, u, x, y):
    """Every column of u, and its first and second pure partials."""
    cols = [u[:, i] for i in range(u.shape[1])]
    return [f for c in cols for f in [c] + [mod.diff(c, z, k) for z in (x, y) for k in (1, 2)]]


@pytest.mark.parametrize('name', sorted(NETS))
def test_network_values_and_derivatives_match_jax(name):
    jnet, params, tnet = _pair(name)
    pts = np.random.RandomState(1).rand(40, 2) * 1.4 - 0.2

    @jax.jit
    def jax_values(p):
        jx, jy = JF.coords_from_points(p)
        return [f.value for f in _family(JF, JNoCondition().enforce(jnet, params, jx, jy), jx, jy)]

    tx, ty = F.coords_from_points(torch.tensor(pts))
    F.reset_taylor_fallback_count()
    fields = _family(F, NoCondition().enforce(tnet, tx, ty), tx, ty)
    for t, j in zip(fields, jax_values(jnp.asarray(pts)), strict=True):
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0
    # the plain forward agrees too
    _close(tnet(torch.tensor(pts)), jnet.apply(params, jnp.asarray(pts)))


@pytest.mark.parametrize('name', ['fcnn-swish-trainable', 'fcnn-aptx-trainable'])
def test_trainable_activation_gradients_match_jax(name):
    """The activations' scalars are parameters: the gradient of a sum of
    second derivatives reaches them as in JAX."""
    jnet, params, tnet = _pair(name, seed=3)
    pts = np.random.RandomState(2).rand(20, 2)

    def jloss(p):
        jx, jy = JF.coords_from_points(jnp.asarray(pts))
        u = JNoCondition().enforce(jnet, p, jx, jy)
        return (JF.diff(u, jx, 2).value ** 2).sum() + u.value.sum()

    jgrads = jax.jit(jax.grad(jloss))(params)
    tx, ty = F.coords_from_points(torch.tensor(pts))
    u = NoCondition().enforce(tnet, tx, ty)
    ((F.diff(u, tx, 2).value ** 2).sum() + u.value.sum()).backward()
    for actv, ja in zip(tnet.actvs, jgrads['actv'], strict=True):
        for k, g in ja.items():
            _close(getattr(actv, k).grad, g)
    for lin, lp in zip(tnet.linears, jgrads['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


@pytest.mark.parametrize('hidden,order', [((16,), 2), ((8, 8), 2), ((8, 8), 1)])
def test_siren_reaches_fcnn_taylor(monkeypatch, hidden, order):
    """SIREN's Taylor path goes through ``fcnn_taylor`` once per evaluation
    context, on w0-folded layers, with the sin activation."""
    calls = []
    real = taylor_mlp.fcnn_taylor

    def counted(points, layers, order, actv='tanh'):
        calls.append((len(layers), order, actv))
        return real(points, layers, order, actv)

    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', counted)
    net = N.SIREN(2, 1, hidden_units=hidden, w0=30.0)
    x, y = F.coords_from_points(torch.rand(17, 2, dtype=F64))
    u = F.network_field(net, (x, y))
    d = F.diff(u, x, order)
    assert torch.isfinite(d.value).all()
    assert calls == [(len(hidden) + 1, order, 'sin')]
    # a value alone (order 0) goes layer by layer
    calls.clear()
    x0, y0 = F.coords_from_points(torch.rand(5, 2, dtype=F64))
    assert F.network_field(net, (x0, y0)).value.shape == (5, 1) and calls == []


def test_siren_init_bounds():
    torch.manual_seed(0)
    net = N.SIREN(3, 2, hidden_units=(64, 64), w0=30.0, dtype=F64)
    W = [lin.weight.detach() for lin in net.linears]
    b = [lin.bias.detach() for lin in net.linears]
    bounds = [1 / 3, np.sqrt(6 / 64) / 30, np.sqrt(6 / 64) / 30]
    for w, bound in zip(W, bounds):
        assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound
    for bias, fan_in in zip(b, (3, 64, 64)):
        assert bias.abs().max() <= 1 / np.sqrt(fan_in)


def test_fourier_features_are_frozen():
    net = N.FourierFCNN(2, 1, n_features=4, hidden_units=(4,), dtype=F64)
    assert 'B' in dict(net.named_buffers()) and 'B' not in dict(net.named_parameters())
    assert 'B' in net.state_dict()


def test_monomial_width_and_warnings():
    with pytest.warns(UserWarning, match='degrees is 0'):
        N.MonomialNN([0, 1])
    with pytest.warns(UserWarning, match='Duplicate'):
        N.MonomialNN([1, 1])
    with pytest.raises(ValueError):
        N.MonomialNN([])
    x, y = F.coords_from_points(torch.rand(5, 2, dtype=F64))
    assert F.network_field(N.MonomialNN(3), (x, y)).shape == (5, 6)
