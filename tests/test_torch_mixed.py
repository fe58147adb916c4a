"""The PyTorch port's mixed partials (polarization) against the JAX package
and torch's double backward, in float64.

- the extraction plans equal the JAX package's arrays exactly;
- u_xy (FCNN 2-16-16-1) and u_xy, u_xz, u_yz (FCNN 3-16-16-1) agree with the
  JAX package's ``partial_entry`` and with double-backward
  ``torch.autograd`` on the plain module to 1e-10 relative;
- the four vector identities (div curl = 0, curl grad = 0, div grad =
  laplacian, curl curl = grad div - vector laplacian) on random net fields
  in cartesian, spherical and cylindrical coordinates: every side agrees
  with the JAX package to 1e-8 relative and each identity holds to 1e-8 of
  the scale of its terms;
- ``h1`` and ``h1 semi`` of a first-order 2-D residual: loss and gradients
  to 1e-10, one network pass per batch;
- every network and activation rule runs in a polarization context: u_xy
  of each network equals torch's double backward to 1e-10;
- a mixed partial of total order 3 equals the JAX package's and triple backward.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, losses as JL, operators as JO
from neurodiffeq_tpu.conditions import NoCondition as JNoCondition
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.ops.taylor import _extraction_plan as jax_plan
from neurodiffeq_tpu_torch import fields as F, losses as L, operators as O
from neurodiffeq_tpu_torch.conditions import NoCondition
from neurodiffeq_tpu_torch.networks import APTx, FCNN, FourierFCNN, MonomialNN, Resnet, SinActv, SIREN, Swish
from neurodiffeq_tpu_torch.ops.taylor import _extraction_plan
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10


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


def _nets(n_in, n, hidden, seed):
    """``n`` JAX tanh nets, their float64 parameters, and the port's nets loaded with them."""
    jnets, params, tnets = [], [], []
    for k in range(n):
        jnet = JFCNN(n_in, 1, hidden_units=hidden)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed + k)))
        jnets.append(jnet), params.append(p)
        tnets.append(FCNN(n_in, 1, hidden_units=hidden).load_jax_params(jax.tree.map(np.asarray, p)))
    return jnets, params, tnets


@pytest.mark.parametrize('m,n', [(2, 2), (3, 2), (2, 3), (3, 3)])
def test_extraction_plan_equals_jax(m, n):
    if n < m:  # no partial of order n has all m axes in its support: both packages refuse the plan
        for plan in (_extraction_plan, jax_plan):
            with pytest.raises(np.linalg.LinAlgError):
                plan(m, n)
        return
    got, want = _extraction_plan(m, n), jax_plan(m, n)
    assert got[0] == want[0] and got[1] == want[1]
    for a, b in zip(got[2:], want[2:], strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)


PAIRS = {2: [(0, 1)], 3: [(0, 1), (0, 2), (1, 2)]}


@pytest.mark.parametrize('d', [2, 3])
def test_mixed_partials_match_jax_and_double_backward(d):
    jnets, params, tnets = _nets(d, 1, (16, 16), seed=d)
    pts = np.random.RandomState(d).rand(40, d) * 2 - 1

    def mixed(diff, coords, u):
        return [diff(diff(u, coords[a]), coords[b]) for a, b in PAIRS[d]]

    @jax.jit
    def jax_values(p):
        coords = JF.coords_from_points(p)
        return [f.value for f in mixed(JF.diff, coords, JNoCondition().enforce(jnets[0], params[0], *coords))]

    coords = F.coords_from_points(torch.tensor(pts))
    F.reset_taylor_fallback_count()
    got = [f.value for f in mixed(F.diff, coords, NoCondition().enforce(tnets[0], *coords))]
    assert F.taylor_fallback_count() == 0
    leaf = torch.tensor(pts, requires_grad=True)
    (g,) = torch.autograd.grad(tnets[0](leaf).sum(), leaf, create_graph=True)
    hess = [torch.autograd.grad(g[:, a].sum(), leaf, retain_graph=True)[0] for a in range(d)]
    for (a, b), t, j in zip(PAIRS[d], got, jax_values(jnp.asarray(pts)), strict=True):
        _close(t, j)
        _close(t[:, 0], hess[a][:, b])


NETWORKS = {
    'fcnn sin': lambda: FCNN(2, 1, hidden_units=(8, 8), actv=SinActv),
    'swish': lambda: FCNN(2, 1, hidden_units=(8,), actv=lambda: Swish(beta=1.3, trainable=True)),
    'aptx': lambda: FCNN(2, 1, hidden_units=(8,), actv=lambda: APTx(trainable=True)),
    'resnet': lambda: Resnet(2, 1, hidden_units=(8,)),
    'fourier': lambda: FourierFCNN(2, 1, n_features=4, sigma=0.5, hidden_units=(8,)),
    'siren': lambda: SIREN(2, 1, hidden_units=(8, 8), w0=3.0),
    'monomial': lambda: MonomialNN(3),
}


@pytest.mark.parametrize('name', list(NETWORKS))
def test_every_network_rule_runs_in_a_polarization_context(name):
    torch.manual_seed(1)
    net = NETWORKS[name]()
    pts = torch.rand(12, 2, dtype=torch.float64) + 0.2
    x, y = F.coords_from_points(pts)
    u = F.network_field(net, (x, y)).sum(axis=1)
    got = F.diff(F.diff(u, x), y).value[:, 0]
    leaf = pts.clone().requires_grad_()
    (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
    (hx,) = torch.autograd.grad(g[:, 0].sum(), leaf)
    # relative to the second partials: u_xy of the separable monomials is 0
    assert (got - hx[:, 1]).abs().max() <= TOL * hx.abs().max()


# --------------------------------------------------------- vector identities

def _points(system, n, seed):
    rng = np.random.RandomState(seed)
    if system == 'cartesian':
        return rng.rand(n, 3) * 2 - 1
    first = rng.rand(n) + 0.5
    if system == 'spherical':
        return np.stack([first, rng.rand(n) * np.pi * 0.9 + 0.05, rng.rand(n) * 2 * np.pi], axis=1)
    return np.stack([first, rng.rand(n) * 2 * np.pi, rng.rand(n) * 2 - 1], axis=1)


def _ops(ops, system):
    """(grad, div, curl, laplacian, vector laplacian) of one coordinate system."""
    if system == 'cartesian':
        return (ops.grad, ops.div, ops.curl, ops.laplacian, ops.vector_laplacian)
    p = 'spherical_' if system == 'spherical' else 'cylindrical_'
    return tuple(getattr(ops, p + name) for name in ('grad', 'div', 'curl', 'laplacian', 'vector_laplacian'))


def _identity(ops, system, name, us, coords):
    """(left sides, right sides) of the identity on the vector field ``us``
    (its first component is the scalar field of the gradient identities)."""
    grad, div, curl, lap, vlap = _ops(ops, system)
    if name == 'div curl':
        return [div(*curl(*us, *coords), *coords)], None
    if name == 'curl grad':
        return list(curl(*grad(us[0], *coords), *coords)), None
    if name == 'div grad':
        return [div(*grad(us[0], *coords), *coords)], [lap(us[0], *coords)]
    gd = grad(div(*us, *coords), *coords)
    return list(curl(*curl(*us, *coords), *coords)), [g - v for g, v in zip(gd, vlap(*us, *coords))]


@pytest.mark.parametrize('name', ['div curl', 'curl grad', 'div grad', 'curl curl'])
@pytest.mark.parametrize('system', ['cartesian', 'spherical', 'cylindrical'])
def test_identities_match_jax(system, name):
    jnets, params, tnets = _nets(3, 3, (8,), seed=60)
    pts = _points(system, 25, 61)

    def build(ops, coords, us):
        lhs, rhs = _identity(ops, system, name, us, coords)
        return lhs + (rhs or [])

    @jax.jit
    def jax_values(p):
        coords = JF.coords_from_points(p)
        us = [JNoCondition().enforce(n, q, *coords) for n, q in zip(jnets, params)]
        return [f.value for f in build(JO, coords, us)]

    coords = F.coords_from_points(torch.tensor(pts))
    us = [NoCondition().enforce(n, *coords) for n in tnets]
    F.reset_taylor_fallback_count()
    lhs, rhs = _identity(O, system, name, us, coords)
    got = [f.value.detach().numpy() for f in lhs + (rhs or [])]
    assert F.taylor_fallback_count() == 0
    # the scale of the identity's terms: the fields' second partials
    scale = max(F.diff(u, c, 2).value.abs().max().item() for u in us for c in coords)
    for t, j in zip(got, jax_values(jnp.asarray(pts)), strict=True):
        assert np.abs(t - np.asarray(j)).max() <= 1e-8 * scale
    for k, left in enumerate(got[:len(lhs)]):
        assert np.abs(left - (got[len(lhs) + k] if rhs else 0)).max() <= 1e-8 * scale


# ----------------------------------------------------------------- H1 losses

def _residual(ops, u, x, y):
    """A first-order residual over (x, y): its gradient holds u_xy."""
    gx, gy = ops.grad(u, x, y)
    return gx + x * gy - u * y


@pytest.mark.parametrize('loss', ['h1', 'h1 semi'])
def test_h1_of_a_first_order_2d_residual_matches_jax(loss, monkeypatch):
    jnets, params, tnets = _nets(2, 1, (16, 16), seed=70)
    pts = np.random.RandomState(71).rand(33, 2) * 2 - 1

    def jloss(ps):
        x, y = JF.coords_from_points(jnp.asarray(pts))
        u = JNoCondition().enforce(jnets[0], ps[0], x, y)
        return JL._losses[loss](_residual(JO, u, x, y), [u], [x, y])

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    calls = []
    real = FCNN.taylor_apply
    monkeypatch.setattr(FCNN, 'taylor_apply',
                        lambda self, s, ctx: calls.append((ctx.is_axes, ctx.order)) or real(self, s, ctx))
    x, y = F.coords_from_points(torch.tensor(pts))
    u = NoCondition().enforce(tnets[0], x, y)
    tval = L._losses[loss](_residual(O, u, x, y), [u], [x, y])
    tval.backward()
    # one pass on the axes at order 2, and one on the polarization direction (x + y) / sqrt 2
    assert sorted(calls) == [(False, 2), (True, 2)]
    _close(tval, jval)
    for lin, lp in zip(tnets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


def test_total_order_3_raises():
    """A mixed partial of total order 3 (which raised before orders >= 3 were
    ported) equals the JAX package's and torch's triple backward to 1e-10."""
    jnets, params, (net,) = _nets(2, 1, (8,), seed=80)
    pts = np.random.RandomState(80).rand(5, 2)
    x, y = F.coords_from_points(torch.tensor(pts))
    u = NoCondition().enforce(net, x, y)
    got = F.diff(F.diff(u, x, 2), y).value
    jx, jy = JF.coords_from_points(jnp.asarray(pts))
    _close(got, JF.diff(JF.diff(JNoCondition().enforce(jnets[0], params[0], jx, jy), jx, 2), jy).value)
    leaf = torch.tensor(pts, requires_grad=True)
    (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
    (gx,) = torch.autograd.grad(g[:, 0].sum(), leaf, create_graph=True)
    (gxx,) = torch.autograd.grad(gx[:, 0].sum(), leaf)
    _close(got[:, 0], gxx[:, 1])
