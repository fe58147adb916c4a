"""The PyTorch port's Taylor engine at orders 3 and 4 against the JAX package, in float64.

- every lifted op, pure and mixed partials of total order 3 and 4, against
  the JAX package's Taylor mode to 1e-10 (relative to the largest entry, or
  absolute below 1), and against its compose mode where its Taylor mode
  gives NaN: ``x ** 2`` at order >= 3 through ``jet``'s ``pow`` (log of the
  base), which the port's closed power rule avoids;
- every network of the port at orders 3 and 4, pure and mixed;
- H1 of the heat residual (order 3): loss and every gradient to 1e-10;
- Swish and APTx have no rule past order 2 and raise, as in the JAX
  package, and compute under ``eval_mode('compose')``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, networks as JN
from neurodiffeq_tpu.conditions import IBVP1D as JIBVP1D, NoCondition as JNoCondition
from neurodiffeq_tpu.solvers import Solver2D as JSolver2D
from neurodiffeq_tpu_torch import fields as F, networks as N
from neurodiffeq_tpu_torch.conditions import IBVP1D, NoCondition
from neurodiffeq_tpu_torch.solvers import Solver2D
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
    """|got - want| <= tol * max(max |want|, 1): relative, or absolute for
    partials that vanish (e.g. the fourth y-derivative of a cubic)."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# (axis, order) multi-indices: pure orders 3 and 4, mixed of total order 3 and 4
PARTIALS = [((0, 3),), ((1, 4),), ((0, 2), (1, 1)), ((0, 1), (1, 3)), ((0, 2), (1, 2))]

OPS = {
    'exp': lambda M, x, y: M.exp(x * y),
    'log': lambda M, x, y: M.log(1 + x * y),
    'sin': lambda M, x, y: M.sin(3 * x * y),
    'cos': lambda M, x, y: M.cos(x * y + y),
    'tan': lambda M, x, y: M.tan(x * y),
    'tanh': lambda M, x, y: M.tanh(2 * x - y),
    'sinh': lambda M, x, y: M.sinh(x * y),
    'cosh': lambda M, x, y: M.cosh(x - y),
    'sqrt': lambda M, x, y: M.sqrt(x + y * y),
    'sigmoid': lambda M, x, y: M.sigmoid(x * y - 0.3),
    'erf': lambda M, x, y: M.erf(x - y),
    'abs': lambda M, x, y: M.abs(x - 0.5) * y,
    'atan': lambda M, x, y: M.atan(x * y),
    'asin': lambda M, x, y: M.asin(x * y * 0.9),
    'acos': lambda M, x, y: M.acos(x * y * 0.9),
    'atan2': lambda M, x, y: M.atan2(x + 0.1, y - 0.5),
    'mul': lambda M, x, y: (x * x + y) * M.sin(y * x),
    'div': lambda M, x, y: (x + y) / (1 + x * y),
    'pow': lambda M, x, y: (x + y) ** 2.5,
    'int pow': lambda M, x, y: (x - y) ** 3,
    'const div': lambda M, x, y: 2.0 / (1 + x * y),
    'const pow': lambda M, x, y: 2.0 ** (x * y),
    'field pow': lambda M, x, y: (x + 1) ** (y + 0.5),
    'power': lambda M, x, y: M.power(x * y + 1, 3),
    'maximum': lambda M, x, y: M.maximum(x * x, y),
    'minimum': lambda M, x, y: M.minimum(x, y * y),
    'const maximum': lambda M, x, y: M.maximum(x * y, 0.3),
    'neg': lambda M, x, y: -(x * y) ** 3,
}


def _partial(M, u, coords, alpha):
    for ax, o in alpha:
        u = M.diff(u, coords[ax], o)
    return u


def _jax_partials(build, pts, compose=False):
    def run():
        jc = JF.coords_from_points(jnp.asarray(pts))
        u = build(jc)
        return [np.asarray(_partial(JF, u, jc, alpha).value) for alpha in PARTIALS]

    if compose:
        with JF.eval_mode('compose'):
            return run()
    return run()


def _port_partials(build, pts):
    coords = F.coords_from_points(torch.tensor(pts))
    u = build(coords)
    F.reset_taylor_fallback_count()
    out = [_partial(F, u, coords, alpha).value for alpha in PARTIALS]
    assert F.taylor_fallback_count() == 0
    return out


@pytest.mark.parametrize('name', list(OPS))
def test_lifted_ops_at_orders_3_and_4_match_jax(name):
    pts = np.random.RandomState(0).rand(20, 2) * 0.8 + 0.1
    op = OPS[name]
    got = _port_partials(lambda c: op(F, *c), pts)
    want = _jax_partials(lambda c: op(JF, *c), pts)
    if not all(np.isfinite(w).all() for w in want):  # jet's pow of a negative base ('int pow')
        want = _jax_partials(lambda c: op(JF, *c), pts, compose=True)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


def test_square_has_no_nan_at_a_nonpositive_base():
    """The JAX package's Taylor mode gives NaN for ``diff((x - 0.5) ** 2 *
    sin(x), x, 3)`` wherever the base is <= 0 (``jet``'s pow takes a log);
    the port's closed power rule gives its compose mode's value."""
    pts = np.array([[0.0], [0.5], [-0.3], [2.0]])
    (jx,) = JF.coords_from_points(jnp.asarray(pts))
    jax_taylor = np.asarray(JF.diff((jx - 0.5) ** 2 * JF.sin(jx), jx, 3).value)
    assert np.isnan(jax_taylor[:2]).all()  # the reference defect the port does not copy
    with JF.eval_mode('compose'):
        (jx,) = JF.coords_from_points(jnp.asarray(pts))
        want = np.asarray(JF.diff((jx - 0.5) ** 2 * JF.sin(jx), jx, 3).value)
    (x,) = F.coords_from_points(torch.tensor(pts))
    F.reset_taylor_fallback_count()
    got = F.diff((x - 0.5) ** 2 * F.sin(x), x, 3).value
    assert F.taylor_fallback_count() == 0
    _close(got, want)
    _close(got[3:], jax_taylor[3:])  # where the base is positive the two agree


NETS = {  # (JAX network, port network): the same architecture in both packages
    'fcnn tanh': lambda: (JN.FCNN(2, 1, hidden_units=(8, 8)), N.FCNN(2, 1, hidden_units=(8, 8))),
    'fcnn sin': lambda: (JN.FCNN(2, 2, hidden_units=(6,), actv=JN.SinActv),
                         N.FCNN(2, 2, hidden_units=(6,), actv=N.SinActv)),
    'resnet': lambda: (JN.Resnet(2, 1, hidden_units=(8,)), N.Resnet(2, 1, hidden_units=(8,))),
    'fourier': lambda: (JN.FourierFCNN(2, 1, n_features=4, sigma=0.5, hidden_units=(8,)),
                        N.FourierFCNN(2, 1, n_features=4, sigma=0.5, hidden_units=(8,))),
    'siren': lambda: (JN.SIREN(2, 1, hidden_units=(8, 8), w0=3.0), N.SIREN(2, 1, hidden_units=(8, 8), w0=3.0)),
    'monomial': lambda: (JN.MonomialNN([0, 1, 2, 3]), N.MonomialNN([0, 1, 2, 3])),
}


def _pair(name, seed=0):
    jnet, tnet = NETS[name]()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    if params is not None:
        tnet.load_jax_params(jax.tree.map(np.asarray, params))
    return jnet, params, tnet


@pytest.mark.parametrize('name', list(NETS))
def test_networks_at_orders_3_and_4_match_jax(name):
    jnet, params, tnet = _pair(name)
    pts = np.random.RandomState(1).rand(16, 2) * 1.4 - 0.2
    got = _port_partials(lambda c: NoCondition().enforce(tnet, *c).sum(axis=1), pts)
    want = _jax_partials(lambda c: JNoCondition().enforce(jnet, params, *c).sum(axis=1), pts)
    for g, w in zip(got, want, strict=True):
        _close(g, w)


def test_third_partial_matches_triple_backward():
    """diff(u, x, 3) of an FCNN equals torch's triple backward on the module."""
    _, _, net = _pair('fcnn tanh', seed=5)
    pts = torch.tensor(np.random.RandomState(5).rand(12, 2))
    x, y = F.coords_from_points(pts)
    got = F.diff(F.network_field(net, (x, y)), x, 3).value[:, 0]
    leaf = pts.clone().requires_grad_()
    (gx,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
    (gxx,) = torch.autograd.grad(gx[:, 0].sum(), leaf, create_graph=True)
    (gxxx,) = torch.autograd.grad(gxx[:, 0].sum(), leaf)
    _close(got, gxxx[:, 0])


K, L, T = 0.3, 2.0, 1.5


def _heat(mod, cond_cls, solver_cls, **kwargs):
    cond = cond_cls(x_min=0.0, x_max=L, t_min=0.0, t_min_val=lambda x: mod.sin(np.pi / L * x),
                    x_min_val=lambda t: 0 * t, x_max_val=lambda t: 0 * t)
    return solver_cls(pde_system=lambda u, x, t: [mod.diff(u, t) - K * mod.diff(u, x, 2)], conditions=[cond],
                      xy_min=(0, 0), xy_max=(L, T), loss_fn='h1', **kwargs)


def test_h1_of_the_heat_residual_matches_jax():
    """H1 of a second-order residual needs order 3: the heat loss under
    ``h1`` and every gradient agree with the JAX package to 1e-10."""
    jnet = JN.FCNN(2, 1, hidden_units=(8, 8))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(2)))
    jsolver = _heat(JF, JIBVP1D, JSolver2D, nets=[jnet])
    tsolver = _heat(F, IBVP1D, Solver2D, nets=[N.FCNN(2, 1, hidden_units=(8, 8))])
    tsolver.load_jax_params([jax.tree.map(np.asarray, params)])
    pts = np.random.RandomState(3).rand(16, 2) * [L, T]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jsolver._loss_and_metrics, has_aux=True))(
        [params], [jnp.asarray(pts[:, :1]), jnp.asarray(pts[:, 1:])])
    F.reset_taylor_fallback_count()
    tloss, _ = tsolver._loss_and_metrics([torch.tensor(pts[:, :1]), torch.tensor(pts[:, 1:])])
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    _close(tloss, jloss)
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


@pytest.mark.parametrize('actv', ['Swish', 'APTx'])
def test_swish_and_aptx_raise_past_order_2(actv):
    """No Taylor rule past order 2 (the JAX package raises IndexError there);
    under ``eval_mode('compose')`` the third derivative equals the JAX
    package's compose mode."""
    jnet = JN.FCNN(2, 1, hidden_units=(6,), actv=getattr(JN, actv))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(4)))
    tnet = N.FCNN(2, 1, hidden_units=(6,), actv=getattr(N, actv)).load_jax_params(jax.tree.map(np.asarray, params))
    pts = np.random.RandomState(4).rand(10, 2)
    x, y = F.coords_from_points(torch.tensor(pts))
    u = NoCondition().enforce(tnet, x, y)
    with pytest.raises(NotImplementedError, match=actv):
        F.diff(u, x, 3).value
    with pytest.raises(IndexError):
        jx, jy = JF.coords_from_points(jnp.asarray(pts))
        JF.diff(JNoCondition().enforce(jnet, params, jx, jy), jx, 3).value
    with F.eval_mode('compose'):
        x, y = F.coords_from_points(torch.tensor(pts))
        got = F.diff(NoCondition().enforce(tnet, x, y), x, 3).value
    with JF.eval_mode('compose'):
        jx, jy = JF.coords_from_points(jnp.asarray(pts))
        want = JF.diff(JNoCondition().enforce(jnet, params, jx, jy), jx, 3).value
    _close(got, want)
