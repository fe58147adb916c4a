"""The PyTorch port's compose path and the rest of ``fields.py`` against the
JAX package, in float64.

- a field without a Taylor rule composes (repeated ``torch.autograd.grad`` on its
  batched function) and counts one fallback: ``pin`` and its derivatives,
  ``scalar_field``, ``where``; every value equals the JAX package's; a
  field named twice in one formula is evaluated once;
- ``coordinates``, ``composite``, the lifted ``power``, ``maximum`` and
  ``minimum``, ``safe_diff``/``unsafe_diff``, ``set_diff_method`` (its three
  methods agree) and the ``neurodiffeq`` module alias;
- ``eval_mode('compose')`` equals Taylor mode on the operator suite, and a
  solver's loss and gradients under it equal the JAX package's;
- the fallback counts of the heat variants: 0 with Dirichlet ends, 2 per
  residual with a Neumann end, as in the JAX package;
- ``Field.mean(axis=...)``, ``abs``, the comparisons, ``reshape``, ``max``
  and ``min`` behave as the JAX package's (fault F5), and ``torch.exp`` of a
  field still raises.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import neurodiffeq_tpu_torch
from neurodiffeq_tpu import fields as JF, operators as JO
from neurodiffeq_tpu.conditions import IBVP1D as JIBVP1D, NoCondition as JNoCondition
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import Solver2D as JSolver2D
from neurodiffeq_tpu_torch import fields as F, operators as O
from neurodiffeq_tpu_torch.conditions import IBVP1D, NoCondition
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
N = 24


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)
    F.set_diff_method('auto')


def _close(got, want, tol=TOL):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _points(seed=0, d=2):
    return np.random.RandomState(seed).rand(N, d) * 0.8 + 0.1


def _both(pts):
    """The coordinate Fields of ``pts`` in the JAX package and in the port."""
    return JF.coords_from_points(jnp.asarray(pts)), F.coords_from_points(torch.tensor(pts))


def test_field_methods_follow_jax():
    """F5: ``mean(axis=0)`` raised TypeError in the port (it took ``dim``),
    and ``abs``, the comparisons, ``reshape``, ``max`` and ``min`` were missing."""
    (jx, jy), (x, y) = _both(_points())
    ju, u = JF.cat([jx, jy * jy - 0.3]), F.cat([x, y * y - 0.3])
    for axis in (None, 0, 1):
        _close(u.mean(axis=axis), ju.mean(axis=axis))
        _close(u.max(axis=axis), ju.max(axis=axis))
        _close(u.min(axis=axis), ju.min(axis=axis))
    _close(u.abs().value, ju.abs().value)
    _close(F.diff(u[:, 1:].abs(), y).value, JF.diff(ju[:, 1:].abs(), jy).value)
    for op in ('__lt__', '__le__', '__gt__', '__ge__'):
        got = getattr(u, op)(0.1)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(getattr(ju, op)(0.1)))
        assert np.array_equal(getattr(x, op)(y).numpy(), np.asarray(getattr(jx, op)(jy)))
    assert x.reshape(-1, 1) is x and x.reshape((N, 1)) is x
    _close(u.reshape(-1), ju.reshape(-1))


def test_torch_math_on_a_field_still_raises():
    (x, y) = F.coords_from_points(torch.tensor(_points()))
    with pytest.raises(TypeError):
        torch.exp(x)
    with pytest.raises(TypeError):
        torch.sin(x * y)


def test_pin_values_and_derivatives_match_jax():
    """``pin(f, i, c, k)`` is the k-th derivative along coordinate i at c: a
    field of the other coordinates, constant in direction i; it composes."""
    (jx, jy), (x, y) = _both(_points(1))
    jf, f = jx * jx * JF.sin(jy) + jx ** 3 * jy, x * x * F.sin(y) + x ** 3 * y
    for k in (0, 1, 2):
        jg, g = JF.pin(jf, 0, 0.5, derivative_order=k), F.pin(f, 0, 0.5, derivative_order=k)
        F.reset_taylor_fallback_count()
        _close(g.value, jg.value)
        assert F.taylor_fallback_count() == 1
        assert torch.equal(F.diff(g, x).value, torch.zeros(N, 1, dtype=torch.float64))
        for order in (1, 2):
            _close(F.diff(g, y, order).value, JF.diff(jg, jy, order).value)
    _close(F.substitute(f, 1, -0.2).value, JF.substitute(jf, 1, -0.2).value)
    with pytest.raises(ValueError, match='raw coordinate'):
        F.pin(x, 0, 0.5)


def test_scalar_field_composite_and_coordinates_match_jax():
    pts = _points(2)
    jx, jy = JF.coordinates(pts[:, 0], pts[:, 1])
    x, y = F.coordinates(pts[:, 0], pts[:, 1])
    assert x.value.dtype == torch.float64 and x.shape == (N, 1)
    # a per-sample function has no Taylor rule: it composes
    js = JF.scalar_field(lambda a, b: jnp.sin(a) * b ** 2, (jx, jy))
    s = F.scalar_field(lambda a, b: torch.sin(a) * b ** 2, (x, y))
    assert s.shape == (N, 1)
    F.reset_taylor_fallback_count()
    for fs, jfs in ((s, js), (F.diff(s, x, 3), JF.diff(js, jx, 3)), (F.diff(F.diff(s, x), y, 2),
                                                                   JF.diff(JF.diff(js, jx), jy, 2))):
        _close(fs.value, jfs.value)
    assert F.taylor_fallback_count() == 3
    # composite: one fused formula, its series from a path jvp (no fallback)
    jnet = JFCNN(2, 1, hidden_units=(8,))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(3)))
    net = FCNN(2, 1, hidden_units=(8,)).load_jax_params(jax.tree.map(np.asarray, params))
    ju, u = JNoCondition().enforce(jnet, params, jx, jy), NoCondition().enforce(net, x, y)
    jc = JF.composite(lambda u_, x_, y_: jnp.exp(-u_) * jnp.sin(x_) + y_ ** 2, ju, jx, jy)
    c = F.composite(lambda u_, x_, y_: torch.exp(-u_) * torch.sin(x_) + y_ ** 2, u, x, y)
    F.reset_taylor_fallback_count()
    for fc, jfc in ((c, jc), (F.diff(c, x), JF.diff(jc, jx)), (F.diff(c, y, 3), JF.diff(jc, jy, 3))):
        _close(fc.value, jfc.value)
    assert F.taylor_fallback_count() == 0


def test_lifted_power_where_maximum_minimum_match_jax():
    (jx, jy), (x, y) = _both(_points(3))
    cases = [(JF.power(jx + jy, 3), F.power(x + y, 3)),
             (JF.power(2.0, jx * jy), F.power(2.0, x * y)),
             (JF.maximum(jx * jx, jy), F.maximum(x * x, y)),
             (JF.minimum(jx, 0.5), F.minimum(x, 0.5)),
             (JF.where(jx.value > 0.5, jx * jy, jy ** 2), F.where(x > 0.5, x * y, y ** 2))]
    for jf, f in cases:
        for order in (0, 1, 2):
            if order:
                jf, f = JF.diff(jf, jx), F.diff(f, x)
            _close(f.value, jf.value)
    # where has no rule: its value combines its operands' values, and its
    # derivative composes, as in the JAX package
    F.reset_taylor_fallback_count()
    JF.reset_taylor_fallback_count()
    F.diff(F.where(x > 0.5, x * y, y ** 2), y).value
    JF.diff(JF.where(jx.value > 0.5, jx * jy, jy ** 2), jy).value
    assert F.taylor_fallback_count() == JF.taylor_fallback_count() == 1


def test_diff_methods_agree_and_shape_checks():
    """'auto', 'jet' and 'jvp' all repeat torch.autograd.grad here: the same values,
    equal to the JAX package's."""
    (jt,), (t,) = _both(_points(4, d=1))
    js = JF.scalar_field(lambda a: jnp.tanh(a) * a ** 2, (jt,))
    s = F.scalar_field(lambda a: torch.tanh(a) * a ** 2, (t,))
    for order in (2, 3, 4):
        values = []
        for method in ('jvp', 'jet', 'auto'):
            F.set_diff_method(method)
            assert F.get_diff_method() == method
            values.append(F.diff(s, t, order).value)
        assert all(torch.equal(values[0], v) for v in values[1:])
        _close(values[0], JF.diff(js, jt, order).value)
    with pytest.raises(ValueError):
        F.set_diff_method('newton')
    (x, y) = F.coords_from_points(torch.tensor(_points(5)))
    wide = F.cat([x, y])
    with pytest.raises(ValueError):
        F.safe_diff(wide, x)
    d = F.unsafe_diff(wide, x)
    assert d.shape == (N, 2) and torch.equal(d.value, torch.tensor([[1.0, 0.0]] * N, dtype=torch.float64))
    assert neurodiffeq_tpu_torch.neurodiffeq is F
    from neurodiffeq_tpu_torch.neurodiffeq import diff
    assert diff is F.diff and neurodiffeq_tpu_torch.safe_diff is F.safe_diff


def _net_pair(d, seed):
    jnet = JFCNN(d, 1, hidden_units=(8, 8))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    return jnet, params, FCNN(d, 1, hidden_units=(8, 8)).load_jax_params(jax.tree.map(np.asarray, params))


def _operator_suite(ops, u, x, y, z):
    return ([ops.laplacian(u, x, y, z)] + list(ops.grad(u, x, y, z)) + [ops.div(*ops.grad(u, x, y, z), x, y, z)]
            + list(ops.curl(u, u * x, u * y, x, y, z)) + [ops.vector_laplacian(u, u * y, u * z, x, y, z)[0]])


def test_compose_equals_taylor_on_the_operator_suite():
    """``eval_mode('compose')`` gives Taylor mode's values on the cartesian
    operators of a network field, and the JAX package's compose values."""
    jnet, params, net = _net_pair(3, 6)
    pts = _points(6, d=3)
    coords = F.coords_from_points(torch.tensor(pts))
    taylor = [f.value for f in _operator_suite(O, NoCondition().enforce(net, *coords), *coords)]
    with F.eval_mode('compose'):
        assert F.get_eval_mode() == 'compose'
        coords = F.coords_from_points(torch.tensor(pts))
        compose = [f.value for f in _operator_suite(O, NoCondition().enforce(net, *coords), *coords)]
    assert F.get_eval_mode() == 'taylor'
    with JF.eval_mode('compose'):
        jc = JF.coords_from_points(jnp.asarray(pts))
        jax_compose = [f.value for f in _operator_suite(JO, JNoCondition().enforce(jnet, params, *jc), *jc)]
    for t, c, j in zip(taylor, compose, jax_compose, strict=True):
        _close(c, t)
        _close(c, j)
    with pytest.raises(ValueError):
        F.set_eval_mode('jet')


K, L, T = 0.3, 2.0, 1.5
VARIANTS = {'dirichlet': ('x_min_val', 'x_max_val'), 'neumann': ('x_min_prime', 'x_max_prime'),
            'dirichlet-neumann': ('x_min_val', 'x_max_prime')}


def _heat(mod, cond_cls, solver_cls, variant, **kwargs):
    cond = cond_cls(x_min=0.0, x_max=L, t_min=0.0, t_min_val=lambda x: mod.cos(np.pi / L * x),
                    **{k: (lambda t: 0 * t) for k in VARIANTS[variant]})
    return solver_cls(pde_system=lambda u, x, t: [mod.diff(u, t) - K * mod.diff(u, x, 2)], conditions=[cond],
                      xy_min=(0, 0), xy_max=(L, T), **kwargs)


@pytest.mark.parametrize('variant', list(VARIANTS))
def test_heat_fallback_counts(variant):
    """0 fallbacks with Dirichlet ends (u keeps its Taylor rule); with a
    Neumann end u is built on pinned anchors, and u_t and u_xx compose: 2
    per residual, as in the JAX package."""
    pts = _points(7) * [L, T]
    jsolver = _heat(JF, JIBVP1D, JSolver2D, variant, nets=[JFCNN(2, 1, hidden_units=(8,))])
    JF.reset_taylor_fallback_count()
    jsolver._loss_and_metrics(jsolver.params, [jnp.asarray(pts[:, :1]), jnp.asarray(pts[:, 1:])])
    tsolver = _heat(F, IBVP1D, Solver2D, variant, nets=[FCNN(2, 1, hidden_units=(8,))])
    F.reset_taylor_fallback_count()
    tsolver._loss_and_metrics([torch.tensor(pts[:, :1]), torch.tensor(pts[:, 1:])])
    assert F.taylor_fallback_count() == JF.taylor_fallback_count() == (0 if variant == 'dirichlet' else 2)


def test_compose_mode_solver_matches_jax():
    """A solver under ``eval_mode='compose'``: loss and every gradient (a
    backward through repeated ``torch.autograd.grad``) equal the JAX package's
    compose mode and the port's Taylor mode to 1e-10."""
    jnet, params, net = _net_pair(2, 8)
    jsolver = _heat(JF, JIBVP1D, JSolver2D, 'neumann', nets=[jnet], eval_mode='compose')
    pts = _points(8) * [L, T]
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jsolver._loss_and_metrics, has_aux=True))(
        [params], [jnp.asarray(pts[:, :1]), jnp.asarray(pts[:, 1:])])
    grads = []
    for mode in ('compose', None):
        tsolver = _heat(F, IBVP1D, Solver2D, 'neumann', nets=[net], eval_mode=mode)
        net.zero_grad()
        loss, _ = tsolver._loss_and_metrics([torch.tensor(pts[:, :1]), torch.tensor(pts[:, 1:])])
        loss.backward()
        _close(loss, jloss)
        grads.append([p.grad.clone() for p in net.parameters()])
    for lin, lp in zip(net.linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])
    for a, b in zip(*grads, strict=True):
        _close(a, b)


def test_compose_values_are_differentiable_in_their_inputs():
    """Points that require grad (a solution's inputs, say) reach a composed
    value's graph: d/dy of g = d/dy [pin(f_x, x = 0.5) * y] for f = x^2 sin y,
    that is sin y + y cos y, differentiates to 2 cos y - y sin y."""
    pts = torch.tensor(_points(9), requires_grad=True)
    x, y = F.coords_from_points(pts)
    g = F.diff(F.pin(x * x * F.sin(y), 0, 0.5, derivative_order=1) * y, y)
    yv = pts[:, 1:].detach()
    _close(g.value, torch.sin(yv) + yv * torch.cos(yv))
    (grad,) = torch.autograd.grad(g.value.sum(), pts)
    _close(grad[:, 1:], 2 * torch.cos(yv) - yv * torch.sin(yv))
    assert torch.equal(grad[:, 0], torch.zeros(N, dtype=torch.float64))




def test_compose_evaluates_a_field_named_twice_once():
    """A field that one formula names more than once (IBVP1D's insulated
    variant names its x_min anchor's slope twice) is evaluated once per
    composition, and the value and its derivatives still equal the JAX
    package's: g = f^2 + f for f = pin(x^2 sin y, x = 0.5, slope) = sin y."""
    (jx, jy), (x, y) = _both(_points(10))
    calls = []
    inner = x * x * F.sin(y)
    traced = F.Field(inner.coords, 1, lambda p: calls.append(1) or inner.fn(p))
    f = F.pin(traced, 0, 0.5, derivative_order=1)
    jf = JF.pin(jx * jx * JF.sin(jy), 0, 0.5, derivative_order=1)
    g, jg = f * f + f, jf * jf + jf
    _close(g.value, jg.value)
    assert len(calls) == 1
    calls.clear()
    for order in (1, 2):  # both start from g's one shared first gradient
        _close(F.diff(g, y, order).value, JF.diff(jg, jy, order).value)
    assert len(calls) == 1
