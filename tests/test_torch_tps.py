"""The PyTorch port's irregular-domain toolkit (``pde.py``: MacFall's
length-factor thin-plate splines) against the JAX package's, in float64.

The spline fit is the JAX package's numpy solve, so the weights agree bit
for bit; the torch evaluation on Fields equals the numpy one. On the
hexagram of ``tests/test_pde_irregular.py`` (Dirichlet on one half,
Neumann on the other), ``CustomBoundaryCondition.enforce`` of a tanh net
carrying the JAX parameters gives the JAX package's value, first and second
derivatives to 1e-10 relative (the Neumann term differentiates the
network, so the second derivatives take it to order 3), and ``in_domain``
gives its mask. The port of ``test_arbitrary_boundary`` (an ELU net, which
has no Taylor rule, through ``solve2D`` for one epoch) meets the anchors of
``BASELINE.md``: the Dirichlet control points within 1e-4, the normal
derivatives at the Neumann control points within 1e-2.
"""
import warnings

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from neurodiffeq_tpu import fields as JF, pde as JP
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu_torch import diff, fields as F, pde as P
from neurodiffeq_tpu_torch.generators import PredefinedGenerator
from neurodiffeq_tpu_torch.monitors import Monitor2D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

from chip_smoke import hexagram
from test_pde_irregular import _build_cbc

matplotlib.use('Agg')
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    plt.close('all')
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _random_points(n, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 2))


def _hexagram(mod):
    """The hexagram (chip_smoke.py's, phase 5q) in package ``mod``'s ``pde``
    module: the condition and the Dirichlet and Neumann control points on it."""
    cbc, dirichlet, neumann, _ = hexagram(mod)
    return cbc, dirichlet, neumann


def _solution_analytical(x, y):
    return np.log(1 + x ** 2 + y ** 2)


def test_hexagram_is_the_anchor_of_the_jax_tests():
    want, want_d, want_n = _build_cbc()
    got, got_d, got_n = _hexagram(JP)
    for a, b in [(got_d, want_d), (got_n, want_n), (got.dirichlet_control_points, want.dirichlet_control_points),
                 (got.neumann_control_points, want.neumann_control_points)]:
        assert [repr(p) for p in a] == [repr(p) for p in b]


def test_spline_fits_equal_jax_bit_for_bit():
    centers = _random_points(17, seed=0)
    targets = np.stack([np.sin(centers[:, 0]), centers.prod(axis=1)], axis=1)
    for args in [(centers, targets), (centers, targets[:, 0], 0.3)]:
        js, ts = JP._ThinPlateSpline(*args), P._ThinPlateSpline(*args)
        assert np.array_equal(ts.kernel_weights, js.kernel_weights) and np.array_equal(ts.affine, js.affine)
        assert ts.n_outputs == js.n_outputs
    jcbc, _, _ = _hexagram(JP)
    tcbc, _, _ = _hexagram(P)
    for name in ('a_d_interp', 'l_d_interp', 'g_interp', 'l_m_interp', 'n_hat_interp'):
        js, ts = getattr(jcbc, name).spline, getattr(tcbc, name).spline
        assert np.array_equal(ts.kernel_weights, js.kernel_weights) and np.array_equal(ts.affine, js.affine)
    assert [p.loc for p in tcbc.dirichlet_control_points] == [p.loc for p in jcbc.dirichlet_control_points]
    assert [p.loc for p in tcbc.neumann_control_points] == [p.loc for p in jcbc.neumann_control_points]


def test_field_path_equals_numpy_path():
    cps = [P.DirichletControlPoint(loc=p, val=np.hypot(*p)) for p in _random_points(10, seed=4)]
    ncps = [P.NeumannControlPoint(loc=(np.cos(t), np.sin(t)), val=0.0, normal_vector=(np.cos(t), 2 * np.sin(t)))
            for t in np.linspace(0, 2 * np.pi, 12, endpoint=False)]
    probe = _random_points(25, seed=5)
    xf, yf = F.coordinates(probe[:, 0], probe[:, 1])
    for interp in (P.InterpolatorCreator.fit_surface(cps), P.InterpolatorCreator.fit_length_factor(cps),
                   P.InterpolatorCreator.fit_normal_vector(ncps)):
        via_field = interp.interpolate((xf, yf))
        via_np = interp.interpolate_np((probe[:, 0], probe[:, 1]))
        for f, a in zip(via_field if isinstance(via_field, tuple) else [via_field],
                        via_np if isinstance(via_np, tuple) else [via_np], strict=True):
            assert f.shape == (25, 1)
            np.testing.assert_allclose(f.value.numpy().ravel(), a, rtol=1e-12, atol=1e-12)
        # numpy coordinates take the numpy path
        got = interp.interpolate((probe[:, 0], probe[:, 1]))
        for g, a in zip(got if isinstance(got, tuple) else [got], via_np if isinstance(via_np, tuple) else [via_np]):
            assert np.array_equal(g, a)
    # the weights are cast once per (device, dtype)
    spline = P.InterpolatorCreator.fit_surface(cps).spline
    pts = torch.tensor(probe)
    spline.formula(pts)
    cached = spline._tensors[(pts.device, pts.dtype)]
    spline.formula(pts.float())
    assert spline._tensors[(pts.device, pts.dtype)] is cached and len(spline._tensors) == 2


def test_control_point_ordering_follows_jax():
    # clockwise from the +x axis
    seq = [(1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1)]
    pts = [P.DirichletControlPoint(loc=p, val=0.0) for p in reversed(seq)]
    cleaned = P.CustomBoundaryCondition._clean_control_points(pts, P.Point((0, 0)))
    assert [p.loc for p in cleaned] == [(float(x), float(y)) for x, y in seq]
    # a hair above the +x axis sorts first
    pts = [P.DirichletControlPoint(loc=(0.5, -0.5), val=0.0), P.DirichletControlPoint(loc=(1.0, 1e-9), val=0.0)]
    assert P.CustomBoundaryCondition._clean_control_points(pts, P.Point((0, 0)))[0].loc == (1.0, 1e-9)
    # adjacent near-duplicates are dropped
    thetas = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts = [P.DirichletControlPoint(loc=(np.cos(t), np.sin(t)), val=0.0) for t in thetas]
    dup = P.DirichletControlPoint(loc=(pts[3].loc[0] + 1e-9, pts[3].loc[1]), val=0.0)
    assert len(P.CustomBoundaryCondition._clean_control_points(pts + [dup], P.Point((0, 0)))) == 8
    assert repr(P.NeumannControlPoint((1, 2), 0.5, (3, 4))) == repr(JP.NeumannControlPoint((1, 2), 0.5, (3, 4)))
    assert (P.ROUND_TO_ZERO, P.K, P.ALPHA) == (JP.ROUND_TO_ZERO, JP.K, JP.ALPHA)


def test_enforce_and_its_derivatives_match_jax_on_the_hexagram():
    jcbc, _, _ = _hexagram(JP)
    tcbc, _, _ = _hexagram(P)
    jnet = JFCNN(2, 1, hidden_units=(16, 16))
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(0)))
    tnet = FCNN(2, 1, hidden_units=(16, 16)).load_jax_params(jax.tree.map(np.asarray, jparams))
    pts = np.random.default_rng(0).uniform(-0.8, 0.8, (64, 2))

    @jax.jit
    def jax_values(params, x, y):
        xf, yf = JF.coordinates(x, y)
        u = jcbc.enforce(jnet, params, xf, yf)
        d = JF.diff
        return [f.value for f in (u, d(u, xf), d(u, yf), d(u, xf, 2), d(u, yf, 2), d(d(u, xf), yf))]

    want = jax_values(jparams, jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, 1]))
    xf, yf = F.coordinates(pts[:, 0], pts[:, 1])
    u = tcbc.enforce(tnet, xf, yf)
    fields = (u, diff(u, xf), diff(u, yf), diff(u, xf, 2), diff(u, yf, 2), diff(diff(u, xf), yf))
    for f in reversed(fields):  # the deepest first: one Taylor context of order 3 serves all
        f.value
    assert F.taylor_fallback_count() == 0
    for f, w in zip(fields, want, strict=True):
        w = np.asarray(w)
        assert np.abs(f.value.detach().numpy() - w).max() / np.abs(w).max() < 1e-10
    grid = np.meshgrid(np.linspace(-1.2, 1.2, 25), np.linspace(-1.2, 1.2, 25))
    mask = tcbc.in_domain(*grid)
    assert mask.dtype == bool and 0 < mask.sum() < mask.size
    assert np.array_equal(mask, np.asarray(jcbc.in_domain(*grid)))


def test_dirichlet_exact_with_an_untrained_net():
    thetas = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    cps = [P.DirichletControlPoint(loc=(np.cos(t), np.sin(t)), val=np.sin(3 * t)) for t in thetas]
    cbc = P.CustomBoundaryCondition(P.Point((0, 0)), cps)
    assert cbc.a_m(FCNN(2, 1), None) == 0.0  # no Neumann points: no correction
    xf, yf = F.coordinates(np.cos(thetas), np.sin(thetas))
    u = cbc.enforce(FCNN(n_input_units=2, hidden_units=(8,)), xf, yf).value.detach().numpy().ravel()
    np.testing.assert_allclose(u, [p.val for p in cps], atol=1e-5)


class ELU(nn.Module):
    """An activation with no Taylor rule: the enforced solution composes."""

    def forward(self, x):
        return torch.nn.functional.elu(x)


def test_arbitrary_boundary():
    cbc, dirichlet_cps, neumann_cps = _hexagram(P)

    def get_grid(n):
        return np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n))

    xx_train, yy_train = get_grid(28)
    mask = cbc.in_domain(xx_train, yy_train)
    train_gen = PredefinedGenerator(xx_train[mask], yy_train[mask])
    xx_valid, yy_valid = get_grid(10)
    mask_v = cbc.in_domain(xx_valid, yy_valid)
    valid_gen = PredefinedGenerator(xx_valid[mask_v], yy_valid[mask_v])

    def rmse(u, x, y):
        return torch.mean((u - torch.log(1 + x ** 2 + y ** 2)) ** 2) ** 0.5

    def de_problem_c(u, x, y):
        return (diff(u, x, order=2) + diff(u, y, order=2) + F.exp(u)
                - 1.0 - x ** 2 - y ** 2 - 4.0 / (1.0 + x ** 2 + y ** 2) ** 2)

    torch.manual_seed(0)
    net = FCNN(n_input_units=2, hidden_units=(100, 100), actv=ELU)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        solution, history = P.solve2D(
            pde=de_problem_c, condition=cbc, xy_min=(-1, -1), xy_max=(1, 1),
            train_generator=train_gen, valid_generator=valid_gen, net=net, max_epochs=1,
            monitor=Monitor2D(check_every=1, xy_min=(-1, -1), xy_max=(1, 1), valid_generator=valid_gen),
            metrics={'rmse': rmse})
    assert set(history) == {'train_loss', 'valid_loss', 'train__rmse', 'valid__rmse'}

    # Dirichlet control points: exact by the spline's construction
    xs = np.array([p.loc[0] for p in dirichlet_cps])
    ys = np.array([p.loc[1] for p in dirichlet_cps])
    us = solution(xs, ys, to_numpy=True)
    assert np.isclose(us, _solution_analytical(xs, ys), atol=1e-4).all()

    # Neumann control points: the normal derivative
    xs = np.array([p.loc[0] for p in neumann_cps])
    ys = np.array([p.loc[1] for p in neumann_cps])
    nxs = np.array([p.normal_vector[0] for p in neumann_cps])
    nys = np.array([p.normal_vector[1] for p in neumann_cps])
    xf, yf = F.coordinates(xs, ys)
    uf = solution.conditions[0].enforce(solution.nets[0], xf, yf)
    normal_derivative = (nxs[:, None] * diff(uf, xf).value.detach().numpy()
                         + nys[:, None] * diff(uf, yf).value.detach().numpy()).ravel()
    assert np.isclose(normal_derivative, [p.val for p in neumann_cps], atol=1e-2).all()
