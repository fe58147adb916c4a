"""The PyTorch port's spherical path against the JAX package, in float64.

Spherical Poisson (the Gaussian-charge BASELINE config of
``benchmarks/configs.py``, cut to an FCNN 3-16-16-1 on 64 points) through
``SolverSpherical``: both solvers get the same parameters
(``BaseSolver.load_jax_params``) and the same points. Loss and every
gradient agree to 1e-10 relative; the parameters after 5 Adam steps under
the cosine schedule (optax's ``cosine_decay_schedule`` against
``torch.optim.Adam`` under a ``LambdaLR`` of the same formula) to 1e-9.
Also here: the spherical and cylindrical operators, the four spherical
conditions, ``GeneratorSpherical`` and the lifted inverse-trigonometric
functions, each against the JAX package to 1e-10.
"""
import numpy as np
import pytest
from scipy.special import erf
from scipy.stats import ks_2samp

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF, operators as JO
from neurodiffeq_tpu.conditions import (DirichletBVPSpherical as JDirichletBVPSpherical,
                                        DirichletBVPSphericalBasis as JDirichletBVPSphericalBasis,
                                        InfDirichletBVPSpherical as JInfDirichletBVPSpherical,
                                        InfDirichletBVPSphericalBasis as JInfDirichletBVPSphericalBasis,
                                        NoCondition as JNoCondition)
from neurodiffeq_tpu.function_basis import HarmonicsLaplacian as JHarmonicsLaplacian
from neurodiffeq_tpu.function_basis import RealSphericalHarmonics as JRealSphericalHarmonics
from neurodiffeq_tpu.generators import GeneratorSpherical as JGeneratorSpherical
from neurodiffeq_tpu.generators import PredefinedGenerator as JPredefinedGenerator
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import SolverSpherical as JSolverSpherical
from neurodiffeq_tpu_torch import diff, fields as F, losses as L, operators as O
from neurodiffeq_tpu_torch.conditions import (DirichletBVPSpherical, DirichletBVPSphericalBasis,
                                              InfDirichletBVPSpherical, InfDirichletBVPSphericalBasis,
                                              NoCondition)
from neurodiffeq_tpu_torch.function_basis import HarmonicsLaplacian, RealSphericalHarmonics
from neurodiffeq_tpu_torch.generators import GeneratorSpherical, PredefinedGenerator
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import SolutionSphericalHarmonics, SolverSpherical
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
F64 = torch.float64
TOL = 1e-10
N_POINTS = 64
K = 1 / (4 * np.pi)
COEFF = 1 / np.power(2 * np.pi, 1.5)
R0, R1 = 0.1, 3.0
V0, V1 = (float(K / r * erf(r / np.sqrt(2))) for r in (R0, R1))


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


def _sphere_points(n, seed, r_lo=0.5, r_hi=1.5):
    """(n, 3) points: r in [r_lo, r_hi], theta away from the poles, phi in [0, 2 pi)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.rand(n) * (r_hi - r_lo) + r_lo, rng.rand(n) * np.pi * 0.9 + 0.05 * np.pi,
                     rng.rand(n) * 2 * np.pi], axis=1)


def _nets(n_in, n_out, n, hidden, seed):
    """``n`` JAX tanh nets, their float64 parameters, and the port's nets loaded with them."""
    jnets, params, tnets = [], [], []
    for k in range(n):
        jnet = JFCNN(n_in, n_out, hidden_units=hidden)
        p = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed + k)))
        jnets.append(jnet), params.append(p)
        tnets.append(FCNN(n_in, n_out, hidden_units=hidden).load_jax_params(jax.tree.map(np.asarray, p)))
    return jnets, params, tnets


def _torch_params(net):
    return [(lin.weight.detach().numpy().T, lin.bias.detach().numpy()) for lin in net.linears]


def _cosine(steps, alpha):
    """optax's ``cosine_decay_schedule`` as a ``LambdaLR`` factor."""
    return lambda k: alpha + (1 - alpha) * 0.5 * (1 + np.cos(np.pi * min(k, steps) / steps))


# -------------------------------------------------------- spherical Poisson

def _poisson(mod, ops):
    return lambda u, r, th, ph: [ops.spherical_laplacian(u, r, th, ph) + COEFF * mod.exp(-(r ** 2) / 2)]


def _poisson_solvers(jax_optimizer=None, **kwargs):
    """The JAX and the port's solvers on the same parameters and predefined points."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if jax_optimizer is not None:
        jkw['optimizer'] = jax_optimizer
    for kw, gen in ((jkw, JPredefinedGenerator), (tkw, PredefinedGenerator)):
        for phase, seed in (('train_generator', 1), ('valid_generator', 2)):
            if phase not in kw:
                pts = _sphere_points(N_POINTS, seed, R0, R1)
                kw[phase] = gen(*pts.T)
    jsolver = JSolverSpherical(
        _poisson(JF, JO), [JDirichletBVPSpherical(R0, lambda th, ph: V0 + 0 * th, R1, lambda th, ph: V1 + 0 * th)],
        R0, R1, nets=[JFCNN(3, 1, hidden_units=(16, 16))], **jkw)
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = SolverSpherical(
        _poisson(F, O), [DirichletBVPSpherical(R0, lambda th, ph: V0 + 0 * th, R1, lambda th, ph: V1 + 0 * th)],
        R0, R1, nets=[FCNN(3, 1, hidden_units=(16, 16))], **tkw)
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    return jsolver, tsolver


PTS = _sphere_points(N_POINTS, 0, R0, R1)


def test_spherical_poisson_loss_and_gradients_match_jax():
    metrics = {'u_mean': lambda u, r, th, ph: u.mean()}
    jsolver, tsolver = _poisson_solvers(metrics=metrics)
    cols = [PTS[:, i:i + 1] for i in range(3)]
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jsolver._loss_and_metrics, has_aux=True))(
        jsolver.params, [jnp.asarray(c) for c in cols])
    F.reset_taylor_fallback_count()
    tloss, tmetrics = tsolver._loss_and_metrics([torch.tensor(c) for c in cols])
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    _close(tloss, jloss)
    _close(tmetrics['u_mean'], jmetrics['u_mean'])
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


def test_cosine_scheduled_adam_steps_match_optax():
    """5 steps under a schedule of 3: the rate holds at its floor past T."""
    steps, n_updates, alpha = 3, 5, 1e-2
    jsolver, tsolver = _poisson_solvers()
    cols = [jnp.asarray(PTS[:, i:i + 1]) for i in range(3)]
    schedule = optax.cosine_decay_schedule(1e-3, steps, alpha=alpha)
    params, opt = jsolver.params, optax.adam(schedule)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(lambda p: jsolver._loss_and_metrics(p, cols)[0]))
    for _ in range(n_updates):
        updates, state = opt.update(grad_fn(params), state, params)
        params = optax.apply_updates(params, updates)

    sched = torch.optim.lr_scheduler.LambdaLR(tsolver.optimizer, _cosine(steps, alpha))
    rates = []
    for _ in range(n_updates):
        rates.append(tsolver.optimizer.param_groups[0]['lr'])
        tsolver.optimizer.zero_grad()
        tsolver._loss_and_metrics([torch.tensor(np.asarray(c)) for c in cols])[0].backward()
        tsolver.optimizer.step()
        sched.step()
    _close(rates, [schedule(k) for k in range(n_updates)], tol=1e-15)
    assert rates[-1] == rates[-2] == pytest.approx(1e-5)
    for (W, b), lp in zip(_torch_params(tsolver.nets[0]), params[0]['layers'], strict=True):
        _close(W, lp['W'], tol=1e-9)
        _close(b, lp['b'], tol=1e-9)


def test_fit_follows_the_jax_trajectory():
    """On predefined points, ``fit`` with the schedule stepped by a callback
    gives JAX's loss histories, best parameters, solution and residuals."""
    epochs = 4
    jsolver, tsolver = _poisson_solvers(
        jax_optimizer=optax.adam(optax.cosine_decay_schedule(1e-3, 3, alpha=1e-2)))
    jsolver.fit(epochs, tqdm_file=None)
    sched = torch.optim.lr_scheduler.LambdaLR(tsolver.optimizer, _cosine(3, 1e-2))
    tsolver.fit(epochs, callbacks=[lambda s: sched.step()], tqdm_file=None)
    for key in ('train_loss', 'valid_loss'):
        _close(tsolver.metrics_history[key], jsolver.metrics_history[key], tol=1e-9)
    pts = _sphere_points(20, 9, R0, R1)
    _close(tsolver.get_solution()(*pts.T, to_numpy=True), jsolver.get_solution()(*pts.T), tol=1e-9)
    _close(tsolver.get_residuals(*pts.T, to_numpy=True), jsolver.get_residuals(*pts.T), tol=1e-8)
    internals = tsolver.get_internals()
    assert (internals['r_min'], internals['r_max'], internals['enforcer']) == (R0, R1, None)


def test_default_generators_and_net():
    solver = SolverSpherical(_poisson(F, O), [DirichletBVPSpherical(R0, lambda th, ph: V0 + 0 * th)], R0, R1)
    for phase in ('train', 'valid'):
        gen = solver.generator[phase]
        assert isinstance(gen, GeneratorSpherical)
        assert (gen.size, gen.r_min, gen.r_max, gen.method) == (512, R0, R1, 'equally-spaced-noisy')
    assert solver.nets[0].linears[0].in_features == 3 and tuple(solver.nets[0].hidden_units) == (32, 32)
    with pytest.raises(ValueError, match='r_min and r_max'):
        SolverSpherical(_poisson(F, O), [NoCondition()])


# ------------------------------------------ harmonics: radial nets, a basis

def test_harmonics_solver_matches_jax():
    """A radial net enforced through ``DirichletBVPSphericalBasis`` (the
    solver passes it ``r`` alone) against ``HarmonicsLaplacian``: loss,
    gradients and the harmonics solution agree with JAX."""
    n_comp = 9
    r_0, r_1 = np.linspace(0.0, 0.8, n_comp), np.zeros(n_comp)

    def make(solver, fields, cond, basis_lap, net, predefined):
        return solver(lambda R, r, th, ph: [basis_lap(R, r, th, ph) + COEFF * fields.exp(-(r ** 2) / 2)],
                      [cond(0.5, r_0, 1.5, r_1)], nets=[net],
                      train_generator=predefined(*PTS_H.T), valid_generator=predefined(*PTS_H.T))

    jnets, params, tnets = _nets(1, n_comp, 1, (8,), seed=3)
    jsolver = make(JSolverSpherical, JF, JDirichletBVPSphericalBasis, JHarmonicsLaplacian(2), jnets[0],
                   JPredefinedGenerator)
    jsolver.params = params
    tsolver = make(SolverSpherical, F, DirichletBVPSphericalBasis, HarmonicsLaplacian(2), tnets[0],
                   PredefinedGenerator)
    cols = [PTS_H[:, i:i + 1] for i in range(3)]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(c) for c in cols])[0]))(jsolver.params)
    F.reset_taylor_fallback_count()
    tloss = tsolver._loss_and_metrics([torch.tensor(c) for c in cols])[0]
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    _close(tloss, jloss)
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
    pts = _sphere_points(15, 11)
    want = jsolver.get_solution(best=False, harmonics_fn=JRealSphericalHarmonics(2))(*pts.T)
    got = tsolver.get_solution(best=False, harmonics_fn=RealSphericalHarmonics(2))(*pts.T, to_numpy=True)
    _close(got, want)
    with pytest.warns(FutureWarning):
        sol = SolutionSphericalHarmonics(tsolver.nets, tsolver.conditions, max_degree=2)
    _close(sol(*pts.T, to_numpy=True), want)
    with pytest.raises(ValueError, match='harmonics_fn'):
        SolutionSphericalHarmonics(tsolver.nets, tsolver.conditions)


PTS_H = _sphere_points(24, 4)


def test_enforcer_overrides_the_conditions():
    calls = []

    def enforcer(net, cond, coords):
        calls.append(len(coords))
        return cond.enforce(net, *coords)

    solver = SolverSpherical(_poisson(F, O), [DirichletBVPSpherical(R0, lambda th, ph: V0 + 0 * th)],
                             R0, R1, enforcer=enforcer, n_batches_valid=1,
                             train_generator=GeneratorSpherical(16, R0, R1),
                             valid_generator=GeneratorSpherical(16, R0, R1))
    solver.fit(1, tqdm_file=None)
    assert calls == [3, 3]


def test_harmonics_laplacian_agrees_with_the_spherical_laplacian():
    """Through a radial-net ``DirichletBVPSphericalBasis``: the basis-space
    laplacian equals ``spherical_laplacian`` of the expanded function."""
    n_comp = 9
    net = FCNN(1, n_comp, hidden_units=(8, 8))
    r, th, ph = F.coords_from_points(torch.tensor(_sphere_points(50, 12)))
    coeffs = DirichletBVPSphericalBasis(0.5, np.zeros(n_comp)).enforce(net, r)
    lap_basis = HarmonicsLaplacian(2)(coeffs, r, th, ph)
    u = (coeffs * RealSphericalHarmonics(2)(th, ph)).sum(axis=1, keepdims=True)
    lap_direct = O.spherical_laplacian(u, r, th, ph)
    _close(lap_basis.value, lap_direct.value.detach().numpy(), tol=1e-9)


# ------------------------------------------------------------- operators

def _spherical_ops(ops, us, coords):
    (ur, uth, uph), (r, th, ph) = us, coords
    return (list(ops.spherical_grad(ur, r, th, ph)) + [ops.spherical_div(ur, uth, uph, r, th, ph)]
            + list(ops.spherical_curl(ur, uth, uph, r, th, ph)) + [ops.spherical_laplacian(uth, r, th, ph)]
            + list(ops.spherical_vector_laplacian(ur, uth, uph, r, th, ph))
            + list(ops.spherical_to_cartesian(r, th, ph)) + list(ops.cartesian_to_spherical(ur, uth, uph)))


def _cylindrical_ops(ops, us, coords):
    (ur, uph, uz), (rho, ph, z) = us, coords
    return (list(ops.cylindrical_grad(ur, rho, ph, z)) + [ops.cylindrical_div(ur, uph, uz, rho, ph, z)]
            + list(ops.cylindrical_curl(ur, uph, uz, rho, ph, z)) + [ops.cylindrical_laplacian(uz, rho, ph, z)]
            + list(ops.cylindrical_vector_laplacian(ur, uph, uz, rho, ph, z))
            + list(ops.cylindrical_to_cartesian(rho, ph, z)) + list(ops.cartesian_to_cylindrical(ur, uph, uz)))


@pytest.mark.parametrize('system', ['spherical', 'cylindrical'])
def test_curvilinear_operators_match_jax(system):
    """Every operator on three shared net fields (the conversions also on
    net fields, so that atan2 and sqrt carry a series), plus the second
    r-derivative of the converted fields."""
    collect = _spherical_ops if system == 'spherical' else _cylindrical_ops
    jnets, params, tnets = _nets(3, 1, 3, (8,), seed=20)
    pts = _sphere_points(29, 21)

    def build(mod, ops, coords, us, d):
        out = collect(ops, us, coords)
        return out + [d(out[-3], coords[0], 2), d(out[-2], coords[2], 2)]

    @jax.jit
    def jax_values(p):
        coords = JF.coords_from_points(p)
        us = [JNoCondition().enforce(n, q, *coords) for n, q in zip(jnets, params)]
        return [f.value for f in build(JF, JO, coords, us, jdiff)]

    coords = F.coords_from_points(torch.tensor(pts))
    us = [NoCondition().enforce(n, *coords) for n in tnets]
    F.reset_taylor_fallback_count()
    got = build(F, O, coords, us, diff)
    want = jax_values(jnp.asarray(pts))
    assert len(got) == len(want) == 19
    for t, j in zip(got, want):
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0


def test_closed_form_laplacians():
    r, th, ph = F.coords_from_points(torch.tensor(_sphere_points(200, 13)))
    _close(O.spherical_laplacian(r ** 2, r, th, ph).value, np.full((200, 1), 6.0))
    assert O.spherical_laplacian(1 / r, r, th, ph).value.abs().max() < 1e-10
    rho, phi, z = r, ph, th
    _close(O.cylindrical_laplacian(rho ** 2, rho, phi, z).value, np.full((200, 1), 4.0))
    assert O.cylindrical_laplacian(F.log(rho), rho, phi, z).value.abs().max() < 1e-10


def test_coordinate_conversions_round_trip():
    r, th, ph = F.coords_from_points(torch.tensor(_sphere_points(200, 14)))
    r2, t2, p2 = O.cartesian_to_spherical(*O.spherical_to_cartesian(r, th, ph))
    _close(r2.value, r.value.numpy())
    _close(t2.value, th.value.numpy())
    dphi = (p2 - ph).value.numpy() % (2 * np.pi)
    assert np.minimum(dphi, 2 * np.pi - dphi).max() < 1e-10
    rho, phi, z = F.coords_from_points(torch.tensor(_sphere_points(200, 15) - [0, 0, np.pi]))
    r3, p3, z3 = O.cartesian_to_cylindrical(*O.cylindrical_to_cartesian(rho, phi, z))
    _close(r3.value, rho.value.numpy())
    _close(p3.value, phi.value.numpy())
    assert torch.equal(z3.value, z.value)


@pytest.mark.parametrize('identity', ['spherical div grad', 'spherical curl grad', 'cylindrical curl grad',
                                      'cartesian curl grad', 'h1 of a spherical residual'])
def test_identities_needing_mixed_partials_raise(identity):
    """These need mixed partials: the identities hold to 1e-10 of the scale
    of their terms, and the H1 loss of a first-order residual over (r,
    theta, phi) equals plain torch autograd's."""
    (net,) = _nets(3, 1, 1, (8,), seed=30)[2]
    pts = torch.tensor(_sphere_points(8, 31))
    coords = F.coords_from_points(pts)
    u = NoCondition().enforce(net, *coords)
    F.reset_taylor_fallback_count()
    if identity == 'h1 of a spherical residual':
        got = L._losses['h1'](O.spherical_grad(u, *coords)[1], [u], list(coords))
        leaf = pts.clone().requires_grad_()
        (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
        res = g[:, 1] / leaf[:, 0]  # u_theta / r
        (res_grad,) = torch.autograd.grad(res.sum(), leaf)
        _close(got, (torch.cat([res[:, None], res_grad], dim=1) ** 2).mean().detach())
    else:
        scale = max(diff(u, c, 2).value.abs().max().item() for c in coords)
        if identity == 'spherical div grad':
            out = [O.spherical_div(*O.spherical_grad(u, *coords), *coords) - O.spherical_laplacian(u, *coords)]
        elif identity == 'spherical curl grad':
            out = O.spherical_curl(*O.spherical_grad(u, *coords), *coords)
        elif identity == 'cylindrical curl grad':
            out = O.cylindrical_curl(*O.cylindrical_grad(u, *coords), *coords)
        else:
            out = O.curl(*O.grad(u, *coords), *coords)
        for f in out:
            assert f.value.abs().max().item() <= 1e-10 * scale
    assert F.taylor_fallback_count() == 0


def test_h1_of_the_poisson_residual_needs_order_3():
    """The second-order spherical residual's H1 norm needs order 3: it
    equals the JAX package's to 1e-10, with no fallback."""
    from neurodiffeq_tpu import losses as JL
    jnets, params, tnets = _nets(3, 1, 1, (8,), seed=32)
    pts = _sphere_points(8, 33)
    coords = F.coords_from_points(torch.tensor(pts))
    u = NoCondition().enforce(tnets[0], *coords)
    F.reset_taylor_fallback_count()
    got = L._losses['h1'](O.spherical_laplacian(u, *coords), [u], list(coords))
    assert F.taylor_fallback_count() == 0
    jc = JF.coords_from_points(jnp.asarray(pts))
    ju = JNoCondition().enforce(jnets[0], params[0], *jc)
    _close(got, JL._losses['h1'](JO.spherical_laplacian(ju, *jc), [ju], list(jc)))


# ------------------------------------------------------------- conditions

def _boundary_values(mod):
    """The boundary functions f, g of the conditions, in ``mod``'s math."""
    f = lambda th, ph: 0.3 + mod.sin(th) * mod.cos(ph)  # noqa: E731
    g = lambda th, ph: -0.2 * mod.cos(th) + 0 * ph  # noqa: E731
    return f, g


CONDITION_NAMES = ['bvp one-ended', 'bvp two-ended', 'inf bvp', 'basis one-ended', 'basis two-ended',
                   'inf basis']


def _condition_pair(name):
    R_a, R_b = np.array([0.4, -0.1, 0.7]), np.array([-0.3, 0.2, 0.0])
    (jf, jg), (tf, tg) = _boundary_values(JF), _boundary_values(F)
    return {
        'bvp one-ended': (JDirichletBVPSpherical(0.7, jf), DirichletBVPSpherical(0.7, tf)),
        'bvp two-ended': (JDirichletBVPSpherical(0.7, jf, 1.3, jg), DirichletBVPSpherical(0.7, tf, 1.3, tg)),
        'inf bvp': (JInfDirichletBVPSpherical(0.7, jf, jg, order=2), InfDirichletBVPSpherical(0.7, tf, tg, order=2)),
        'basis one-ended': (JDirichletBVPSphericalBasis(0.7, R_a), DirichletBVPSphericalBasis(0.7, R_a)),
        'basis two-ended': (JDirichletBVPSphericalBasis(0.7, R_a, 1.3, R_b),
                            DirichletBVPSphericalBasis(0.7, R_a, 1.3, R_b)),
        'inf basis': (JInfDirichletBVPSphericalBasis(0.7, R_a, R_b, order=2),
                      InfDirichletBVPSphericalBasis(0.7, R_a, R_b, order=2)),
    }[name]


@pytest.mark.parametrize('name', CONDITION_NAMES)
def test_spherical_conditions_match_jax(name):
    jc, tc = _condition_pair(name)
    basis = name.startswith('basis') or name == 'inf basis'
    jnets, params, tnets = _nets(1 if basis else 3, 3 if basis else 1, 1, (8,), seed=40)
    pts = _sphere_points(17, 41)

    def build(d, u, coords):
        r, th, ph = coords
        out = [u, d(u[:, 0:1], r), d(u[:, 0:1], r, 2)]
        return out if basis else out + [d(u, th, 2), d(u, ph)]

    @jax.jit
    def jax_values(p):
        coords = JF.coords_from_points(p)
        u = jc.enforce(jnets[0], params[0], *(coords[:1] if basis else coords))
        return [f.value for f in build(jdiff, u, coords)]

    coords = F.coords_from_points(torch.tensor(pts))
    u = tc.enforce(tnets[0], *(coords[:1] if basis else coords))
    for got, want in zip(build(diff, u, coords), jax_values(jnp.asarray(pts)), strict=True):
        _close(got.value, want)


@pytest.mark.parametrize('name', CONDITION_NAMES)
def test_spherical_boundary_values_with_an_untrained_net(name):
    """Exact constraints: the boundary values hold whatever the net is. Three
    points and three coefficients: the coefficients still broadcast as one
    row over the points."""
    _, tc = _condition_pair(name)
    basis = name.startswith('basis') or name == 'inf basis'
    net = FCNN(1 if basis else 3, 3 if basis else 1, hidden_units=(8, 8))
    th, ph = np.array([0.4, 1.1, 2.9]), np.array([0.2, 3.0, 5.5])
    f, g = _boundary_values(np)
    anchors = [(0.7, f(th, ph) if not basis else tc.R_0.numpy())]
    if name in ('bvp two-ended', 'basis two-ended'):
        anchors.append((1.3, g(th, ph) if not basis else tc.R_1.numpy()))
    for r, want in anchors:
        coords = F.coords_from_points(torch.tensor(np.stack([np.full(3, r), th, ph], axis=1)))
        u = tc.enforce(net, *(coords[:1] if basis else coords)).value.detach().numpy()
        assert np.abs(u - (want if basis else want[:, None])).max() < 1e-10


def test_condition_arguments():
    with pytest.raises(ValueError):
        DirichletBVPSpherical(0.1, lambda th, ph: th, r_1=1.0)
    with pytest.raises(ValueError):
        DirichletBVPSphericalBasis(0.1, [0.0], r_1=1.0)
    for make in (lambda: DirichletBVPSphericalBasis(0.1, [0.0], max_degree=2),
                 lambda: InfDirichletBVPSphericalBasis(0.1, [0.0], [1.0], max_degree=2)):
        with pytest.warns(FutureWarning, match='max_degree'):
            make()
    c = InfDirichletBVPSphericalBasis(0.1, [1.0, 2.0], [3.0, 4.0], device='cpu', dtype=torch.float32)
    assert c.R_0.dtype == c.R_inf.dtype == torch.float32 and c.R_0.device.type == 'cpu'


# ------------------------------------------------------------- generator

@pytest.mark.parametrize('method', ['equally-spaced-noisy', 'equally-radius-noisy'])
def test_generator_spherical_matches_jax_in_distribution(method):
    """Two-sample KS tests on r, cos(theta) and phi against the JAX sampler's
    own draws (4,000 points each), plus ranges and shapes."""
    n, r_min, r_max = 4000, 0.2, 2.0
    jr, jth, jph = (np.asarray(a) for a in
                    jax.jit(JGeneratorSpherical(n, r_min, r_max, method=method).sample)(jax.random.PRNGKey(0)))
    gen = GeneratorSpherical(n, r_min, r_max, method=method)
    r, th, ph = gen.sample(torch.Generator().manual_seed(0))
    assert r.shape == th.shape == ph.shape == (n,) and r.dtype == F64
    assert r.min() >= r_min and r.max() <= r_max
    assert th.min() >= 0 and th.max() <= np.pi and ph.min() >= 0 and ph.max() <= 2 * np.pi
    for got, want in ((r, jr), (torch.cos(th), np.cos(jth)), (ph, jph)):
        assert ks_2samp(got.numpy(), want).pvalue > 1e-3
    r2, _, _ = gen.sample(torch.Generator().manual_seed(1))
    assert not torch.equal(r, r2)
    assert len(gen.get_examples()) == 3
    assert repr(gen).startswith('GeneratorSpherical(size=4000')
    with pytest.raises(ValueError):
        GeneratorSpherical(4, 1.0, 0.5)
    with pytest.raises(ValueError):
        GeneratorSpherical(4, method='bogus')


# ------------------------------------------------------ lifted field math

def _trig_fields(mod, x, y):
    inner = 0.6 * x * y + 0.2 * x
    return [mod.tan(0.5 * x + 0.3 * y * x), mod.atan(x * y + x), mod.asin(inner), mod.acos(inner),
            mod.atan2(y + x * x, x + 2.0), mod.atan2(x * y, 0.7), mod.atan2(-0.4, y + 1.5)]


def test_inverse_trig_fields_match_jax():
    """Values and first and second partials along both axes, against the
    JAX package (whose ops have no batched rule and compose per sample)."""
    pts = np.random.RandomState(50).rand(21, 2) * 1.6 - 0.8

    def build(mod, d, x, y):
        out = []
        for f in _trig_fields(mod, x, y):
            out += [f, d(f, x), d(f, y), d(f, x, 2), d(f, y, 2)]
        return out

    @jax.jit
    def jax_values(p):
        x, y = JF.coords_from_points(p)
        return [f.value for f in build(JF, jdiff, x, y)]

    x, y = F.coords_from_points(torch.tensor(pts))
    F.reset_taylor_fallback_count()
    got = build(F, diff, x, y)
    for t, j in zip(got, jax_values(jnp.asarray(pts)), strict=True):
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0
    # plain tensors pass through to torch
    v = torch.tensor([0.25], dtype=F64)
    assert torch.equal(F.atan2(v, v + 1), torch.atan2(v, v + 1)) and torch.equal(F.acos(v), torch.acos(v))


def test_field_sum_keepdims():
    x, y = F.coords_from_points(torch.tensor(np.random.RandomState(51).rand(6, 2)))
    both = F.cat([x, y * y])
    s = both.sum(axis=1, keepdims=True)
    assert s.shape == (6, 1) and both.sum(axis=1).shape == (6, 1)
    _close(diff(s, y, 2).value, np.full((6, 1), 2.0))
    assert both.sum(axis=0, keepdims=True).shape == (1, 2) and both.sum().ndim == 0
