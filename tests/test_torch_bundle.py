"""The PyTorch port's solution bundle against the JAX package, in float64.

``du/dt + lam u = 0`` over lam in [0.5, 1.5] through ``BundleSolver1D``
(BASELINE config 5 of ``benchmarks/configs.py``, cut to hidden (8, 8) and
an 8 x 8 mesh): both solvers get the same parameters
(``BaseSolver.load_jax_params``) and the same points. Loss and every
gradient agree to 1e-10 relative, the parameters after 5 Adam steps to
1e-9. The bundle conditions agree to 1e-12 with their derivatives; the
solution's gradient in lam agrees with ``jax.grad`` to 1e-10 (the inverse
workflow of ``tests/test_inverse.py``).
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF
from neurodiffeq_tpu.conditions import BundleDirichletBVP as JBundleDirichletBVP, BundleIVP as JBundleIVP
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import BundleSolver1D as JBundleSolver1D
from neurodiffeq_tpu_torch import diff, fields as F
from neurodiffeq_tpu_torch import generators as G
from neurodiffeq_tpu_torch.conditions import BundleDirichletBVP, BundleIVP
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.solvers import BundleSolution1D, BundleSolver1D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
F64 = torch.float64
HIDDEN = (8, 8)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _decay(u, t, lam, d):
    return [d(u, t) + lam * u]


def _shared(jnet, key, tnet):
    """Float64 JAX parameters of ``jnet`` and ``tnet`` loaded with them."""
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(key)))
    return params, tnet.load_jax_params(jax.tree.map(np.asarray, params))


# ------------------------------------------------------------- conditions

CONDITIONS = {
    'ivp fixed': (lambda m: m.BundleIVP(t_0=0.2, u_0=1.5), 1),
    'ivp u_0 sampled': (lambda m: m.BundleIVP(t_0=0.2, bundle_param_lookup={'u_0': 0}), 1),
    'ivp t_0 sampled (polynomial)': (lambda m: m.BundleIVP(u_0=2.0, bundle_param_lookup={'t_0': 0}), 1),
    'ivp neumann sampled': (lambda m: m.BundleIVP(t_0=0.1, bundle_param_lookup={'u_0': 0, 'u_0_prime': 1}), 2),
    'ivp t_0 and neumann sampled': (lambda m: m.BundleIVP(u_0=0.5, u_0_prime=-1.0,
                                                          bundle_param_lookup={'t_0': 1}), 2),
    'dirichlet u_0 sampled': (lambda m: m.BundleDirichletBVP(t_0=0., u_0=1., t_1=1., u_1=-1.,
                                                             bundle_param_lookup={'u_0': 0}), 1),
    'dirichlet t_1 and u_1 sampled': (lambda m: m.BundleDirichletBVP(t_0=0., u_0=1., t_1=None, u_1=None,
                                                                     bundle_param_lookup={'t_1': 0, 'u_1': 1}), 2),
}


class _J:
    BundleIVP, BundleDirichletBVP = JBundleIVP, JBundleDirichletBVP


class _T:
    BundleIVP, BundleDirichletBVP = BundleIVP, BundleDirichletBVP


@pytest.mark.parametrize('name', list(CONDITIONS))
def test_bundle_conditions_match_jax(name):
    """Value, du/dt, d2u/dt2 and du/dtheta_0 of the enforced net, to 1e-12."""
    make, n_theta = CONDITIONS[name]
    jc, tc = make(_J), make(_T)
    d = 1 + n_theta
    params, tnet = _shared(JFCNN(n_input_units=d, hidden_units=(8,)), 2, FCNN(n_input_units=d, hidden_units=(8,)))
    rng = np.random.RandomState(3)
    pts = np.concatenate([rng.rand(20, 1), 1.5 + rng.rand(20, n_theta)], axis=1)  # thetas in [1.5, 2.5]

    @jax.jit
    def jax_values(p):
        cs = JF.coords_from_points(p)
        u = jc.enforce(JFCNN(n_input_units=d, hidden_units=(8,)), params, *cs)
        return [u.value, jdiff(u, cs[0]).value, jdiff(u, cs[0], 2).value, jdiff(u, cs[1]).value]

    cs = F.coords_from_points(torch.tensor(pts))
    u = tc.enforce(tnet, *cs)
    got = [u.value, diff(u, cs[0]).value, diff(u, cs[0], 2).value, diff(u, cs[1]).value]
    for g, w in zip(got, jax_values(jnp.asarray(pts)), strict=True):
        assert _rel(g, w) < 1e-12


def test_bundle_conditions_hold_exactly_with_an_untrained_net():
    net = FCNN(n_input_units=3, hidden_units=(8, 8))
    rng = np.random.RandomState(4)
    t0s, u0s, u0ps = rng.rand(10), rng.rand(10), rng.rand(10)
    # sampled t_0, polynomial blend: u = u_0 at t = t_0
    t, th = F.coords_from_points(torch.tensor(np.stack([t0s, t0s], axis=1)))
    u = BundleIVP(u_0=2.0, bundle_param_lookup={'t_0': 0}).enforce(FCNN(n_input_units=2), t, th)
    assert np.abs(u.numpy() - 2.0).max() < 1e-12
    # sampled u_0 and u_0': both hold at t_0
    t, a, b = F.coords_from_points(torch.tensor(np.stack([0.1 * np.ones(10), u0s, u0ps], axis=1)))
    u = BundleIVP(t_0=0.1, bundle_param_lookup={'u_0': 0, 'u_0_prime': 1}).enforce(net, t, a, b)
    assert np.abs(u.numpy()[:, 0] - u0s).max() < 1e-12
    assert np.abs(diff(u, t).numpy()[:, 0] - u0ps).max() < 1e-12
    # both ends of a bundle of Dirichlet problems
    cond = BundleDirichletBVP(t_0=0., u_0=1., t_1=1., u_1=-1., bundle_param_lookup={'u_0': 0})
    for t_end, want in ((0.0, u0s), (1.0, -np.ones(10))):
        t, th = F.coords_from_points(torch.tensor(np.stack([t_end * np.ones(10), u0s], axis=1)))
        assert np.abs(cond.enforce(FCNN(n_input_units=2), t, th).numpy()[:, 0] - want).max() < 1e-12


def test_bundle_condition_keys_and_deprecated_aliases():
    with pytest.raises(ValueError, match='not allowed'):
        BundleIVP(t_0=0, u_0=1, bundle_param_lookup={'bogus': 0})
    with pytest.raises(ValueError, match='not allowed'):
        BundleDirichletBVP(0., 1., 1., 2., bundle_param_lookup={'u_0_prime': 0})
    with pytest.warns(FutureWarning):
        c = BundleIVP(t_0=0.0, x_0=1.0, x_0_prime=2.0)
    assert (c.u_0, c.u_0_prime) == (1.0, 2.0)
    with pytest.warns(FutureWarning):
        c = BundleIVP(0.0, 1.0, bundle_conditions={'t_0': 0})
    assert c.bundle_param_lookup == {'t_0': 0}
    with pytest.warns(FutureWarning):
        c = BundleDirichletBVP(0.0, 1.0, 2.0, 3.0, bundle_conditions={'u_1': 0})
    assert c.bundle_param_lookup == {'u_1': 0}


# ------------------------------------------------------------- the solver

def _solvers(theta_min=0.5, theta_max=1.5, eq_param_index=(0,), conditions=None, **kwargs):
    """The JAX and the port's bundle solvers on the same parameters."""
    conds = conditions or (lambda m: [m.BundleIVP(t_0=0.0, u_0=1.0)])
    n_in = 1 + (1 if isinstance(theta_min, (int, float)) else len(theta_min))
    jsolver = JBundleSolver1D(ode_system=lambda u, t, *th: _decay(u, t, th[-1], jdiff), conditions=conds(_J),
                              t_min=0.0, t_max=1.0, theta_min=theta_min, theta_max=theta_max,
                              eq_param_index=eq_param_index, nets=[JFCNN(n_input_units=n_in, hidden_units=HIDDEN)],
                              **kwargs)
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = BundleSolver1D(ode_system=lambda u, t, *th: _decay(u, t, th[-1], diff), conditions=conds(_T),
                             t_min=0.0, t_max=1.0, theta_min=theta_min, theta_max=theta_max,
                             eq_param_index=eq_param_index, nets=[FCNN(n_input_units=n_in, hidden_units=HIDDEN)],
                             **kwargs)
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    return jsolver, tsolver


def _mesh(*ranges):
    """The 8-point-per-axis 'equally-spaced' mesh as (N, 1) columns."""
    gen = None
    for lo, hi in ranges:
        axis = G.Generator1D(8, lo, hi, method='equally-spaced')
        gen = axis if gen is None else gen ^ axis
    return [c.reshape(-1, 1) for c in gen.sample(None)]


BUNDLES = {
    'lam in the equation (config 5)': (dict(), [(0.0, 1.0), (0.5, 1.5)]),
    'u_0 in the condition, lam in the equation': (
        dict(theta_min=(0.5, 0.8), theta_max=(1.5, 1.2), eq_param_index=(1,),
             conditions=lambda m: [m.BundleIVP(t_0=0.0, bundle_param_lookup={'u_0': 0})]),
        [(0.0, 1.0), (0.5, 1.5), (0.8, 1.2)]),
}


@pytest.mark.parametrize('name', list(BUNDLES))
def test_bundle_loss_and_gradients_match_jax(name):
    kwargs, ranges = BUNDLES[name]
    jsolver, tsolver = _solvers(**kwargs)
    cols = _mesh(*ranges)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, c: jsolver._loss_and_metrics(p, c)[0]))(
        jsolver.params, [jnp.asarray(c.numpy()) for c in cols])
    F.reset_taylor_fallback_count()
    tloss, _ = tsolver._loss_and_metrics(cols)
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    assert _rel(tloss, jloss) < 1e-10
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers'], strict=True):
        assert _rel(lin.weight.grad.numpy().T, lp['W']) < 1e-10
        assert _rel(lin.bias.grad.numpy(), lp['b']) < 1e-10


def test_bundle_adam_steps_match_optax():
    jsolver, tsolver = _solvers()
    cols = _mesh((0.0, 1.0), (0.5, 1.5))
    params, opt = jsolver.params, optax.adam(1e-3)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(c.numpy()) for c in cols])[0]))
    for _ in range(5):
        updates, state = opt.update(grad_fn(params), state, params)
        params = optax.apply_updates(params, updates)
    for _ in range(5):
        tsolver.optimizer.zero_grad()
        tsolver._loss_and_metrics(cols)[0].backward()
        tsolver.optimizer.step()
    for lin, lp in zip(tsolver.nets[0].linears, params[0]['layers'], strict=True):
        assert _rel(lin.weight.detach().numpy().T, lp['W']) < 1e-9
        assert _rel(lin.bias.detach().numpy(), lp['b']) < 1e-9


def test_bundle_solver_defaults_and_internals():
    solver = BundleSolver1D(ode_system=lambda u, t, lam: _decay(u, t, lam, diff),
                            conditions=[BundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0,
                            theta_min=0.5, theta_max=1.5, eq_param_index=(0,))
    train, valid = solver.generator['train'], solver.generator['valid']
    assert isinstance(train, G.MeshGenerator) and isinstance(valid, G.MeshGenerator)
    assert train.size == valid.size == 32 * 32
    assert [g.method for g in train.generators] == ['equally-spaced-noisy'] * 2
    assert [(g.t_min, g.t_max) for g in valid.generators] == [(0.0, 1.0), (0.5, 1.5)]
    assert solver.nets[0].n_input_units == 2 and solver.nets[0].hidden_units == (32, 32)
    internals = solver.get_internals(['r_min', 'r_max', 'eq_param_index'], return_type='dict')
    assert internals == {'r_min': (0.0, 0.5), 'r_max': (1.0, 1.5), 'eq_param_index': (2,)}
    # the default validation mesh is the JAX package's to one ulp (XLA's CPU
    # backend fuses the mesh and contracts its linspace into an FMA)
    jvalid = JBundleSolver1D(ode_system=lambda u, t, lam: _decay(u, t, lam, jdiff),
                             conditions=[JBundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0,
                             theta_min=0.5, theta_max=1.5, eq_param_index=(0,)).generator['valid']
    for got, want in zip(valid.sample(None), jax.jit(jvalid.sample)(jax.random.PRNGKey(0)), strict=True):
        want = np.asarray(want).reshape(-1)
        assert np.all(np.abs(got.numpy() - want) <= np.spacing(want))

    two = BundleSolver1D(ode_system=lambda u, t: [diff(u, t)], conditions=[BundleIVP(0.0, 1.0)], t_min=0.0,
                         t_max=1.0, theta_min=(0.0, 1.0), theta_max=[1.0, 2.0])
    assert two.generator['train'].size == 32 ** 3 and two.nets[0].n_input_units == 3
    assert two.eq_param_index == ()
    with pytest.raises(ValueError, match='length of theta_min and theta_max'):
        BundleSolver1D(ode_system=None, conditions=[BundleIVP(0.0, 1.0)], t_min=0.0, t_max=1.0,
                       theta_min=(0.0, 1.0), theta_max=2.0)
    with pytest.raises(ValueError, match='t_min and t_max'):
        BundleSolver1D(ode_system=None, conditions=[BundleIVP(0.0, 1.0)], t_min=None, t_max=1.0)


def test_bundle_fit_reaches_the_kernel_five_times_per_epoch(monkeypatch):
    """Config 5 at its own width (FCNN 2-32-32-1, 32 x 32 points): one train
    and four validation batches per epoch, each one fused Taylor-MLP call
    at d = 2 and order 1 (the CUDA ``taylor_mlp`` on the card)."""
    calls = []
    fused = taylor_mlp.fcnn_taylor

    def counting(points, layers, order, actv='tanh'):
        calls.append((tuple(points.shape), tuple(W.shape[1] for W, _ in layers), order))
        return fused(points, layers, order, actv)

    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', counting)
    solver = BundleSolver1D(ode_system=lambda u, t, lam: _decay(u, t, lam, diff),
                            conditions=[BundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0,
                            theta_min=0.5, theta_max=1.5, eq_param_index=(0,))
    F.reset_taylor_fallback_count()
    solver.fit(3, tqdm_file=None)
    assert F.taylor_fallback_count() == 0 and solver.global_epoch == 3
    assert calls == [((1024, 2), (32, 32, 1), 1)] * 15
    assert solver.metrics_history['train_loss'][-1] < solver.metrics_history['train_loss'][0]


# ------------------------------------------------------------- the solution (F4)

def test_solution_is_differentiable_in_lambda_like_jax():
    """d(mse)/d(lam) through the frozen solution, the inverse workflow of
    ``tests/test_inverse.py``, equals ``jax.grad`` through the JAX one."""
    jsolver, tsolver = _solvers()
    jsol, tsol = jsolver.get_solution(best=False), tsolver.get_solution(best=False)
    assert isinstance(tsol, BundleSolution1D)
    ts = np.linspace(0, 1, 25)
    data = np.exp(-1.23 * ts)

    def jmse(lam):
        return ((jsol(ts, jnp.ones(25) * lam) - data) ** 2).mean()

    jval, jgrad = jax.value_and_grad(jmse)(0.8)
    lam = torch.tensor(0.8, dtype=F64, requires_grad=True)
    tval = ((tsol(ts, torch.ones(25, dtype=F64) * lam) - torch.tensor(data)) ** 2).mean()
    tval.backward()
    assert _rel(tval, jval) < 1e-10
    assert _rel(lam.grad, jgrad) < 1e-10
    # the backward reaches lam only: the solution's parameters are frozen
    # copies and gather no gradient, while the solver's own nets still train
    assert all(p.grad is None and not p.requires_grad for net in tsol.nets for p in net.parameters())
    assert all(p.requires_grad for p in tsolver.nets[0].parameters())
    # values agree, and with no input that requires grad no graph is kept
    plain = tsol(ts, 0.8 * np.ones(25))
    assert plain.grad_fn is None and not plain.requires_grad
    assert _rel(plain, jsol(ts, 0.8 * np.ones(25))) < 1e-10
    assert _rel(tsol(ts, 0.8 * np.ones(25), to_numpy=True), np.asarray(jsol(ts, 0.8 * np.ones(25)))) < 1e-10
    with torch.no_grad():
        assert tsol(ts, torch.ones(25, dtype=F64) * lam).grad_fn is None


def test_inverse_workflow_recovers_lambda():
    """The workflow itself at a small size: a solution trained over lam in
    [0.5, 1.5] and Adam on lam through it recover the lam of the data."""
    torch.manual_seed(0)
    solver = BundleSolver1D(ode_system=lambda u, t, lam: _decay(u, t, lam, diff),
                            conditions=[BundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0,
                            theta_min=0.5, theta_max=1.5, eq_param_index=(0,),
                            nets=[FCNN(n_input_units=2, hidden_units=(16, 16))],
                            train_generator=G.Generator1D(16, 0.0, 1.0, method='equally-spaced-noisy') ^ G.Generator1D(
                                16, 0.5, 1.5, method='equally-spaced-noisy'),
                            valid_generator=G.Generator1D(16, 0.0, 1.0, method='equally-spaced') ^ G.Generator1D(
                                16, 0.5, 1.5, method='equally-spaced'),
                            n_batches_valid=1, optimizer=None, generator=torch.Generator().manual_seed(0))
    solver.optimizer = torch.optim.Adam(solver.nets[0].parameters(), lr=1e-2)
    solver.fit(400, tqdm_file=None)
    sol = solver.get_solution()
    ts = torch.linspace(0, 1, 25, dtype=F64)
    data = torch.exp(-1.23 * ts)
    lam = torch.tensor(0.7, dtype=F64, requires_grad=True)
    opt = torch.optim.Adam([lam], lr=5e-2)
    for _ in range(150):
        opt.zero_grad()
        loss = ((sol(ts, torch.ones_like(ts) * lam) - data) ** 2).mean()
        loss.backward()
        opt.step()
    assert abs(lam.item() - 1.23) < 0.05, lam.item()
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        sol(ts.numpy(), np.ones(25))  # numpy inputs still evaluate without a graph
