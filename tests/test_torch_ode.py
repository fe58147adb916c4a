"""The PyTorch port's ODE path against the JAX package, in float64.

Lotka-Volterra through ``Solver1D`` (two sin nets of hidden (8, 8), the
BASELINE config of ``benchmarks/configs.py`` cut to size): both solvers get
the same parameters (``BaseSolver.load_jax_params``) and the same points.
Loss and every gradient of both nets agree to 1e-10 relative; the
parameters after 5 Adam steps (optax against ``torch.optim.Adam``) to
1e-9. Also here: the 1-D conditions (exact constraints with an untrained
net, to 1e-10), ``Generator1D`` and the generator combinators (bit for bit
where deterministic, in distribution where random), ``fit`` and the
closure path of ``torch.optim.LBFGS``.
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF
from neurodiffeq_tpu.conditions import (DirichletBVP as JDirichletBVP, EnsembleCondition as JEnsembleCondition,
                                        IVP as JIVP, NoCondition as JNoCondition)
from neurodiffeq_tpu.generators import Generator1D as JGenerator1D, Generator2D as JGenerator2D
from neurodiffeq_tpu.networks import FCNN as JFCNN, SinActv as JSinActv
from neurodiffeq_tpu.solvers import Solver1D as JSolver1D
from neurodiffeq_tpu_torch import diff, fields as F
from neurodiffeq_tpu_torch import generators as G
from neurodiffeq_tpu_torch.callbacks import SetOptimizer
from neurodiffeq_tpu_torch.conditions import (BaseCondition, DirichletBVP, EnsembleCondition, IVP,
                                              NoCondition)
from neurodiffeq_tpu_torch.networks import FCNN, SinActv
from neurodiffeq_tpu_torch.solvers import Solver1D, _requires_closure
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
F64 = torch.float64
HIDDEN, N_POINTS = (8, 8), 32


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


def _lv(u, v, t, d):
    return [d(u, t) - (u - u * v), d(v, t) - (u * v - v)]


def _solvers(generators=None, **kwargs):
    """The JAX and the port's Lotka-Volterra solvers on the same parameters.
    ``generators``: a method for both generators of both solvers."""
    jkw, tkw = dict(kwargs), dict(kwargs)
    if generators is not None:
        jkw.update(train_generator=JGenerator1D(N_POINTS, 0.1, 12.0, method=generators),
                   valid_generator=JGenerator1D(N_POINTS, 0.1, 12.0, method=generators))
        tkw.update(train_generator=G.Generator1D(N_POINTS, 0.1, 12.0, method=generators),
                   valid_generator=G.Generator1D(N_POINTS, 0.1, 12.0, method=generators))
    jsolver = JSolver1D(ode_system=lambda u, v, t: _lv(u, v, t, jdiff),
                        conditions=[JIVP(0.1, 1.5), JIVP(0.1, 1.0)], t_min=0.1, t_max=12.0,
                        nets=[JFCNN(hidden_units=HIDDEN, actv=JSinActv) for _ in range(2)], **jkw)
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = Solver1D(ode_system=lambda u, v, t: _lv(u, v, t, diff),
                       conditions=[IVP(0.1, 1.5), IVP(0.1, 1.0)], t_min=0.1, t_max=12.0,
                       nets=[FCNN(hidden_units=HIDDEN, actv=SinActv) for _ in range(2)], **tkw)
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    return jsolver, tsolver


def _torch_params(net):
    """The port's parameters in the JAX layout: [(W (in, out), b), ...]."""
    return [(lin.weight.detach().numpy().T, lin.bias.detach().numpy()) for lin in net.linears]


TS = np.random.RandomState(7).rand(N_POINTS, 1) * 11.9 + 0.1
METRICS = {'u_mean': lambda u, v, t: u.mean(), 'uv_max': lambda u, v, t: (u * v).max()}


@pytest.mark.parametrize('loss_fn,weights', [('l2', None), ('l2', (0.5, 4.0)), ('l1', (0.5, 4.0)),
                                             ('h1', None)])
def test_lotka_volterra_loss_and_gradients_match_jax(loss_fn, weights):
    jsolver, tsolver = _solvers(loss_fn=loss_fn, residual_weights=weights, metrics=METRICS)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jsolver._loss_and_metrics, has_aux=True))(
        jsolver.params, [jnp.asarray(TS)])
    F.reset_taylor_fallback_count()
    tloss, tmetrics = tsolver._loss_and_metrics([torch.tensor(TS)])
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    assert _rel(tloss, jloss) < 1e-10
    for name in METRICS:
        assert _rel(tmetrics[name], jmetrics[name]) < 1e-10
    for net, jg in zip(tsolver.nets, jgrads, strict=True):
        for lin, lp in zip(net.linears, jg['layers'], strict=True):
            assert _rel(lin.weight.grad.numpy().T, lp['W']) < 1e-10
            assert _rel(lin.bias.grad.numpy(), lp['b']) < 1e-10


def test_lotka_volterra_adam_steps_match_optax():
    jsolver, tsolver = _solvers()
    params, opt = jsolver.params, optax.adam(1e-3)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(TS)])[0]))
    for _ in range(5):
        updates, state = opt.update(grad_fn(params), state, params)
        params = optax.apply_updates(params, updates)
    for _ in range(5):
        tsolver.optimizer.zero_grad()
        tsolver._loss_and_metrics([torch.tensor(TS)])[0].backward()
        tsolver.optimizer.step()
    for net, jp in zip(tsolver.nets, params, strict=True):
        for (W, b), lp in zip(_torch_params(net), jp['layers'], strict=True):
            assert _rel(W, lp['W']) < 1e-9
            assert _rel(b, lp['b']) < 1e-9


def test_fit_follows_the_jax_trajectory():
    """With deterministic generators both packages train on the same points:
    ``fit`` gives the same loss histories, lowest loss and best parameters."""
    jsolver, tsolver = _solvers(generators='equally-spaced')
    jsolver.fit(6, tqdm_file=None)
    tsolver.fit(6, tqdm_file=None)
    for key in ('train_loss', 'valid_loss'):
        assert len(tsolver.metrics_history[key]) == 6
        assert _rel(tsolver.metrics_history[key], jsolver.metrics_history[key]) < 1e-9
    assert _rel(tsolver.lowest_loss, jsolver.lowest_loss) < 1e-9
    for net, jp in zip(tsolver.best_nets, jsolver.best_params, strict=True):
        for (W, b), lp in zip(_torch_params(net), jp['layers'], strict=True):
            assert _rel(W, lp['W']) < 1e-9 and _rel(b, lp['b']) < 1e-9
    ts = np.linspace(0.1, 12, 40)
    for got, want in zip(tsolver.get_solution()(ts, to_numpy=True), jsolver.get_solution()(ts, to_numpy=True)):
        assert _rel(got, want) < 1e-9
    for got, want in zip(tsolver.get_residuals(ts, to_numpy=True), jsolver.get_residuals(ts, to_numpy=True)):
        assert _rel(got, want) < 1e-8


def test_fit_api():
    _, solver = _solvers()
    flushed = []

    class Flush:
        def __call__(self, s):
            pass

        def flush(self):
            flushed.append(True)

    solver.fit(3, callbacks=[Flush()], tqdm_file=None)
    assert flushed == [True] and solver.global_epoch == 3 and solver.local_epoch == 3
    with pytest.raises(ValueError, match='Unknown keyword'):
        solver.fit(1, tqdm_file=None, bogus=False)
    solver.fit(1, tqdm_file=None, pipeline=False)  # accepted, as in the JAX package (F9)
    assert solver.global_epoch == 4

    class Monitor:  # fit(monitor=...) warns and draws through the monitor's callback, as in JAX
        def to_callback(self):
            return Flush()

    with pytest.warns(UserWarning, match='MonitorCallback'):
        solver.fit(1, monitor=Monitor(), tqdm_file=None)
    assert flushed == [True, True] and solver.global_epoch == 5
    # internals, and the best nets as copies
    internals = solver.get_internals()
    assert internals['t_min'] == 0.1 and internals['global_epoch'] == 5
    assert solver.get_internals('lowest_loss') == solver.lowest_loss == min(solver.metrics_history['valid_loss'])
    assert solver.get_internals(['n_funcs', 'nets'], return_type='dict')['n_funcs'] == 2
    with pytest.raises(ValueError):
        solver.get_internals(['nets'], return_type='bogus')
    best = solver.best_nets
    assert len(best) == 2 and best[0] is not solver.nets[0]
    # a shared net is one set of parameters
    net = FCNN(n_output_units=2, hidden_units=(4,))
    shared = Solver1D(lambda u, v, t: [diff(u, t) - v, diff(v, t) + u], [IVP(0, 1), IVP(0, 0)],
                      t_min=0.0, t_max=1.0, nets=[net, net])
    assert shared._unique_nets == [net]
    with pytest.raises(ValueError, match='parameters of 1 nets'):
        shared.load_jax_params([{}, {}])


def _future_warnings(build):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        build()
    return [str(w.message) for w in caught if issubclass(w.category, FutureWarning)]


def test_deprecated_shuffle_and_batch_size_warn_and_are_ignored():
    """The JAX constructors accept ``shuffle`` and ``batch_size``, warn and
    ignore them; so do the port's: the same warnings, the same training."""
    deprecated = dict(shuffle=True, batch_size=16)
    caught = _future_warnings(lambda: _solvers(**deprecated))  # the JAX solver's first, then the port's
    assert len(caught) == 4 and caught[2:] == caught[:2]
    _, plain = _solvers(generators='equally-spaced')
    _, old_style = _solvers(generators='equally-spaced', **deprecated)
    old_style.load_jax_params([{'layers': [{'W': W, 'b': b} for W, b in _torch_params(net)]} for net in plain.nets])
    plain.fit(3, tqdm_file=None)
    old_style.fit(3, tqdm_file=None)
    assert plain.metrics_history == old_style.metrics_history


def test_every_solver_takes_the_deprecated_arguments():
    from neurodiffeq_tpu_torch.conditions import BundleIVP, DirichletBVP2D, DirichletBVPSpherical
    from neurodiffeq_tpu_torch.solvers import BundleSolver1D, GenericSolver, Solver2D, SolverSpherical
    build = {
        'Solver2D': lambda **kw: Solver2D(lambda u, x, y: [diff(u, x)], [DirichletBVP2D(
            0, lambda y: 0 * y, 1, lambda y: 0 * y, 0, lambda x: 0 * x, 1, lambda x: 0 * x)],
            xy_min=(0, 0), xy_max=(1, 1), **kw),
        'SolverSpherical': lambda **kw: SolverSpherical(lambda u, r, th, ph: [diff(u, r)], [DirichletBVPSpherical(
            0.1, lambda th, ph: 0 * th)], r_min=0.1, r_max=1.0, **kw),
        'GenericSolver': lambda **kw: GenericSolver(lambda u, t: [diff(u, t)], [IVP(0, 1)], n_input_units=1,
                                                    n_output_units=1, train_generator=G.Generator1D(8),
                                                    valid_generator=G.Generator1D(8), **kw),
        'BundleSolver1D': lambda **kw: BundleSolver1D(lambda u, t: [diff(u, t)], [BundleIVP(0, 1)], t_min=0.0,
                                                      t_max=1.0, theta_min=0.0, theta_max=1.0, **kw),
    }
    for name, make in build.items():
        assert len(_future_warnings(lambda: make(shuffle=True, batch_size=4))) == 2, name
        assert _future_warnings(lambda: make(shuffle=False)) == [], name


def test_solution_without_copy_is_a_snapshot():
    """``get_solution(copy=False, best=False)`` keeps the parameters it was
    given, as the JAX package's immutable ones are kept: later training
    does not move it. ``copy`` governs the conditions only."""
    _, solver = _solvers()
    ts = np.linspace(0.1, 12, 30)
    sol = solver.get_solution(copy=False, best=False)
    before = sol(ts, to_numpy=True)
    solver.fit(3, tqdm_file=None)
    for a, b in zip(before, sol(ts, to_numpy=True), strict=True):
        assert np.array_equal(a, b)
    assert all(n is not m for n, m in zip(sol.nets, solver.nets))
    assert sol.conditions[0] is solver.conditions[0]
    assert solver.get_solution(copy=True, best=False).conditions[0] is not solver.conditions[0]
    moved = solver.get_solution(copy=False, best=False)(ts, to_numpy=True)
    assert not np.array_equal(moved[0], before[0])


def test_solution_is_differentiable_in_its_inputs():
    """A solution evaluated on a tensor that requires grad keeps the graph:
    autograd's du/dt equals the Taylor engine's (the JAX solution is
    differentiable in its inputs too); on plain inputs no graph is kept."""
    _, solver = _solvers()
    sol = solver.get_solution(best=False)
    ts = torch.linspace(0.1, 12, 30, dtype=F64, requires_grad=True)
    u, v = sol(ts)
    (du,) = torch.autograd.grad(u.sum(), ts)
    (t,) = F.coords_from_points(ts.detach().reshape(-1, 1))
    with torch.no_grad():
        want = diff(solver.conditions[0].enforce(solver.nets[0], t), t).value[:, 0]
    assert _rel(du, want.numpy()) < 1e-10
    assert sol(ts.detach())[0].grad_fn is None


def test_set_generator_loss_and_optimizer():
    _, solver = _solvers()
    gen = G.PredefinedGenerator(np.linspace(0.1, 12, 16))
    solver.set_generator(gen, 'valid')
    with pytest.raises(ValueError):
        solver.set_generator(gen, 'test')
    solver.set_loss_fn('l1')
    assert solver.loss_fn.residual_power == 1
    adam = solver.optimizer
    solver.fit(2, tqdm_file=None)
    assert len(adam.state) > 0
    solver.set_optimizer(adam, reset_state=False)
    assert len(adam.state) > 0
    solver.set_optimizer(adam)
    assert len(adam.state) == 0
    assert solver._generate_batch('valid')[0].shape == (16, 1)


def test_analytic_solutions_is_a_metric():
    with pytest.warns(FutureWarning):
        solver = Solver1D(lambda u, t: diff(u, t) + u, [IVP(0.0, 1.0)], t_min=0.0, t_max=1.0,
                          analytic_solutions=lambda t: torch.exp(-t))
    solver.fit(2, tqdm_file=None)
    assert len(solver.metrics_history['valid__analytic_mse']) == 2


def test_residual_weights_validation():
    for bad in ([1.0, -1.0], 'ab', [0.0]):
        with pytest.raises(ValueError):
            Solver1D(lambda u, t: diff(u, t), [IVP(0, 1)], t_min=0.0, t_max=1.0, residual_weights=bad)
    solver = Solver1D(lambda u, t: diff(u, t), [IVP(0, 1)], t_min=0.0, t_max=1.0, residual_weights=[1.0, 2.0])
    with pytest.raises(ValueError, match='residual_weights has 2'):
        solver.fit(1, tqdm_file=None)


@pytest.mark.parametrize('mode', ['direct', 'callback'])
def test_lbfgs_trains_through_the_closure(mode):
    """``torch.optim.LBFGS`` (passed directly, or set by ``SetOptimizer``)
    is stepped once per batch with a closure and solves u' + u = 0."""
    net = FCNN(hidden_units=(16, 16))
    opt = torch.optim.LBFGS(net.parameters(), lr=0.5, max_iter=20) if mode == 'direct' else None
    torch.manual_seed(0)
    solver = Solver1D(lambda u, t: diff(u, t) + u, [IVP(0.0, 1.0)], t_min=0.0, t_max=2.0, nets=[net],
                      optimizer=opt, generator=torch.Generator().manual_seed(0))
    callbacks = [SetOptimizer(torch.optim.LBFGS, optimizer_kwargs=dict(lr=0.5, max_iter=20))] if mode != 'direct' else []
    solver.fit(20, callbacks=callbacks, tqdm_file=None)
    assert solver._closure_style and isinstance(solver.optimizer, torch.optim.LBFGS)
    ts = np.linspace(0, 2, 50)
    assert np.abs(solver.get_solution()(ts, to_numpy=True) - np.exp(-ts)).max() < 2e-2


def test_requires_closure():
    p = [torch.zeros(2, requires_grad=True)]
    assert _requires_closure(torch.optim.LBFGS(p))
    assert not _requires_closure(torch.optim.Adam(p))
    assert not _requires_closure(torch.optim.SGD(p, lr=0.1))


# ------------------------------------------------------------- conditions

def _cond_pairs():
    return {
        'ivp': (JIVP(0.3, 1.5), IVP(0.3, 1.5)),
        'ivp-neumann': (JIVP(0.3, 1.5, -0.7), IVP(0.3, 1.5, -0.7)),
        'dirichlet-bvp': (JDirichletBVP(0.3, 1.5, 2.0, -0.4), DirichletBVP(0.3, 1.5, 2.0, -0.4)),
        'none': (JNoCondition(), NoCondition()),
    }


@pytest.mark.parametrize('name', ['ivp', 'ivp-neumann', 'dirichlet-bvp', 'none'])
def test_conditions_match_jax(name):
    jc, tc = _cond_pairs()[name]
    jnet = JFCNN(hidden_units=(8,), actv=JSinActv)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(2)))
    tnet = FCNN(hidden_units=(8,), actv=SinActv).load_jax_params(jax.tree.map(np.asarray, params))
    ts = np.random.RandomState(3).rand(20, 1) * 3

    @jax.jit
    def jax_values(p):
        (t,) = JF.coords_from_points(p)
        u = jc.enforce(jnet, params, t)
        return [u.value, jdiff(u, t).value, jdiff(u, t, 2).value]

    (t,) = F.coords_from_points(torch.tensor(ts))
    u = tc.enforce(tnet, t)
    for got, want in zip([u.value, diff(u, t).value, diff(u, t, 2).value], jax_values(jnp.asarray(ts))):
        assert _rel(got, want) < 1e-10


def test_exact_constraints_with_an_untrained_net():
    net = FCNN(hidden_units=(8, 8), actv=SinActv)
    (t,) = F.coords_from_points(torch.tensor([[0.3], [2.0]], dtype=F64))
    u = IVP(0.3, 1.5).enforce(net, t)
    assert abs(u.value[0, 0].item() - 1.5) < 1e-10
    u = IVP(0.3, 1.5, -0.7).enforce(net, t)
    assert abs(u.value[0, 0].item() - 1.5) < 1e-10
    assert abs(diff(u, t).value[0, 0].item() + 0.7) < 1e-10
    u = DirichletBVP(0.3, 1.5, 2.0, -0.4).enforce(net, t)
    assert np.abs(u.value[:, 0].detach().numpy() - [1.5, -0.4]).max() < 1e-10
    # an ensemble holds each column to its own condition
    two = FCNN(n_output_units=2, hidden_units=(8,))
    u = EnsembleCondition(IVP(0.3, 1.5), DirichletBVP(0.3, -1.0, 2.0, 3.0)).enforce(two, t)
    assert u.shape == (2, 2)
    assert np.abs(u.value.detach().numpy()[0] - [1.5, -1.0]).max() < 1e-10
    assert abs(u.value[1, 1].item() - 3.0) < 1e-10


def test_ensemble_condition_matches_jax_and_checks_enforce():
    jnet = JFCNN(n_output_units=2, hidden_units=(8,))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(4)))
    tnet = FCNN(n_output_units=2, hidden_units=(8,)).load_jax_params(jax.tree.map(np.asarray, params))
    ts = np.random.RandomState(5).rand(15, 1)
    (jt,) = JF.coords_from_points(jnp.asarray(ts))
    ju = JEnsembleCondition(JIVP(0.0, 1.0), JNoCondition()).enforce(jnet, params, jt)
    (t,) = F.coords_from_points(torch.tensor(ts))
    tu = EnsembleCondition(IVP(0.0, 1.0), NoCondition()).enforce(tnet, t)
    assert _rel(tu.value, ju.value) < 1e-10
    assert _rel(diff(tu[:, 0], t, 2).value, jdiff(ju[:, 0], jt, 2).value) < 1e-10

    class Custom(BaseCondition):
        def enforce(self, net, *coords):
            return super().enforce(net, *coords)

    with pytest.raises(ValueError, match='force=True'):
        EnsembleCondition(IVP(0, 1), Custom())
    with pytest.warns(UserWarning, match='overrides'):
        EnsembleCondition(IVP(0, 1), Custom(), force=True)
    with pytest.raises(ValueError, match='number of output units'):
        EnsembleCondition(IVP(0, 1)).enforce(tnet, t)


def test_condition_deprecated_aliases():
    with pytest.warns(FutureWarning):
        c = IVP(t_0=0.0, x_0=1.0, x_0_prime=2.0)
    assert (c.u_0, c.u_0_prime) == (1.0, 2.0)
    with pytest.warns(FutureWarning):
        c = DirichletBVP(t_0=0.0, x_0=1.0, t_1=1.0, x_1=2.0)
    assert (c.u_0, c.u_1) == (1.0, 2.0)


# ------------------------------------------------------------- generators

DOMAINS = ((0.1, 12.0, 32), (0.01, 10.0, 17), (1.0, 3.0, 33))


def _jax_sample(n, a, b, method):
    return np.asarray(jax.jit(lambda k: JGenerator1D(n, a, b, method=method).sample(k))(jax.random.PRNGKey(0)))


@pytest.mark.parametrize('method,a,b,n', [(m, a, b, n) for m in ('equally-spaced', 'chebyshev', 'chebyshev1',
                                                                  'chebyshev2') for a, b, n in DOMAINS])
def test_deterministic_1d_methods_match_jax_exactly(method, a, b, n):
    (got,) = G.Generator1D(n, a, b, method=method).sample(None)
    assert np.array_equal(_jax_sample(n, a, b, method), got.numpy())


@pytest.mark.parametrize('a,b,n', DOMAINS)
def test_log_spaced_matches_jax_to_one_ulp(a, b, n):
    """``10 ** linspace``: the exponents agree bit for bit, but XLA's CPU
    ``pow`` and the C library's differ by one ulp on some inputs."""
    want = _jax_sample(n, a, b, 'log-spaced')
    (got,) = G.Generator1D(n, a, b, method='log-spaced').sample(None)
    assert np.all(np.abs(got.numpy() - want) <= np.spacing(want))


@pytest.mark.parametrize('method', ['chebyshev', 'chebyshev2', 'equally-spaced'])
def test_deterministic_2d_methods_match_jax_exactly(method):
    jx, jy = jax.jit(lambda k: JGenerator2D((7, 5), (-1, 0.1), (2, 3), method=method).sample(k))(
        jax.random.PRNGKey(0))
    tx, ty = G.Generator2D((7, 5), (-1, 0.1), (2, 3), method=method).sample(None)
    assert np.array_equal(np.asarray(jx), tx.numpy()) and np.array_equal(np.asarray(jy), ty.numpy())


def _draws(sample, n_draws):
    return np.stack([np.asarray(sample(i)) for i in range(n_draws)])


@pytest.mark.parametrize('method', ['uniform', 'equally-spaced-noisy', 'log-spaced-noisy', 'chebyshev2-noisy',
                                    'latin-hypercube'])
def test_random_1d_methods_match_jax_in_distribution(method):
    """Over 300 draws of 16 points: the same bounds, and per point the same
    mean and spread (within sampling error)."""
    n, a, b = 16, 0.5, 4.0
    jgen, tgen = JGenerator1D(n, a, b, method=method), G.Generator1D(n, a, b, method=method)
    jsample = jax.jit(jgen.sample)
    jd = _draws(lambda i: jsample(jax.random.PRNGKey(i)), 300)
    td = _draws(lambda i: tgen.sample(torch.Generator().manual_seed(i))[0], 300)
    jd, td = (np.sort(d, axis=1) for d in (jd, td))  # per rank: order statistics
    if method not in ('equally-spaced-noisy', 'log-spaced-noisy'):
        assert td.min() >= a and td.max() <= b
    spread = jd.std(axis=0)
    assert np.all(np.abs(td.mean(axis=0) - jd.mean(axis=0)) <= 0.35 * spread + 1e-12)
    assert np.all(np.abs(td.std(axis=0) - spread) <= 0.25 * spread + 1e-12)
    if method == 'latin-hypercube':  # one point in each of the n strata
        strata = np.floor((td - a) / ((b - a) / n)).astype(int)
        assert (strata == np.arange(n)).all()


@pytest.mark.parametrize('method', ['chebyshev2-noisy', 'latin-hypercube'])
def test_random_2d_methods(method):
    gen = G.Generator2D((6, 4), (0, -1), (1, 1), method=method)
    x, y = gen.sample(torch.Generator().manual_seed(0))
    assert x.shape == y.shape == (24,)
    assert x.min() >= 0 and x.max() <= 1 and y.min() >= -1 and y.max() <= 1
    assert len(torch.unique(x)) == 6 and len(torch.unique(y)) == 4  # a mesh of per-axis nodes
    x2, _ = gen.sample(torch.Generator().manual_seed(1))
    assert not torch.equal(x, x2)


def test_generator_combinators():
    g1 = G.Generator1D(5, 0.0, 1.0, method='equally-spaced')
    g2 = G.Generator1D(3, 2.0, 3.0, method='chebyshev')
    (cat,) = (g1 + g2).sample(None)
    assert (g1 + g2).size == 8 and torch.equal(cat, torch.cat([g1.sample(None)[0], g2.sample(None)[0]]))
    ens = (g1 * G.Generator1D(5, -1.0, 0.0, method='equally-spaced')).sample(None)
    assert len(ens) == 2 and all(e.shape == (5,) for e in ens)
    with pytest.raises(ValueError):
        g1 * g2
    mesh = (g1 ^ g2).sample(None)  # a meshgrid, the last generator fastest
    assert (g1 ^ g2).size == 15 and torch.equal(mesh[0], g1.sample(None)[0].repeat_interleave(3))
    assert torch.equal(mesh[1], g2.sample(None)[0].repeat(5))
    static = G.StaticGenerator(G.Generator1D(6, method='uniform'))
    assert torch.equal(static.sample(torch.Generator().manual_seed(1))[0], static.get_examples())
    pre = G.PredefinedGenerator([1, 2, 3], np.array([[4], [5], [6]]))
    assert pre.size == 3 and torch.equal(pre.get_examples()[1], torch.tensor([4., 5., 6.], dtype=F64))
    with pytest.raises(ValueError):
        G.PredefinedGenerator([1, 2], [1])
    # 'halton' (the high-dimensional slice): randomized low-discrepancy points in the box
    for gen in (G.Generator1D(4, method='halton'), G.Generator2D(method='halton')):
        cols = gen.sample(torch.Generator().manual_seed(0))
        assert all(c.shape == (gen.size,) and c.min() >= 0 and c.max() < 1 for c in cols)
    with pytest.raises(ValueError):
        G.Generator1D(4, -1.0, 1.0, method='log-spaced')
    with pytest.raises(ValueError):
        G.Generator1D(4, method='bogus')
    assert repr(g1).startswith('Generator1D(size=5')
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        assert isinstance(repr(static), str)
