"""The PyTorch port's hypersolver against the JAX package, in float64.

``DiscreteSolution1D`` against ``jnp.interp`` to 1e-12 (inside the grid,
on its knots and outside it); the residual targets and the corrected
Euler, Heun and RK4 rollouts to 1e-10 at shared corrector parameters
(``Hypersolver.load_jax_params``); 5 ``Hypersolver.fit`` steps
(``torch.optim.Adam`` against ``optax.adam``) to 1e-9.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu.hypersolver import (DiscreteSolution1D as JDiscreteSolution1D, Euler as JEuler,
                                         Heun as JHeun, Hypersolver as JHypersolver, RK4 as JRK4)
from neurodiffeq_tpu_torch.hypersolver import RK4, DiscreteSolution1D, Euler, Heun, Hypersolver
from neurodiffeq_tpu_torch.hypersolver.numerical_solvers import _normalize_rhs
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
F64 = torch.float64
INTEGRATORS = {'euler': (JEuler, Euler), 'heun': (JHeun, Heun), 'rk4': (JRK4, RK4)}
# (right-hand side, u0, t0, tn, exact solution): exponential decay and the sin/cos system
PROBLEMS = {
    'decay': (lambda u, t: [-u], 1.0, 0.0, 2.0, lambda ts: [np.exp(-np.asarray(ts))]),
    'sin-cos': (lambda u1, u2, t: [u2, -u1], (0.0, 1.0), 0.0, np.pi,
                lambda ts: [np.sin(np.asarray(ts)), np.cos(np.asarray(ts))]),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def test_discrete_solution_matches_jnp_interp():
    rng = np.random.RandomState(0)
    ts = np.sort(rng.rand(12)) * 3 - 0.5
    us = [np.sin(ts), rng.randn(12)]
    queries = np.concatenate([np.linspace(-1.5, 3.5, 41), ts, [ts[0], ts[-1]]])  # outside, inside, knots
    want = JDiscreteSolution1D(ts, *us)(queries)
    got = DiscreteSolution1D(torch.tensor(ts), *us)(queries)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want, strict=True):
        assert _rel(g, w) < 1e-12
    # outside the grid it holds the end values; on a knot, the knot's value
    (g0,) = DiscreteSolution1D(ts, us[0])(np.array([-9.0, 9.0, ts[4]]))
    assert g0.tolist() == [us[0][0], us[0][-1], us[0][4]]


def _pair(problem, integrator, n_steps=20, seed=0):
    """The JAX and the port's hypersolvers on the same corrector parameters."""
    func, u0, t0, tn, sol = PROBLEMS[problem]
    jcls, tcls = INTEGRATORS[integrator]
    jhs = JHypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=n_steps, sol=sol, numerical_solver=jcls())
    jhs.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jhs.net.init(jax.random.PRNGKey(seed)))
    jhs.opt_state = jhs.optimizer.init(jhs.params)
    ths = Hypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=n_steps, sol=sol, numerical_solver=tcls())
    ths.load_jax_params(jax.tree.map(np.asarray, jhs.params))
    return jhs, ths


@pytest.mark.parametrize('problem', list(PROBLEMS))
@pytest.mark.parametrize('integrator', list(INTEGRATORS))
def test_residual_targets_and_corrected_rollouts_match_jax(problem, integrator):
    jhs, ths = _pair(problem, integrator)
    assert _rel(ths.residual, jhs.residual) < 1e-10
    assert _rel(ths._loss(), jhs._loss(jhs.params)) < 1e-10
    func, u0, t0, tn, _ = PROBLEMS[problem]
    jcls, tcls = INTEGRATORS[integrator]
    want = jcls().solve(func, u0, t0, tn, 20, hypernet=jhs.net, params=jhs.params)
    with torch.no_grad():
        got = tcls().solve(func, u0, t0, tn, 20, hypernet=ths.net)
    plain_want = jcls().solve(func, u0, t0, tn, 20)
    plain_got = tcls().solve(func, u0, t0, tn, 20)
    for g, w in zip(got + plain_got, list(want) + list(plain_want), strict=True):
        assert _rel(g, w) < 1e-10
    for g, w in zip(ths.get_solution()(np.linspace(t0, tn, 33)), jhs.get_solution()(np.linspace(t0, tn, 33)),
                    strict=True):
        assert _rel(g, w) < 1e-10


@pytest.mark.parametrize('integrator', ['euler', 'heun'])
def test_fit_steps_match_optax(integrator):
    jhs, ths = _pair('sin-cos', integrator, n_steps=30, seed=1)
    jhs.fit(5)
    ths.fit(5)
    assert ths.global_epoch == jhs.global_epoch == 5 and ths.local_epoch == 5
    assert _rel(ths.metrics_history['train_loss'], jhs.metrics_history['train_loss']) < 1e-9
    for lin, lp in zip(ths.net.linears, jhs.params['layers'], strict=True):
        assert _rel(lin.weight.detach().numpy().T, lp['W']) < 1e-9
        assert _rel(lin.bias.detach().numpy(), lp['b']) < 1e-9


def test_hypersolver_beats_plain_euler():
    func, u0, t0, tn, sol = PROBLEMS['decay']
    torch.manual_seed(0)
    hs = Hypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=20, sol=sol, numerical_solver=Euler())
    hs.fit(500)
    ts = np.linspace(0, 2, 37)
    (corrected,) = hs.get_solution()(ts)
    (plain,) = DiscreteSolution1D(*Euler().solve(func, u0, t0, tn, 20))(ts)
    err_corrected = np.abs(corrected.numpy() - np.exp(-ts)).max()
    err_plain = np.abs(plain.numpy() - np.exp(-ts)).max()
    assert err_corrected < err_plain / 2, (err_corrected, err_plain)


def test_hypersolver_api():
    func, u0, t0, tn, _ = PROBLEMS['sin-cos']
    # the known solution may return tensors; the default net is FCNN(dim + 1 -> dim, (32, 32))
    hs = Hypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=10,
                     sol=lambda ts: [torch.sin(ts), torch.cos(ts)], numerical_solver=Heun(),
                     generator=torch.Generator().manual_seed(3))
    assert hs.net.n_input_units == 3 and hs.net.n_output_units == 2 and hs.net.hidden_units == (32, 32)
    again = Hypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=10, sol=PROBLEMS['sin-cos'][4],
                        numerical_solver=Heun(), generator=torch.Generator().manual_seed(3))
    for a, b in zip(hs.net.parameters(), again.net.parameters(), strict=True):
        assert torch.equal(a, b)  # the same generator draws the same net
    for lin in hs.net.linears:  # within nn.Linear's own bounds
        bound = 1 / np.sqrt(lin.in_features)
        assert lin.weight.abs().max() <= bound and lin.bias.abs().max() <= bound
    assert _rel(hs.residual, again.residual) < 1e-12
    sgd = Hypersolver(func=func, u0=u0, t0=t0, tn=tn, n_steps=10, sol=PROBLEMS['sin-cos'][4],
                      numerical_solver=Euler(), net=FCNN(3, 2, hidden_units=(8,)),
                      optimizer=lambda params: torch.optim.SGD(params, lr=1e-2))
    assert isinstance(sgd.optimizer, torch.optim.SGD)
    sgd.fit(3)
    assert sgd.global_epoch == 3 and len(sgd.metrics_history['train_loss']) == 3
    with pytest.raises(TypeError, match='u0 must be'):
        Hypersolver(func=func, u0='1', t0=t0, tn=tn, n_steps=10, sol=PROBLEMS['sin-cos'][4],
                    numerical_solver=Euler())
    # a bare tensor from a one-equation right-hand side is one equation, not one per point
    out = torch.ones(5)
    assert _normalize_rhs(out, 1) == [out] and len(_normalize_rhs(torch.ones(2, 5), 2)) == 2
