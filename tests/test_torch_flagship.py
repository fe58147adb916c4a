"""The PyTorch port's flagship training path against the JAX package.

The flagship is the 2-D Laplace Dirichlet problem the benchmark measures
(``__graft_entry__._flagship_solver``), cut here to a grid of 8 x 8 and one
hidden layer of 16. Both solvers get the same parameters (through
``FCNN.load_jax_params``) and the same points, in float64. Loss and every
parameter gradient agree to 1e-10 relative; the parameters after 5 Adam
steps (optax against ``torch.optim.Adam``) to 1e-9 relative.
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu_torch import fields as F, diff
from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
from neurodiffeq_tpu_torch.generators import Generator2D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _flagship_solver  # noqa: E402

torch.set_num_threads(2)
GRID, HIDDEN = (8, 8), (16,)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64 if dtype == torch.float64 else 32)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _torch_flagship(grid=GRID, hidden=HIDDEN, **kwargs):
    """The port's counterpart of ``_flagship_solver``, in float64 on the CPU."""
    dt = torch.float64
    cond = DirichletBVP2D(
        x_min=0.0, x_min_val=lambda y: 0 * y,
        x_max=1.0, x_max_val=lambda y: 0 * y,
        y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x),
        y_max=1.0, y_max_val=lambda x: 0 * x)
    return Solver2D(
        pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)],
        conditions=[cond], xy_min=(0.0, 0.0), xy_max=(1.0, 1.0),
        nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=hidden, dtype=dt)],
        train_generator=Generator2D(grid, (0, 0), (1, 1), method='equally-spaced-noisy', dtype=dt),
        valid_generator=Generator2D(grid, (0, 0), (1, 1), method='equally-spaced', dtype=dt),
        dtype=dt, **kwargs)


@pytest.fixture
def pair():
    jsolver = _flagship_solver(grid=GRID, hidden=HIDDEN)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = _torch_flagship()
    tsolver.nets[0].load_jax_params([{k: np.asarray(v) for k, v in lp.items()}
                                     for lp in jparams[0]['layers']])
    pts = np.random.RandomState(7).rand(GRID[0] * GRID[1], 2)
    return jsolver, jparams, tsolver, pts


def _jax_cols(pts):
    return [jnp.asarray(pts[:, :1]), jnp.asarray(pts[:, 1:])]


def _torch_cols(pts):
    return [torch.tensor(pts[:, :1]), torch.tensor(pts[:, 1:])]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _torch_params(net):
    """The port's parameters in the JAX layout: [(W (in, out), b), ...]."""
    return [(lin.weight.detach().numpy().T, lin.bias.detach().numpy()) for lin in net.linears]


def test_loss_and_gradients_match_jax(pair):
    jsolver, jparams, tsolver, pts = pair
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jsolver._loss_and_metrics, has_aux=True))(
        jparams, _jax_cols(pts))
    F.reset_taylor_fallback_count()
    tloss, _ = tsolver._loss_and_metrics(_torch_cols(pts))
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    assert _rel(tloss.item(), jloss) < 1e-10
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers']):
        assert _rel(lin.weight.grad.numpy().T, lp['W']) < 1e-10
        assert _rel(lin.bias.grad.numpy(), lp['b']) < 1e-10


def test_adam_steps_match_optax(pair):
    jsolver, jparams, tsolver, pts = pair
    opt = optax.adam(1e-3)
    state = opt.init(jparams)
    cols = _jax_cols(pts)
    grad_fn = jax.jit(jax.grad(lambda p: jsolver._loss_and_metrics(p, cols)[0]))
    for _ in range(5):
        updates, state = opt.update(grad_fn(jparams), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

    tcols = _torch_cols(pts)
    for _ in range(5):
        tsolver.optimizer.zero_grad()
        tsolver._loss_and_metrics(tcols)[0].backward()
        tsolver.optimizer.step()
    for (W, b), lp in zip(_torch_params(tsolver.nets[0]), jparams[0]['layers']):
        assert _rel(W, lp['W']) < 1e-9
        assert _rel(b, lp['b']) < 1e-9


def test_short_fit_lowers_loss_and_yields_a_solution():
    torch.manual_seed(0)
    solver = _torch_flagship(n_batches_valid=1, generator=torch.Generator().manual_seed(0))
    F.reset_taylor_fallback_count()
    solver.fit(200)
    assert F.taylor_fallback_count() == 0
    hist = solver.metrics_history['train_loss']
    assert len(hist) == 200 and len(solver.metrics_history['valid_loss']) == 200
    assert np.mean(hist[-20:]) < np.mean(hist[:20])
    assert solver.lowest_loss == min(solver.metrics_history['valid_loss'])

    xs, ys = np.meshgrid(np.linspace(0, 1, 11), np.linspace(0, 1, 11))
    sol = solver.get_solution()
    u = sol(xs, ys, to_numpy=True)
    assert u.shape == (11, 11) and np.isfinite(u).all()
    assert np.abs(u[0] - np.sin(np.pi * xs[0])).max() < 1e-12  # the y = 0 edge is exact
    res = solver.get_residuals(xs, ys, to_numpy=True)
    assert res.shape == (11, 11) and np.isfinite(res).all()
    # the solution is a snapshot: training on does not move it
    solver.fit(5)
    assert np.array_equal(sol(xs, ys, to_numpy=True), u)
