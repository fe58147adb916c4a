"""The PyTorch port's lid-driven cavity slice against the JAX package, in
float64.

The primitive-variable (u, v, p) cavity and the streamfunction-vorticity
cavity (``examples/lid_driven_cavity.py`` and
``examples/cavity_streamfunction.py``, cut to a shared FCNN 2-32-3 / 2-32-2
on N = 128 points): the loss and every parameter gradient agree to 1e-10
relative across the JAX package, the port's ``Solver2D`` and plain torch
autograd on the same parameters and points; three Adam steps under the
cosine anneal match optax to 1e-9; a shared net runs one ``taylor_apply``
per batch. Also here: ``GenericSolver`` on a 3-D Poisson problem (loss and
gradients to 1e-10, its solution to 1e-10) and ``Generator3D``
(``'equally-spaced'`` bit for bit, the random methods in distribution).
"""
import os
import sys
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF
from neurodiffeq_tpu.conditions import BaseCondition as JBaseCondition
from neurodiffeq_tpu.generators import Generator3D as JGenerator3D, PredefinedGenerator as JPredefinedGenerator
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import GenericSolver as JGenericSolver, Solver2D as JSolver2D
from neurodiffeq_tpu_torch import diff, fields as F
from neurodiffeq_tpu_torch.conditions import BaseCondition
from neurodiffeq_tpu_torch.generators import Generator1D, Generator2D, Generator3D, PredefinedGenerator
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import GenericSolver, Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'examples'))
import cavity_streamfunction as jcsf  # noqa: E402
import lid_driven_cavity as jldc  # noqa: E402

torch.set_num_threads(2)
F64 = torch.float64
TOL = 1e-10
N, HIDDEN, RE = 128, (32,), 100.0
PTS = np.random.RandomState(11).rand(N, 2)


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
    want = want.detach().numpy() if torch.is_tensor(want) else np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# ----------------------------------------------- the port's cavity problems

def u_lid(x):
    """The primitive cavity's smoothed lid profile."""
    return (1 - F.exp(-50.0 * x)) * (1 - F.exp(50.0 * (x - 1)))


class HardCavityU(BaseCondition):
    def parameterize(self, out, x, y):
        return x * (1 - x) * y * (1 - y) * out + y * u_lid(x)


class HardCavityV(BaseCondition):
    def parameterize(self, out, x, y):
        return x * (1 - x) * y * (1 - y) * out


class HardCavityP(BaseCondition):
    def parameterize(self, out, x, y):
        return (1 - F.exp(-x)) * (1 - F.exp(-y)) * out


def navier_stokes(u, v, p, x, y):
    nu = 1.0 / RE
    return [u * diff(u, x) + v * diff(u, y) + diff(p, x) - nu * (diff(u, x, 2) + diff(u, y, 2)),
            u * diff(v, x) + v * diff(v, y) + diff(p, y) - nu * (diff(v, x, 2) + diff(v, y, 2)),
            diff(u, x) + diff(v, y)]


def u_lid_c1(x, exp=F.exp):
    """The streamfunction cavity's C^1 lid profile (A = 50)."""
    return (1 - exp(-((50.0 * x) ** 2))) * (1 - exp(-((50.0 * (x - 1)) ** 2)))


class PsiCavity(BaseCondition):
    def parameterize(self, out, x, y):
        bump = x * (1 - x) * y * (1 - y)
        return y * y * (y - 1) * F.exp(-20.0 * (1 - y)) * u_lid_c1(x) + bump * bump * out


class ScaledOutput(BaseCondition):
    def parameterize(self, out, x, y):
        return 50.0 * out


def stream_vorticity(psi, w, x, y):
    nu = 1.0 / RE
    u, v = diff(psi, y), -diff(psi, x)
    return [w + diff(psi, x, 2) + diff(psi, y, 2),
            u * diff(w, x) + v * diff(w, y) - nu * (diff(w, x, 2) + diff(w, y, 2))]


FORMS = {  # name -> (port conditions, equations, residual weights, JAX conditions, JAX equations)
    'primitive': (lambda: [HardCavityU(), HardCavityV(), HardCavityP()], navier_stokes, None,
                  lambda: [jldc.HardCavityU(), jldc.HardCavityV(), jldc.HardCavityP()],
                  jldc.navier_stokes(RE)),
    'psi-omega': (lambda: [PsiCavity(), ScaledOutput()], stream_vorticity, [0.3 ** 2, 1.0],
                  lambda: [jcsf.PsiCavity(20.0), jcsf.ScaledOutput(50.0)], jcsf.stream_vorticity(RE)),
}


def _impose(conds):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    return conds


def _solvers(form, hidden=HIDDEN, jax_optimizer=None):
    """The JAX and the port's ``Solver2D`` of one cavity form, one shared net
    with the same float64 parameters, training on ``PTS``."""
    tconds, eqs, weights, jconds, jeqs = FORMS[form]
    n_out = len(tconds())
    jnet = JFCNN(2, n_out, hidden_units=hidden)
    jkw = {} if jax_optimizer is None else {'optimizer': jax_optimizer}
    jsolver = JSolver2D(jeqs, _impose(jconds()), nets=[jnet] * n_out, train_generator=JPredefinedGenerator(*PTS.T),
                        valid_generator=JPredefinedGenerator(*PTS.T), n_batches_valid=0,
                        residual_weights=weights, **jkw)
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tnet = FCNN(2, n_out, hidden_units=hidden)
    tsolver = Solver2D(eqs, _impose(tconds()), nets=[tnet] * n_out, train_generator=PredefinedGenerator(*PTS.T),
                       valid_generator=PredefinedGenerator(*PTS.T), n_batches_valid=0, residual_weights=weights)
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    return jsolver, tsolver


def _autograd_loss(form, layers, pts):
    """The cavity loss in plain torch: the net's forward, the trial
    functions and every derivative by ``torch.autograd.grad``."""
    xx, yy = (torch.tensor(pts[:, i], requires_grad=True) for i in range(2))
    h = torch.stack([xx, yy], dim=1)
    for W, b in layers[:-1]:
        h = torch.tanh(h @ W + b)
    out = h @ layers[-1][0] + layers[-1][1]

    def d(f, t):
        return torch.autograd.grad(f, t, grad_outputs=torch.ones_like(f), create_graph=True)[0]

    nu = 1.0 / RE
    bump = xx * (1 - xx) * yy * (1 - yy)
    if form == 'primitive':
        u = bump * out[:, 0] + yy * (1 - torch.exp(-50.0 * xx)) * (1 - torch.exp(50.0 * (xx - 1)))
        v = bump * out[:, 1]
        p = (1 - torch.exp(-xx)) * (1 - torch.exp(-yy)) * out[:, 2]
        u_x, u_y, v_x, v_y = d(u, xx), d(u, yy), d(v, xx), d(v, yy)
        res = [u * u_x + v * u_y + d(p, xx) - nu * (d(u_x, xx) + d(u_y, yy)),
               u * v_x + v * v_y + d(p, yy) - nu * (d(v_x, xx) + d(v_y, yy)),
               u_x + v_y]
    else:
        psi = yy * yy * (yy - 1) * torch.exp(-20.0 * (1 - yy)) * u_lid_c1(xx, torch.exp) + bump * bump * out[:, 0]
        w = 50.0 * out[:, 1]
        psi_x, psi_y, w_x, w_y = d(psi, xx), d(psi, yy), d(w, xx), d(w, yy)
        res = [(w + d(psi_x, xx) + d(psi_y, yy)) * (0.3 ** 2) ** 0.5,
               psi_y * w_x - psi_x * w_y - nu * (d(w_x, xx) + d(w_y, yy))]
    return (torch.stack(res, dim=1) ** 2).mean()


@pytest.mark.parametrize('form', list(FORMS))
def test_cavity_loss_and_gradients_match_jax_and_autograd(form):
    jsolver, tsolver = _solvers(form)
    cols = [PTS[:, i:i + 1] for i in range(2)]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(c) for c in cols])[0]))(jsolver.params)
    (jgrads,) = jgrads  # one parameter pytree: the net is shared
    F.reset_taylor_fallback_count()
    tloss = tsolver._loss_and_metrics([torch.tensor(c) for c in cols])[0]
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    layers = [(torch.tensor(np.asarray(lp['W'])).requires_grad_(), torch.tensor(np.asarray(lp['b'])).requires_grad_())
              for lp in jsolver.params[0]['layers']]
    aloss = _autograd_loss(form, layers, PTS)
    aloss.backward()
    _close(tloss, jloss)
    _close(aloss, jloss)
    for lin, lp, (W, b) in zip(tsolver.nets[0].linears, jgrads['layers'], layers, strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])
        _close(W.grad, lp['W'])
        _close(b.grad, lp['b'])


def test_cosine_annealed_adam_steps_match_optax():
    """Three updates under optax's ``cosine_decay_schedule`` (1e-3, alpha
    0.01, here over 2 steps so that the floor is reached) against
    ``torch.optim.Adam`` under a ``LambdaLR`` of the same formula."""
    steps, alpha = 2, 0.01
    schedule = optax.cosine_decay_schedule(1e-3, steps, alpha=alpha)
    jsolver, tsolver = _solvers('primitive', jax_optimizer=optax.adam(schedule))
    jsolver.fit(3, tqdm_file=None)
    sched = torch.optim.lr_scheduler.LambdaLR(
        tsolver.optimizer, lambda k: alpha + (1 - alpha) * 0.5 * (1 + np.cos(np.pi * min(k, steps) / steps)))
    tsolver.fit(3, callbacks=[lambda s: sched.step()], tqdm_file=None)
    _close(tsolver.metrics_history['train_loss'], jsolver.metrics_history['train_loss'], tol=1e-9)
    for lin, lp in zip(tsolver.nets[0].linears, jsolver.params[0]['layers'], strict=True):
        _close(lin.weight.T, lp['W'], tol=1e-9)
        _close(lin.bias, lp['b'], tol=1e-9)


@pytest.mark.parametrize('form', list(FORMS))
def test_a_shared_net_runs_once_per_batch(form, monkeypatch):
    """Three (two) conditions slice the columns of one network series: one
    ``taylor_apply`` per training batch, at order 2, on the axes."""
    calls = []
    real = FCNN.taylor_apply
    monkeypatch.setattr(FCNN, 'taylor_apply',
                        lambda self, s, ctx: calls.append((ctx.is_axes, ctx.order)) or real(self, s, ctx))
    _, tsolver = _solvers(form)
    tsolver.fit(3, tqdm_file=None)
    assert calls == [(True, 2)] * 3


def test_trained_cavity_keeps_its_walls():
    """A short float64 fit on fresh uniform points (``Generator1D *
    Generator1D``, as the configuration samples): the loss on a fixed grid
    falls, and with the trained net u = v = 0 on the walls, u = u_lid on the
    lid and p = 0 on x = 0 and y = 0."""
    torch.manual_seed(0)
    net = FCNN(2, 3, hidden_units=(16, 16))
    solver = Solver2D(navier_stokes, _impose([HardCavityU(), HardCavityV(), HardCavityP()]), nets=[net] * 3,
                      train_generator=Generator1D(256, 0.0, 1.0) * Generator1D(256, 0.0, 1.0),
                      valid_generator=Generator2D((16, 16), (0, 0), (1, 1), method='equally-spaced'),
                      n_batches_valid=1, generator=torch.Generator().manual_seed(0))
    solver.fit(60, tqdm_file=None)
    hist = solver.metrics_history['valid_loss']
    assert hist[-1] < hist[0]
    s = np.linspace(0, 1, 21)
    zeros, ones = np.zeros_like(s), np.ones_like(s)
    sol = solver.get_solution()
    for xs, ys in ((zeros, s), (ones, s), (s, zeros)):
        u, v, _ = sol(xs, ys, to_numpy=True)
        assert np.abs(u).max() < 1e-12 and np.abs(v).max() < 1e-12
    u, v, _ = sol(s, ones, to_numpy=True)
    _close(u, (1 - np.exp(-50.0 * s)) * (1 - np.exp(50.0 * (s - 1))), tol=1e-12)
    assert np.abs(v).max() < 1e-12
    for xs, ys in ((zeros, s), (s, zeros)):
        assert np.abs(sol(xs, ys, to_numpy=True)[2]).max() < 1e-12


# -------------------------------------------------------------- GenericSolver

def _box(base):
    class ZeroBoundaryBox(base):
        """u = 64 x(1-x) y(1-y) z(1-z) ANN: zero on the faces of the unit cube."""

        def parameterize(self, out, x, y, z):
            return 64 * x * (1 - x) * y * (1 - y) * z * (1 - z) * out

    return ZeroBoundaryBox()


def _poisson_3d(mod, d):
    """Delta u = -3 pi^2 sin(pi x) sin(pi y) sin(pi z) in ``mod``'s field math."""
    def pde(u, x, y, z):
        src = -3 * np.pi ** 2 * mod.sin(np.pi * x) * mod.sin(np.pi * y) * mod.sin(np.pi * z)
        return [d(u, x, 2) + d(u, y, 2) + d(u, z, 2) - src]

    return pde


def test_generic_solver_matches_jax():
    pts = np.random.RandomState(5).rand(64, 3)
    jnet = JFCNN(3, 1, hidden_units=(16, 16))
    jsolver = JGenericSolver(diff_eqs=_poisson_3d(JF, jdiff), conditions=[_box(JBaseCondition)], nets=[jnet],
                             train_generator=JPredefinedGenerator(*pts.T), valid_generator=JPredefinedGenerator(*pts.T))
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = GenericSolver(diff_eqs=_poisson_3d(F, diff), conditions=[_box(BaseCondition)],
                            nets=[FCNN(3, 1, hidden_units=(16, 16))], train_generator=PredefinedGenerator(*pts.T),
                            valid_generator=PredefinedGenerator(*pts.T))
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    cols = [pts[:, i:i + 1] for i in range(3)]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(c) for c in cols])[0]))(jsolver.params)
    F.reset_taylor_fallback_count()
    tloss = tsolver._loss_and_metrics([torch.tensor(c) for c in cols])[0]
    tloss.backward()
    assert F.taylor_fallback_count() == 0
    _close(tloss, jloss)
    for lin, lp in zip(tsolver.nets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])
    q = np.random.RandomState(6).rand(3, 17)
    _close(tsolver.get_solution(best=False)(*q, to_numpy=True), jsolver.get_solution(best=False)(*q))


# ---------------------------------------------------------------- Generator3D

@pytest.mark.parametrize('grid,lo,hi', [((10, 10, 10), (0, 0, 0), (1, 1, 1)),
                                        ((4, 5, 6), (-1.0, 0.5, 2.0), (2.0, 3.0, 7.0))])
def test_generator3d_equally_spaced_matches_jax_exactly(grid, lo, hi):
    want = jax.jit(lambda k: JGenerator3D(grid, lo, hi, method='equally-spaced').sample(k))(jax.random.PRNGKey(0))
    got = Generator3D(grid, lo, hi, method='equally-spaced').sample(None)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == F64 and np.array_equal(g.numpy(), np.asarray(w))


def test_generator3d_random_methods():
    grid = Generator3D((6, 7, 8), method='equally-spaced').sample(None)
    gen = Generator3D((6, 7, 8))
    assert gen.size == 336 and repr(gen).startswith('Generator3D(size=336')
    noise = torch.stack([torch.stack(gen.sample(torch.Generator().manual_seed(k))) - torch.stack(grid)
                         for k in range(20)])
    for i, n in enumerate((6, 7, 8)):
        assert abs(noise[:, i].std().item() * 4 * n - 1) < 0.05
    a = gen.sample(torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, gen.sample(torch.Generator().manual_seed(1))[0])
    # latin hypercube: every axis has one node in each of its n strata
    xs = Generator3D((4, 5, 6), (0, 0, 0), (1, 2, 3), method='latin-hypercube').sample(torch.Generator().manual_seed(0))
    for x, n, top in zip(xs, (4, 5, 6), (1, 2, 3)):
        strata = torch.unique(torch.floor(x / (top / n)))
        assert torch.equal(strata, torch.arange(n, dtype=F64))
    # 'halton' (the high-dimensional slice): 336 low-discrepancy points filling the box
    xs = Generator3D((6, 7, 8), (0, 0, 0), (1, 2, 3), method='halton').sample(torch.Generator().manual_seed(0))
    for x, top in zip(xs, (1, 2, 3)):
        assert x.shape == (336,) and x.min() >= 0 and x.max() < top
    with pytest.raises(ValueError):
        Generator3D(method='bogus')
