"""The PyTorch port's time-dependent 1-D conditions against the JAX package, in float64.

- ``IBVP1D`` (the heat equation through ``Solver2D``, ``examples/heat_equation.py``
  cut to an FCNN 2-8-8-1 on 16 points) and ``DoubleEndedBVP1D`` (u'' + u = 0
  through ``Solver1D``), each in its four boundary combinations with
  nonzero boundary data: loss and every parameter gradient agree to 1e-10
  relative, the Neumann ends through the compose path;
- every variant is exact at its anchors with an untrained net: the initial
  values, the Dirichlet values and the Neumann slopes (``diff`` of the
  solution's field) to 1e-10;
- a short heat fit lowers the loss with no fallback.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF
from neurodiffeq_tpu.conditions import DoubleEndedBVP1D as JDoubleEndedBVP1D, IBVP1D as JIBVP1D
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import Solver1D as JSolver1D, Solver2D as JSolver2D
from neurodiffeq_tpu_torch import fields as F
from neurodiffeq_tpu_torch.conditions import DoubleEndedBVP1D, IBVP1D
from neurodiffeq_tpu_torch.generators import Generator2D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver1D, Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
K, L, T = 0.3, 2.0, 1.5
VARIANTS = ['dd', 'dn', 'nd', 'nn']  # (x_min, x_max): Dirichlet or Neumann


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _close(got, want, tol=TOL):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


# boundary data: t_min_val(x), and per end the value or the slope as a function of t
def _ibvp_data(mod):
    return dict(t_min_val=lambda x: mod.cos(np.pi / L * x) + 0.1 * x,
                x_min_val=lambda t: 1 + 0.2 * mod.sin(t), x_min_prime=lambda t: 0.1 + 0.3 * mod.sin(t),
                x_max_val=lambda t: np.cos(np.pi) + 0.2 + 0.5 * t, x_max_prime=lambda t: 0.1 - 0.4 * t)


def _ibvp(mod, variant):
    data = _ibvp_data(mod)
    keys = [('x_min_val' if variant[0] == 'd' else 'x_min_prime'),
            ('x_max_val' if variant[1] == 'd' else 'x_max_prime')]
    cls = JIBVP1D if mod is JF else IBVP1D
    return cls(x_min=0.0, x_max=L, t_min=0.0, t_min_val=data['t_min_val'], **{k: data[k] for k in keys})


DE_DATA = dict(x_min_val=0.5, x_min_prime=-0.7, x_max_val=1.5, x_max_prime=0.3)


def _double_ended(mod, variant):
    keys = [('x_min_val' if variant[0] == 'd' else 'x_min_prime'),
            ('x_max_val' if variant[1] == 'd' else 'x_max_prime')]
    cls = JDoubleEndedBVP1D if mod is JF else DoubleEndedBVP1D
    return cls(x_min=0.0, x_max=1.0, **{k: DE_DATA[k] for k in keys})


def _pair(kind, variant, seed):
    """(JAX solver, its float64 parameters, the port's solver loaded with them, points)."""
    n_in = 2 if kind == 'ibvp' else 1
    jnet = JFCNN(n_in, 1, hidden_units=(8, 8))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    net = FCNN(n_in, 1, hidden_units=(8, 8))
    if kind == 'ibvp':
        def solver(mod, cls, nets):
            return cls(pde_system=lambda u, x, t: [mod.diff(u, t) - K * mod.diff(u, x, 2)],
                       conditions=[_ibvp(mod, variant)], xy_min=(0, 0), xy_max=(L, T), nets=nets)

        js, ts = solver(JF, JSolver2D, [jnet]), solver(F, Solver2D, [net])
        pts = np.random.RandomState(seed).rand(16, 2) * [L, T]
    else:
        def solver(mod, cls, nets):
            return cls(ode_system=lambda u, x: [mod.diff(u, x, 2) + u], conditions=[_double_ended(mod, variant)],
                       t_min=0.0, t_max=1.0, nets=nets)

        js, ts = solver(JF, JSolver1D, [jnet]), solver(F, Solver1D, [net])
        pts = np.random.RandomState(seed).rand(16, 1)
    ts.load_jax_params([jax.tree.map(np.asarray, params)])
    return js, params, ts, pts


@pytest.mark.parametrize('kind', ['ibvp', 'double-ended'])
@pytest.mark.parametrize('variant', VARIANTS)
def test_loss_and_gradients_match_jax(kind, variant):
    js, params, ts, pts = _pair(kind, variant, seed=VARIANTS.index(variant))
    JF.reset_taylor_fallback_count()  # counted as the JAX package traces
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(js._loss_and_metrics, has_aux=True))(
        [params], [jnp.asarray(pts[:, i:i + 1]) for i in range(pts.shape[1])])
    F.reset_taylor_fallback_count()
    tloss, _ = ts._loss_and_metrics([torch.tensor(pts[:, i:i + 1]) for i in range(pts.shape[1])])
    tloss.backward()
    # a Neumann end anchors through pin, which composes: in the heat residual
    # u_t and u_xx; in u'' + u, u'' and each anchor of u's value
    assert F.taylor_fallback_count() == JF.taylor_fallback_count()
    assert (F.taylor_fallback_count() == 0) == (variant == 'dd')
    _close(tloss, jloss)
    for lin, lp in zip(ts.nets[0].linears, jgrads[0]['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


def _field_at(solver, *cols):
    """The solution's Field and its coordinate Fields at the given columns."""
    (u,), coords = solver._forward([torch.as_tensor(c, dtype=torch.float64).reshape(-1, 1) for c in cols])
    return u, coords


@pytest.mark.parametrize('variant', VARIANTS)
def test_ibvp_exact_at_its_anchors(variant):
    _, _, ts, _ = _pair('ibvp', variant, seed=10)
    data = _ibvp_data(F)
    xs, tt = np.linspace(0, L, 9), np.linspace(0, T, 7)
    with torch.no_grad():
        u, (x, t) = _field_at(ts, xs, np.zeros_like(xs))
        _close(u.value, data['t_min_val'](x).value)
        for end, key in ((0.0, variant[0]), (L, variant[1])):
            u, (x, t) = _field_at(ts, np.full_like(tt, end), tt)
            name = f"x_{'min' if end == 0.0 else 'max'}_{'val' if key == 'd' else 'prime'}"
            got = u if key == 'd' else F.diff(u, x)
            want = data[name](t)
            _close(got.value, want.value if isinstance(want, F.Field) else want)


@pytest.mark.parametrize('variant', VARIANTS)
def test_double_ended_exact_at_its_anchors(variant):
    _, _, ts, _ = _pair('double-ended', variant, seed=11)
    with torch.no_grad():
        for end, key in ((0.0, variant[0]), (1.0, variant[1])):
            u, (x,) = _field_at(ts, np.array([end, end]))
            name = f"x_{'min' if end == 0.0 else 'max'}_{'val' if key == 'd' else 'prime'}"
            got = (u if key == 'd' else F.diff(u, x)).value
            _close(got, torch.full((2, 1), DE_DATA[name], dtype=torch.float64))


def test_short_heat_fit_lowers_the_loss():
    """``examples/heat_equation.py``'s Dirichlet problem at 8 x 8, ``fit(150)``."""
    torch.manual_seed(0)
    cond = IBVP1D(x_min=0.0, x_max=L, t_min=0.0, t_min_val=lambda x: F.sin(np.pi / L * x),
                  x_min_val=lambda t: 0 * t, x_max_val=lambda t: 0 * t)
    solver = Solver2D(pde_system=lambda u, x, t: [F.diff(u, t) - K * F.diff(u, x, 2)], conditions=[cond],
                      xy_min=(0, 0), xy_max=(L, T), nets=[FCNN(2, 1, hidden_units=(16, 16))],
                      train_generator=Generator2D((8, 8), (0, 0), (L, T), method='equally-spaced-noisy'),
                      valid_generator=Generator2D((8, 8), (0, 0), (L, T), method='equally-spaced'),
                      n_batches_valid=1, generator=torch.Generator().manual_seed(0))
    F.reset_taylor_fallback_count()
    solver.fit(150, tqdm_file=None)
    assert F.taylor_fallback_count() == 0
    hist = solver.metrics_history['train_loss']
    assert np.mean(hist[-15:]) < 0.5 * np.mean(hist[:15])
    xs = np.linspace(0, L, 5)
    assert np.abs(solver.get_solution()(xs, 0 * xs, to_numpy=True) - np.sin(np.pi * xs / L)).max() < 1e-12
