"""The PyTorch port's Field layer, condition and generator against the JAX
package, in float64 on the same numpy inputs and parameters.

Tolerance for values and derivatives: 1e-10 relative to the largest entry
(both packages do the same float64 arithmetic in other orders).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF
from neurodiffeq_tpu.conditions import DirichletBVP2D as JDirichletBVP2D
from neurodiffeq_tpu.generators import Generator2D as JGenerator2D
from neurodiffeq_tpu.networks import FCNN as JFCNN, SinActv as JSinActv, Tanh as JTanh
from neurodiffeq_tpu_torch import fields as F
from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
from neurodiffeq_tpu_torch.generators import Generator2D
from neurodiffeq_tpu_torch.networks import FCNN, SinActv, Tanh
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64 if dtype == torch.float64 else 32)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _cond(mod):
    """The flagship's boundary condition, built with either package's field math."""
    return (JDirichletBVP2D if mod is JF else DirichletBVP2D)(
        x_min=0.0, x_min_val=lambda y: 0 * y,
        x_max=1.0, x_max_val=lambda y: 0 * y,
        y_min=0.0, y_min_val=lambda x: mod.sin(np.pi * x),
        y_max=1.0, y_max_val=lambda x: 0 * x)


def _nets(hidden=(16,), actv='tanh', seed=0):
    jnet = JFCNN(2, 1, hidden_units=hidden, actv=JSinActv if actv == 'sin' else JTanh)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    tnet = FCNN(2, 1, hidden_units=hidden, actv=SinActv if actv == 'sin' else Tanh, dtype=torch.float64)
    tnet.load_jax_params([{k: np.asarray(v) for k, v in lp.items()} for lp in params['layers']])
    return jnet, params, tnet


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _laplace_family(mod, u, x, y):
    """u, its first and second partials, and its Laplacian."""
    return ([u] + [mod.diff(u, c, k) for c in (x, y) for k in (1, 2)]
            + [mod.diff(u, x, 2) + mod.diff(u, y, 2)])


@pytest.mark.parametrize('hidden,actv', [((16,), 'tanh'), ((8, 8), 'sin')])
def test_diff_of_enforced_network_matches_jax(hidden, actv):
    pts = np.random.RandomState(3).rand(50, 2)
    jnet, params, tnet = _nets(hidden, actv)

    @jax.jit
    def jax_values(p):
        jx, jy = JF.coords_from_points(p)
        return [f.value for f in _laplace_family(JF, _cond(JF).enforce(jnet, params, jx, jy), jx, jy)]

    tx, ty = F.coords_from_points(torch.tensor(pts))
    fields = _laplace_family(F, _cond(F).enforce(tnet, tx, ty), tx, ty)
    for t, j in zip(fields, jax_values(jnp.asarray(pts))):
        assert t.shape == j.shape
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0


def test_lifted_math_matches_jax():
    """Each lifted op with a Taylor rule, and the generic path-jvp rule
    (a power of two series), against the JAX package at order 2."""
    pts = np.random.RandomState(4).rand(30, 2) + 0.5
    exprs = [
        lambda m, x, y: m.exp(x * y) + m.log(x) * m.sqrt(y),
        lambda m, x, y: m.tanh(x - y) / (1 + m.sigmoid(y)) - m.erf(x * 0.3),
        lambda m, x, y: m.sinh(x) * m.cosh(y) - m.cos(x) ** 3 + 2.0 ** y,
        lambda m, x, y: m.abs(x - 1.0) * (-y) + 1.0 / x,
        lambda m, x, y: x ** y,
    ]

    def family(mod, x, y):
        return [mod.diff(e(mod, x, y), c, k) for e in exprs for c in (x, y) for k in (1, 2)]

    jax_values = jax.jit(lambda p: [f.value for f in family(JF, *JF.coords_from_points(p))])
    for t, j in zip(family(F, *F.coords_from_points(torch.tensor(pts))), jax_values(jnp.asarray(pts))):
        _close(t.value, j)


def test_exact_constraint_on_all_edges():
    """Untrained net: the enforced solution equals the boundary data on the
    four edges to 1e-8."""
    _, _, tnet = _nets()
    s = np.linspace(0, 1, 41)
    edges = [(np.zeros_like(s), s, 0 * s), (np.ones_like(s), s, 0 * s),
             (s, np.zeros_like(s), np.sin(np.pi * s)), (s, np.ones_like(s), 0 * s)]
    for xs, ys, want in edges:
        x, y = F.coords_from_points(torch.tensor(np.stack([xs, ys], axis=1)))
        u = _cond(F).enforce(tnet, x, y)
        assert np.abs(u.value.detach().numpy()[:, 0] - want).max() < 1e-8


def test_torch_math_on_a_field_raises():
    x, y = F.coords_from_points(torch.rand(5, 2, dtype=torch.float64))
    with pytest.raises(TypeError):
        torch.exp(x)
    with pytest.raises(TypeError):
        F.diff(x.value, y)
    assert isinstance(torch.ones(5, 1, dtype=torch.float64) * x, F.Field)
    assert isinstance(np.ones((5, 1)) * x, F.Field)


def test_unported_paths_raise():
    """A field without a Taylor rule composes (repeated
    ``torch.autograd.grad``), counting one fallback, and equals torch's
    backward; a mixed partial of a network field equals torch's double
    backward. (The name dates from before the compose fallback was ported,
    when such a field raised.)"""
    pts = torch.rand(6, 2, dtype=torch.float64)
    x, y = F.coords_from_points(pts)
    _, _, tnet = _nets()
    leaf = pts.clone().requires_grad_()
    (g,) = torch.autograd.grad(tnet(leaf).sum(), leaf, create_graph=True)
    (hx,) = torch.autograd.grad(g[:, 0].sum(), leaf)
    _close(F.diff(F.diff(F.network_field(tnet, (x, y)), x), y).value[:, 0], hx[:, 1])
    relu_net = FCNN(2, 1, hidden_units=(4,), actv=torch.nn.ReLU, dtype=torch.float64)
    F.reset_taylor_fallback_count()
    got = F.diff(F.network_field(relu_net, (x, y)), x).value
    assert F.taylor_fallback_count() == 1
    (want,) = torch.autograd.grad(relu_net(leaf).sum(), leaf)
    _close(got[:, 0], want[:, 0])
    F.reset_taylor_fallback_count()


@pytest.mark.parametrize('grid', [(32, 32), (8, 8), (5, 11)])
def test_equally_spaced_grid_matches_jax_exactly(grid):
    jx, jy = jax.jit(lambda k: JGenerator2D(grid, (0, 0), (1, 1), method='equally-spaced').sample(k))(
        jax.random.PRNGKey(0))
    tx, ty = Generator2D(grid, (0, 0), (1, 1), method='equally-spaced', dtype=torch.float64).sample(None)
    assert np.array_equal(np.asarray(jx), tx.numpy())
    assert np.array_equal(np.asarray(jy), ty.numpy())


def test_noisy_grid_matches_in_distribution():
    gen = Generator2D((32, 32), (0, 0), (1, 1), dtype=torch.float64)
    grid = Generator2D((32, 32), (0, 0), (1, 1), method='equally-spaced', dtype=torch.float64).sample(None)
    rng = torch.Generator().manual_seed(0)
    noise = torch.stack([torch.stack(gen.sample(rng)) - torch.stack(grid) for _ in range(8)])
    std = 1 / 32 / 4
    assert abs(noise.mean().item()) < 0.05 * std
    assert abs(noise.std().item() / std - 1) < 0.02
    # two draws differ, and the same seed repeats the draw
    a = gen.sample(torch.Generator().manual_seed(1))[0]
    assert torch.equal(a, gen.sample(torch.Generator().manual_seed(1))[0])
    assert not torch.equal(a, gen.sample(torch.Generator().manual_seed(2))[0])
