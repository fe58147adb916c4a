"""The PyTorch port's function bases against the JAX package, in float64.

Each basis on coordinate Fields (values and second partials) and on plain
tensors, each basis-space Laplacian on the coefficients of a radial net
loaded with the JAX net's parameters, and the 25 module-level harmonics
``Y0_0 ... Y4p4``: all to 1e-10 relative.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF, function_basis as JB
from neurodiffeq_tpu.conditions import NoCondition as JNoCondition
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu_torch import diff, fields as F, function_basis as B
from neurodiffeq_tpu_torch.conditions import NoCondition
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10


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


def _angular_bases(mod):
    """name -> (the basis in ``mod``, the arguments it takes)."""
    return {
        'legendre': (mod.LegendreBasis(5), 'x'),
        'custom': (mod.CustomBasis([lambda x: x * 1, lambda x: x ** 3 - 0.5]), 'x'),
        'zonal': (mod.ZonalSphericalHarmonics(max_degree=4), 'theta phi'),
        'zonal degrees': (mod.ZonalSphericalHarmonics(degrees=[1, 3]), 'theta phi'),
        'fourier': (mod.RealFourierSeries(3), 'phi'),
        'real harmonics': (mod.RealSphericalHarmonics(4), 'theta phi'),
    }


BASES = list(_angular_bases(B))
PTS = np.random.RandomState(0).rand(23, 2) * [np.pi * 0.9, 2 * np.pi] + [0.05 * np.pi, 0.0]


@pytest.mark.parametrize('name', BASES)
def test_bases_on_fields_match_jax(name):
    jbasis, kind = _angular_bases(JB)[name]
    tbasis, _ = _angular_bases(B)[name]

    def build(mod, d, a, b):
        args = (mod.cos(a),) if kind == 'x' else (b,) if kind == 'phi' else (a, b)
        y = (jbasis if mod is JF else tbasis)(*args)
        last = y[:, y.shape[1] - 1:y.shape[1]]
        return [y, d(last, a, 2), d(last, b, 2), d(y[:, 1:2], a)]

    @jax.jit
    def jax_values(p):
        a, b = JF.coords_from_points(p)
        return [f.value for f in build(JF, jdiff, a, b)]

    a, b = F.coords_from_points(torch.tensor(PTS))
    F.reset_taylor_fallback_count()
    got = build(F, diff, a, b)
    for t, j in zip(got, jax_values(jnp.asarray(PTS)), strict=True):
        _close(t.value, j)
    assert F.taylor_fallback_count() == 0


@pytest.mark.parametrize('name', BASES)
def test_bases_on_tensors_give_tensors(name):
    tbasis, kind = _angular_bases(B)[name]
    jbasis, _ = _angular_bases(JB)[name]
    th, ph = (PTS[:, i:i + 1] for i in range(2))
    args = (np.cos(th),) if kind == 'x' else (ph,) if kind == 'phi' else (th, ph)
    got = tbasis(*[torch.tensor(a) for a in args])
    assert torch.is_tensor(got) and got.dtype == torch.float64
    _close(got, jbasis(*[jnp.asarray(a) for a in args]))


def test_module_level_harmonics_match_jax():
    th, ph = (torch.tensor(PTS[:, i]) for i in range(2))
    names = [n for n in B.__all__ if n.startswith('Y')]
    assert len(names) == 25
    for name in names:
        got = getattr(B, name)(th, ph)
        assert torch.is_tensor(got), name
        _close(got, getattr(JB, name)(jnp.asarray(PTS[:, 0]), jnp.asarray(PTS[:, 1])))


@pytest.mark.parametrize('name', ['zonal', 'fourier', 'harmonics'])
def test_basis_laplacians_match_jax(name):
    """On the coefficients of a radial net (loaded with the JAX net's
    parameters) on 3-D points: (r, theta, phi), or (r, phi, unused) for the
    polar Fourier laplacian."""
    jop, top, n_comp = {
        'zonal': (JB.ZonalSphericalHarmonicsLaplacian(max_degree=3), B.ZonalSphericalHarmonicsLaplacian(max_degree=3), 4),
        'fourier': (JB.FourierLaplacian(2), B.FourierLaplacian(2), 5),
        'harmonics': (JB.HarmonicsLaplacian(2), B.HarmonicsLaplacian(2), 9),
    }[name]
    jnet = JFCNN(1, n_comp, hidden_units=(8, 8))
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(3)))
    tnet = FCNN(1, n_comp, hidden_units=(8, 8)).load_jax_params(jax.tree.map(np.asarray, params))
    rng = np.random.RandomState(4)
    pts = np.stack([rng.rand(19) + 0.5, rng.rand(19) * np.pi * 0.9 + 0.05 * np.pi, rng.rand(19) * 2 * np.pi], 1)

    def apply(op, coeffs, r, th, ph):
        return op(coeffs, r, ph) if name == 'fourier' else op(coeffs, r, th, ph)

    @jax.jit
    def jax_value(p):
        r, th, ph = JF.coords_from_points(p)
        return apply(jop, JNoCondition().enforce(jnet, params, r), r, th, ph).value

    r, th, ph = F.coords_from_points(torch.tensor(pts))
    F.reset_taylor_fallback_count()
    got = apply(top, NoCondition().enforce(tnet, r), r, th, ph)
    assert got.shape == (19, 1)
    _close(got.value, jax_value(jnp.asarray(pts)))
    assert F.taylor_fallback_count() == 0


def test_legendre_polynomials_and_basis_arguments():
    x = torch.linspace(-1, 1, 11, dtype=torch.float64)
    for degree in range(6):
        p = B.LegendrePolynomial(degree)
        assert p.coefficients == JB.LegendrePolynomial(degree).coefficients
        _close(p(x), np.asarray(JB.LegendrePolynomial(degree)(np.asarray(x))) * np.ones(11))
    for bad in (dict(), dict(max_degree=2, degrees=[1])):
        with pytest.raises(ValueError):
            B.ZonalSphericalHarmonics(**bad)
    assert B.ZonalSphericalHarmonics(degrees=[0, 3]).max_degree == 3
    _close(B.HarmonicsLaplacian(2).laplacian_coefficients, JB.HarmonicsLaplacian(2).laplacian_coefficients)


def test_deprecated_aliases():
    with pytest.warns(FutureWarning):
        obj = B.ZeroOrderSphericalHarmonics(max_degree=2)
    assert isinstance(obj, B.ZonalSphericalHarmonics)
    with pytest.warns(FutureWarning):
        obj = B.ZeroOrderSphericalHarmonicsLaplacian(max_degree=2)
    assert isinstance(obj, B.ZonalSphericalHarmonicsLaplacian)
    assert isinstance(obj, B.BasisOperator) and isinstance(obj.harmonics_fn, B.FunctionBasis)
