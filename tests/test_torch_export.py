"""Solution export, ``get_residual_info`` and the port's imports.

- ``BaseSolution.export`` -> ``load_exported_solution`` (a ``torch.export``
  program with a dynamic batch dimension) against the JAX package's StableHLO
  artifact of the same solution: 1-D, a 2-D system, spherical, a bundle, a
  basis condition and SIREN and FourierFCNN nets, all on the same
  parameters in float64; the outputs agree to 1e-10 at N = 1, 7 and 50,
  and equal the port's own solution;
- ``utils.get_residual_info`` against the JAX package's to 1e-10;
- importing the port, and ``chip_smoke.py``, imports no ``jax``,
  ``matplotlib``, ``dill``, ``requests`` or ``tensorboard`` beyond what
  ``import torch`` itself brings, and works where none of them is
  installed.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import diff as jdiff, fields as JF, utils as jutils
from neurodiffeq_tpu.conditions import (BundleIVP as JBundleIVP, DirichletBVPSpherical as JDirichletBVPSpherical,
                                        DirichletBVPSphericalBasis as JBasis, IVP as JIVP, NoCondition as JNoCondition)
from neurodiffeq_tpu.networks import FCNN as JFCNN, FourierFCNN as JFourierFCNN, SIREN as JSIREN
from neurodiffeq_tpu.solvers import load_exported_solution as jload_exported_solution
from neurodiffeq_tpu_torch import diff, fields as F, utils
from neurodiffeq_tpu_torch.conditions import (BundleIVP, DirichletBVPSpherical, DirichletBVPSphericalBasis, IVP,
                                              NoCondition)
from neurodiffeq_tpu_torch.function_basis import RealSphericalHarmonics
from neurodiffeq_tpu_torch.networks import FCNN, FourierFCNN, SIREN
from neurodiffeq_tpu_torch.solvers import (BundleSolution1D, Solution1D, Solution2D, SolutionSpherical,
                                           SolutionSphericalHarmonics, load_exported_solution)
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _pair(jnet, tnet, seed):
    """JAX parameters in float64 and the port's net loaded with them."""
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    tnet.load_jax_params(jax.tree.map(np.asarray, params))
    return params


def _solutions(kind):
    """(JAX solution, the port's solution, n_coords, points sampler)."""
    from neurodiffeq_tpu.solvers import (BundleSolution1D as JBundleSolution1D, Solution1D as JSolution1D,
                                         Solution2D as JSolution2D, SolutionSpherical as JSolutionSpherical,
                                         SolutionSphericalHarmonics as JSolutionSphericalHarmonics)
    from neurodiffeq_tpu.function_basis import RealSphericalHarmonics as JRealSphericalHarmonics
    if kind in ('1d', 'siren', 'fourier'):
        jnet, tnet = {'1d': (JFCNN(1, 1, hidden_units=(8, 8)), FCNN(1, 1, hidden_units=(8, 8))),
                      'siren': (JSIREN(1, 1, hidden_units=(8, 8), w0=5.0), SIREN(1, 1, hidden_units=(8, 8), w0=5.0)),
                      'fourier': (JFourierFCNN(1, 1, n_features=6, sigma=1.0, hidden_units=(8,)),
                                  FourierFCNN(1, 1, n_features=6, sigma=1.0, hidden_units=(8,)))}[kind]
        p = _pair(jnet, tnet, 1)
        return (JSolution1D([jnet], [p], [JIVP(0.0, 1.0)]), Solution1D([tnet], [IVP(0.0, 1.0)]), 1,
                lambda rng, n: rng.random((n, 1)) * 2)
    if kind == '2d':
        jnets, tnets = [JFCNN(2, 1, hidden_units=(8,)) for _ in range(2)], [FCNN(2, 1, hidden_units=(8,)) for _ in
                                                                            range(2)]
        ps = [_pair(j, t, i) for i, (j, t) in enumerate(zip(jnets, tnets))]
        return (JSolution2D(jnets, ps, [JNoCondition(), JNoCondition()]),
                Solution2D(tnets, [NoCondition(), NoCondition()]), 2, lambda rng, n: rng.random((n, 2)))
    if kind == 'spherical':
        jnet, tnet = JFCNN(3, 1, hidden_units=(8,)), FCNN(3, 1, hidden_units=(8,))
        p = _pair(jnet, tnet, 2)
        jc = JDirichletBVPSpherical(0.5, lambda th, ph: 1.0 + 0 * th, 2.0, lambda th, ph: 0 * th)
        tc = DirichletBVPSpherical(0.5, lambda th, ph: 1.0 + 0 * th, 2.0, lambda th, ph: 0 * th)
        return (JSolutionSpherical([jnet], [p], [jc]), SolutionSpherical([tnet], [tc]), 3,
                lambda rng, n: np.stack([rng.random(n) * 1.5 + 0.5, rng.random(n) * 2 + 0.5, rng.random(n) * 3], 1))
    if kind == 'harmonics':
        K = 9
        R = np.linspace(0.1, 0.9, K)
        jnet, tnet = JFCNN(1, K, hidden_units=(8,)), FCNN(1, K, hidden_units=(8,))
        p = _pair(jnet, tnet, 3)
        return (JSolutionSphericalHarmonics([jnet], [p], [JBasis(r_0=0.5, R_0=R)],
                                            harmonics_fn=JRealSphericalHarmonics(max_degree=2)),
                SolutionSphericalHarmonics([tnet], [DirichletBVPSphericalBasis(r_0=0.5, R_0=R)],
                                           harmonics_fn=RealSphericalHarmonics(max_degree=2)), 3,
                lambda rng, n: np.stack([rng.random(n) * 1.5 + 0.5, rng.random(n) * 2 + 0.5, rng.random(n) * 3], 1))
    jnet, tnet = JFCNN(2, 1, hidden_units=(8,)), FCNN(2, 1, hidden_units=(8,))
    p = _pair(jnet, tnet, 4)
    return (JBundleSolution1D([jnet], [p], [JBundleIVP(t_0=0.0, u_0=1.0)]),
            BundleSolution1D([tnet], [BundleIVP(t_0=0.0, u_0=1.0)]), 2,
            lambda rng, n: np.stack([rng.random(n), 0.5 + rng.random(n)], 1))


@pytest.mark.parametrize('kind', ['1d', '2d', 'spherical', 'harmonics', 'bundle', 'siren', 'fourier'])
def test_export_equals_jax_artifact(kind, tmp_path):
    jsol, tsol, n_coords, draw = _solutions(kind)
    path = str(tmp_path / 'solution.pt2')
    blob = tsol.export(n_coords=n_coords, path=path)
    assert len(blob) > 0 and open(path, 'rb').read() == blob
    jserve = jload_exported_solution(jsol.export(n_coords=n_coords, dtype=jnp.float64))
    rng = np.random.default_rng(0)
    for source in (path, blob):
        serve = load_exported_solution(source)
        for n in (1, 7, 50):
            pts = draw(rng, n)
            outs, jouts = serve(pts), jserve(pts)
            assert len(outs) == len(jouts) == len(tsol.nets)
            own = tsol(*[pts[:, i] for i in range(n_coords)])
            own = own if isinstance(own, list) else [own]
            for got, want, mine in zip(outs, jouts, own):
                assert got.shape == (n, 1)
                np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
                assert torch.equal(got[:, 0], mine)


def test_export_serves_tensors_and_float32():
    set_tensor_type('cpu', 32)
    sol = Solution1D([FCNN(1, 1, hidden_units=(8,))], [IVP(0.0, 1.0)])
    serve = load_exported_solution(sol.export(n_coords=1))
    t = torch.linspace(0, 2, 13).reshape(-1, 1)
    (u,) = serve(t)
    assert u.dtype == torch.float32 and torch.equal(u[:, 0], sol(t[:, 0]))
    (u64,) = load_exported_solution(sol.export(n_coords=1, dtype=torch.float64))(t.double())
    assert u64.dtype == torch.float32 and torch.equal(u64, u)


@pytest.mark.parametrize('order', [0, 1, 2])
def test_get_residual_info_equals_jax(order):
    jnet, tnet = JFCNN(2, 1, hidden_units=(8,)), FCNN(2, 1, hidden_units=(8,))
    p = _pair(jnet, tnet, 5)
    pts = np.random.default_rng(1).random((11, 2))
    jx, jy = JF.coordinates(pts[:, 0], pts[:, 1])
    x, y = F.coordinates(pts[:, 0], pts[:, 1])
    from neurodiffeq_tpu.conditions import _ann_field
    ju = _ann_field(jnet, p, (jx, jy))
    u = F.network_field(tnet, (x, y))
    jeqs = lambda u, x, y: [jdiff(u, x, 2) + jdiff(u, y, 2), u * x]  # noqa: E731
    eqs = lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2), u * x]  # noqa: E731
    want = jutils.get_residual_info([ju], [jx, jy], jeqs, highest_order=order)
    got = utils.get_residual_info([u], [x, y], eqs, highest_order=order)
    flat = lambda t: [t] if not isinstance(t, list) else [x for e in t for x in flat(e)]  # noqa: E731
    assert len(got) == order + 1
    for g, w in zip(flat(got), flat(want)):
        assert g.shape == tuple(w.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)
    fields = utils.get_residual_info([u], [x, y], eqs, highest_order=order, detach=False)
    assert isinstance(fields[0][0], F.Field)


BLOCKED = ('jax', 'matplotlib', 'dill', 'requests', 'tensorboard')
PROBE = """
import sys
{block}
import torch
before = set(sys.modules)
import {target}
new = sorted(m for m in set(sys.modules) - before if m.split('.')[0] in {blocked!r})
print(new)
assert not new, new
"""


@pytest.mark.parametrize('target', ['neurodiffeq_tpu_torch', 'chip_smoke', 'cpu_rehearsal'])
@pytest.mark.parametrize('blocked', [False, True])
def test_imports_need_no_optional_package(target, blocked):
    block = ''.join(f"sys.modules[{m!r}] = None\n" for m in BLOCKED) if blocked else ''
    code = PROBE.format(block=block, target=target, blocked=BLOCKED)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == '[]'
