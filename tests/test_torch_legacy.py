"""The PyTorch port's legacy v1 APIs (``ode``, ``pde``, ``pde_spherical``)
against the JAX package's, in float64.

Each legacy function trains both packages' solvers from the same parameters
(the JAX package's initial parameters, drawn from its seeded key store, are
loaded into the port's nets) on the same deterministic points: the
``metrics_history`` agree to 1e-9 relative. Also: ``return_internal``,
``additional_loss_term``, the ``FutureWarning``\\ s, every deprecated alias,
``make_animation`` and the public names of the four ported modules.
"""
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import matplotlib
import matplotlib.pyplot as plt
import numpy as np
import pytest

import jax
import torch

import neurodiffeq_tpu as jpkg
import neurodiffeq_tpu.ode  # noqa: F401 (the legacy modules, as attributes of the package)
import neurodiffeq_tpu.pde  # noqa: F401
import neurodiffeq_tpu.pde_spherical  # noqa: F401
import neurodiffeq_tpu.temporal  # noqa: F401
import neurodiffeq_tpu_torch as tpkg
from neurodiffeq_tpu import conditions as JC, fields as JF, generators as JG, operators as JO
from neurodiffeq_tpu.function_basis import RealSphericalHarmonics as JRealSphericalHarmonics
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.utils import next_rng_key, set_seed as jset_seed
from neurodiffeq_tpu_torch import conditions as C, fields as F, generators as G, operators as O
from neurodiffeq_tpu_torch.function_basis import RealSphericalHarmonics
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

matplotlib.use('Agg')
torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
EPOCHS, SEED = 4, 3
INTERNALS = {'nets', 'conditions', 'train_generator', 'valid_generator', 'optimizer', 'criterion'}


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    plt.close('all')
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _nets(shapes):
    """JAX nets, the parameters the JAX solver will draw for them (its
    seeded key store, split once per distinct net) and the port's nets
    loaded with those parameters."""
    jnets = [JFCNN(n_in, n_out, hidden_units=(8, 8)) for n_in, n_out in shapes]
    jset_seed(SEED)
    keys = jax.random.split(next_rng_key(), len(jnets))
    params = [jax.tree.map(np.asarray, net.init(k)) for net, k in zip(jnets, keys)]
    tnets = [FCNN(n_in, n_out, hidden_units=(8, 8)).load_jax_params(p) for (n_in, n_out), p in zip(shapes, params)]
    jset_seed(SEED)
    return jnets, tnets


def _spherical_points():
    rng = np.random.RandomState(4)
    return 0.5 + 1.5 * rng.rand(40), 0.1 + 2.9 * rng.rand(40), 2 * np.pi * rng.rand(40)


def _case(name, pkg, P, Cm, Gm, Om, d, nets):
    """``(legacy function, keyword arguments)`` of case ``name`` in one package."""
    if name == 'solve':
        return pkg.ode.solve, dict(
            ode=lambda u, t: d(u, t) + u, condition=Cm.IVP(0.0, 1.0), net=nets[0],
            train_generator=Gm.Generator1D(16, 0.0, 2.0, method='equally-spaced'),
            valid_generator=Gm.Generator1D(16, 0.0, 2.0, method='equally-spaced'),
            additional_loss_term=lambda u, t: 0.01 * (u.value ** 2).mean(),
            metrics={'u_max': lambda u, t: u.max()})
    if name == 'solve_system':
        return pkg.ode.solve_system, dict(
            ode_system=lambda u1, u2, t: [d(u1, t) - u2, d(u2, t) + u1], conditions=[Cm.IVP(0.0, 0.0), Cm.IVP(0.0, 1.0)],
            t_min=0.0, t_max=2.0, single_net=nets[0],
            train_generator=Gm.Generator1D(16, 0.0, 2.0, method='equally-spaced'),
            valid_generator=Gm.Generator1D(16, 0.0, 2.0, method='equally-spaced'))
    if name == 'solve2D':
        cond = Cm.DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                                 y_min=0.0, y_min_val=lambda x: P.sin(np.pi * x), y_max=1.0, y_max_val=lambda x: 0 * x)
        return pkg.pde.solve2D, dict(
            pde=lambda u, x, y: d(u, x, 2) + d(u, y, 2), condition=cond, net=nets[0],
            train_generator=Gm.Generator2D((6, 6), (0, 0), (1, 1), method='equally-spaced'),
            valid_generator=Gm.Generator2D((5, 5), (0, 0), (1, 1), method='equally-spaced'))
    if name == 'solve2D_system':
        return pkg.pde.solve2D_system, dict(
            pde_system=lambda u, v, x, y: [d(u, x) + u - v, d(v, y) + v - u],
            conditions=[Cm.NoCondition(), Cm.NoCondition()], nets=nets,
            train_generator=Gm.Generator2D((6, 6), (0, 0), (1, 1), method='equally-spaced'),
            valid_generator=Gm.Generator2D((5, 5), (0, 0), (1, 1), method='equally-spaced'), n_batches_valid=2)
    pts = _spherical_points()
    gens = dict(train_generator=Gm.PredefinedGenerator(*pts), valid_generator=Gm.PredefinedGenerator(*pts))
    if name == 'solve_spherical':
        cond = Cm.DirichletBVPSpherical(0.5, lambda th, ph: 1.0 + 0 * th, 2.0, lambda th, ph: 0.25 + 0 * th)
        return pkg.pde_spherical.solve_spherical, dict(
            pde=lambda u, r, th, ph: Om.spherical_laplacian(u, r, th, ph) + u, condition=cond, net=nets[0],
            analytic_solution=lambda r, th, ph: 1 / r, **gens)
    harmonics = (JRealSphericalHarmonics if pkg is jpkg else RealSphericalHarmonics)(max_degree=1)
    return pkg.pde_spherical.solve_spherical_system, dict(
        pde_system=lambda u, r, th, ph: [d(u, r, shape_check=False) + u], conditions=[Cm.NoCondition()],
        nets=nets, harmonics_fn=harmonics, **gens)


SHAPES = {'solve': [(1, 1)], 'solve_system': [(1, 2)], 'solve2D': [(2, 1)], 'solve2D_system': [(2, 1), (2, 1)],
          'solve_spherical': [(3, 1)], 'solve_spherical_system': [(1, 4)]}


@pytest.mark.parametrize('name', list(SHAPES))
def test_legacy_history_matches_jax(name):
    jnets, tnets = _nets(SHAPES[name])
    jfn, jkw = _case(name, jpkg, JF, JC, JG, JO, JF.diff, jnets)
    tfn, tkw = _case(name, tpkg, F, C, G, O, tpkg.diff, tnets)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jsol, jhist = jfn(max_epochs=EPOCHS, **jkw)
        with pytest.warns(FutureWarning, match='deprecated'):
            tsol, thist, internals = tfn(max_epochs=EPOCHS, return_internal=True, **tkw)
    assert set(thist) == set(jhist) and len(thist) >= 2
    for key in jhist:
        assert len(thist[key]) == EPOCHS
        assert _rel(thist[key], jhist[key]) < 1e-9, key
    assert set(internals) == INTERNALS
    assert all(n is tn for n, tn in zip(internals['nets'], tnets * (2 if name == 'solve_system' else 1)))
    assert F.taylor_fallback_count() == 0
    # the returned solutions (the last parameters: return_best=False) agree too
    coords = (_spherical_points() if 'spherical' in name else (np.linspace(0, 1, 9), np.linspace(1, 0, 9))
              if '2D' in name else (np.linspace(0, 2, 9),))
    got, want = tsol(*coords, to_numpy=True), jsol(*coords, to_numpy=True)
    for g, w in zip(got if isinstance(got, list) else [got], want if isinstance(want, list) else [want]):
        assert _rel(g, w) < 1e-9


def test_default_nets_shared_impose_on_and_exact_conditions():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        solution, history = tpkg.ode.solve_system(
            ode_system=lambda u1, u2, t: [tpkg.diff(u1, t) - u2, tpkg.diff(u2, t) + u1],
            conditions=[C.IVP(t_0=0.0, u_0=0.0), C.IVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0, max_epochs=3)
    assert len(history['train_loss']) == 3
    net = solution.nets[0]
    assert solution.nets[1] is net and net.n_output_units == 2 and net.hidden_units == (32, 32)
    assert [c.ith_unit for c in solution.conditions] == [0, 1]
    u1, u2 = solution(np.zeros(1), to_numpy=True)
    assert abs(u1[0]) < 1e-12 and abs(u2[0] - 1) < 1e-12
    with pytest.raises(ValueError, match='Only one of net and nets'):
        tpkg.ode.solve_system(lambda u, t: [u], [C.NoCondition()], 0.0, 1.0, single_net=FCNN(), nets=[FCNN()])


def test_additional_loss_term_enters_the_loss():
    calls = []

    def extra(u, t):
        calls.append((u.shape, t.shape))
        return 100.0 * (u.value ** 2).mean()

    def run(term):
        torch.manual_seed(0)
        gen = G.Generator1D(8, 0.0, 1.0, method='equally-spaced')
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            return tpkg.ode.solve(lambda u, t: tpkg.diff(u, t) + u, C.IVP(0.0, 1.0), net=FCNN(hidden_units=(4,)),
                                  train_generator=gen, valid_generator=gen, additional_loss_term=term,
                                  max_epochs=1)[1]

    plain, with_term = run(None), run(extra)
    assert calls == [((8, 1), (8, 1))] * 5  # 1 train and 4 validation batches
    assert with_term['train_loss'][0] > plain['train_loss'][0] + 1.0


def test_future_warnings_and_deprecated_aliases():
    with pytest.warns(FutureWarning, match='The `solve_system` function is deprecated'):
        tpkg.ode.solve(lambda u, t: tpkg.diff(u, t) + u, C.IVP(0.0, 1.0), 0.0, 1.0, max_epochs=1)
    with pytest.warns(FutureWarning, match='The `solve2D_system` function is deprecated'):
        tpkg.pde.solve2D(lambda u, x, y: tpkg.diff(u, x), C.NoCondition(), (0, 0), (1, 1), max_epochs=1,
                         n_batches_valid=1)
    with pytest.warns(FutureWarning, match='solve_spherical is deprecated'):
        tpkg.pde_spherical.solve_spherical(lambda u, r, th, ph: tpkg.diff(u, r), C.NoCondition(), 0.5, 1.0,
                                           max_epochs=1)
    ode, pde, sph = tpkg.ode, tpkg.pde, tpkg.pde_spherical
    aliases = [
        (ode.ExampleGenerator, (16,), G.Generator1D), (ode.Monitor, (0.0, 1.0), tpkg.monitors.Monitor1D),
        (pde.ExampleGenerator2D, ((4, 4),), G.Generator2D),
        (pde.PredefinedExampleGenerator2D, (np.zeros(3), np.ones(3)), G.PredefinedGenerator),
        (pde.Solution, ([FCNN(2, 1)], [C.NoCondition()]), tpkg.solvers.Solution2D),
        (sph.ExampleGenerator3D, ((2, 2, 2),), G.Generator3D), (sph.ExampleGeneratorSpherical, (16,), G.GeneratorSpherical),
        (sph.NoConditionSpherical, (), C.NoCondition), (sph.NoConditionSphericalHarmonics, (), C.NoCondition),
        (sph.DirichletBVPSpherical, (0.5, lambda th, ph: 0 * th), C.DirichletBVPSpherical),
        (sph.DirichletBVPSphericalHarmonics, (0.5, np.zeros(4)), C.DirichletBVPSphericalBasis),
        (sph.InfDirichletBVPSpherical, (0.5, lambda th, ph: 0 * th, lambda th, ph: 0 * th), C.InfDirichletBVPSpherical),
        (sph.InfDirichletBVPSphericalHarmonics, (0.5, np.zeros(4), np.zeros(4)), C.InfDirichletBVPSphericalBasis),
        (sph.SphericalSolver, (lambda u, r, th, ph: [tpkg.diff(u, r)], [C.NoCondition()], 0.5, 1.0),
         tpkg.solvers.SolverSpherical),
    ]
    for alias, args, cls in aliases:
        with pytest.warns(FutureWarning, match='deprecated'):
            assert isinstance(alias(*args), cls)


def test_make_animation_returns_a_funcanimation():
    from matplotlib.animation import FuncAnimation
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        solution, _ = tpkg.pde.solve2D(lambda u, x, t: tpkg.diff(u, t) - tpkg.diff(u, x, 2), C.NoCondition(),
                                       (0, 0), (1, 1), max_epochs=2)
    anim = tpkg.pde.make_animation(solution, xs=np.linspace(0, 1, 8), ts=np.linspace(0, 1, 5))
    assert isinstance(anim, FuncAnimation)
    frames = solution(*np.meshgrid(np.linspace(0, 1, 8), np.linspace(0, 1, 5)), to_numpy=True)
    ax = plt.gca()
    assert ax.get_xlim() == (0.0, 1.0) and ax.get_ylim()[0] < frames.min() and ax.get_ylim()[1] > frames.max()


@pytest.mark.parametrize('module', ['temporal', 'ode', 'pde', 'pde_spherical'])
def test_public_names_follow_jax(module):
    """Every public name of the JAX module (its ``__all__`` where it has one)
    exists in the port's, and the legacy modules re-export the same names."""
    jmod, tmod = getattr(jpkg, module), getattr(tpkg, module)

    def public(mod):
        return {k for k, v in vars(mod).items() if not k.startswith('_') and not isinstance(v, types.ModuleType)}

    if hasattr(jmod, '__all__'):
        assert tmod.__all__ == jmod.__all__ and all(hasattr(tmod, name) for name in jmod.__all__)
    else:
        assert public(tmod) == public(jmod)


def test_import_loads_neither_jax_nor_matplotlib():
    """The package, with its temporal and legacy modules, imports neither
    jax (nor any module of the JAX package) nor matplotlib: the monitors and
    ``make_animation`` import matplotlib at first use."""
    code = ("import sys; import neurodiffeq_tpu_torch as p; "
            "from neurodiffeq_tpu_torch import temporal, ode, pde, pde_spherical; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'matplotlib', 'neurodiffeq_tpu')]; "
            "assert not bad, bad; print(sorted(set(p.__all__) & {'temporal', 'ode', 'pde', 'pde_spherical'}))")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=dict(os.environ), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "['ode', 'pde', 'pde_spherical', 'temporal']"
