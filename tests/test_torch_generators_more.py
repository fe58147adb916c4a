"""The PyTorch port's remaining generators, ``IrregularBoundaryCondition``
and the ``utils`` helpers against the JAX package, in float64.

``MeshGenerator`` (``^``) and the Transform, Filter, Resample, Batch and
Sampler wrappers: bit for bit where the JAX package is deterministic (on
deterministic base generators), by their invariants where they draw (range,
ordering, membership, sizes). A dynamic-size ``FilterGenerator`` and a
``BatchGenerator`` train through ``fit``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import generators as JG, utils as JU
from neurodiffeq_tpu.conditions import IrregularBoundaryCondition as JIrregular
from neurodiffeq_tpu_torch import diff
from neurodiffeq_tpu_torch import generators as G, utils as U
from neurodiffeq_tpu_torch.conditions import IVP, IrregularBoundaryCondition
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.solvers import Solver1D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _jax(gen, seed=0):
    """A JAX generator's sample, jitted as the JAX solvers draw it, as a
    tuple of flat numpy arrays."""
    out = jax.jit(gen.sample)(jax.random.PRNGKey(seed))
    return tuple(np.asarray(o).reshape(-1) for o in (out if isinstance(out, (tuple, list)) else (out,)))


def _np(out):
    return tuple(o.numpy().reshape(-1) for o in out)


AXES = [(5, 0.0, 1.0), (4, 0.5, 1.5), (3, -2.0, 3.0)]


@pytest.mark.parametrize('n_axes', [2, 3])
def test_equally_spaced_mesh_matches_jax(n_axes):
    """The mesh of the 'equally-spaced' axes, the last varying fastest: bit
    for bit the meshgrid of the JAX package's axes, and within one ulp of
    its fused mesh (XLA's CPU backend contracts the linspace into an FMA
    there)."""
    jgens = [JG.Generator1D(n, a, b, method='equally-spaced') for n, a, b in AXES[:n_axes]]
    tgens = [G.Generator1D(n, a, b, method='equally-spaced') for n, a, b in AXES[:n_axes]]
    jmesh, tmesh = jgens[0], tgens[0]
    for jg, tg in zip(jgens[1:], tgens[1:]):
        jmesh, tmesh = jmesh ^ jg, tmesh ^ tg
    assert isinstance(tmesh, G.MeshGenerator) and len(tmesh.generators) == n_axes
    assert tmesh.size == jmesh.size == int(np.prod([n for n, _, _ in AXES[:n_axes]]))
    got = _np(tmesh.sample(None))
    axes = [_jax(g)[0] for g in jgens]
    for g, w in zip(got, np.meshgrid(*axes, indexing='ij'), strict=True):
        assert np.array_equal(g, w.reshape(-1))
    for g, w in zip(got, _jax(jmesh), strict=True):
        assert np.all(np.abs(g - w) <= np.abs(np.spacing(w)))


def test_mesh_nesting_and_checks():
    g1, g2, g3 = (G.Generator1D(n, 0.0, 1.0, method='equally-spaced') for n in (4, 6, 2))
    nested = (g1 ^ g2) ^ g3
    flat = G.MeshGenerator(g1, g2, g3)
    assert nested.size == 48 and list(nested.generators) == list(flat.generators) == [g1, g2, g3]
    for a, b in zip(nested.sample(None), flat.sample(None), strict=True):
        assert torch.equal(a, b)
    (single,) = G.MeshGenerator(g1).sample(None)
    assert torch.equal(single, g1.sample(None)[0])
    with pytest.raises(ValueError):
        g1 ^ None
    assert 'MeshGenerator(size=48' in repr(nested)


def test_noisy_mesh_keeps_the_mesh_order_and_range():
    """'equally-spaced-noisy' axes: each axis draws its own noise, once per
    batch; the mesh repeats the first axis's draw over the second, in order."""
    gen = G.Generator1D(8, 0.0, 1.0, method='equally-spaced-noisy') ^ G.Generator1D(
        6, 0.5, 1.5, method='equally-spaced-noisy')
    t, lam = (c.numpy().reshape(8, 6) for c in gen.sample(torch.Generator().manual_seed(0)))
    assert (t == t[:, :1]).all() and (lam == lam[:1]).all()
    assert np.all(np.abs(t[:, 0] - np.linspace(0, 1, 8)) < 5 * (1 / 8) / 4)
    assert np.all(np.abs(lam[0] - np.linspace(0.5, 1.5, 6)) < 5 * (1 / 6) / 4)
    t2, _ = gen.sample(torch.Generator().manual_seed(1))
    assert not np.array_equal(t2.numpy().reshape(8, 6), t)


def test_transform_generator_matches_jax():
    base_j = JG.Generator2D((4, 3), (0, 0), (1, 2), method='equally-spaced')
    base_t = G.Generator2D((4, 3), (0, 0), (1, 2), method='equally-spaced')
    per_col = [lambda x: x * 2, None]
    whole = lambda x, y: (x + y, x * y)  # noqa: E731
    for kw in (dict(transforms=per_col), dict(transform=whole)):
        want = _jax(JG.TransformGenerator(base_j, **kw))
        got = _np(G.TransformGenerator(base_t, **kw).sample(None))
        for g, w in zip(got, want, strict=True):
            assert np.array_equal(g, w)
    for g, w in zip(G.TransformGenerator(base_t).sample(None), base_t.sample(None), strict=True):
        assert torch.equal(g, w)  # no transform: the identity on every column
    one = G.TransformGenerator(G.Generator1D(5, 0.0, 1.0, method='equally-spaced'), transform=lambda x: x + 1)
    assert np.array_equal(_np(one.sample(None))[0], np.linspace(1, 2, 5))
    with pytest.raises(ValueError, match='both'):
        G.TransformGenerator(base_t, transforms=per_col, transform=whole)


def test_dynamic_filter_generator_matches_jax():
    keep = lambda xs: np.asarray(xs[0]) + np.asarray(xs[1]) < 1.0  # noqa: E731
    jgen = JG.FilterGenerator(JG.Generator2D((6, 6), method='equally-spaced'), filter_fn=keep)
    tgen = G.FilterGenerator(G.Generator2D((6, 6), method='equally-spaced'), filter_fn=keep)
    got = _np(tgen.sample(None))
    for g, w in zip(got, jgen.sample(jax.random.PRNGKey(0)), strict=True):
        assert np.array_equal(g, np.asarray(w))
    assert tgen.size == jgen.size == len(got[0]) < 36
    frozen = G.FilterGenerator(G.Generator1D(10, method='equally-spaced'), lambda xs: xs[0] > 0.5,
                               update_size=False)
    assert len(frozen.sample(None)[0]) == 5 and frozen.size == 10


def test_fixed_size_filter_generator():
    base = G.Generator1D(64, 0.0, 1.0, method='equally-spaced')
    gen = G.FilterGenerator(base, filter_fn=lambda xs: xs[0] < 0.5, size=100, fixed_size=True)
    (x,) = gen.sample(torch.Generator().manual_seed(0))
    pool = base.sample(None)[0]
    assert x.shape == (100,) and gen.size == 100 and (x < 0.5).all()
    assert set(x.tolist()) <= set(pool[pool < 0.5].tolist())
    assert len(set(x.tolist())) > 16  # a spread of picks, not one point
    # columns stay aligned through the pick; with no point passing, the first sample repeats
    xy = G.FilterGenerator(G.Generator2D((8, 8), method='equally-spaced'), lambda xs: xs[0] + xs[1] < 1.0,
                           size=50, fixed_size=True).sample(torch.Generator().manual_seed(1))
    assert (xy[0] + xy[1] < 1.0).all()
    (none,) = G.FilterGenerator(base, lambda xs: xs[0] > 2.0, size=5, fixed_size=True).sample(
        torch.Generator().manual_seed(2))
    assert torch.equal(none, torch.zeros(5, dtype=torch.float64))


def test_resample_generator():
    base = G.Generator1D(32, 0.0, 1.0, method='equally-spaced')
    pool = set(base.sample(None)[0].tolist())
    (x,) = G.ResampleGenerator(base, size=16).sample(torch.Generator().manual_seed(0))
    assert x.shape == (16,) and len(set(x.tolist())) == 16 and set(x.tolist()) <= pool
    (y,) = G.ResampleGenerator(base, size=64, replacement=True).sample(torch.Generator().manual_seed(0))
    assert y.shape == (64,) and set(y.tolist()) <= pool and len(set(y.tolist())) < 64
    (z,) = G.ResampleGenerator(base).sample(torch.Generator().manual_seed(3))  # a shuffle
    assert sorted(z.tolist()) == sorted(pool)
    # columns stay aligned
    xs, ys = G.ResampleGenerator(G.Generator1D(9, 0, 1, method='equally-spaced') * G.Generator1D(
        9, 0, 2, method='equally-spaced'), size=5).sample(torch.Generator().manual_seed(4))
    assert torch.equal(ys, 2 * xs)


def test_batch_generator_matches_jax():
    """On a deterministic base both caches hand out the same batches."""
    jgen = JG.BatchGenerator(JG.Generator1D(6, 0.0, 1.0, method='equally-spaced'), batch_size=4)
    tgen = G.BatchGenerator(G.Generator1D(6, 0.0, 1.0, method='equally-spaced'), batch_size=4)
    for i in range(5):
        (got,) = tgen.sample(torch.Generator().manual_seed(i))
        assert np.array_equal(got.numpy(), np.asarray(jgen.sample(jax.random.PRNGKey(i))))
    with pytest.raises(ValueError):
        G.BatchGenerator(G.PredefinedGenerator(np.zeros(0)), batch_size=1)


def test_sampler_generator_matches_jax():
    jgen = JG.SamplerGenerator(JG.Generator2D((4, 4), method='equally-spaced'))
    tgen = G.SamplerGenerator(G.Generator2D((4, 4), method='equally-spaced'))
    cols = tgen.get_examples()
    assert isinstance(cols, list) and all(c.shape == (16, 1) for c in cols)
    for g, w in zip(cols, jgen.sample(jax.random.PRNGKey(0)), strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _decay_solver(train_generator, **kwargs):
    torch.manual_seed(0)
    return Solver1D(ode_system=lambda u, t: [diff(u, t) + u], conditions=[IVP(t_0=0.0, u_0=1.0)],
                    train_generator=train_generator, valid_generator=G.Generator1D(32, 0, 2, method='equally-spaced'),
                    nets=[FCNN(hidden_units=(16, 16))], generator=torch.Generator().manual_seed(0), **kwargs)


@pytest.mark.parametrize('kind', ['filter', 'batch'])
def test_dynamic_size_generators_train_through_fit(kind):
    if kind == 'filter':  # a batch of whatever passes: its size changes with each draw
        train = G.FilterGenerator(G.Generator1D(64, 0, 2, method='uniform'), filter_fn=lambda xs: xs[0] > 0.1)
    else:
        train = G.BatchGenerator(G.Generator1D(48, 0, 2, method='uniform'), batch_size=32)
    solver = _decay_solver(train)
    sizes = []
    sample = train.sample
    train.sample = lambda gen: sizes.append(len(out := sample(gen)[0])) or (out,)
    solver.optimizer = torch.optim.Adam(solver.nets[0].parameters(), lr=1e-2)
    solver.fit(300, tqdm_file=None)
    assert solver.global_epoch == 300 and solver.best_params is not None
    assert (len(set(sizes)) > 1) if kind == 'filter' else set(sizes) == {32}
    ts = np.linspace(0.1, 2, 40)
    err = np.abs(solver.get_solution()(ts, to_numpy=True) - np.exp(-ts)).max()
    assert err < 5e-2, err


def test_irregular_boundary_condition():
    pts = np.random.RandomState(0).rand(7)
    got, want = IrregularBoundaryCondition().in_domain(pts, pts), JIrregular().in_domain(pts, pts)
    assert got.dtype == bool and np.array_equal(got, np.asarray(want)) and got.all()


def test_utils_helpers_match_jax(tmp_path):
    mat = np.random.RandomState(1).rand(5, 3)
    for got, want in zip(U.split_columns(torch.tensor(mat)), JU.split_columns(jnp.asarray(mat)), strict=True):
        assert np.array_equal(got.numpy(), np.asarray(want))
    cols = [torch.tensor(mat[:, j]) for j in range(3)]
    assert np.array_equal(U.hstack(cols).numpy(), np.asarray(JU.hstack([jnp.asarray(c.numpy()) for c in cols])))
    assert np.array_equal(U.vstack(cols).numpy(), np.asarray(JU.vstack([jnp.asarray(c.numpy()) for c in cols])))
    for x in (mat[:, 0], mat, 2.5):
        got = U.as_2d_column(x)
        assert got.dtype == torch.float64 and np.array_equal(got.numpy(), np.asarray(JU.as_2d_column(x)))
    assert U.as_2d_column(mat[:, 0], dtype=torch.float32).dtype == torch.float32
    with pytest.raises(ValueError, match='2 dimensions'):
        U.split_columns(torch.zeros(3))
    U.safe_mkdir(tmp_path / 'a' / 'b')
    U.safe_mkdir(tmp_path / 'a' / 'b')
    assert (tmp_path / 'a' / 'b').is_dir()
