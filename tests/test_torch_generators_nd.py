"""The PyTorch port's high-dimensional generators against the JAX package,
in float64: the scrambled Halton sequence, ``GeneratorND`` and
``GeneratorHypercube``.

- ``_halton`` equals the JAX package's bit for bit given the same rotation
  and scramble (reproduced here from the JAX key), at d = 1, 6 and 15;
  ``'halton'`` is valid in ``Generator1D``/``2D``/``3D``, in
  ``GeneratorND`` (the whole-box string) and in ``GeneratorHypercube``;
- the deterministic ``GeneratorND`` methods equal the JAX package's
  compiled grids to one ulp, ``cut`` and ``noisy`` behave as there;
- ``GeneratorHypercube``: shapes and bounds, the boundary law (one face per
  point, faces picked with probability proportional to 1 / L_i, sides
  equally; a chi-square test on a fixed seed), and every validation error,
  with the JAX package's messages. Random streams cannot follow JAX's
  threefry draws, so the draws themselves are not compared.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import generators as JG
from neurodiffeq_tpu_torch import generators as G
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _jax_draws(key, n, dim):
    """The rotation and scramble draws of the JAX package's ``_halton(key, n, dim)``."""
    shift = np.asarray(jax.random.uniform(key, (dim,), dtype=jnp.float64))
    scrambles = []
    for d, b in enumerate(JG._HALTON_PRIMES[:dim]):
        if b < 17:
            scrambles.append(None)
            continue
        n_digits = int(np.log(max(n, 2)) / np.log(b)) + 2
        kd = jax.random.fold_in(key, 10007 + d)
        a = int(jax.random.randint(jax.random.fold_in(kd, 0), (), 1, b))
        c = np.asarray(jax.random.randint(jax.random.fold_in(kd, 1), (n_digits,), 0, b))
        scrambles.append((a, torch.tensor(c)))
    return torch.tensor(shift), scrambles


@pytest.mark.parametrize('dim', [1, 6, 15])
@pytest.mark.parametrize('n', [1, 100, 777])
def test_halton_matches_jax_bit_for_bit(dim, n):
    key = jax.random.PRNGKey(dim * 1000 + n)
    want = np.asarray(JG._halton(key, n, dim))
    shift, scrambles = _jax_draws(key, n, dim)
    got = G._halton_points(n, dim, shift, scrambles, torch.float64, 'cpu').numpy()
    assert got.shape == (n, dim)
    assert np.array_equal(got, want)


def test_halton_draws_from_the_generator():
    """``_halton`` takes its rotation and scramble from the caller's
    ``torch.Generator``: the same seed gives the same points, another seed
    other points, every point in [0, 1); unrotated, the first b^k points of
    a base-b column are the multiples of b^-k but one, and b^-(k+1)."""
    draw = lambda seed: G._halton(torch.Generator().manual_seed(seed), 243, 8, torch.float64, 'cpu')  # noqa: E731
    a = draw(0)
    assert torch.equal(a, draw(0)) and not torch.equal(a, draw(1))
    assert a.min() >= 0 and a.max() < 1
    for col, (b, k) in enumerate([(2, 7), (3, 5)]):
        u = G._halton_points(b ** k, 2, torch.zeros(2, dtype=torch.float64), [None, None], torch.float64, 'cpu')
        assert sorted(torch.round(u[:, col] * b ** k).long().tolist()) == list(range(b ** k))
    shift, scrambles = G._halton_draws(torch.Generator().manual_seed(0), 243, 8, torch.float64, 'cpu')
    assert torch.equal(a, G._halton_points(243, 8, shift, scrambles, torch.float64, 'cpu'))
    with pytest.raises(ValueError, match='up to 15'):
        G._halton(torch.Generator(), 8, 16, torch.float64, 'cpu')


@pytest.mark.parametrize('make', [
    lambda g: g.Generator1D(100, -1.0, 2.0, method='halton'),
    lambda g: g.Generator2D((10, 12), (0.0, -1.0), (2.0, 1.0), method='halton'),
    lambda g: g.Generator3D((4, 5, 6), (0.0, 0.0, 1.0), (1.0, 3.0, 2.0), method='halton'),
    lambda g: g.GeneratorND((4, 5, 6, 2), (0, 0, 0, -1), (1, 2, 3, 1), methods='halton'),
    lambda g: g.GeneratorHypercube(120, 7, r_min=-1.0, r_max=1.0, method='halton'),
])
def test_halton_methods_are_valid(make):
    """Every generator that takes 'halton' in the JAX package takes it here,
    with the same point count and box."""
    gen, jgen = make(G), make(JG)
    cols = G._as_tuple(gen.sample(torch.Generator().manual_seed(0)))
    jcols = JG._as_tuple(jax.jit(jgen.sample)(jax.random.PRNGKey(0)))
    assert gen.size == jgen.size and len(cols) == len(jcols)
    for c, jc in zip(cols, jcols):
        jc = np.asarray(jc)
        assert c.shape == jc.shape and c.dtype == torch.float64
        lo, hi = jc.min(), jc.max()
        span = hi - lo
        assert lo - 0.05 * span <= c.min().item() and c.max().item() <= hi + 0.05 * span


def _jax_grid(gen):
    return tuple(np.asarray(o) for o in jax.jit(gen.sample)(jax.random.PRNGKey(0)))


@pytest.mark.parametrize('methods,grid,r_min,r_max,kw', [
    (['equally-spaced', 'equally-spaced'], (5, 7), (0.0, -1.0), (1.0, 2.0), {}),
    (['chebyshev', 'chebyshev2', 'chebyshev1'], (4, 5, 3), (0.0, 0.0, -2.0), (1.0, 3.0, 2.0), {}),
    (['log-spaced', 'exp-spaced'], (6, 5), (0.1, 0.5), (10.0, 2.0), {'base': (10, 2)}),
    (['equally-spaced', 'chebyshev2'], (8, 6), (0.0, 0.0), (1.0, 1.0), {'cut': ((1, -1), (None, 4))}),
    ('equally-spaced', 9, 0.0, 1.0, {'cut': (2, None)}),
])
def test_generator_nd_grids_match_jax(methods, grid, r_min, r_max, kw):
    """The deterministic methods (``noisy=False``) equal the JAX package's
    compiled grids to one ulp, ``cut`` included, in the meshgrid's order."""
    gen = G.GeneratorND(grid, r_min, r_max, methods=methods, noisy=False, **kw)
    want = _jax_grid(JG.GeneratorND(grid, r_min, r_max, methods=methods, noisy=False, **kw))
    got = gen.sample(None)
    assert gen.size == want[0].size and len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.all(np.abs(g.numpy() - w) <= np.abs(np.spacing(w)))


def test_generator_nd_noise_and_uniform_axes():
    """Gaussian noise of the given std per axis around the grid (a quarter
    grid step by default), fresh per draw; 'uniform' axes redraw their nodes
    in their interval and take no noise; ``abs_value`` folds the sign."""
    base = G.GeneratorND((40, 50), (0.0, 0.0), (1.0, 2.0), noisy=False).sample(None)
    gen = G.GeneratorND((40, 50), (0.0, 0.0), (1.0, 2.0), r_noise_std=(0.01, 0.02))
    rng = torch.Generator().manual_seed(0)
    draws = [gen.sample(rng) for _ in range(4)]
    for axis, std in ((0, 0.01), (1, 0.02)):
        noise = torch.stack([d[axis] - base[axis] for d in draws])
        assert abs(noise.std().item() / std - 1) < 0.05 and abs(noise.mean().item()) < 0.05 * std
    default = G.GeneratorND((40, 50), (0.0, 0.0), (1.0, 2.0)).sample(rng)
    assert abs((default[1] - base[1]).std().item() / (2.0 / 50 / 4) - 1) < 0.1
    uni = G.GeneratorND((30, 4), (1.0, 0.0), (3.0, 1.0), methods=['uniform', 'equally-spaced'])
    (u1, _), (u2, _) = uni.sample(rng), uni.sample(rng)
    assert u1.min() >= 1.0 and u1.max() < 3.0 and not torch.equal(u1, u2)
    assert torch.equal(u1.reshape(30, 4)[:, 0:1].expand(30, 4), u1.reshape(30, 4))  # no noise on the nodes
    folded = G.GeneratorND((20,), (0.0,), (0.1,), methods=['equally-spaced'], r_noise_std=(0.5,),
                           abs_value=True).sample(rng)[0]
    assert folded.min() >= 0


@pytest.mark.parametrize('kw', [
    dict(methods=['halton', 'equally-spaced']),
    dict(methods='halton', cut=((0, 2), (0, 2))),
    dict(grid=(2,) * 16, r_min=(0.0,) * 16, r_max=(1.0,) * 16, methods='halton'),
    dict(methods=['equally-spaced', 'equally-spaced'], colour='blue'),
])
def test_generator_nd_validation_matches_jax(kw):
    kw = {'grid': (2, 2), 'r_min': (0.0, 0.0), 'r_max': (1.0, 1.0), **kw}
    with pytest.raises(ValueError) as jerr:
        JG.GeneratorND(**kw)
    with pytest.raises(ValueError) as err:
        G.GeneratorND(**kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize('method', ['uniform', 'halton'])
def test_hypercube_interior_shapes_and_bounds(method):
    gen = G.GeneratorHypercube(500, 6, r_min=(-1, 0, 0, 2, 0, 0), r_max=(1, 1, 3, 2.5, 1, 1e-3), method=method)
    cols = gen.sample(torch.Generator().manual_seed(0))
    assert gen.size == 500 and len(cols) == 6
    for c, lo, hi in zip(cols, gen.r_min, gen.r_max):
        assert c.shape == (500,) and c.dtype == torch.float64
        assert c.min() >= lo and c.max() <= hi
        # the points spread over the interval
        assert (c.max() - c.min()) > 0.9 * (hi - lo)


def test_hypercube_boundary_law():
    """Every point lies on exactly one face; the axis of its face is drawn
    with probability proportional to 1 / L_i (chi-square, 2 degrees of
    freedom, fixed seed) and its side with probability 1/2."""
    lo, hi = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 6.0])
    gen = G.GeneratorHypercube(30000, 3, r_min=tuple(lo), r_max=tuple(hi), boundary=True)
    pts = torch.stack(gen.sample(torch.Generator().manual_seed(5)), dim=1).numpy()
    on_lo, on_hi = pts == lo, pts == hi
    on_face = on_lo | on_hi
    assert np.all(on_face.sum(axis=1) == 1)
    assert np.all((pts >= lo) & (pts <= hi))
    counts = on_face.sum(axis=0)
    p = (1 / (hi - lo)) / (1 / (hi - lo)).sum()
    chi2 = float(((counts - p * len(pts)) ** 2 / (p * len(pts))).sum())
    assert chi2 < 13.8  # the 0.1% tail of chi-square with 2 degrees of freedom
    n_hi = on_hi.sum()
    assert abs(n_hi - len(pts) / 2) < 3.3 * np.sqrt(len(pts) / 4)
    # the coordinates off the face stay uniform in their interval
    free = pts[~on_face[:, 0], 0]
    assert abs(free.mean() - 0.5) < 0.01 and abs(free.std() - np.sqrt(1 / 12)) < 0.01


@pytest.mark.parametrize('args,kw', [
    ((10, 0), {}),
    ((10, 3), dict(r_min=(0.0, 0.0))),
    ((10, 2), dict(r_min=(0.0, 1.0), r_max=(1.0, 1.0))),
    ((10, 2), dict(method='sobol')),
    ((10, 2), dict(method='halton', boundary=True)),
    ((10, 16), dict(method='halton')),
])
def test_hypercube_validation_matches_jax(args, kw):
    with pytest.raises(ValueError) as jerr:
        JG.GeneratorHypercube(*args, **kw)
    with pytest.raises(ValueError) as err:
        G.GeneratorHypercube(*args, **kw)
    assert str(err.value) == str(jerr.value)


def test_hypercube_repr_and_combinators():
    """A boundary sampler concatenates with an interior one (``+``) into one
    batch, as a boundary-penalty loss takes them."""
    inner = G.GeneratorHypercube(40, 4)
    bnd = G.GeneratorHypercube(10, 4, boundary=True)
    both = inner + bnd
    cols = both.sample(torch.Generator().manual_seed(0))
    assert both.size == 50 and len(cols) == 4 and cols[0].shape == (50,)
    assert repr(inner).startswith('GeneratorHypercube(size=40, dim=4')
