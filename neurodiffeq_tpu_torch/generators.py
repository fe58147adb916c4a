r"""Collocation-point generators (counterpart of ``neurodiffeq_tpu/generators.py``).

A generator is a description of a point set plus a ``device`` and a
``dtype``; ``sample(generator)`` draws one batch with an explicit
``torch.Generator`` on that device, and ``get_examples()`` draws with the
port's global generator for the device (:func:`~neurodiffeq_tpu_torch.utils.get_generator`).
Deterministic methods reproduce the JAX package's compiled arithmetic bit
for bit; random methods match it in distribution (the JAX threefry streams
cannot be reproduced in torch).

Generators combine with ``g1 + g2`` (:class:`ConcatGenerator`),
``g1 * g2`` (:class:`EnsembleGenerator`) and ``g1 ^ g2``
(:class:`MeshGenerator`), and wrap into :class:`TransformGenerator`,
:class:`FilterGenerator`, :class:`ResampleGenerator`,
:class:`BatchGenerator`, :class:`ResidualAdaptiveGenerator` and
:class:`SamplerGenerator`. A wrapper draws
from the one ``torch.Generator`` it is given, its sub-generators in order.
The port samples eagerly, so a batch may change size from one draw to the
next (``FilterGenerator`` without ``fixed_size``, ``BatchGenerator``'s
cache) and still train through ``fit``.
"""
import math

import numpy as np
import torch

from .utils import get_generator, resolve

__all__ = ['BaseGenerator', 'Generator1D', 'Generator2D', 'Generator3D', 'GeneratorSpherical', 'ConcatGenerator',
           'StaticGenerator', 'PredefinedGenerator', 'TransformGenerator', 'EnsembleGenerator', 'MeshGenerator',
           'FilterGenerator', 'ResampleGenerator', 'BatchGenerator', 'ResidualAdaptiveGenerator',
           'SamplerGenerator', 'contains_buried_adaptive']

_NO_HALTON = ("method 'halton' is not ported yet "
              "(ROADMAP.md §1 item 17, the high-dimensional toolkit: scrambled Halton)")


def _linspace(start, stop, num, dtype, device):
    """``num`` points from ``start`` to ``stop`` inclusive, in the same
    floating-point operations as the compiled ``jnp.linspace`` (XLA turns
    ``start * (1 - i / div) + stop * (i / div)`` into
    ``start * (1 - i * r) + i * (stop * r)`` with ``r = 1 / div``), so that
    grids agree bit for bit with the JAX package."""
    if num == 1:
        return torch.full((1,), start, dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    r = one / (num - 1)
    i = torch.arange(num - 1, dtype=dtype, device=device)
    out = (one * start) * (1 - i * r) + i * ((one * stop) * r)
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def _chebyshev_first(a, b, n, dtype, device):
    # XLA folds ``((i + 0.5) / n) * pi`` into ``(i + 0.5) * (pi / n)``
    nodes = torch.cos((torch.arange(n, dtype=dtype, device=device) + 0.5) * (math.pi / n))
    return ((a + b) + (b - a) * nodes) / 2


def _chebyshev_second(a, b, n, dtype, device, noise=None):
    i = torch.arange(n, dtype=dtype, device=device)
    if noise is not None:
        i = i + noise
    nodes = torch.cos(i * (math.pi / float(n - 1)))
    return ((a + b) + (b - a) * nodes) / 2


def _chebyshev_second_noisy(gen, a, b, n, dtype, device):
    noise = torch.rand(n, generator=gen, dtype=dtype, device=device) * 2 - 1
    return _chebyshev_second(a, b, n, dtype, device, noise)


def _latin_hypercube(gen, a, b, n, dtype, device):
    step = (b - a) / n
    lowers = a + step * torch.arange(n, dtype=dtype, device=device)
    points = lowers + torch.rand(n, generator=gen, dtype=dtype, device=device) * step
    return points[torch.randperm(n, generator=gen, device=device)]


def _compute_log_negative(t_min, t_max, whence):
    if t_min <= 0 or t_max <= 0:
        raise ValueError(
            f"In this version, the interval [{t_min}, {t_max}] cannot be used for "
            f"log-sampling in {whence}. If you meant to sample from the interval "
            f"[10 ^ {t_min}, 10 ^ {t_max}], please pass in {10 ** t_min} and {10 ** t_max}"
        )
    return float(np.log10(t_min)), float(np.log10(t_max))


def _as_tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _sub_generators(gen):
    """The generators ``gen`` wraps or combines."""
    sub = getattr(gen, 'generator', None)
    return ([sub] if isinstance(sub, BaseGenerator) else []) + [
        g for g in getattr(gen, 'generators', ()) or () if isinstance(g, BaseGenerator)]


def _has_fixed_size(gen):
    """Whether every batch of ``gen`` has the same size: not so for a
    ``FilterGenerator`` without ``fixed_size`` or a ``BatchGenerator``, or
    anything built on one (the generators the JAX package cannot jit)."""
    if isinstance(gen, BatchGenerator) or (isinstance(gen, FilterGenerator) and not gen.fixed_size):
        return False
    return all(_has_fixed_size(g) for g in _sub_generators(gen))


def contains_buried_adaptive(gen):
    """True if a :class:`ResidualAdaptiveGenerator` sits inside a
    combinator or wrapper, where its selection cannot run: the solvers
    honor only the outermost train generator's ``adaptive`` flag."""
    stack, seen, top = [gen], set(), True
    while stack:
        g = stack.pop()
        if id(g) in seen:
            continue
        seen.add(id(g))
        if getattr(g, 'adaptive', False) and not top:
            return True
        top = False
        stack.extend(_sub_generators(g))
    return False


class BaseGenerator:
    """Base class for generators: children implement ``sample(generator)``,
    returning a tuple of ``(size,)`` tensors, and set ``size``."""

    def __init__(self, device=None, dtype=None):
        self.size = None
        self.device, self.dtype = resolve(device, dtype)

    def sample(self, generator):
        raise NotImplementedError  # pragma: no cover

    def get_examples(self):
        """Draw one batch with the global generator for this device."""
        out = _as_tuple(self.sample(get_generator(self.device)))
        return out[0] if len(out) == 1 else out

    @staticmethod
    def check_generator(obj):
        if not isinstance(obj, BaseGenerator):
            raise ValueError(f"{obj} is not a generator")

    def __add__(self, other):
        self.check_generator(other)
        return ConcatGenerator(self, other)

    def __mul__(self, other):
        self.check_generator(other)
        return EnsembleGenerator(self, other)

    def __xor__(self, other):
        self.check_generator(other)
        return MeshGenerator(self, other)

    def _internal_vars(self):
        return dict(size=self.size)

    @staticmethod
    def _obj_repr(obj):
        if isinstance(obj, (tuple, list)):
            inner = ', '.join(BaseGenerator._obj_repr(item) for item in obj)
            return f'({inner})' if isinstance(obj, tuple) else f'[{inner}]'
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            return f'tensor(shape={tuple(obj.shape)})'
        return repr(obj)

    def __repr__(self):
        d = self._internal_vars()
        return f"{self.__class__.__name__}({', '.join(f'{k}={self._obj_repr(v)}' for k, v in d.items())})"


class Generator1D(BaseGenerator):
    """1-D training points.

    :param size: Number of points per batch.
    :param t_min: Lower bound, defaults to 0.0.
    :param t_max: Upper bound, defaults to 1.0.
    :param method: one of 'uniform' (the default), 'equally-spaced',
        'equally-spaced-noisy', 'log-spaced', 'log-spaced-noisy',
        'chebyshev'/'chebyshev1', 'chebyshev2', 'chebyshev2-noisy',
        'latin-hypercube'. ('halton' is not ported yet and raises.)
    :param noise_std: standard deviation of the noise for noisy methods;
        defaults to ``((t_max - t_min) / size) / 4``.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    :raises ValueError: When provided with an unknown method.
    """

    _METHODS = ('uniform', 'equally-spaced', 'equally-spaced-noisy', 'log-spaced', 'log-spaced-noisy',
                'chebyshev', 'chebyshev1', 'chebyshev2', 'chebyshev2-noisy', 'latin-hypercube')

    def __init__(self, size, t_min=0.0, t_max=1.0, method='uniform', noise_std=None, device=None, dtype=None):
        super().__init__(device, dtype)
        if method == 'halton':
            raise NotImplementedError(_NO_HALTON)
        if method not in self._METHODS:
            raise ValueError(f'Unknown method: {method}')
        self.size = size
        self.t_min, self.t_max = t_min, t_max
        self.method = method
        self.noise_std = noise_std if noise_std else ((t_max - t_min) / size) / 4.0
        dt, dev = self.dtype, self.device
        if method.startswith('log-spaced'):
            lo, hi = _compute_log_negative(t_min, t_max, self.__class__)
            # jnp.logspace: base ** linspace
            self._base = torch.pow(10.0, _linspace(lo, hi, size, dt, dev))
        elif method.startswith('equally-spaced'):
            self._base = _linspace(t_min, t_max, size, dt, dev)
        elif method in ('chebyshev', 'chebyshev1'):
            self._base = _chebyshev_first(t_min, t_max, size, dt, dev)
        elif method == 'chebyshev2':
            self._base = _chebyshev_second(t_min, t_max, size, dt, dev)

    def sample(self, generator):
        """One batch ``(t,)``; ``generator`` lives on the points' device."""
        m, n, dt, dev = self.method, self.size, self.dtype, self.device
        if m == 'uniform':
            t = torch.rand(n, generator=generator, dtype=dt, device=dev) * (self.t_max - self.t_min) + self.t_min
        elif m.endswith('-noisy') and m != 'chebyshev2-noisy':
            t = self._base + torch.randn(n, generator=generator, dtype=dt, device=dev) * self.noise_std
        elif m == 'chebyshev2-noisy':
            t = _chebyshev_second_noisy(generator, self.t_min, self.t_max, n, dt, dev)
        elif m == 'latin-hypercube':
            t = _latin_hypercube(generator, self.t_min, self.t_max, n, dt, dev)
        else:
            t = self._base
        return (t,)

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(t_min=self.t_min, t_max=self.t_max, method=self.method, noise_std=self.noise_std))
        return d


class Generator2D(BaseGenerator):
    r"""2-D training points on an ``m x n`` grid (flattened).

    :param grid: grid shape ``(m, n)``, defaults to ``(10, 10)``.
    :param xy_min: lower bounds ``(x_0, y_0)``, defaults to ``(0.0, 0.0)``.
    :param xy_max: upper bounds ``(x_1, y_1)``, defaults to ``(1.0, 1.0)``.
    :param method: 'equally-spaced', 'equally-spaced-noisy' (the default: the
        grid plus Gaussian noise per point), 'chebyshev'/'chebyshev1',
        'chebyshev2', 'chebyshev2-noisy' or 'latin-hypercube' (the per-axis
        nodes of the 1-D method, meshed). ('halton' is not ported yet.)
    :param xy_noise_std: per-axis noise std; defaults to grid-step / 4 per axis.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    _METHODS = ('equally-spaced', 'equally-spaced-noisy', 'chebyshev', 'chebyshev1', 'chebyshev2',
                'chebyshev2-noisy', 'latin-hypercube')

    def __init__(self, grid=(10, 10), xy_min=(0.0, 0.0), xy_max=(1.0, 1.0),
                 method='equally-spaced-noisy', xy_noise_std=None, device=None, dtype=None):
        super().__init__(device, dtype)
        if method == 'halton':
            raise NotImplementedError(_NO_HALTON)
        if method not in self._METHODS:
            raise ValueError(f'Unknown method: {method}')
        self.grid = grid
        self.size = grid[0] * grid[1]
        self.xy_min = xy_min
        self.xy_max = xy_max
        self.method = method
        self.xy_noise_std = xy_noise_std
        self._grid_points = None
        if method not in ('chebyshev2-noisy', 'latin-hypercube'):
            self._grid_points = self._mesh(self._axes(None))

    def _axes(self, generator):
        m, dt, dev = self.method, self.dtype, self.device
        axes = []
        for i in range(2):
            a, b, n = self.xy_min[i], self.xy_max[i], self.grid[i]
            if m.startswith('equally-spaced'):
                axes.append(_linspace(a, b, n, dt, dev))
            elif m in ('chebyshev', 'chebyshev1'):
                axes.append(_chebyshev_first(a, b, n, dt, dev))
            elif m == 'chebyshev2':
                axes.append(_chebyshev_second(a, b, n, dt, dev))
            elif m == 'chebyshev2-noisy':
                axes.append(_chebyshev_second_noisy(generator, a, b, n, dt, dev))
            else:
                axes.append(_latin_hypercube(generator, a, b, n, dt, dev))
        return axes

    @staticmethod
    def _mesh(axes):
        gx, gy = torch.meshgrid(*axes, indexing='ij')
        return gx.flatten(), gy.flatten()

    def sample(self, generator):
        """One batch ``(x, y)``; ``generator`` lives on the points' device."""
        if self._grid_points is None:
            return self._mesh(self._axes(generator))
        gx, gy = self._grid_points
        if self.method != 'equally-spaced-noisy':
            return gx, gy
        if self.xy_noise_std:
            sx, sy = self.xy_noise_std
        else:
            sx = ((self.xy_max[0] - self.xy_min[0]) / self.grid[0]) / 4.0
            sy = ((self.xy_max[1] - self.xy_min[1]) / self.grid[1]) / 4.0
        noise = torch.randn((2, self.size), generator=generator, dtype=self.dtype, device=self.device)
        return gx + noise[0] * sx, gy + noise[1] * sy

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(grid=self.grid, xy_min=self.xy_min, xy_max=self.xy_max,
                      method=self.method, xy_noise_std=self.xy_noise_std))
        return d


class Generator3D(BaseGenerator):
    r"""3-D training points on an ``m x n x k`` grid (flattened); not to be
    confused with :class:`GeneratorSpherical`.

    :param grid: grid shape ``(m, n, k)``, defaults to ``(10, 10, 10)``.
    :param xyz_min: lower bounds, defaults to ``(0.0, 0.0, 0.0)``.
    :param xyz_max: upper bounds, defaults to ``(1.0, 1.0, 1.0)``.
    :param method: 'equally-spaced', 'equally-spaced-noisy' (the default: the
        grid plus Gaussian noise of a quarter grid step per axis and point),
        'chebyshev'/'chebyshev1', 'chebyshev2' or 'latin-hypercube' (the
        per-axis nodes of the 1-D method, meshed). ('halton' is not ported
        yet and raises.)
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    _METHODS = ('equally-spaced', 'equally-spaced-noisy', 'chebyshev', 'chebyshev1', 'chebyshev2',
                'latin-hypercube')

    def __init__(self, grid=(10, 10, 10), xyz_min=(0.0, 0.0, 0.0), xyz_max=(1.0, 1.0, 1.0),
                 method='equally-spaced-noisy', device=None, dtype=None):
        super().__init__(device, dtype)
        if method == 'halton':
            raise NotImplementedError(_NO_HALTON)
        if method not in self._METHODS:
            raise ValueError(f"Unknown method: {method}")
        self.size = grid[0] * grid[1] * grid[2]
        self.grid = grid
        self.xyz_min = xyz_min
        self.xyz_max = xyz_max
        self.method = method
        self._grid_points = None if method == 'latin-hypercube' else self._mesh(self._axes(None))

    def _axes(self, generator):
        m, dt, dev = self.method, self.dtype, self.device
        axes = []
        for i in range(3):
            a, b, n = self.xyz_min[i], self.xyz_max[i], self.grid[i]
            if m.startswith('equally-spaced'):
                axes.append(_linspace(a, b, n, dt, dev))
            elif m in ('chebyshev', 'chebyshev1'):
                axes.append(_chebyshev_first(a, b, n, dt, dev))
            elif m == 'chebyshev2':
                axes.append(_chebyshev_second(a, b, n, dt, dev))
            else:
                axes.append(_latin_hypercube(generator, a, b, n, dt, dev))
        return axes

    @staticmethod
    def _mesh(axes):
        return tuple(g.flatten() for g in torch.meshgrid(*axes, indexing='ij'))

    def sample(self, generator):
        """One batch ``(x, y, z)``; ``generator`` lives on the points' device."""
        if self._grid_points is None:
            return self._mesh(self._axes(generator))
        if self.method != 'equally-spaced-noisy':
            return self._grid_points
        noise = torch.randn((3, self.size), generator=generator, dtype=self.dtype, device=self.device)
        return tuple(g + noise[i] * (((self.xyz_max[i] - self.xyz_min[i]) / self.grid[i]) / 4.0)
                     for i, g in enumerate(self._grid_points))

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(grid=self.grid, xyz_min=self.xyz_min, xyz_max=self.xyz_max, method=self.method))
        return d


class GeneratorSpherical(BaseGenerator):
    r"""Points in spherical coordinates ``(r, theta, phi)``, with directions
    spread over the sphere as the JAX package draws them: three uniforms
    normalised under ``sqrt`` (plus ``1e-6``) with random signs, then
    ``theta = arccos(z)`` and ``phi = pi - atan2(y, x)``, in ``[0, 2 pi]``.

    :param size: number of points.
    :param r_min: interior radius.
    :param r_max: exterior radius.
    :param method: 'equally-spaced-noisy' (``r^2 ~ U``, uniform in volume)
        or 'equally-radius-noisy' (``r ~ U``).
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    def __init__(self, size, r_min=0., r_max=1., method='equally-spaced-noisy', device=None, dtype=None):
        super().__init__(device, dtype)
        if r_min < 0 or r_max < r_min:
            raise ValueError(f"Illegal range [{r_min}, {r_max}]")
        if method not in ('equally-spaced-noisy', 'equally-radius-noisy'):
            raise ValueError(f'Unknown method: {method}')
        self.size = size
        self.r_min, self.r_max = r_min, r_max
        self.method = method

    def sample(self, generator):
        """One batch ``(r, theta, phi)``; ``generator`` lives on the points' device."""
        n, dt, dev = self.size, self.dtype, self.device
        a, b, c, u = torch.rand((4, n), generator=generator, dtype=dt, device=dev)
        signs = torch.randint(0, 2, (3, n), generator=generator, device=dev).to(dt) * 2 - 1
        denom = a + b + c
        x, y, z = (torch.sqrt(t / denom) + 1e-6 for t in (a, b, c))
        x, y, z = x * signs[0], y * signs[1], z * signs[2]
        theta = torch.arccos(z)
        phi = -torch.atan2(y, x) + math.pi
        if self.method == 'equally-spaced-noisy':
            lower, upper = self.r_min ** 2, self.r_max ** 2
            r = torch.sqrt((upper - lower) * u + lower)
        else:
            r = (self.r_max - self.r_min) * u + self.r_min
        return r, theta, phi

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(r_min=self.r_min, r_max=self.r_max, method=self.method))
        return d


class _Combinator(BaseGenerator):
    """A generator over sub-generators, on the device and dtype of the first."""

    def __init__(self, *generators):
        for g in generators:
            self.check_generator(g)
        super().__init__(generators[0].device, generators[0].dtype)
        self.generators = generators

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generators=self.generators))
        return d


class ConcatGenerator(_Combinator):
    r"""Concatenates the sample vectors of its sub-generators (``g1 + g2``)."""

    def __init__(self, *generators):
        super().__init__(*generators)
        self.size = sum(gen.size for gen in generators)

    def sample(self, generator):
        all_examples = [_as_tuple(g.sample(generator)) for g in self.generators]
        n_cols = len(all_examples[0])
        if any(len(e) != n_cols for e in all_examples):
            raise ValueError("Sub-generators return different numbers of columns")
        return tuple(torch.cat([e[j] for e in all_examples]) for j in range(n_cols))


class EnsembleGenerator(_Combinator):
    r"""Returns ALL the samples of its sub-generators as one tuple
    (``g1 * g2``). Sub-generators must have equal sizes."""

    def __init__(self, *generators):
        super().__init__(*generators)
        self.size = generators[0].size
        for i, gen in enumerate(generators):
            if gen.size != self.size:
                raise ValueError(f"gens[{i}].size ({gen.size}) != gens[0].size ({self.size})")

    def sample(self, generator):
        return tuple(t for g in self.generators for t in _as_tuple(g.sample(generator)))


class StaticGenerator(BaseGenerator):
    """Samples the sub-generator once at construction (with the global
    generator of its device) and returns the same samples every time."""

    def __init__(self, generator):
        super().__init__(generator.device, generator.dtype)
        self.generator = generator
        self.size = generator.size
        self.examples = _as_tuple(generator.sample(get_generator(generator.device)))

    def sample(self, generator):
        return self.examples

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator, examples=self.examples))
        return d


class PredefinedGenerator(BaseGenerator):
    """A generator of fixed, user-provided points (arrays or tensors of equal
    length, flattened).

    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    def __init__(self, *xs, device=None, dtype=None):
        super().__init__(device, dtype)
        self.size = len(xs[0])
        for x in xs:
            if self.size != len(x):
                raise ValueError(f'tensors of different lengths encountered {self.size} != {len(x)}')
        self.xs = tuple(torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x),
                                        dtype=self.dtype, device=self.device).flatten() for x in xs)

    def sample(self, generator):
        return self.xs

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(xs=self.xs))
        return d


class TransformGenerator(BaseGenerator):
    """Applies transformations to the sample vectors.

    :param generator: base generator.
    :param transforms: list of per-column callables (None = identity).
    :param transform: a single callable applied to all the columns at once,
        ``transform(*columns)``.
    """

    def __init__(self, generator, transforms=None, transform=None):
        super().__init__(generator.device, generator.dtype)
        self.generator = generator
        self.size = generator.size
        if transforms is not None and transform is not None:
            raise ValueError("transform and transforms cannot be both specified")
        if transforms is not None:
            self.trans = [(lambda x: x) if t is None else t for t in transforms]
        elif transform is not None:
            self.trans = transform
        else:
            self.trans = lambda *xs: xs

    def sample(self, generator):
        xs = _as_tuple(self.generator.sample(generator))
        if callable(self.trans):
            return _as_tuple(self.trans(*xs))
        return tuple(t(x) for t, x in zip(self.trans, xs))

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator, trans=self.trans))
        return d


class MeshGenerator(_Combinator):
    r"""Returns a meshgrid of the samples of its sub-generators (``g1 ^ g2``),
    flattened with ``indexing='ij'``: the last generator's points vary
    fastest. Nested MeshGenerators flatten, so ``(g1 ^ g2) ^ g3`` equals
    ``MeshGenerator(g1, g2, g3)``."""

    def __init__(self, *generators):
        flat = []
        for g in generators:
            flat.extend(g.generators if isinstance(g, MeshGenerator) else [g])
        super().__init__(*flat)
        self.size = int(np.prod([g.size for g in self.generators]))

    def sample(self, generator):
        axes = tuple(t for g in self.generators for t in _as_tuple(g.sample(generator)))
        if len(axes) == 1:
            return axes
        return tuple(g.flatten() for g in torch.meshgrid(*axes, indexing='ij'))


class FilterGenerator(BaseGenerator):
    """Keeps the samples that pass a boolean filter.

    - By default the batch keeps every point that passes, so its size
      varies with the draw (``size`` follows it if ``update_size``).
    - With ``fixed_size=True`` it always returns ``size`` points, drawn
      uniformly with replacement from those that pass: the same conditional
      distribution at a static shape. If none passes, it returns copies of
      the first sample.

    :param generator: base generator.
    :param filter_fn: maps the list of sample columns to a boolean mask
        (tensor or numpy).
    :param size: points per batch with ``fixed_size``; defaults to the base
        generator's size.
    :param update_size: set ``size`` to each dynamic batch's size.
    :param fixed_size: return exactly ``size`` points.
    """

    def __init__(self, generator, filter_fn, size=None, update_size=True, fixed_size=False):
        super().__init__(generator.device, generator.dtype)
        self.generator = generator
        self.filter_fn = filter_fn
        self.size = generator.size if size is None else size
        self.fixed_size = bool(fixed_size)
        self.update_size = False if fixed_size else update_size

    def _mask(self, xs):
        mask = self.filter_fn(list(xs))
        return torch.as_tensor(mask if torch.is_tensor(mask) else np.asarray(mask), device=self.device).reshape(-1)

    def sample(self, generator):
        xs = _as_tuple(self.generator.sample(generator))
        mask = self._mask(xs)
        if not self.fixed_size:
            xs = tuple(x[mask] for x in xs)
            if self.update_size:
                self.size = len(xs[0])
            return xs
        # the passing indices first, in order; a uniform pick among the first
        # `count` of them, with no read of the count back to the host
        passing = torch.argsort((~mask).to(torch.int8), stable=True)
        count = mask.sum().clamp(min=1)
        u = torch.rand(self.size, generator=generator, dtype=self.dtype, device=self.device)
        picked = passing[torch.minimum((u * count).long(), count - 1)]
        return tuple(x[picked] for x in xs)

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator, filter_fn=self.filter_fn, fixed_size=self.fixed_size))
        return d


class ResampleGenerator(BaseGenerator):
    """Shuffles and resamples the sub-generator's output, with or without
    replacement.

    :param generator: base generator.
    :param size: points per batch; defaults to the base generator's size.
    :param replacement: draw with replacement.
    """

    def __init__(self, generator, size=None, replacement=False):
        super().__init__(generator.device, generator.dtype)
        self.generator = generator
        self.size = generator.size if size is None else size
        self.replacement = replacement

    def sample(self, generator):
        n = self.generator.size
        if self.replacement:
            indices = torch.randint(0, n, (self.size,), generator=generator, device=self.device)
        else:
            indices = torch.randperm(n, generator=generator, device=self.device)[:self.size]
        return tuple(x[indices] for x in _as_tuple(self.generator.sample(generator)))

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator, replacement=self.replacement))
        return d


class BatchGenerator(BaseGenerator):
    """Caches samples of the sub-generator and returns batches of
    ``batch_size`` points from the cache, refilling it as needed; the first
    fill draws from the global generator of the device. Stateful across
    calls.

    :param generator: base generator.
    :param batch_size: points per batch.
    """

    def __init__(self, generator, batch_size):
        super().__init__(generator.device, generator.dtype)
        if generator.size <= 0:
            raise ValueError(f"generator has size {generator.size} <= 0")
        self.generator = generator
        self.size = batch_size
        self.cached_xs = list(_as_tuple(generator.sample(get_generator(generator.device))))

    def sample(self, generator):
        while len(self.cached_xs[0]) < self.size:
            new = _as_tuple(self.generator.sample(generator))
            self.cached_xs = [torch.cat([x, n]) for x, n in zip(self.cached_xs, new)]
        batch = tuple(x[:self.size] for x in self.cached_xs)
        self.cached_xs = [x[self.size:] for x in self.cached_xs]
        return batch

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator))
        return d


class ResidualAdaptiveGenerator(BaseGenerator):
    """Residual-based adaptive collocation sampling.

    Every training step draws ``oversample`` batches from the wrapped
    generator, scores each candidate point by the magnitude of the current
    equation residual, and keeps ``generator.size`` of them:

    - ``strategy='power'`` (default): indices drawn with replacement with
      probability proportional to ``score**alpha / mean(score**alpha) + c``,
      the RAD scheme of Wu et al. (2023) (``alpha=1, c=1`` defaults);
    - ``strategy='topk'``: the worst-residual points, greedily.

    Solvers see the ``adaptive`` flag and pass a residual scorer
    (``BaseSolver._residual_scores``); used standalone or for validation it
    samples like the base generator. The base generator's batches must all
    have one size. The draws cannot follow the JAX package's random streams:
    the same candidates and scores give the same 'power' probabilities and
    'topk' indices.
    """

    adaptive = True

    def __init__(self, generator, oversample=4, strategy='power', alpha=1.0, c=1.0):
        self.check_generator(generator)
        super().__init__(generator.device, generator.dtype)
        if not _has_fixed_size(generator):
            raise ValueError('ResidualAdaptiveGenerator requires a base generator whose batches have a fixed '
                             'size (not a FilterGenerator without fixed_size, nor a BatchGenerator)')
        if strategy not in ('power', 'topk'):
            raise ValueError(f"unknown strategy {strategy!r}; expected 'power' or 'topk'")
        if int(oversample) < 1:
            raise ValueError(f'oversample must be >= 1, got {oversample}')
        if c < 0:
            raise ValueError(f'c must be >= 0, got {c}')
        self.generator = generator
        self.size = generator.size
        self.oversample = int(oversample)
        self.strategy = strategy
        self.alpha = alpha
        self.c = c

    def sample(self, generator):
        return self.generator.sample(generator)

    def probabilities(self, scores):
        """The 'power' selection probabilities of candidates with ``scores``."""
        w = scores ** self.alpha
        tiny = torch.finfo(w.dtype).tiny
        # the floor keeps a probability positive when c == 0 and every residual vanishes
        p = torch.clamp_min(w / (w.mean() + tiny) + self.c, tiny)
        return p / p.sum()

    @torch.no_grad()
    def sample_scored(self, generator, scorer):
        """Draw ``oversample * size`` candidates and keep ``size`` by score.

        :param generator: the ``torch.Generator`` to draw with.
        :param scorer: maps the tuple of candidate coordinate tensors to
            per-point scores ``(M,)``; it runs under ``no_grad``, so no
            gradient flows through the selection.
        """
        draws = [_as_tuple(self.generator.sample(generator)) for _ in range(self.oversample)]
        cand = tuple(torch.cat([d[i] for d in draws]) for i in range(len(draws[0])))
        scores = scorer(cand).reshape(-1)
        if self.strategy == 'topk':
            idx = torch.topk(scores, self.size).indices
        else:
            idx = torch.multinomial(self.probabilities(scores), self.size, replacement=True, generator=generator)
        out = tuple(c[idx] for c in cand)
        return out if len(out) > 1 else out[0]

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator, oversample=self.oversample, strategy=self.strategy,
                      alpha=self.alpha, c=self.c))
        return d


class SamplerGenerator(BaseGenerator):
    """Wraps a generator so that every sample comes back as a list of
    ``(N, 1)`` columns, as the solvers consume them."""

    def __init__(self, generator):
        super().__init__(generator.device, generator.dtype)
        self.generator = generator
        self.size = generator.size

    @property
    def adaptive(self):
        return getattr(self.generator, 'adaptive', False)

    def sample(self, generator):
        return [u.reshape(-1, 1) for u in _as_tuple(self.generator.sample(generator))]

    def sample_scored(self, generator, scorer):
        """The adaptive ``sample``: the column-wise ``scorer`` of the solvers
        adapted to the wrapped generator's coordinate tuples."""
        samples = self.generator.sample_scored(generator, lambda cand: scorer([u.reshape(-1, 1) for u in cand]))
        return [u.reshape(-1, 1) for u in _as_tuple(samples)]

    def get_examples(self):
        return self.sample(get_generator(self.device))

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(generator=self.generator))
        return d
