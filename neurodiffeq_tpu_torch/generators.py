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

__all__ = ['BaseGenerator', 'Generator1D', 'Generator2D', 'Generator3D', 'GeneratorND', 'GeneratorSpherical',
           'GeneratorHypercube', 'ConcatGenerator', 'StaticGenerator', 'PredefinedGenerator', 'TransformGenerator',
           'EnsembleGenerator', 'MeshGenerator', 'FilterGenerator', 'ResampleGenerator', 'BatchGenerator',
           'ResidualAdaptiveGenerator', 'SamplerGenerator', 'contains_buried_adaptive']


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


# the prime bases of the Halton sequence's first 15 dimensions
_HALTON_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47)


def _halton_draws(gen, n, dim, dtype, device):
    """The random draws of :func:`_halton_points`: per dimension of base
    ``b >= 17`` a digit multiplier in ``[1, b)`` and ``n_digits`` digit
    shifts in ``[0, b)`` (None below base 17), and the ``(dim,)`` rotation."""
    scrambles = []
    for b in _HALTON_PRIMES[:dim]:
        if b < 17:
            scrambles.append(None)
            continue
        a = int(torch.randint(1, b, (), generator=gen, device=device))
        c = torch.randint(0, b, (_halton_digits(n, b),), generator=gen, device=device)
        scrambles.append((a, c))
    shift = torch.rand(dim, generator=gen, dtype=dtype, device=device)
    return shift, scrambles


def _halton_digits(n, b):
    return int(np.log(max(n, 2)) / np.log(b)) + 2


def _halton_points(n, dim, shift, scrambles, dtype, device):
    r"""Halton points in ``[0, 1)^dim`` from given draws: the radical inverse
    of 1..n in the first ``dim`` prime bases, each digit of base ``b >= 17``
    scrambled as ``(a * digit + c_j) mod b`` (Matousek), then rotated by
    ``shift`` modulo 1 (Cranley-Patterson). The columns run side by side,
    each in the JAX package's order of operations (``x += f * digit`` with
    ``f`` the Python float ``b^-(j+1)`` cast to the dtype), so the points
    equal its ``_halton`` bit for bit given the same draws."""
    if dim > len(_HALTON_PRIMES):
        raise ValueError(f"the Halton sequence supports up to {len(_HALTON_PRIMES)} dimensions, got {dim}")
    bases = _HALTON_PRIMES[:dim]
    n_digits = [_halton_digits(n, b) for b in bases]
    # digit j's weight per column, divided in Python as the JAX package
    # divides it; 0 past a column's digits, where the sum then stays as it is
    weights = np.zeros((max(n_digits), dim))
    for col, (b, k) in enumerate(zip(bases, n_digits)):
        f = 1.0 / b
        for j in range(k):
            weights[j, col] = f
            f = f / b
    weights = torch.tensor(weights, dtype=dtype, device=device)
    mult = torch.tensor([1 if s is None else s[0] for s in scrambles], device=device)
    shifts = torch.zeros((max(n_digits), dim), dtype=torch.long, device=device)
    for col, s in enumerate(scrambles):
        if s is not None:
            shifts[:len(s[1]), col] = s[1]
    b_t = torch.tensor(bases, device=device)
    idx = torch.arange(1, n + 1, device=device)[:, None].expand(n, dim)
    x = torch.zeros((n, dim), dtype=dtype, device=device)
    for j in range(max(n_digits)):
        digit = (mult * (idx % b_t) + shifts[j]) % b_t
        x = x + weights[j] * digit.to(dtype)
        idx = idx // b_t
    return torch.remainder(x + shift, 1.0)


def _halton(gen, n, dim, dtype, device):
    r"""Randomized Halton points in ``[0, 1)^dim``, drawn from the
    ``torch.Generator`` ``gen`` (:func:`_halton_points`). A fresh draw per
    batch randomizes the rotation (the integral estimate stays unbiased)
    while each batch keeps its low discrepancy; dimensions of base 17 and
    up are also digit-scrambled, which breaks the correlated 2-D
    projections of neighbouring high bases at typical batch sizes."""
    if dim > len(_HALTON_PRIMES):
        raise ValueError(f"the Halton sequence supports up to {len(_HALTON_PRIMES)} dimensions, got {dim}")
    shift, scrambles = _halton_draws(gen, n, dim, dtype, device)
    return _halton_points(n, dim, shift, scrambles, dtype, device)


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
        'latin-hypercube' or 'halton' (randomized low-discrepancy points,
        :func:`_halton`).
    :param noise_std: standard deviation of the noise for noisy methods;
        defaults to ``((t_max - t_min) / size) / 4``.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    :raises ValueError: When provided with an unknown method.
    """

    _METHODS = ('uniform', 'equally-spaced', 'equally-spaced-noisy', 'log-spaced', 'log-spaced-noisy',
                'chebyshev', 'chebyshev1', 'chebyshev2', 'chebyshev2-noisy', 'latin-hypercube', 'halton')

    def __init__(self, size, t_min=0.0, t_max=1.0, method='uniform', noise_std=None, device=None, dtype=None):
        super().__init__(device, dtype)
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
        elif m == 'halton':
            t = self.t_min + (self.t_max - self.t_min) * _halton(generator, n, 1, dt, dev)[:, 0]
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
        nodes of the 1-D method, meshed), or 'halton': ``grid[0] * grid[1]``
        randomized low-discrepancy points filling the rectangle directly
        (:func:`_halton`).
    :param xy_noise_std: per-axis noise std; defaults to grid-step / 4 per axis.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    _METHODS = ('equally-spaced', 'equally-spaced-noisy', 'chebyshev', 'chebyshev1', 'chebyshev2',
                'chebyshev2-noisy', 'latin-hypercube', 'halton')

    def __init__(self, grid=(10, 10), xy_min=(0.0, 0.0), xy_max=(1.0, 1.0),
                 method='equally-spaced-noisy', xy_noise_std=None, device=None, dtype=None):
        super().__init__(device, dtype)
        if method not in self._METHODS:
            raise ValueError(f'Unknown method: {method}')
        self.grid = grid
        self.size = grid[0] * grid[1]
        self.xy_min = xy_min
        self.xy_max = xy_max
        self.method = method
        self.xy_noise_std = xy_noise_std
        self._grid_points = None
        if method not in ('chebyshev2-noisy', 'latin-hypercube', 'halton'):
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
        if self.method == 'halton':
            u = _halton(generator, self.size, 2, self.dtype, self.device)
            return tuple(self.xy_min[i] + (self.xy_max[i] - self.xy_min[i]) * u[:, i] for i in range(2))
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
        per-axis nodes of the 1-D method, meshed), or 'halton': randomized
        low-discrepancy points filling the box directly (:func:`_halton`).
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    _METHODS = ('equally-spaced', 'equally-spaced-noisy', 'chebyshev', 'chebyshev1', 'chebyshev2',
                'latin-hypercube', 'halton')

    def __init__(self, grid=(10, 10, 10), xyz_min=(0.0, 0.0, 0.0), xyz_max=(1.0, 1.0, 1.0),
                 method='equally-spaced-noisy', device=None, dtype=None):
        super().__init__(device, dtype)
        if method not in self._METHODS:
            raise ValueError(f"Unknown method: {method}")
        self.size = grid[0] * grid[1] * grid[2]
        self.grid = grid
        self.xyz_min = xyz_min
        self.xyz_max = xyz_max
        self.method = method
        self._grid_points = None if method in ('latin-hypercube', 'halton') else self._mesh(self._axes(None))

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
        if self.method == 'halton':
            u = _halton(generator, self.size, 3, self.dtype, self.device)
            return tuple(self.xyz_min[i] + (self.xyz_max[i] - self.xyz_min[i]) * u[:, i] for i in range(3))
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


class GeneratorND(BaseGenerator):
    r"""N-D training points as a meshgrid (flattened, ``indexing='ij'``) of
    per-axis node sets.

    :param grid: per-axis node counts; an int if N = 1.
    :param r_min: per-axis lower bounds.
    :param r_max: per-axis upper bounds.
    :param methods: per-axis method: 'uniform', 'equally-spaced',
        'log-spaced', 'exp-spaced', 'chebyshev'/'chebyshev1', 'chebyshev2'.
        The whole-box string ``methods='halton'`` instead fills the N-D box
        with ``prod(grid)`` randomized low-discrepancy points
        (:func:`_halton`, N <= 15); ``noisy`` and ``cut`` do not apply to it.
    :param noisy: add per-axis Gaussian noise if True (the default).
    :param r_noise_std: per-axis noise std; defaults to a quarter of each
        axis's grid step (relative to the node for 'log-spaced' and
        'exp-spaced').
    :param cut: per-axis ``(start, stop)`` slices of the node sets (kwarg).
    :param base: per-axis log base of 'exp-spaced' (kwarg, default 10).
    :param abs_value: take the absolute value of noisy samples (kwarg).
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    _METHODS = ('uniform', 'equally-spaced', 'log-spaced', 'exp-spaced', 'chebyshev', 'chebyshev1', 'chebyshev2')

    def __init__(self, grid=(10, 10), r_min=(0.0, 0.0), r_max=(1.0, 1.0),
                 methods=('equally-spaced', 'equally-spaced'), noisy=True, r_noise_std=None, device=None,
                 dtype=None, **kwargs):
        super().__init__(device, dtype)
        self.grid, self.r_min, self.r_max = grid, r_min, r_max
        self.methods, self.noisy, self.r_noise_std = methods, noisy, r_noise_std
        if isinstance(methods, str):
            methods = [methods]
        if isinstance(grid, int):
            grid = (grid,)
        if isinstance(r_min, (float, int)):
            r_min = (r_min,)
        if isinstance(r_max, (float, int)):
            r_max = (r_max,)
        if isinstance(r_noise_std, (float, int)):
            r_noise_std = (r_noise_std,)
        n_axes = len(grid)
        self._halton_box = isinstance(self.methods, str) and self.methods == 'halton'
        if not self._halton_box and 'halton' in methods:
            raise ValueError(
                "'halton' is a whole-box method, not a per-axis one: pass "
                "methods='halton' (a string) to fill the N-D box with "
                "low-discrepancy points")
        cut = kwargs.pop('cut', None)
        if self._halton_box:
            if cut is not None:
                raise ValueError("'cut' does not apply to methods='halton' "
                                 "(points fill the box, not a per-axis mesh)")
            if n_axes > len(_HALTON_PRIMES):
                raise ValueError(f"methods='halton' supports up to "
                                 f"{len(_HALTON_PRIMES)} dimensions, got {n_axes}")
        if cut is None:
            cut = tuple((None, None) for _ in range(n_axes))
        base = kwargs.pop('base', tuple(10 for _ in range(n_axes)))
        abs_value = kwargs.pop('abs_value', False)
        if kwargs:
            raise ValueError(f'Unknown keyword argument(s): {list(kwargs.keys())}')
        if isinstance(base, (float, int)):
            base = (base,)
        if isinstance(cut[0], (float, int)) or cut[0] is None:
            cut = (cut,)
        if not self._halton_box:
            for m in methods:
                if m not in self._METHODS:
                    raise ValueError(f'Unknown method: {m}')
        self._n_axes, self._grid, self._r_min, self._r_max = n_axes, grid, r_min, r_max
        self._methods, self._cut, self._base, self._abs_value = methods, cut, base, abs_value
        self._r_noise_std_tuple = r_noise_std
        self.size = int(np.prod([len(range(*slice(*cut[i]).indices(grid[i]))) for i in range(n_axes)]))
        # the node sets and noise stds of the deterministic axes, made once
        self._fixed = None if self._halton_box else [
            None if m == 'uniform' else self._axis_nodes(i, None) for i, m in enumerate(methods)]

    def _axis_nodes(self, i, generator):
        method, dt, dev = self._methods[i], self.dtype, self.device
        a, b, n = self._r_min[i], self._r_max[i], self._grid[i]
        noise_rstd = self._r_noise_std_tuple[i] if self._r_noise_std_tuple else ((b - a) / n) / 4.0
        if method == 'equally-spaced':
            x = _linspace(a, b, n, dt, dev)
            std = noise_rstd * torch.ones(n, dtype=dt, device=dev)
        elif method == 'uniform':
            x = torch.rand(n, generator=generator, dtype=dt, device=dev) * (b - a) + a
            std = torch.zeros(n, dtype=dt, device=dev)
        elif method == 'log-spaced':
            x = torch.pow(10.0, _linspace(float(np.log10(a)), float(np.log10(b)), n, dt, dev))
            std = noise_rstd * x
        elif method == 'exp-spaced':
            lin = _linspace(self._base[i] ** a, self._base[i] ** b, n, dt, dev)
            x = torch.log(lin) / float(np.log(self._base[i]))
            std = noise_rstd * x
        elif method in ('chebyshev', 'chebyshev1'):
            x = _chebyshev_first(a, b, n, dt, dev)
            std = noise_rstd * torch.ones(n, dtype=dt, device=dev)
        else:
            x = _chebyshev_second(a, b, n, dt, dev)
            std = noise_rstd * torch.ones(n, dtype=dt, device=dev)
        sl = slice(*self._cut[i])
        return x[sl], std[sl]

    def sample(self, generator):
        """One batch of N columns; ``generator`` lives on the points' device."""
        if self._halton_box:
            u = _halton(generator, self.size, self._n_axes, self.dtype, self.device)
            return tuple(self._r_min[i] + (self._r_max[i] - self._r_min[i]) * u[:, i] for i in range(self._n_axes))
        axes = [fixed if fixed is not None else self._axis_nodes(i, generator) for i, fixed in enumerate(self._fixed)]
        grids = torch.meshgrid(*[x for x, _ in axes], indexing='ij')
        stds = torch.meshgrid(*[s for _, s in axes], indexing='ij')
        out = []
        for g, s in zip(grids, stds):
            g = g.flatten()
            if self.noisy:
                g = g + torch.randn(g.shape, generator=generator, dtype=self.dtype, device=self.device) * s.flatten()
                if self._abs_value:
                    g = torch.abs(g)
            out.append(g)
        return tuple(out)

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(grid=self.grid, r_min=self.r_min, r_max=self.r_max,
                      methods=self.methods, noisy=self.noisy, r_noise_std=self.r_noise_std))
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


class GeneratorHypercube(BaseGenerator):
    r"""IID (or quasi-Monte-Carlo) points in a ``dim``-dimensional box, the
    high-dimensional companion of
    :func:`~neurodiffeq_tpu_torch.operators.stde_laplacian`
    (:class:`GeneratorND`'s meshgrid has the product of its axes' counts).

    With ``boundary=True`` the points lie ON the box's boundary: a uniform
    interior draw with one coordinate snapped to its min or max. Axis ``i``
    is picked with probability proportional to its face's (d-1)-measure,
    :math:`\prod_{j \ne i} (b_j - a_j)`, that is :math:`\propto 1/(b_i -
    a_i)`, either side with probability 1/2, so the sample is uniform on
    the whole boundary, anisotropic boxes included.

    :param size: number of points.
    :param dim: number of dimensions (columns returned).
    :param r_min: scalar or per-axis lower bounds. Defaults to 0.
    :param r_max: scalar or per-axis upper bounds. Defaults to 1.
    :param method: 'uniform' (iid) or 'halton' (randomized low-discrepancy,
        ``dim`` <= 15, interior only).
    :param boundary: sample the boundary instead of the interior.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    def __init__(self, size, dim, r_min=0.0, r_max=1.0, method='uniform', boundary=False, device=None, dtype=None):
        super().__init__(device, dtype)
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        r_min = tuple(r_min) if np.ndim(r_min) else (float(r_min),) * dim
        r_max = tuple(r_max) if np.ndim(r_max) else (float(r_max),) * dim
        if len(r_min) != dim or len(r_max) != dim:
            raise ValueError(
                f"r_min/r_max must be scalars or length-{dim}: got {len(r_min)}/{len(r_max)}")
        if any(hi <= lo for lo, hi in zip(r_min, r_max)):
            raise ValueError(f"Illegal box [{r_min}, {r_max}]")
        if method not in ('uniform', 'halton'):
            raise ValueError(f'Unknown method: {method}')
        if method == 'halton':
            if boundary:
                raise ValueError("method='halton' samples the interior; use "
                                 "method='uniform' with boundary=True")
            if dim > len(_HALTON_PRIMES):
                raise ValueError(f"method='halton' supports up to "
                                 f"{len(_HALTON_PRIMES)} dimensions, got {dim}")
        self.size, self.dim = size, dim
        self.r_min, self.r_max = r_min, r_max
        self.method, self.boundary = method, boundary
        self._lo = torch.tensor(r_min, dtype=self.dtype, device=self.device)
        self._hi = torch.tensor(r_max, dtype=self.dtype, device=self.device)
        inv_len = 1.0 / (np.asarray(r_max) - np.asarray(r_min))
        self._face_p = torch.tensor(inv_len / inv_len.sum(), dtype=torch.float64, device=self.device)

    def sample(self, generator):
        """One batch of ``dim`` columns; ``generator`` lives on the points' device."""
        n, d, dt, dev = self.size, self.dim, self.dtype, self.device
        if self.method == 'halton':
            u = _halton(generator, n, d, dt, dev)
        else:
            u = torch.rand((n, d), generator=generator, dtype=dt, device=dev)
        pts = self._lo + (self._hi - self._lo) * u
        if self.boundary:
            face = torch.multinomial(self._face_p, n, replacement=True, generator=generator)
            side = torch.randint(0, 2, (n, 1), generator=generator, device=dev).to(dt)
            onehot = torch.nn.functional.one_hot(face, d).to(dt)
            face_val = self._lo * (1 - side) + self._hi * side
            pts = pts * (1 - onehot) + face_val * onehot
        return tuple(pts[:, i] for i in range(d))

    def _internal_vars(self):
        d = super()._internal_vars()
        d.update(dict(dim=self.dim, r_min=self.r_min, r_max=self.r_max,
                      method=self.method, boundary=self.boundary))
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
