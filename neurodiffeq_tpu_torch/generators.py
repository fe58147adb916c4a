r"""Collocation-point generators (counterpart of ``neurodiffeq_tpu/generators.py``).

A generator is a description of a point set plus a ``device`` and a
``dtype``; ``sample(generator)`` draws one batch with an explicit
``torch.Generator`` on that device, and ``get_examples()`` draws with the
port's global generator for the device (:func:`~neurodiffeq_tpu_torch.utils.get_generator`).
"""
import torch

from .utils import get_generator, resolve

__all__ = ['BaseGenerator', 'Generator2D']


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
        out = self.sample(get_generator(self.device))
        return out[0] if len(out) == 1 else out

    def _internal_vars(self):
        return dict(size=self.size)

    def __repr__(self):
        d = self._internal_vars()
        return f"{self.__class__.__name__}({', '.join(f'{k}={v!r}' for k, v in d.items())})"


class Generator2D(BaseGenerator):
    r"""2-D training points on an ``m x n`` grid (flattened).

    :param grid: grid shape ``(m, n)``, defaults to ``(10, 10)``.
    :param xy_min: lower bounds ``(x_0, y_0)``, defaults to ``(0.0, 0.0)``.
    :param xy_max: upper bounds ``(x_1, y_1)``, defaults to ``(1.0, 1.0)``.
    :param method: 'equally-spaced' or 'equally-spaced-noisy' (the default):
        the grid, or the grid plus Gaussian noise per point.
    :param xy_noise_std: per-axis noise std; defaults to grid-step / 4 per axis.
    :param device: device of the points (the port's default if None).
    :param dtype: dtype of the points (the port's default if None).
    """

    def __init__(self, grid=(10, 10), xy_min=(0.0, 0.0), xy_max=(1.0, 1.0),
                 method='equally-spaced-noisy', xy_noise_std=None, device=None, dtype=None):
        super().__init__(device, dtype)
        if method not in ('equally-spaced', 'equally-spaced-noisy'):
            raise ValueError(f'Unknown method: {method} (other methods are not ported yet)')
        self.grid = grid
        self.size = grid[0] * grid[1]
        self.xy_min = xy_min
        self.xy_max = xy_max
        self.method = method
        self.xy_noise_std = xy_noise_std
        axes = [_linspace(self.xy_min[i], self.xy_max[i], self.grid[i], self.dtype, self.device)
                for i in range(2)]
        gx, gy = torch.meshgrid(*axes, indexing='ij')
        self._grid_points = (gx.flatten(), gy.flatten())

    def sample(self, generator):
        """One batch ``(x, y)``; ``generator`` lives on the points' device."""
        gx, gy = self._grid_points
        if self.method == 'equally-spaced':
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
