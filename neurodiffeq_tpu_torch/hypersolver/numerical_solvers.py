r"""Numerical ODE integrators with an optional neural corrector
(counterpart of ``neurodiffeq_tpu/hypersolver/numerical_solvers.py``).

The JAX package rolls the integrator out as one ``lax.scan``; here the
rollout is a plain loop over the steps, each step one small set of
kernels, since PyTorch runs eagerly.
"""
from abc import ABC, abstractmethod

import numpy as np
import torch

from ..generators import _linspace
from ..utils import resolve

__all__ = ['NumericalSolver', 'Euler', 'Heun', 'RK4']


class NumericalSolver(ABC):
    r"""Base integrator: a subclass defines ``order`` (the global order p)
    and ``step``, the increment slope :math:`\Phi(u, t, h)` of
    :math:`u_{i+1} = u_i + h\,\Phi`. The rollout adds an optional neural
    correction scaled by :math:`h^{p+1}`, the local truncation order.
    """

    order = None

    def solve(self, func, u0, t0, tn, n_steps, hypernet=None, device=None, dtype=None):
        """Roll the integrator out over ``n_steps`` equal steps.

        :param func: the right-hand side, maps ``(*u, t)`` to du/dt components.
        :param u0: the initial state (a number or a sequence).
        :param t0: the initial time. :param tn: the final time.
        :param n_steps: the number of steps.
        :param hypernet: optional corrector module; it maps the ``(1, dim + 1)``
            row ``[t_i, u_i]`` to ``dim`` outputs.
        :param device: device of the rollout (the port's default if None).
        :param dtype: dtype of the rollout (the port's default if None).
        :return: ``[ts, u_1(ts), ..., u_k(ts)]``, tensors of ``n_steps + 1``.
        """
        device, dtype = resolve(device, dtype)
        ts = _linspace(t0, tn, n_steps + 1, dtype, device)
        if isinstance(u0, (float, int)):
            u0 = (u0,)
        u = torch.as_tensor(u0, dtype=dtype, device=device).reshape(-1)
        h = (tn - t0) / n_steps
        us = [u]
        for t in ts[:-1]:
            du = torch.stack([torch.as_tensor(d, dtype=dtype, device=device).reshape(())
                              for d in _as_seq(self.step(func, u, t, h))])
            u_new = u + h * du
            if hypernet is not None:
                row = torch.cat([t.reshape(1), u]).reshape(1, -1)
                u_new = u_new + h ** (self.order + 1) * hypernet(row).reshape(u.shape)
            u = u_new
            us.append(u)
        us = torch.stack(us)
        return [ts] + [us[:, j] for j in range(us.shape[1])]

    @abstractmethod
    def step(self, func, u, t, h):
        pass  # pragma: no cover


class Euler(NumericalSolver):
    r"""Forward Euler:
    :math:`u_{i+1} = u_i + h f(u_i, t_i) + h^2\,\mathrm{hypernet}(t_i, u_i)`."""
    order = 1

    def step(self, func, u, t, h):
        return func(*u, t)


class Heun(NumericalSolver):
    r"""Heun's method (explicit trapezoidal, global order 2) with an
    :math:`h^3`-scaled corrector:
    :math:`\Phi = \tfrac12\left[f(u_i, t_i) + f(u_i + h f(u_i, t_i), t_i + h)\right]`."""
    order = 2

    def step(self, func, u, t, h):
        k1 = _normalize_rhs(func(*u, t), len(u))
        u_pred = [ui + h * k for ui, k in zip(u, k1)]
        k2 = _normalize_rhs(func(*u_pred, t + h), len(u))
        return [0.5 * (a + b) for a, b in zip(k1, k2)]


class RK4(NumericalSolver):
    r"""The classic fourth-order Runge-Kutta method with an
    :math:`h^5`-scaled corrector:
    :math:`\Phi = \tfrac16(k_1 + 2k_2 + 2k_3 + k_4)` with the standard
    half-step stages."""
    order = 4

    def step(self, func, u, t, h):
        n = len(u)
        k1 = _normalize_rhs(func(*u, t), n)
        u2 = [ui + 0.5 * h * k for ui, k in zip(u, k1)]
        k2 = _normalize_rhs(func(*u2, t + 0.5 * h), n)
        u3 = [ui + 0.5 * h * k for ui, k in zip(u, k2)]
        k3 = _normalize_rhs(func(*u3, t + 0.5 * h), n)
        u4 = [ui + h * k for ui, k in zip(u, k3)]
        k4 = _normalize_rhs(func(*u4, t + h), n)
        return [(a + 2 * b + 2 * c + d) / 6.0 for a, b, c, d in zip(k1, k2, k3, k4)]


def _normalize_rhs(out, n_eq):
    """A right-hand side's return value as one entry per equation. A bare
    tensor from a single-equation func (``lambda u, t: -u`` over a batch of
    N points) stays one equation: split into N per-point entries it would
    misalign the zip over equations in a multi-stage step."""
    if isinstance(out, (list, tuple)):
        return list(out)
    if n_eq == 1:
        return [out]
    return _as_seq(out)


def _as_seq(x):
    if isinstance(x, (list, tuple)):
        return x
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim >= 1:
        return [x[i] for i in range(x.shape[0])]
    return [x]
