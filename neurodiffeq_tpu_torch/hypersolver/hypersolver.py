r"""Hypersolver: a network learns the correction to a low-order ODE
integrator (counterpart of ``neurodiffeq_tpu/hypersolver/hypersolver.py``).

The residual targets :math:`R_i = (u_{i+1} - u_i - h\,\Phi(u_i, t_i)) / h^{p+1}`
come from a known solution; the corrector is trained with the mean squared
error on them, and the rollout adds its :math:`h^{p+1}`-scaled output at
every step (:math:`h^2` for Euler, :math:`h^3` for Heun). The target of the
step :math:`t_i \to t_{i+1}` is paired with the net at the step's start
:math:`(t_i, u_i)`, where the rollout applies it, as the JAX package pairs
them.
"""
import math

import numpy as np
import torch
from torch import nn

from ..generators import _linspace
from ..networks import FCNN
from ..utils import resolve

__all__ = ['Hypersolver', 'DiscreteSolution1D']


def _tensor(x, dtype, device):
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), dtype=dtype, device=device)


class DiscreteSolution1D:
    r"""Linear interpolation between solution values on a fixed time grid;
    outside the grid it holds the end values, as ``jnp.interp`` does.

    :param ts: the increasing time grid.
    :param us: one value array per component, on the grid.
    """

    def __init__(self, ts, *us):
        self.ts = torch.as_tensor(ts)
        self.us_tuple = torch.stack([_tensor(u, self.ts.dtype, self.ts.device) for u in us], dim=1)

    def __call__(self, ts):
        """The interpolated components at ``ts`` (numpy or torch), a list of tensors."""
        x = _tensor(ts, self.ts.dtype, self.ts.device).reshape(-1)
        xp = self.ts
        i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
        dx = xp[i] - xp[i - 1]
        delta = x - xp[i - 1]
        flat = dx.abs() <= np.spacing(torch.finfo(xp.dtype).eps)  # a repeated knot: no division by 0
        cols = []
        for fp in self.us_tuple.unbind(1):
            f = torch.where(flat, fp[i - 1], fp[i - 1] + (delta / torch.where(flat, 1, dx)) * (fp[i] - fp[i - 1]))
            f = torch.where(x < xp[0], fp[0], f)
            cols.append(torch.where(x > xp[-1], fp[-1], f))
        return cols


class Hypersolver:
    r"""Train a network to correct a low-order integrator toward a known solution.

    :param func: the ODE right-hand side, maps ``(*u, t)`` to du/dt components.
    :param u0: initial state (a number or a sequence).
    :param t0: initial time. :param tn: final time. :param n_steps: grid steps.
    :param sol: the known solution: maps the time grid (a tensor) to a list
        of component values (tensors or numpy arrays).
    :param numerical_solver: the base integrator (e.g. ``Euler()``).
    :param net: corrector network; defaults to ``FCNN(dim + 1 -> dim, (32, 32))``.
    :param optimizer: a ``torch.optim.Optimizer`` over the net's parameters,
        or a callable that builds one from them; defaults to
        ``torch.optim.Adam(lr=1e-3)``.
    :param device: device of the grid and the net (the port's default if None).
    :param dtype: dtype of the grid and the net (the port's default if None).
    :param generator: ``torch.Generator`` on the CPU that initializes the
        default net (torch's global generator if None), with the bounds of
        ``nn.Linear``'s own initialization.
    """

    def __init__(self, func, u0, t0, tn, n_steps, sol, numerical_solver, net=None, optimizer=None,
                 device=None, dtype=None, generator=None):
        self.device, self.dtype = resolve(device, dtype)
        self.func = func
        if isinstance(u0, (int, float)):
            u0 = [float(u0)]
        elif not isinstance(u0, (list, tuple)):
            raise TypeError(f"u0 must be int, float, list, or tuple, not {type(u0)}")
        self.u0 = torch.tensor(u0, dtype=self.dtype, device=self.device)
        self.t0, self.tn, self.n_steps = t0, tn, n_steps
        self.h = (tn - t0) / n_steps
        self.ts = _linspace(t0, tn, n_steps + 1, self.dtype, self.device)
        self.solution = sol
        self.numerical_solver = numerical_solver
        self.us = torch.stack([_tensor(u, self.dtype, self.device) for u in sol(self.ts)], dim=1)
        self.local_epoch = 0
        self._max_local_epoch = 1

        head, tail = self.us[1:], self.us[:-1]
        step_out = numerical_solver.step(func, list(tail.unbind(1)), self.ts[:-1], self.h)
        if not isinstance(step_out, (list, tuple)):
            step_out = [step_out]
        slopes = torch.stack([_tensor(s, self.dtype, self.device).expand(tail.shape[0]) for s in step_out], dim=1)
        self.residual = (head - tail - self.h * slopes) / self.h ** (numerical_solver.order + 1)

        dim = self.u0.shape[0]
        if net is None:  # with a generator, drawn on the CPU where it lives, then moved
            net = FCNN(n_input_units=dim + 1, n_output_units=dim, hidden_units=(32, 32),
                       device='cpu' if generator is not None else self.device, dtype=self.dtype)
            if generator is not None:
                for lin in net.linears:
                    bound = 1 / math.sqrt(lin.in_features)  # nn.Linear's own bounds
                    for p in (lin.weight, lin.bias):
                        nn.init.uniform_(p, -bound, bound, generator=generator)
        self.net = net.to(device=self.device, dtype=self.dtype)
        if optimizer is None:
            optimizer = torch.optim.Adam(self.net.parameters(), lr=1e-3)
        elif not isinstance(optimizer, torch.optim.Optimizer):
            optimizer = optimizer(self.net.parameters())
        self.optimizer = optimizer

        self.metrics_history = {'train_loss': [], 'valid_loss': []}
        self._inputs = torch.cat([self.ts.reshape(-1, 1), self.us], dim=1)

    def _loss(self):
        # the target of the step t_i -> t_{i+1} against the net at its start
        return ((self.residual - self.net(self._inputs)[:-1]) ** 2).mean()

    def fit(self, max_epochs):
        """Train the corrector for ``max_epochs`` optimizer steps on the whole grid."""
        self._max_local_epoch = max_epochs
        losses = []
        for _ in range(max_epochs):
            self.optimizer.zero_grad(set_to_none=True)
            loss = self._loss()
            loss.backward()
            self.optimizer.step()
            losses.append(loss.detach())
        self.local_epoch += max_epochs
        if losses:
            self.metrics_history['train_loss'].extend(torch.stack(losses).tolist())

    @property
    def global_epoch(self):
        return len(self.metrics_history['train_loss'])

    @torch.no_grad()
    def get_solution(self):
        """Roll out the corrected integrator; returns a :class:`DiscreteSolution1D`."""
        ret = self.numerical_solver.solve(self.func, self.u0, self.t0, self.tn, self.n_steps, hypernet=self.net,
                                          device=self.device, dtype=self.dtype)
        return DiscreteSolution1D(*ret)

    @torch.no_grad()
    def load_jax_params(self, params):
        """Load the JAX package's corrector parameters (its ``params``, a
        pytree of numpy arrays) through the net's ``load_jax_params``."""
        self.net.load_jax_params(params)
        return self

