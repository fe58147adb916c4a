r"""Training engines (counterpart of ``neurodiffeq_tpu/solvers.py``): the
parts the 2-D Laplace flagship uses.

One training epoch samples ``n_batches_train`` batches, evaluates the
residual through the batched Taylor engine, sums the batches' gradients
(``backward`` accumulates) and takes one optimizer step. One validation
epoch averages the loss over ``n_batches_valid`` batches; it runs under
``torch.no_grad()``, since the residual's derivatives are propagated
forward and need no autograd graph. The parameters with the lowest
validation loss are kept (``best_params``).

The JAX package's compiled-epoch machinery (flat parameter carry,
seed-keyed compile cache, scanned fit chunks, speculative dispatch) has no
counterpart here: PyTorch runs eagerly.
"""
from abc import ABC, abstractmethod
from copy import deepcopy

import numpy as np
import torch

from ._version_utils import deprecated_alias
from .fields import Field, cat as field_cat, coords_from_points
from .generators import Generator2D
from .losses import _losses
from .networks import FCNN, Tanh
from .utils import full_precision_matmuls, get_generator, resolve

__all__ = ['BaseSolver', 'Solver2D', 'BaseSolution', 'Solution2D']


class BaseSolver(ABC):
    r"""A class for solving ODE/PDE systems.

    :param diff_eqs: maps funcs and coordinate Fields to a (list of) residual Field(s).
    :param conditions: list of conditions, one per target function.
    :param nets: list of network modules; defaults to one
        ``FCNN(hidden_units=(32, 32), actv=Tanh)`` per condition. They are
        moved to ``device`` and ``dtype``.
    :param train_generator: generator of training points (required).
    :param valid_generator: generator of validation points (required).
    :param optimizer: a ``torch.optim.Optimizer`` over the nets' parameters;
        defaults to ``torch.optim.Adam(lr=1e-3)``.
    :param loss_fn: key of the loss registry or a callable
        ``(residual_field, funcs, coords) -> scalar``; defaults to ``'l2'``.
    :param n_batches_train: batches per training epoch (gradients are
        summed, one optimizer step per epoch). Defaults to 1.
    :param n_batches_valid: batches per validation epoch. Defaults to 4.
    :param metrics: dict of named metric callables, called with the values
        (tensors) of funcs and coordinates.
    :param n_input_units: inputs per default network.
    :param n_output_units: outputs per default network.
    :param device: device of nets and points (the port's default if None).
    :param dtype: dtype of nets and points (the port's default if None).
    :param generator: ``torch.Generator`` on ``device`` for sampling; defaults
        to the port's global generator for the device.
    """

    @deprecated_alias(criterion='loss_fn')
    def __init__(self, diff_eqs, conditions, nets=None, train_generator=None, valid_generator=None,
                 optimizer=None, loss_fn=None, n_batches_train=1, n_batches_valid=4, metrics=None,
                 n_input_units=None, n_output_units=None, device=None, dtype=None, generator=None):
        self.device, self.dtype = resolve(device, dtype)
        if self.device.type == 'cuda':
            full_precision_matmuls()
        self.diff_eqs = diff_eqs
        self.conditions = conditions
        self.n_funcs = len(conditions)
        if nets is None:
            nets = [FCNN(n_input_units=n_input_units, n_output_units=n_output_units,
                         hidden_units=(32, 32), actv=Tanh, device=self.device, dtype=self.dtype)
                    for _ in range(self.n_funcs)]
        self.nets = [net.to(device=self.device, dtype=self.dtype) for net in nets]
        # one entry per distinct module: a net shared by several conditions
        # is trained (and tracked) once
        self._unique_nets = list({id(n): n for n in self.nets}.values())

        if train_generator is None:
            raise ValueError("train_generator must be specified")
        if valid_generator is None:
            raise ValueError("valid_generator must be specified")
        self.generator = {'train': train_generator, 'valid': valid_generator}
        if n_batches_train < 1 or n_batches_valid < 0:
            raise ValueError(f"need n_batches_train >= 1 and n_batches_valid >= 0, "
                             f"got {n_batches_train} and {n_batches_valid}")
        self.n_batches = {'train': n_batches_train, 'valid': n_batches_valid}
        self.rng = generator if generator is not None else get_generator(self.device)

        params = [p for net in self._unique_nets for p in net.parameters()]
        self.optimizer = optimizer if optimizer is not None else torch.optim.Adam(params, lr=1e-3)
        self._set_loss_fn(loss_fn)

        self.metrics_fn = metrics if metrics else {}
        self.metrics_history = {'train_loss': [], 'valid_loss': []}
        self.metrics_history.update({'train__' + name: [] for name in self.metrics_fn})
        self.metrics_history.update({'valid__' + name: [] for name in self.metrics_fn})

        self.best_params = None
        self.lowest_loss = None
        self.local_epoch = 0
        self._max_local_epoch = 0
        self._stop_training = False

    def _set_loss_fn(self, criterion):
        if criterion is None:
            self.loss_fn = _losses['l2']
        elif isinstance(criterion, str):
            self.loss_fn = _losses[criterion.lower()]
        elif callable(criterion):
            self.loss_fn = criterion
        else:
            raise TypeError(f"Unknown type of criterion {type(criterion)}")

    @property
    def global_epoch(self):
        return len(self.metrics_history['train_loss'])

    # -------------------------------------------------------------- the loss
    def compute_func_val(self, net, cond, *coordinates):
        r"""Enforce the condition on the network over the coordinates -> Field."""
        return cond.enforce(net, *coordinates)

    def _forward(self, cols, nets=None):
        """Sampled columns -> (funcs, coord_fields); shared by loss and residuals."""
        points = torch.cat([c.reshape(-1, 1) for c in cols], dim=1)
        coord_fields = coords_from_points(points)
        funcs = [self.compute_func_val(net, cond, *coord_fields)
                 for net, cond in zip(nets or self.nets, self.conditions)]
        return funcs, coord_fields

    def _residuals(self, funcs, coord_fields):
        residuals = self.diff_eqs(*funcs, *coord_fields)
        if isinstance(residuals, Field):
            residuals = [residuals]
        return field_cat(residuals)

    def _loss_and_metrics(self, cols):
        """Enforce, residuals, loss + additional loss, metrics."""
        funcs, coord_fields = self._forward(cols)
        residual = self._residuals(funcs, coord_fields)
        loss = self.loss_fn(residual, funcs, coord_fields)
        loss = loss + self.additional_loss(residual, funcs, coord_fields)
        metrics = {name: torch.as_tensor(fn(*[f.value for f in funcs], *[c.value for c in coord_fields]))
                   for name, fn in self.metrics_fn.items()}
        return loss, metrics

    def additional_loss(self, residual, funcs, coords):
        r"""Additional loss terms; override in subclasses. Must return a scalar."""
        return 0.0

    def _generate_batch(self, phase):
        return [c.reshape(-1, 1) for c in self.generator[phase].sample(self.rng)]

    # ---------------------------------------------------------------- epochs
    def _run_epoch(self, phase):
        """One epoch of ``phase``; returns the mean loss and metrics as tensors."""
        n_batches = self.n_batches[phase]
        train = phase == 'train'
        if train:
            self.optimizer.zero_grad(set_to_none=True)
        total, metric_sums = 0.0, {name: 0.0 for name in self.metrics_fn}
        with torch.set_grad_enabled(train):
            for _ in range(n_batches):
                loss, metrics = self._loss_and_metrics(self._generate_batch(phase))
                if train:
                    loss.backward()
                total = total + loss.detach()
                for name in self.metrics_fn:
                    metric_sums[name] = metric_sums[name] + metrics[name].detach()
        if train:
            self.optimizer.step()
        return total / n_batches, {k: v / n_batches for k, v in metric_sums.items()}

    def _record(self, phase, loss, metrics):
        self.metrics_history[f'{phase}_loss'].append(loss)
        for name, v in metrics.items():
            self.metrics_history[f'{phase}__{name}'].append(v)

    def _update_best(self, phase):
        current = self.metrics_history[phase + '_loss'][-1]
        if self.lowest_loss is None or current < self.lowest_loss:
            self.lowest_loss = current
            self.best_params = [{k: v.detach().clone() for k, v in net.state_dict().items()}
                                for net in self._unique_nets]

    def run_train_epoch(self):
        r"""Run a training epoch, update history, and take an optimizer step."""
        self.run_epochs(valid=False)

    def run_valid_epoch(self):
        r"""Run a validation epoch, update history and the best parameters."""
        loss, metrics = self._run_epoch('valid')
        self._record('valid', float(loss), {k: float(v) for k, v in metrics.items()})
        self._update_best('valid')

    def run_epochs(self, valid=True):
        """One training epoch and, if ``valid`` and there are validation
        batches, one validation epoch, with one device-to-host read."""
        has_valid = valid and self.n_batches['valid'] > 0
        out = [self._run_epoch('train')] + ([self._run_epoch('valid')] if has_valid else [])
        names = list(self.metrics_fn)
        flat = torch.stack([torch.as_tensor(x, dtype=torch.float64, device=self.device)
                            for loss, m in out for x in [loss, *[m[k] for k in names]]])
        values = flat.tolist()
        per_phase = len(names) + 1
        for phase, i in zip(('train', 'valid'), range(0, len(values), per_phase)):
            self._record(phase, values[i], dict(zip(names, values[i + 1:i + per_phase])))
        if has_valid:
            self._update_best('valid')
        elif self.n_batches['valid'] == 0:
            self._update_best('train')

    def fit(self, max_epochs):
        r"""Run ``max_epochs`` epochs of training and validation, tracking the
        best parameters. (Callbacks are not ported yet.)"""
        self._stop_training = False
        self._max_local_epoch = max_epochs
        self.local_epoch = 0
        while self.local_epoch < max_epochs and not self._stop_training:
            self.local_epoch += 1
            self.run_epochs()

    # ------------------------------------------------------------ inspection
    def _nets_for(self, best, copy_nets=True):
        """The nets, copied and loaded with the lowest-loss parameters if ``best``."""
        if best and self.best_params is None:
            raise RuntimeError("The best parameters are not available; check if you disabled "
                               "validation and used best=True")
        if not (best or copy_nets):
            return self.nets
        nets = deepcopy(self.nets)  # one deepcopy keeps shared nets shared
        if best:
            unique = list({id(n): n for n in nets}.values())
            for net, state in zip(unique, self.best_params):
                net.load_state_dict(state)
        return nets

    @abstractmethod
    def get_solution(self, copy=True, best=True):
        r"""Get a (callable) solution object."""

    def _as_cols(self, coords):
        coords = [torch.as_tensor(np.asarray(c) if not torch.is_tensor(c) else c,
                                  dtype=self.dtype, device=self.device) for c in coords]
        return coords[0].shape, [c.reshape(-1, 1) for c in coords]

    def get_residuals(self, *coords, to_numpy=False, best=True, no_reshape=False):
        r"""Evaluate the residuals of the differential equation at given points.

        :param coords: coordinate arrays (numpy or torch), any (equal) shape.
        :param to_numpy: return numpy arrays instead of tensors.
        :param best: use the lowest-loss parameters. Defaults to True.
        :param no_reshape: skip reshaping output back to the input shape.
        """
        shape, cols = self._as_cols(coords)
        with torch.no_grad():
            funcs, coord_fields = self._forward(cols, nets=self._nets_for(best))
            residuals = self.diff_eqs(*funcs, *coord_fields)
            if isinstance(residuals, Field):
                residuals = [residuals]
            values = [r.value for r in residuals]
        if not no_reshape:
            values = [v.reshape(shape) for v in values]
        if to_numpy:
            values = [v.cpu().numpy() for v in values]
        return values if len(values) > 1 else values[0]


class BaseSolution(ABC):
    r"""A callable solution to a PDE/ODE (system).

    :param nets: list of network modules (or one module shared by all conditions).
    :param conditions: list of conditions enforced on the solution.
    """

    def __init__(self, nets, conditions):
        if not isinstance(nets, (list, tuple)):
            nets = [nets] * len(conditions)
        self.nets = list(nets)
        self.conditions = list(conditions)
        p = next(self.nets[0].parameters())
        self.device, self.dtype = p.device, p.dtype

    @abstractmethod
    def _compute_u(self, net, condition, *coord_fields):
        pass  # pragma: no cover

    @deprecated_alias(as_type='to_numpy')
    def __call__(self, *coords, to_numpy=False, no_reshape=False):
        r"""Evaluate the solution at given points.

        :param coords: coordinate arrays (numpy or torch), equal shapes.
        :param to_numpy: return ``numpy.ndarray`` instead of tensors.
        :param no_reshape: skip reshaping output back to the input shape.
        """
        coords = [torch.as_tensor(np.asarray(c) if not torch.is_tensor(c) else c,
                                  dtype=self.dtype, device=self.device) for c in coords]
        shape = coords[0].shape
        points = torch.cat([c.reshape(-1, 1) for c in coords], dim=1)
        with torch.no_grad():
            coord_fields = coords_from_points(points)
            us = [self._compute_u(net, cond, *coord_fields).value
                  for net, cond in zip(self.nets, self.conditions)]
        if not no_reshape:
            us = [u.reshape(shape) for u in us]
        if to_numpy:
            us = [u.cpu().numpy() for u in us]
        return us if len(self.nets) > 1 else us[0]


class Solution2D(BaseSolution):
    def _compute_u(self, net, condition, xs, ys):
        return condition.enforce(net, xs, ys)


class Solver2D(BaseSolver):
    r"""A solver for PDEs in 2 dimensions.

    :param pde_system: maps funcs and (x, y) coordinates to residuals.
    :param conditions: list of conditions, one per target function.
    :param xy_min: lower bounds ``(x_0, y_0)`` (ignored if both generators given).
    :param xy_max: upper bounds ``(x_1, y_1)``.
    """

    def __init__(self, pde_system, conditions, xy_min=None, xy_max=None, nets=None,
                 train_generator=None, valid_generator=None, optimizer=None, loss_fn=None,
                 n_batches_train=1, n_batches_valid=4, metrics=None, n_output_units=1,
                 device=None, dtype=None, generator=None):
        if train_generator is None or valid_generator is None:
            if xy_min is None or xy_max is None:
                raise ValueError(
                    f"Either generator is not provided, xy_min and xy_max should be both provided: \n"
                    f"got xy_min={xy_min}, xy_max={xy_max}, "
                    f"train_generator={train_generator}, valid_generator={valid_generator}")
        device, dtype = resolve(device, dtype)
        if train_generator is None:
            train_generator = Generator2D((32, 32), xy_min=xy_min, xy_max=xy_max,
                                          method='equally-spaced-noisy', device=device, dtype=dtype)
        if valid_generator is None:
            valid_generator = Generator2D((32, 32), xy_min=xy_min, xy_max=xy_max,
                                          method='equally-spaced', device=device, dtype=dtype)
        self.xy_min, self.xy_max = xy_min, xy_max
        super().__init__(
            diff_eqs=pde_system, conditions=conditions, nets=nets,
            train_generator=train_generator, valid_generator=valid_generator,
            optimizer=optimizer, loss_fn=loss_fn, n_batches_train=n_batches_train,
            n_batches_valid=n_batches_valid, metrics=metrics, n_input_units=2,
            n_output_units=n_output_units, device=device, dtype=dtype, generator=generator)

    def get_solution(self, copy=True, best=True):
        r"""A callable solution evaluated as ``solution(xs, ys)``.

        :param copy: copy the networks, so that later training does not
            change the solution. Defaults to True.
        :param best: use the lowest-loss parameters. Defaults to True.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        return Solution2D(self._nets_for(best, copy_nets=copy), conditions)

