r"""Callbacks: the training control plane (counterpart of
``neurodiffeq_tpu/callbacks.py``).

``fit`` calls every callback with the solver after each epoch. Action
callbacks do something (stop, report, swap the loss or the optimizer, grow
the batch count); condition callbacks gate an action and combine with
``&`` (and), ``|`` (or), ``~`` (not) and ``^`` (xor).

The port's ``fit`` runs one epoch at a time, so the JAX package's
``next_fire_epoch`` hints (which let it fuse epochs between callback fires
into one device program) have no counterpart. ``MonitorCallback``,
``CheckpointCallback``, ``SimpleTensorboardCallback`` and
``AutoResidualWeightCallback`` are not ported yet (``ROADMAP.md`` §1 item 13a).
"""
import logging
import random
from abc import ABC, abstractmethod

import numpy as np
import torch

from ._version_utils import deprecated_alias, warn_deprecate_class

__all__ = [
    'BaseCallback', 'ActionCallback', 'ConditionCallback',
    'StopCallback', 'ReportCallback', 'EveCallback', 'SetLossFn', 'SetOptimizer', 'ProgressBarCallBack',
    'AndCallback', 'OrCallback', 'NotCallback', 'XorCallback',
    'TrueCallback', 'FalseCallback',
    'OnFirstLocal', 'OnFirstGlobal', 'OnLastLocal',
    'PeriodLocal', 'PeriodGlobal', 'ClosedIntervalLocal', 'ClosedIntervalGlobal',
    'Random', 'RepeatedMetricUp', 'RepeatedMetricDown', 'RepeatedMetricConverge',
    'RepeatedMetricDiverge', 'RepeatedMetricBelow', 'RepeatedMetricAbove',
    'ReportOnFitCallback', 'SetCriterion',
]


class _LoggerMixin:
    r"""Mix-in providing a standard Python ``logger``.

    :param logger: The logger or its name (str). Defaults to the 'root' logger.
    """

    def __init__(self, logger=None):
        if not logger:
            self.logger = logging.getLogger('root')
        elif isinstance(logger, str):
            self.logger = logging.getLogger(logger)
        else:
            self.logger = logger


class BaseCallback(ABC, _LoggerMixin):
    r"""Base class of all callbacks; subclass ``ActionCallback`` or
    ``ConditionCallback`` instead of this."""

    def __init__(self, logger=None):
        _LoggerMixin.__init__(self, logger=logger)

    @abstractmethod
    def __call__(self, solver):
        pass  # pragma: no cover


class ActionCallback(BaseCallback):
    r"""Base class of action callbacks (callbacks that *do* something)."""

    def flush(self):
        """Wait for any asynchronous work this callback started (none here).
        ``fit()`` calls this on every callback before returning."""

    def conditioned_on(self, condition_callback):
        if not isinstance(condition_callback, ConditionCallback):
            raise TypeError(f'{condition_callback} is not an instance of ConditionCallback')
        return condition_callback.set_action_callback(self)


class StopCallback(ActionCallback):
    r"""Stops training, terminating the ``solver.fit()`` call. Use together
    with a ``ConditionCallback`` (otherwise fit exits after the first epoch)."""

    def __call__(self, solver):
        solver._stop_training = True


class ReportCallback(ActionCallback):
    r"""Logs training/validation set sizes and generators."""

    def __call__(self, solver):
        self.logger.info(
            f"Starting from global epoch {solver.global_epoch - 1}\n"
            f"    training with {solver.generator['train']}\n"
            f"    validating with {solver.generator['valid']}"
        )
        tb = solver.generator['train'].size
        ntb = solver.n_batches['train']
        vb = solver.generator['valid'].size
        nvb = solver.n_batches['valid']
        self.logger.info(f"train size = {tb} x {ntb} = {tb * ntb}, valid_size = {vb} x {nvb} = {vb * nvb}")


ReportOnFitCallback = warn_deprecate_class(ReportCallback)


class EveCallback(ActionCallback):
    r"""Geometrically grows ``n_batches['train']`` based on the latest value of
    a metric: :math:`n = \min(n_0 2^k, n_{max})` with
    :math:`k = \max(0, \lfloor \log_p(v/v_0) \rfloor)`."""
    EPS = 1e-4

    def __init__(self, base_value=1.0, double_at=0.1, n_0=1, n_max=None, use_train=True, metric='loss',
                 logger=None):
        super().__init__(logger=logger)
        self.base_value = base_value
        self.double_at = double_at
        self.n_0 = n_0
        self.n_max = n_max or np.inf
        key = 'train' if use_train else 'valid'
        self.key = f'{key}_{metric}'

    def __call__(self, solver):
        value = solver.metrics_history[self.key][-1]
        double_times = int(self.__class__.EPS + (np.log(value) - np.log(self.base_value)) / np.log(self.double_at))
        double_times = max(double_times, 0)
        solver.n_batches['train'] = int(min(self.n_0 * 2 ** double_times, self.n_max))


class SetLossFn(ActionCallback):
    r"""Sets the loss function of the solver (str key or callable); best used
    together with a condition callback.

    :param reset: if True, re-set every time the callback fires; otherwise once.
    """

    @deprecated_alias(criterion='loss_fn')
    def __init__(self, loss_fn, reset=False, logger=None):
        super().__init__(logger=logger)
        self.loss_fn = loss_fn
        self.reset = reset
        self.called = False

    def __call__(self, solver):
        if self.reset or (not self.called):
            self.called = True
            solver._set_loss_fn(self.loss_fn)


SetCriterion = warn_deprecate_class(SetLossFn)


class SetOptimizer(ActionCallback):
    r"""Sets the optimizer of the solver.

    - A ``torch.optim.Optimizer`` instance is used as is.
    - A class (or factory) is called as
      ``optimizer(params, *optimizer_args, **optimizer_kwargs)`` with the
      parameters of the solver's networks.
    """

    def __init__(self, optimizer, optimizer_args=None, optimizer_kwargs=None, reset=False, logger=None):
        super().__init__(logger=logger)
        self.optimizer = optimizer
        self.optimizer_args = optimizer_args or ()
        self.optimizer_kwargs = optimizer_kwargs or {}
        self.reset = reset
        self.called = False

    def __call__(self, solver):
        if self.reset or (not self.called):
            self.called = True
            if isinstance(self.optimizer, torch.optim.Optimizer):
                solver.set_optimizer(self.optimizer)
            elif callable(self.optimizer):
                params = [p for net in solver._unique_nets for p in net.parameters()]
                solver.set_optimizer(self.optimizer(params, *self.optimizer_args, **self.optimizer_kwargs))
            else:
                raise TypeError(f"Unknown optimizer instance/type {self.optimizer}")


class ConditionCallback(BaseCallback):
    r"""Base class of condition callbacks; supports the boolean algebra
    ``&`` (and), ``|`` (or), ``~`` (not), ``^`` (xor)."""

    def __init__(self, logger=None):
        super().__init__(logger=logger)
        self.action_callback = None

    def set_action_callback(self, action_callback):
        if not isinstance(action_callback, ActionCallback):
            raise TypeError(f'{action_callback} is not an instance of ActionCallback')
        self.action_callback = action_callback
        return self

    @abstractmethod
    def condition(self, solver) -> bool:
        pass  # pragma: no cover

    def flush(self):
        """Delegate to the attached action callback."""
        if self.action_callback is not None:
            self.action_callback.flush()

    def __call__(self, solver):
        if self.condition(solver):
            if self.action_callback:
                self.logger.debug(f"condition of {self} met, running the underlying callback "
                                  f"{self.action_callback}")
                self.action_callback(solver)
            else:
                self.logger.warning(f"condition of {self} met, but no underlying action callback is set; skipping")
        else:
            self.logger.debug(f"condition of {self} not met")

    def __and__(self, other):
        return AndCallback(condition_callbacks=[self, other], logger=self.logger)

    def __or__(self, other):
        return OrCallback(condition_callbacks=[self, other], logger=self.logger)

    def __invert__(self):
        return NotCallback(condition_callback=self, logger=self.logger)

    def __xor__(self, other):
        return XorCallback(condition_callbacks=[self, other], logger=self.logger)


class AndCallback(ConditionCallback):
    r"""True iff none of its sub-conditions is False. ``c1 & c2``."""

    def __init__(self, condition_callbacks, logger=None):
        super().__init__(logger=logger)
        self.condition_callbacks = condition_callbacks

    def condition(self, solver) -> bool:
        for cond_cb in self.condition_callbacks:
            if not cond_cb.condition(solver):
                return False
        return True


class OrCallback(ConditionCallback):
    r"""False iff none of its sub-conditions is True. ``c1 | c2``."""

    def __init__(self, condition_callbacks, logger=None):
        super().__init__(logger=logger)
        self.condition_callbacks = condition_callbacks

    def condition(self, solver) -> bool:
        for cond_cb in self.condition_callbacks:
            if cond_cb.condition(solver):
                return True
        return False


class NotCallback(ConditionCallback):
    r"""True iff its sub-condition is False. ``~c1``."""

    def __init__(self, condition_callback, logger=None):
        super().__init__(logger=logger)
        self.condition_callback = condition_callback

    def condition(self, solver) -> bool:
        return not self.condition_callback.condition(solver)


class XorCallback(ConditionCallback):
    r"""False iff evenly many sub-conditions are True. ``c1 ^ c2``."""

    def __init__(self, condition_callbacks, logger=None):
        super().__init__(logger=logger)
        self.condition_callbacks = condition_callbacks

    def condition(self, solver) -> bool:
        return sum(1 for cond_cb in self.condition_callbacks if cond_cb.condition(solver)) % 2 == 1


class TrueCallback(ConditionCallback):
    r"""Always True."""

    def condition(self, solver) -> bool:
        return True


class FalseCallback(ConditionCallback):
    r"""Always False."""

    def condition(self, solver) -> bool:
        return False


class OnFirstLocal(ConditionCallback):
    r"""True only on the first local epoch."""

    def condition(self, solver) -> bool:
        return solver.local_epoch == 1


class OnFirstGlobal(ConditionCallback):
    r"""True only on the first global epoch."""

    def condition(self, solver) -> bool:
        return solver.global_epoch == 1


class OnLastLocal(ConditionCallback):
    r"""True only on the last local epoch."""

    def condition(self, solver) -> bool:
        return solver.local_epoch == solver._max_local_epoch


class PeriodLocal(ConditionCallback):
    r"""True when local epoch == period * n + offset."""

    def __init__(self, period, offset=0, logger=None):
        super().__init__(logger=logger)
        self.period = period
        self.offset = offset % period

    def condition(self, solver) -> bool:
        return solver.local_epoch % self.period == self.offset


class PeriodGlobal(ConditionCallback):
    r"""True when global epoch == period * n + offset."""

    def __init__(self, period, offset=0, logger=None):
        super().__init__(logger=logger)
        self.period = period
        self.offset = offset % period

    def condition(self, solver) -> bool:
        return solver.global_epoch % self.period == self.offset


class ClosedIntervalLocal(ConditionCallback):
    r"""True when min <= local epoch <= max."""

    def __init__(self, min=None, max=None, logger=None):
        super().__init__(logger=logger)
        self.min = -np.inf if min is None else min
        self.max = np.inf if max is None else max

    def condition(self, solver) -> bool:
        return self.min <= solver.local_epoch <= self.max


class ClosedIntervalGlobal(ConditionCallback):
    r"""True when min <= global epoch <= max."""

    def __init__(self, min=None, max=None, logger=None):
        super().__init__(logger=logger)
        self.min = -np.inf if min is None else min
        self.max = np.inf if max is None else max

    def condition(self, solver) -> bool:
        return self.min <= solver.global_epoch <= self.max


class Random(ConditionCallback):
    r"""True with the given probability (drawn from Python's ``random``)."""

    def __init__(self, probability, logger=None):
        super().__init__(logger=logger)
        if probability < 0 or probability > 1:
            raise ValueError('probability must lie in [0, 1]')
        self.probability = probability

    def condition(self, solver) -> bool:
        return random.random() < self.probability


class _RepeatedMetricChange(ConditionCallback):
    def __init__(self, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(logger=logger)
        key = 'train' if use_train else 'valid'
        self.key = f'{key}_{metric}'
        self.times_required = repetition
        self.so_far = 0

    @abstractmethod
    def _last_satisfied(self, last, second2last):
        return last > second2last

    def condition(self, solver) -> bool:
        history = solver.metrics_history[self.key]
        if len(history) >= 2 and self._last_satisfied(last=history[-1], second2last=history[-2]):
            self.so_far += 1
        else:
            self.so_far = 0
        return self.so_far >= self.times_required


class RepeatedMetricUp(_RepeatedMetricChange):
    r"""True if the metric kept increasing by at least some margin for n epochs."""

    def __init__(self, at_least_by=0.0, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.at_least_by = at_least_by

    def _last_satisfied(self, last, second2last):
        return last >= second2last + self.at_least_by


class RepeatedMetricDown(_RepeatedMetricChange):
    r"""True if the metric kept decreasing by at least some margin for n epochs."""

    def __init__(self, at_least_by=0.0, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.at_least_by = at_least_by

    def _last_satisfied(self, last, second2last):
        return last <= second2last - self.at_least_by


class RepeatedMetricConverge(_RepeatedMetricChange):
    r"""True if the metric kept converging within epsilon for n epochs."""

    def __init__(self, epsilon, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.epsilon = abs(epsilon)

    def _last_satisfied(self, last, second2last):
        return abs(last - second2last) < self.epsilon


class RepeatedMetricDiverge(_RepeatedMetricChange):
    r"""True if the metric kept diverging beyond some gap for n epochs."""

    def __init__(self, gap, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.gap = abs(gap)

    def _last_satisfied(self, last, second2last):
        return abs(last - second2last) > self.gap


class RepeatedMetricBelow(_RepeatedMetricChange):
    r"""True if the metric stayed below a threshold for n epochs."""

    def __init__(self, threshold, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.threshold = threshold

    def _last_satisfied(self, last, second2last):
        return last < self.threshold


class RepeatedMetricAbove(_RepeatedMetricChange):
    r"""True if the metric stayed above a threshold for n epochs."""

    def __init__(self, threshold, use_train=True, metric='loss', repetition=1, logger=None):
        super().__init__(use_train=use_train, metric=metric, repetition=repetition, logger=logger)
        self.threshold = threshold

    def _last_satisfied(self, last, second2last):
        return last > self.threshold


class ProgressBarCallBack(ActionCallback):
    r"""Prints a simple textual progress bar."""

    def __call__(self, solver):
        a = solver.local_epoch
        b = solver._max_local_epoch
        progress = int(a / b * 100)
        print('#' * progress + '.' * (100 - progress), end='\r', flush=True)
