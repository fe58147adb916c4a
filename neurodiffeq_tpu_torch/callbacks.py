r"""Callbacks: the training control plane (counterpart of
``neurodiffeq_tpu/callbacks.py``).

``fit`` calls every callback with the solver after each epoch. Action
callbacks do something (stop, report, swap the loss or the optimizer, grow
the batch count); condition callbacks gate an action and combine with
``&`` (and), ``|`` (or), ``~`` (not) and ``^`` (xor).

The port's ``fit`` runs one epoch at a time, so the JAX package's
``next_fire_epoch`` hints (which let it fuse epochs between callback fires
into one device program) have no counterpart. Checkpoints come in two
formats: ``'internals'`` (dill, as in the JAX package) and ``'state_dict'``
(``torch.save`` of the solver's tensor part, where the JAX package writes
orbax). matplotlib, dill and tensorboard are imported at first use.

Under a mesh every rank calls the callbacks with the same global histories;
the ones that write (monitors, checkpoints, TensorBoard) write from rank 0
only, and ``AutoResidualWeightCallback`` sums its gradients over the ranks,
so that every rank gets the unsharded run's weights. Under a ``'model'``
axis a monitor or a checkpoint reads the parameters on every rank (each
rank stores its blocks of the split leaves, and reading gathers them),
then rank 0 writes.
"""
import json
import logging
import math
import os
import random
import warnings
from abc import ABC, abstractmethod
from datetime import datetime

import numpy as np
import torch

from ._version_utils import deprecated_alias, warn_deprecate_class
from .utils import safe_mkdir as _safe_mkdir

__all__ = [
    'BaseCallback', 'ActionCallback', 'ConditionCallback',
    'MonitorCallback', 'StopCallback', 'CheckpointCallback', 'ReportCallback',
    'EveCallback', 'AutoResidualWeightCallback', 'SimpleTensorboardCallback',
    'SetLossFn', 'SetOptimizer', 'ProgressBarCallBack',
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


def _other_rank():
    """Whether this process is a rank other than 0 of a process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized() and dist.get_rank() != 0


def _writes(solver):
    """Whether this process writes for ``solver``: always without a mesh,
    on rank 0 under one."""
    mesh = getattr(solver, 'mesh', None)
    return mesh is None or mesh.get_rank() == 0


def _gathers(solver):
    """Whether reading ``solver``'s parameters is a collective, which every
    rank must join (the solver's ``_reads_collective``)."""
    return getattr(solver, '_reads_collective', False)


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


class MonitorCallback(ActionCallback):
    r"""Updates monitor plots (and optionally saves figures to disk).

    :param monitor: The underlying monitor responsible for plotting solutions.
    :param fig_dir: Directory for saving monitor figs; not saved if omitted.
    :param format: Figure format ('png' default).
    :param background: If True, draw on a worker thread instead of stalling
        training. The nets are live modules that the next optimizer step
        changes, so the worker gets frozen copies of them and of the
        histories, taken when the callback fires. At most one draw is in
        flight; fires arriving while the worker is busy are skipped, except
        the final local epoch, which joins and draws synchronously. A GUI
        matplotlib backend draws synchronously (with a warning). Default
        False: the draw completes before training resumes.
    """

    def __init__(self, monitor, fig_dir=None, format=None, logger=None, background=False, **kwargs):
        super().__init__(logger=logger)
        self.monitor = monitor
        self.fig_dir = fig_dir
        self.format = format or 'png'
        self.background = background
        self._worker = None
        self._warned_gui_backend = False

        for kw in ['check_against_local', 'check_against']:
            if kwargs.pop(kw, None) is not None:
                warnings.warn(f'`Passing {kw}` is deprecated and ignored, use a `PeriodLocal` or `PeriodGlobal` to '
                              f'control how frequently the callback is run', FutureWarning)
        if kwargs.pop('repaint_last', None) is not None:
            warnings.warn('Passing repaint_last is deprecated and ignored, Use a `OnLastLocal` callback to plot on '
                          'last epoch', FutureWarning)
        if kwargs:
            raise ValueError(f'Unknown keyword argument(s): {list(kwargs.keys())}')
        if fig_dir:
            _safe_mkdir(fig_dir)

    def __call__(self, solver):
        # under a model axis every rank gathers the nets' copies, and rank 0 draws them
        copies = solver._nets_for(best=False) if _gathers(solver) else None
        if not _writes(solver):
            return
        is_last = solver.local_epoch >= getattr(solver, '_max_local_epoch', 0)
        background = self.background and not is_last
        if background and not getattr(self.monitor, 'using_non_gui_backend', False):
            if not self._warned_gui_backend:
                warnings.warn('MonitorCallback(background=True) requires a non-GUI matplotlib backend (e.g. Agg); '
                              'drawing synchronously.')
                self._warned_gui_backend = True
            background = False
        global_epoch = solver.global_epoch
        if background:
            if self._worker is not None and self._worker.is_alive():
                return  # the previous draw is still rendering: the live plot lags
            import copy
            # the worker never sees live training state: frozen copies of the
            # nets (one deepcopy keeps a shared net shared) and of the histories
            nets = copies if copies is not None else solver._nets_for(best=False)
            history = {k: list(v) for k, v in solver.metrics_history.items()}
            monitor_solver = copy.copy(solver)
            monitor_solver.nets = nets
            monitor_solver.metrics_history = history
        else:
            nets = copies if copies is not None else solver.nets
            history, monitor_solver = solver.metrics_history, solver
        conditions = solver.conditions

        def draw():
            self.monitor.check(nets, conditions, history=history, solver=monitor_solver)
            if self.fig_dir:
                pic_path = os.path.join(self.fig_dir, f"epoch-{global_epoch}.{self.format}")
                self.monitor.fig.savefig(pic_path, bbox_inches='tight')
                self.logger.info(f'plot saved to {pic_path}')

        if not background:
            self.flush()
            draw()
            return
        import threading
        self._worker = threading.Thread(target=draw, daemon=True)
        self._worker.start()

    def flush(self):
        """Wait for any in-flight background draw to finish."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None


class StopCallback(ActionCallback):
    r"""Stops training, terminating the ``solver.fit()`` call. Use together
    with a ``ConditionCallback`` (otherwise fit exits after the first epoch)."""

    def __call__(self, solver):
        solver._stop_training = True


def _numpy_tree(tree):
    """``tree`` with every tensor made a numpy array."""
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return type(tree)((k, _numpy_tree(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return tree


class CheckpointCallback(ActionCallback):
    r"""Saves solver state to ``ckpt_dir`` at each call.

    :param format: 'internals' (default; a timestamped dill dump of
        ``solver.get_internals('all')`` with the parameters as numpy arrays
        and the optimizer as its class name and numpy state dict)
        or 'state_dict' (``step_<global_epoch>.pt``, the ``torch.save`` of
        the solver's tensor part that :meth:`~neurodiffeq_tpu_torch.solvers.BaseSolver.save`
        writes, beside a ``step_<global_epoch>.meta.json`` of the global
        epoch, the lowest loss and the histories; :meth:`restore` reads it).
        The JAX package's 'orbax' is 'state_dict' here.
    """

    def __init__(self, ckpt_dir, logger=None, format='internals'):
        super().__init__(logger=logger)
        if format == 'orbax':
            raise ValueError("format='orbax' is the JAX package's; use format='state_dict' here")
        if format not in ('internals', 'state_dict'):
            raise ValueError(f"Unknown checkpoint format {format}")
        self.ckpt_dir = ckpt_dir
        self.format = format
        _safe_mkdir(ckpt_dir)

    def __call__(self, solver):
        if not (_writes(solver) or _gathers(solver)):  # under a model axis every rank gathers, rank 0 writes
            return
        if self.format == 'state_dict':
            return self._save_state_dict(solver)
        from .solvers_utils import _optimizer_state

        internals = dict(solver.get_internals("all"))
        for key in ('params', 'best_params'):
            internals[key] = _numpy_tree(internals.get(key))
        # a torch optimizer does not pickle: its class and state as data
        internals['optimizer'] = {'type': type(solver.optimizer).__name__,
                                  'state_dict': _numpy_tree(_optimizer_state(solver)['state_dict'])}
        if not _writes(solver):
            return
        import dill

        fname = os.path.join(self.ckpt_dir, datetime.now().strftime("%Y-%m-%d_%H-%M-%S") + ".internals")
        with open(fname, 'wb') as f:
            dill.dump(internals, f)
        self.logger.info(f"Saved checkpoint to {fname} at local epoch = {solver.local_epoch} "
                         f"(global epoch = {solver.global_epoch})")

    def _save_state_dict(self, solver):
        from .solvers_utils import _state

        step = solver.global_epoch
        path = os.path.join(self.ckpt_dir, f"step_{step}.pt")
        state = _state(solver)
        if not _writes(solver):
            return
        torch.save(state, path)
        meta = {'global_epoch': step, 'lowest_loss': solver.lowest_loss, 'metrics_history': solver.metrics_history}
        with open(os.path.join(self.ckpt_dir, f"step_{step}.meta.json"), 'w') as f:
            json.dump(meta, f)
        self.logger.info(f"Saved checkpoint to {path}")

    @staticmethod
    def restore(solver, ckpt_dir, step):
        """Load the checkpoint of global epoch ``step`` (format
        'state_dict') into ``solver``, a solver built like the saved one:
        its nets' and best parameters, its optimizer and the state of its
        sampling generator, and the histories and lowest loss of the
        ``.meta.json`` sidecar."""
        from .solvers_utils import _restore, _restore_optimizer

        state = torch.load(os.path.join(ckpt_dir, f"step_{step}.pt"), weights_only=True, map_location=solver.device)
        _restore(solver, state)
        _restore_optimizer(solver, state['optimizer'], type(solver.optimizer))
        meta_path = os.path.join(ckpt_dir, f"step_{step}.meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            solver.metrics_history = meta['metrics_history']
            solver.lowest_loss = meta['lowest_loss']
        return solver


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


class AutoResidualWeightCallback(ActionCallback):
    r"""Adapts per-equation ``residual_weights`` toward balanced gradient
    contributions.

    Every fire it measures the parameter-gradient norm :math:`g_k =
    \|\nabla_\theta\,\mathrm{mean}(r_k^2)\|_2` of each equation's unweighted
    loss term on a fresh batch of the train generator (drawn with the
    solver's generator, through the solver's ``_forward``, so the network
    passes are the training path's), and moves the weights toward the
    balanced target :math:`w_k \propto \max_j g_j / g_k` (the multi-equation
    analog of the learning-rate annealing of Wang, Teng & Perdikaris, SIAM
    J. Sci. Comput. 2021). Undamped, that prescription starves the stiff
    equation (``benchmarks/balancing_ab.py``), so the update is a log-space
    step of size ``rate`` toward the target, each factor clipped to
    ``[1/clip, clip]`` per fire, the weights renormalized to ``max(w) = 1``
    and floored at ``min_weight``. Updates freeze once the weights stop
    moving (``freeze_tol`` relative change for ``freeze_patience``
    consecutive fires). Compose with e.g. ``OnFirstLocal() | PeriodLocal(500)``.

    :param rate: log-space step size toward the balanced target (0 < rate <= 1).
    :param clip: max multiplicative weight change per fire (> 1).
    :param min_weight: lower floor on normalized weights.
    :param freeze_tol: relative weight change below which a fire counts as converged.
    :param freeze_patience: consecutive converged fires before updates stop.
    """

    def __init__(self, rate=0.3, clip=2.0, min_weight=1e-4, freeze_tol=0.05, freeze_patience=2, logger=None):
        super().__init__(logger=logger)
        if not 0 < rate <= 1:
            raise ValueError(f'rate must be in (0, 1], got {rate}')
        if clip <= 1:
            raise ValueError(f'clip must be > 1, got {clip}')
        if min_weight <= 0:
            raise ValueError(f'min_weight must be positive, got {min_weight}')
        self.rate = rate
        self.clip = clip
        self.min_weight = min_weight
        self.freeze_tol = freeze_tol
        self.freeze_patience = freeze_patience
        self.weight_history = []  # (local_epoch, grad_norms, weights) per fire
        self.frozen = False
        self._still_fires = 0

    @staticmethod
    def _grad_norms(solver, cols):
        """The L2 norm over the solver's parameters of the gradient of each
        equation's mean squared unweighted residual on ``cols``: one forward,
        one ``torch.autograd.grad`` per equation. Under a mesh each rank
        differentiates its block's share of each term, and the gradients are
        summed over the ``'points'`` axis (one ``all_reduce``) before the
        norms. Under a ``'model'`` axis a rank holds its blocks of the split
        leaves and the same gradient of every replicated leaf as the rest of
        its model group: the squared norms of its blocks, and on model index
        0 those of the replicated leaves, are summed over the model group
        (one more; :func:`~neurodiffeq_tpu_torch.parallel.sharding.squared_norms`)."""
        from .parallel.sharding import all_reduce_, mesh_axes, squared_norms
        params = solver._parameters()
        with torch.enable_grad(), solver._eval_scope():
            funcs, coords = solver._forward(cols)
            res = solver._residuals(funcs, coords, weighted=False).value
            shard = coords[0].coords.shard
            coords[0].coords.release()
            norms, flat = [], []
            for k in range(res.shape[1]):
                term = (res[:, k] ** 2).mean()
                grads = torch.autograd.grad(term if shard is None else shard.weight * term, params,
                                            retain_graph=k + 1 < res.shape[1], allow_unused=True)
                if shard is None:
                    norms.append(torch.sqrt(sum((g * g).sum() for g in grads if g is not None)))
                else:
                    flat.append(torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1)
                                           for g, p in zip(grads, params)]))
        if shard is not None:
            summed = all_reduce_(torch.stack(flat), mesh_axes(solver.mesh).points.get_group())
            norms = list(torch.sqrt(squared_norms(summed, params, solver._unique_nets, solver.mesh)))
        return np.asarray(torch.stack(norms).tolist(), dtype=float)

    def __call__(self, solver):
        if self.frozen:
            return
        from .generators import _as_tuple

        cols = [c.reshape(-1, 1) for c in _as_tuple(solver.generator['train'].sample(solver.rng))]
        g = self._grad_norms(solver, cols)
        if len(g) < 2:
            warnings.warn('AutoResidualWeightCallback: the system has a single equation; there is nothing to '
                          'balance. Freezing.')
            self.frozen = True
            return
        target = g.max() / np.maximum(g, 1e-30)
        cur = np.asarray(solver.residual_weights or [1.0] * len(g), dtype=float)
        if len(cur) != len(g):
            raise ValueError(f'residual_weights has {len(cur)} entries but the system produced {len(g)} residuals')
        step = np.exp(self.rate * np.log(np.maximum(target, 1e-30) / cur))
        w = cur * np.clip(step, 1.0 / self.clip, self.clip)
        w = np.maximum(w / w.max(), self.min_weight)
        self.weight_history.append((solver.local_epoch, [float(x) for x in g], [float(x) for x in w]))
        rel = float(np.abs(np.log(w / cur)).max())
        if rel < math.log1p(self.freeze_tol):
            self._still_fires += 1
            if self._still_fires >= self.freeze_patience:
                self.frozen = True
                self.logger.info(f'residual weights converged at {list(w)}; freezing')
        else:
            self._still_fires = 0
        if rel > 1e-3:
            solver.residual_weights = [float(x) for x in w]


class SimpleTensorboardCallback(ActionCallback):
    r"""Writes every metric's latest value per epoch for TensorBoard. Any
    writer with ``add_scalar(tag, scalar_value, global_step)`` works; the
    default, torch's ``SummaryWriter``, needs the tensorboard package and is
    imported only when no writer is given."""

    def __init__(self, writer=None, logger=None):
        super().__init__(logger=logger)
        if writer:
            self.writer = writer
            return
        try:
            from torch.utils.tensorboard import SummaryWriter  # noqa: F401 -- made by _make_writer
        except ImportError as e:  # pragma: no cover
            raise ImportError(f"TensorBoard doesn't seem to be installed. See the following\n{e}")
        # a rank other than 0 of a process group makes its writer only if it
        # writes (a solver without a mesh): one event file under a mesh
        self.writer = None if _other_rank() else self._make_writer()

    def _make_writer(self):
        from torch.utils.tensorboard import SummaryWriter
        self.logger.info('No writer specified, creating a SummaryWriter automatically.')
        return SummaryWriter()

    def __call__(self, solver):
        if not _writes(solver):
            return
        if self.writer is None:
            self.writer = self._make_writer()
        for name, values in solver.metrics_history.items():
            self.writer.add_scalar(tag=name, scalar_value=values[-1] if values else np.nan,
                                   global_step=solver.global_epoch)


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

    Either goes through ``solver.set_optimizer``: on a ``'model'`` mesh the
    parameters are this rank's blocks, and ``torch.optim.LBFGS``,
    ``Adafactor`` and ``Muon`` step there as they step unsharded
    (:func:`~neurodiffeq_tpu_torch.parallel.optim.on_model_axis`).
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
                params = solver._parameters()
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
