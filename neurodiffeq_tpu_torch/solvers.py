r"""Training engines (counterpart of ``neurodiffeq_tpu/solvers.py``):
``Solver1D`` for ODE systems, ``BundleSolver1D`` for ODE solution bundles
over equation and condition parameters, ``Solver2D`` for 2-D PDEs,
``SolverSpherical`` for PDEs in spherical coordinates and the
dimension-agnostic ``GenericSolver``.

One training epoch samples ``n_batches_train`` batches, evaluates the
residual through the batched Taylor engine, sums the batches' gradients
(``backward`` accumulates) and takes one optimizer step. A closure-style
optimizer (``torch.optim.LBFGS``: its ``step`` takes a ``closure`` with no
default) takes one step per batch instead. One validation epoch averages
the loss over ``n_batches_valid`` batches; it runs under
``torch.no_grad()``, since the residual's derivatives are propagated
forward and need no autograd graph. The parameters with the lowest
validation loss are kept (``best_params``). ``fit`` runs one epoch at a
time and calls its callbacks after each.

The JAX package's compiled-epoch machinery (flat parameter carry,
seed-keyed compile cache, scanned fit chunks, speculative dispatch) has no
counterpart here: PyTorch runs eagerly, so a generator whose batches change
size (``FilterGenerator``, ``BatchGenerator``) trains through the same
``fit``, and ``fit(pipeline=...)`` is accepted and changes nothing.
``fit(profile_dir=...)`` traces the run with ``torch.profiler``, with the
solver loop's spans (:mod:`~neurodiffeq_tpu_torch.tracing`) beside the
kernels.

Every solver takes ``mesh=`` (:func:`~neurodiffeq_tpu_torch.parallel.make_mesh`):
one process per rank, all drawing the same global batch from one generator
state (broadcast from rank 0 with the parameters when the solver is built),
each evaluating its own block of rows. The loss is combined as the global
one (each loss's ``shard_form``), metrics see the gathered batch, the
gradients are summed over the ranks in one ``all_reduce`` per optimizer
step (and per closure call), and the epoch's records in one more: every
rank then holds the unsharded run's losses, metrics and parameters. On a
``(points, model)`` mesh the rows are blocks of the ``'points'`` axis, and
the model ranks of a block evaluate their slices of every FCNN and SIREN
layer pair (:class:`~neurodiffeq_tpu_torch.parallel.sharding.ModelSplit`).
There each rank stores only its blocks of the split leaves, as the JAX
package does (:func:`~neurodiffeq_tpu_torch.parallel.sharding.device_put_params`),
and so do the gradients, the optimizer state and ``best_params``; its model
group computes the same gradient for every replicated leaf, so the
gradients are summed over the ``'points'`` axis alone (on a ``(1, m)`` mesh
not at all). What a solver hands out (solutions, ``best_nets``,
``get_internals``, saved files, checkpoints) is full-size, gathered on every
rank: under a model axis every rank calls those readers alike. Solvers
save, load and resume through
:class:`~neurodiffeq_tpu_torch.solvers_utils.PretrainedSolver`; a solution
exports its evaluator as a ``torch.export`` program
(:meth:`BaseSolution.export`, :func:`load_exported_solution`).
"""
import inspect
import io
import json
import sys
import warnings
from abc import ABC, abstractmethod
from contextlib import contextmanager, nullcontext
from copy import deepcopy

import numpy as np
import torch

from ._version_utils import deprecated_alias
from .conditions import BaseCondition
from . import fields
from .fields import Field, cat as field_cat, coords_from_points
from .generators import Generator1D, Generator2D, GeneratorSpherical, _as_tuple, contains_buried_adaptive
from .losses import _losses
from .networks import FCNN, Tanh
from .parallel.optim import on_model_axis
from .parallel.sharding import (ModelSplit, RowShard, all_reduce_, broadcast_, device_put_params, full_state,
                                mesh_axes, net_parameters, placed_state, plain_copies, shard_params, split_scope,
                                stored_blocks, world_group, _check_mesh)
from .solvers_utils import PretrainedSolver
from .tracing import span
from .utils import full_precision_matmuls, get_generator, resolve

try:  # tqdm is optional at run time
    from tqdm.auto import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

__all__ = ['BaseSolver', 'GenericSolver', 'Solver1D', 'BundleSolver1D', 'Solver2D', 'SolverSpherical',
           'BaseSolution', 'GenericSolution', 'Solution1D', 'BundleSolution1D', 'Solution2D', 'SolutionSpherical',
           'SolutionSphericalHarmonics', 'load_exported_solution']


def _warn_if_buried(generator):
    if contains_buried_adaptive(generator):
        warnings.warn(
            "A ResidualAdaptiveGenerator is nested inside a combinator "
            "(e.g. Concat/Ensemble/Mesh/Transform); only the OUTERMOST "
            "train generator's adaptive selection is honored, so this "
            "solver will train WITHOUT adaptive sampling. Wrap the whole "
            "combined generator instead: ResidualAdaptiveGenerator(g1 + g2).")


def _requires_closure(optimizer):
    """Whether ``optimizer.step`` needs a closure: a ``closure`` parameter
    with no default, as in ``torch.optim.LBFGS`` (the upstream reference's
    test)."""
    p = inspect.signature(optimizer.step).parameters.get('closure')
    return p is not None and p.default is inspect.Parameter.empty


def _shard_form(fn, name):
    """``fn``'s declared ``shard_form`` ('mean' or 'global'); raises under a
    mesh for a term that declares neither, which would be silently wrong."""
    form = getattr(fn, 'shard_form', None)
    if form not in ('mean', 'global'):
        raise ValueError(f"{name} declares no shard_form: under a mesh set its attribute shard_form = 'mean' "
                         f"(a mean over the points, or independent of them) or 'global' (it takes the gathered "
                         f"batch)")
    return form


class BaseSolver(ABC, PretrainedSolver):
    r"""A class for solving ODE/PDE systems.

    :param diff_eqs: maps funcs and coordinate Fields to a (list of) residual Field(s).
    :param conditions: list of conditions, one per target function.
    :param nets: list of network modules; defaults to one
        ``FCNN(hidden_units=(32, 32), actv=Tanh)`` per condition. They are
        moved to ``device`` and ``dtype``. A module listed more than once is
        one set of parameters.
    :param train_generator: generator of training points (required).
    :param valid_generator: generator of validation points (required).
    :param analytic_solutions: **[DEPRECATED]** use ``metrics`` instead.
    :param optimizer: a ``torch.optim.Optimizer`` over the nets' parameters;
        defaults to ``torch.optim.Adam(lr=1e-3)``. Closure-style optimizers
        (``torch.optim.LBFGS``) are detected and stepped once per batch.
    :param loss_fn: key of the loss registry or a callable
        ``(residual_field, funcs, coords) -> scalar``; defaults to ``'l2'``.
    :param n_batches_train: batches per training epoch (gradients are
        summed, one optimizer step per epoch). Defaults to 1.
    :param n_batches_valid: batches per validation epoch. Defaults to 4.
    :param metrics: dict of named metric callables, called with the values
        (tensors) of funcs and coordinates.
    :param n_input_units: inputs per default network.
    :param n_output_units: outputs per default network.
    :param residual_weights: None, or one positive weight per equation:
        equation k's residual is scaled by ``w_k ** (1 / p)`` in the
        training loss, where ``p`` is the loss's ``residual_power``
        (default 2), so that the loss weighs it by ``w_k``.
    :param device: device of nets and points (the port's default if None).
    :param dtype: dtype of nets and points (the port's default if None).
    :param generator: ``torch.Generator`` on ``device`` for sampling; defaults
        to the port's global generator for the device.
    :param shuffle: **[DEPRECATED]** ignored; generators shuffle.
    :param batch_size: **[DEPRECATED]** ignored; use ``n_batches_train`` and
        ``n_batches_valid``.
    :param eval_mode: None, or 'taylor' or 'compose': the Field evaluation
        strategy (:func:`~neurodiffeq_tpu_torch.fields.eval_mode`) under
        which the loss and the adaptive-sampling scores are computed.
    :param mesh: None, or a mesh over the points, or over ``(points,
        model)`` (:func:`~neurodiffeq_tpu_torch.parallel.make_mesh`): this
        rank trains on its block of each batch's rows (and its slices of
        the FCNN and SIREN layer pairs, of which it stores its blocks), with
        the unsharded run's losses, gradients and parameters (module
        docstring). Every rank builds the solver alike. ``get_solution`` and
        ``get_residuals`` evaluate unsharded; under a ``'model'`` axis every
        rank calls them, since they gather the blocks.

    A :class:`~neurodiffeq_tpu_torch.generators.ResidualAdaptiveGenerator`
    as the train generator draws its candidates each batch and keeps them by
    the current residual (:meth:`_residual_scores`).
    """

    @deprecated_alias(criterion='loss_fn')
    def __init__(self, diff_eqs, conditions, nets=None, train_generator=None, valid_generator=None,
                 analytic_solutions=None, optimizer=None, loss_fn=None, n_batches_train=1,
                 n_batches_valid=4, metrics=None, n_input_units=None, n_output_units=None,
                 residual_weights=None, device=None, dtype=None, generator=None,
                 shuffle=None, batch_size=None, eval_mode=None, mesh=None):
        if shuffle:
            warnings.warn("param `shuffle` is deprecated and ignored; shuffling should be performed by generators",
                          FutureWarning)
        if batch_size is not None:
            warnings.warn("param `batch_size` is deprecated and ignored; specify n_batches_train and "
                          "n_batches_valid instead", FutureWarning)
        self.device, self.dtype = resolve(device, dtype)
        if self.device.type == 'cuda':
            full_precision_matmuls()
        self.eval_mode = None if eval_mode is None else fields._check_mode(eval_mode)
        self.diff_eqs = diff_eqs
        self.conditions = conditions
        self.n_funcs = len(conditions)
        if residual_weights is not None:
            try:
                residual_weights = [float(w) for w in residual_weights]
            except (TypeError, ValueError):
                raise ValueError(f"residual_weights must be None or a sequence of positive "
                                 f"numbers; got {residual_weights!r}")
            if any(w <= 0 for w in residual_weights):
                raise ValueError("residual_weights must be positive")
        self.residual_weights = residual_weights
        if nets is None:
            nets = [FCNN(n_input_units=n_input_units, n_output_units=n_output_units,
                         hidden_units=(32, 32), actv=Tanh, device=self.device, dtype=self.dtype)
                    for _ in range(self.n_funcs)]
        self.nets = [net.to(device=self.device, dtype=self.dtype) for net in nets]
        # one entry per distinct module, in order of first appearance: a net
        # shared by several conditions is trained (and tracked) once
        self._unique_nets = list({id(n): n for n in self.nets}.values())

        if train_generator is None:
            raise ValueError("train_generator must be specified")
        if valid_generator is None:
            raise ValueError("valid_generator must be specified")
        _warn_if_buried(train_generator)
        self.generator = {'train': train_generator, 'valid': valid_generator}
        if n_batches_train < 1 or n_batches_valid < 0:
            raise ValueError(f"need n_batches_train >= 1 and n_batches_valid >= 0, "
                             f"got {n_batches_train} and {n_batches_valid}")
        self.n_batches = {'train': n_batches_train, 'valid': n_batches_valid}
        self._batch = {'train': None, 'valid': None}  # the last batch of each phase
        self.rng = generator if generator is not None else get_generator(self.device)

        self.metrics_fn = metrics if metrics else {}
        if analytic_solutions:
            warnings.warn('The `analytic_solutions` argument is deprecated and could lead to unstable '
                          'behavior. Pass a `metrics` dict instead.', FutureWarning)

            def analytic_mse(*args):
                x = args[-n_input_units:]
                u_hat = analytic_solutions(*x)
                u_hat = list(u_hat) if isinstance(u_hat, (list, tuple)) else [u_hat]
                return ((torch.stack(args[:-n_input_units]) - torch.stack(u_hat)) ** 2).mean()

            if 'analytic_mse' in self.metrics_fn:
                warnings.warn("Ignoring `analytic_solutions` in presence of key 'analytic_mse' in `metrics`",
                              FutureWarning)
            else:
                self.metrics_fn['analytic_mse'] = analytic_mse
        self.metrics_history = {'train_loss': [], 'valid_loss': []}
        self.metrics_history.update({'train__' + name: [] for name in self.metrics_fn})
        self.metrics_history.update({'valid__' + name: [] for name in self.metrics_fn})
        self.mesh = mesh
        self._split = None
        if mesh is not None:  # every rank starts from rank 0's parameters and generator state
            _check_mesh(mesh)
            if stored_blocks(self._unique_nets):
                raise ValueError("a net already stores blocks of a model mesh: build the solver from full-size nets "
                                 "(another solver's get_solution().nets or best_nets)")
            shard_params(self._unique_nets, mesh)
            self.rng.set_state(broadcast_(self.rng.get_state(), world_group(mesh)))
            if mesh_axes(mesh).model is not None:  # the Megatron layout: this rank keeps its blocks of the split leaves
                self._split = ModelSplit(mesh)
                device_put_params(self._unique_nets, mesh)

        self.set_optimizer(optimizer if optimizer is not None else torch.optim.Adam(self._parameters(), lr=1e-3))
        self._set_loss_fn(loss_fn)

        self.best_params = None
        self.lowest_loss = None
        self.local_epoch = 0
        self._max_local_epoch = 0
        self._stop_training = False

    # -------------------------------------------------------- configuration
    def _parameters(self):
        """The nets' parameters (this rank's blocks of the split leaves
        under a ``'model'`` axis), in the order they have without one."""
        return [p for net in self._unique_nets for p in net_parameters(net)]

    @property
    def _reads_collective(self):
        """Whether reading the parameters (solutions, ``best_nets``,
        ``get_internals``, ``save``, checkpoints) is a collective that every
        rank joins: under a ``'model'`` axis, whose blocks it gathers."""
        return self._split is not None

    def _set_loss_fn(self, criterion):
        if criterion is None:
            self.loss_fn = _losses['l2']
        elif isinstance(criterion, str):
            self.loss_fn = _losses[criterion.lower()]
        elif callable(criterion):
            self.loss_fn = criterion
        else:
            raise TypeError(f"Unknown type of criterion {type(criterion)}")

    def set_loss_fn(self, loss_fn):
        """Swap the loss function (a registry key or a callable)."""
        self._set_loss_fn(loss_fn)

    def set_optimizer(self, optimizer, reset_state=True):
        """Swap the optimizer. With ``reset_state`` its state (moments,
        step counts, L-BFGS history) starts empty. Under a ``'model'`` axis
        the nets' parameters are this rank's blocks of the split leaves (the
        same parameter objects: an optimizer made over the full-size ones
        before the solver holds the blocks), so its state is 1/m of theirs.
        There ``torch.optim.LBFGS``, ``Adafactor`` and ``Muon``, whose steps
        read across their parameters, step on the blocks with every global
        scalar reduced over the model group, exactly as they step without a
        mesh (:func:`~neurodiffeq_tpu_torch.parallel.optim.on_model_axis`:
        the same object, its class made the model axis's); another
        closure-style optimizer raises a ``ValueError`` there. ``torch.optim.Muon``
        takes 2-D parameters only, so it trains the weights it is given,
        with a mesh or without."""
        if self._split is not None:
            optimizer = on_model_axis(optimizer, self._unique_nets, self._split, _requires_closure(optimizer))
        self.optimizer = optimizer
        self._closure_style = _requires_closure(optimizer)
        if reset_state:
            optimizer.state.clear()
        if self._closure_style and self.n_batches['valid'] == 0:
            warnings.warn(
                "Setting n_batches_valid=0 will update lowest_loss and best_net with training "
                "loss instead of validation loss. This is a problem for closure-style optimizers "
                "because they update the parameters before the training loss is computed. "
                "This leads to potentially worse solution in `best_net`!", RuntimeWarning)

    def set_generator(self, generator, phase='train'):
        """Swap the collocation generator of ``phase`` (``'train'`` or ``'valid'``)."""
        if phase not in self.generator:
            raise ValueError(f"phase must be one of {list(self.generator)}, got {phase!r}")
        if phase == 'train':
            _warn_if_buried(generator)
        self.generator[phase] = generator

    @property
    def global_epoch(self):
        return len(self.metrics_history['train_loss'])

    @property
    def batch(self):
        """The last batch of each phase (``{'train': cols, 'valid': cols}``)."""
        return self._batch

    @property
    def _batch_examples(self):
        warnings.warn('`._batch_examples` has been deprecated in favor of `._batch` and will be removed in a '
                      'future version', FutureWarning)
        return self._batch

    @property
    def criterion(self):
        warnings.warn(f'`{self.__class__.__name__}.criterion` is a deprecated alias for '
                      f'`{self.__class__.__name__}.loss_fn`.')
        return self.loss_fn

    @criterion.setter
    def criterion(self, loss_fn):
        warnings.warn(f'`{self.__class__.__name__}.criterion` is a deprecated alias for '
                      f'`{self.__class__.__name__}.loss_fn`.')
        self._set_loss_fn(loss_fn)

    # -------------------------------------------------------------- the loss
    def compute_func_val(self, net, cond, *coordinates):
        r"""Enforce the condition on the network over the coordinates -> Field."""
        return cond.enforce(net, *coordinates)

    def _forward(self, cols, nets=None, sharded=True):
        """Sampled columns -> (funcs, coord_fields); shared by loss and residuals.
        The per-condition nets run one after another. Under a mesh and
        ``sharded``, on this rank's block of the rows only (the coordinate
        set's ``shard`` says which)."""
        points = torch.cat([c.reshape(-1, 1) for c in cols], dim=1)
        shard = None
        if sharded and self.mesh is not None:
            shard = RowShard(self.mesh, points.shape[0])
            points = points[shard.lo:shard.hi]
        coord_fields = coords_from_points(points, shard)
        funcs = [self.compute_func_val(net, cond, *coord_fields)
                 for net, cond in zip(nets or self.nets, self.conditions)]
        return funcs, coord_fields

    def _residuals(self, funcs, coord_fields, weighted=False):
        residuals = self.diff_eqs(*funcs, *coord_fields)
        if isinstance(residuals, Field):
            residuals = [residuals]
        if weighted and self.residual_weights is not None:
            residuals = self._apply_residual_weights(list(residuals))
        return field_cat(residuals)

    def _apply_residual_weights(self, residuals):
        """Scale each equation's residual by ``w_k ** (1/p)``, ``p`` the loss
        function's ``residual_power`` (default 2): a quadratic loss then sees
        ``sum_k w_k mean(r_k^2)`` and a loss linear in the residual
        ``sum_k w_k mean(r_k)``. Only the training loss is weighted;
        ``get_residuals`` returns raw residuals."""
        rw = self.residual_weights
        if len(rw) != len(residuals):
            raise ValueError(f"residual_weights has {len(rw)} entries but the system "
                             f"produced {len(residuals)} residuals")
        power = getattr(self.loss_fn, 'residual_power', 2)
        return [r * (w ** (1.0 / power)) for r, w in zip(residuals, rw)]

    @contextmanager
    def _eval_scope(self):
        """The scope of the sharded forward passes: the evaluation mode and,
        under a ``'model'`` axis, the nets split over it."""
        with fields.eval_mode(self.eval_mode) if self.eval_mode is not None else nullcontext():
            with split_scope(self._unique_nets, self._split):
                yield

    def _loss_and_metrics(self, cols):
        """Enforce, residuals, loss + additional loss, metrics."""
        with self._eval_scope():
            return self._loss_and_metrics_inner(cols)

    def _loss_and_metrics_inner(self, cols):
        phase = 'train' if torch.is_grad_enabled() else 'valid'  # validation batches build no graph
        with self._span('solver.forward', phase):
            funcs, coord_fields = self._forward(cols)
        with self._span('solver.residual', phase):
            residual = self._residuals(funcs, coord_fields, weighted=True)
            shard = coord_fields[0].coords.shard
            if shard is None:
                loss = self.loss_fn(residual, funcs, coord_fields)
                loss = loss + self.additional_loss(residual, funcs, coord_fields)
                metrics = {name: torch.as_tensor(fn(*[f.value for f in funcs], *[c.value for c in coord_fields]))
                           for name, fn in self.metrics_fn.items()}
            else:
                loss, metrics = self._sharded_loss_and_metrics(shard, residual, funcs, coord_fields)
            coord_fields[0].coords.release()
        return loss, metrics

    def _sharded_loss_and_metrics(self, shard, residual, funcs, coord_fields):
        """This rank's share of the global loss, and the metrics of the
        global batch. The shares' values and gradients sum over the ranks
        to the global loss's. The loss function and ``additional_loss``
        each declare a ``shard_form``: a ``'mean'`` term (a mean over the
        points, or one that does not depend on them) is weighted by the
        block's share of the rows; a ``'global'`` term is computed on the
        gathered batch (plain tensors) on every rank and counted once, on
        rank 0, while each rank keeps its gradient through its rows."""
        terms = [(self.loss_fn, _shard_form(self.loss_fn, f"loss function {self.loss_fn!r}")),
                 (self.additional_loss, _shard_form(self.additional_loss, f"{type(self).__name__}.additional_loss"))]
        gathered, share = None, 0.0
        for fn, form in terms:
            if form == 'mean':
                share = share + shard.weight * fn(residual, funcs, coord_fields)
                continue
            if gathered is None:
                fields_ = [residual] + list(funcs) + list(coord_fields)
                parts = torch.split(shard.gather_rows(torch.cat([f.value for f in fields_], dim=1)),
                                    [f.value.shape[1] for f in fields_], dim=1)
                gathered = (parts[0], list(parts[1:1 + len(funcs)]), list(parts[1 + len(funcs):]))
            full = torch.as_tensor(fn(*gathered), dtype=residual.value.dtype, device=residual.value.device)
            share = share + (full if shard.rank == 0 else full - full.detach())
        return share, self._global_metrics(shard, funcs, coord_fields)

    def _global_metrics(self, shard, funcs, coord_fields):
        """The metrics of the global batch, gathered once, on every rank."""
        if not self.metrics_fn:
            return {}
        with torch.no_grad():
            values = [f.value for f in list(funcs) + list(coord_fields)]
            parts = torch.split(shard.gather_rows(torch.cat(values, dim=1)), [v.shape[1] for v in values], dim=1)
            return {name: torch.as_tensor(fn(*parts)) for name, fn in self.metrics_fn.items()}

    def additional_loss(self, residual, funcs, coords):
        r"""Additional loss terms; override in subclasses. Must return a
        scalar. Under ``residual_weights``, ``residual`` is the weighted one.
        Under a mesh an override declares its ``shard_form``
        (``additional_loss.shard_form = 'mean'`` or ``'global'``, as a loss
        function does; :meth:`_sharded_loss_and_metrics`)."""
        return 0.0

    additional_loss.shard_form = 'mean'  # zero on every block

    @torch.no_grad()
    def _residual_scores(self, cols):
        """Per-point residual magnitude, the L2 norm over the (weighted)
        equations: the epsilon(x) score of Wu et al. (2023), so that the
        adaptive generator's default ``alpha=1`` is their RAD k = 1. No
        gradient flows through it."""
        with self._eval_scope():
            with self._span('solver.forward', 'train'):
                funcs, coord_fields = self._forward(cols)
            with self._span('solver.residual', 'train'):
                r = self._residuals(funcs, coord_fields, weighted=True).value
                shard = coord_fields[0].coords.shard
                coord_fields[0].coords.release()
        scores = torch.sqrt((r * r).sum(dim=1))
        return scores if shard is None else shard.gather_rows(scores)  # every rank scores its block

    def _generate_batch(self, phase):
        gen = self.generator[phase]
        with self._span('solver.batch', phase):
            if phase == 'train' and getattr(gen, 'adaptive', False):
                samples = gen.sample_scored(self.rng,
                                            lambda cand: self._residual_scores([c.reshape(-1, 1) for c in cand]))
            else:
                samples = gen.sample(self.rng)
            self._batch[phase] = [c.reshape(-1, 1) for c in _as_tuple(samples)]
        return self._batch[phase]

    def _span(self, name, phase, recorded=False):
        """A span of the solver loop (:func:`~neurodiffeq_tpu_torch.tracing.span`)
        with ``args`` ``'<phase> <epoch>'``, which one epoch's spans share:
        the 1-based number of ``phase``'s epoch in progress, or of the one
        just ``recorded``; in ``fit``, the global epoch. ``'eval'``
        (``get_residuals``, solutions) has no epochs of its own and counts
        the training epochs recorded."""
        def args():
            runs = self.metrics_history.get(f'{phase}_loss', self.metrics_history['train_loss'])
            return f'{phase} {len(runs) + (not recorded)}'
        return span(name, args)

    # ---------------------------------------------------------------- epochs
    def _trained_parameters(self):
        return [p for group in self.optimizer.param_groups for p in group['params'] if p.requires_grad]

    def _backward(self, loss):
        """``loss.backward()`` into the optimizer's parameters only: the
        backward then skips the graph that leads only to the points (the
        compose path differentiates with respect to copies of them), whose
        gradients nothing reads."""
        with self._span('solver.backward', 'train'):
            loss.backward(inputs=self._trained_parameters())

    def _closure_step(self, cols):
        """One closure-style optimizer step on one batch; returns the loss
        and metrics at the parameters before the step. Under a mesh each
        closure call returns the global loss, its gradients summed over the
        ``'points'`` axis (:meth:`_reduce_grads`); on a ``'model'`` axis the
        optimizer's own reductions over the model group follow
        (:class:`~neurodiffeq_tpu_torch.parallel.optim.LBFGS`)."""
        first = []

        def closure():
            self.optimizer.zero_grad(set_to_none=True)
            loss, metrics = self._loss_and_metrics(cols)
            self._backward(loss)
            if not first:
                first.append((loss.detach(), metrics))
            return loss if self.mesh is None else self._reduce_grads(loss)

        self.optimizer.step(closure)
        return first[0]

    @torch.no_grad()
    def _reduce_grads(self, loss=None):
        """Under a mesh: sum the trained parameters' gradients over the
        ``'points'`` axis in one ``all_reduce``, with ``loss``'s share if
        given. Every rank holds its rows' share of each gradient; under a
        ``'model'`` axis a stored block of a split leaf is this model
        index's alone, and every model rank computes the same gradient of a
        replicated leaf, so nothing is summed over the model group. Every
        rank runs the same graph on its block, so the parameters with a
        gradient are the same on every rank. Returns the global loss, or
        None."""
        with self._span('solver.reduce', 'train'):
            params = [p for p in self._trained_parameters() if p.grad is not None]
            parts = [p.grad.reshape(-1) for p in params] + ([loss.detach().reshape(1)] if loss is not None else [])
            if not parts:
                return None
            dtype = parts[0].dtype
            flat = torch.cat([t.to(dtype) for t in parts])
            all_reduce_(flat, mesh_axes(self.mesh).points.get_group())
            sizes = [p.numel() for p in params]
            for p, g in zip(params, torch.split(flat[:sum(sizes)], sizes)):
                p.grad.copy_(g.view_as(p))
            return flat[-1] if loss is not None else None

    def _run_epoch(self, phase):
        """One epoch of ``phase``; returns the mean loss and metrics as tensors."""
        n_batches = self.n_batches[phase]
        train = phase == 'train'
        closure = train and self._closure_style
        if train and not closure:
            self.optimizer.zero_grad(set_to_none=True)
        total, metric_sums = 0.0, {name: 0.0 for name in self.metrics_fn}
        with torch.set_grad_enabled(train):
            for _ in range(n_batches):
                cols = self._generate_batch(phase)
                if closure:
                    loss, metrics = self._closure_step(cols)
                else:
                    loss, metrics = self._loss_and_metrics(cols)
                    if train:
                        self._backward(loss)
                total = total + loss.detach()
                for name in self.metrics_fn:
                    metric_sums[name] = metric_sums[name] + metrics[name].detach()
        if train and not closure:
            if self.mesh is not None:
                self._reduce_grads()
            self.optimizer.step()
        return total / n_batches, {k: v / n_batches for k, v in metric_sums.items()}

    def _record(self, phase, loss, metrics):
        self.metrics_history[f'{phase}_loss'].append(loss)
        for name, v in metrics.items():
            self.metrics_history[f'{phase}__{name}'].append(v)

    def _full_states(self, states=None):
        """Each distinct net's full-size state dict (of ``states``, one per
        distinct net with its keys, e.g. ``best_params``, instead of the
        live ones): a model axis's blocks gathered, on every rank."""
        return [full_state(net, s) for net, s in zip(self._unique_nets, states or [None] * len(self._unique_nets))]

    @torch.no_grad()
    def load_params(self, params):
        """Load full-size parameters into the nets: one state dict per
        distinct net, in order of first appearance, as ``get_internals(
        'params')`` gives them. Under a ``'model'`` axis each rank keeps its
        blocks of the split leaves."""
        if len(params) != len(self._unique_nets):
            raise ValueError(f"expected parameters of {len(self._unique_nets)} nets, got {len(params)}")
        for net, state in zip(self._unique_nets, params):
            net.load_state_dict(placed_state(net, state))
        return self

    def _update_best(self, phase):
        with self._span('solver.best', phase, recorded=True):
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
        if self.n_batches['valid'] <= 0:
            return
        self._record_epochs([self._run_epoch('valid')], ('valid',))
        self._update_best('valid')

    def _record_epochs(self, out, phases):
        """Record each phase's ``(loss, metrics)`` of ``out`` with one
        device-to-host read. Under a mesh the losses are this rank's shares
        and the metrics global: one ``all_reduce`` over the ``'points'``
        axis sums the shares (and points index 0's metrics), so every rank
        records the global values."""
        with self._span('solver.readback', phases[0]):
            names = list(self.metrics_fn)
            flat = torch.stack([torch.as_tensor(x, dtype=torch.float64, device=self.device)
                                for loss, m in out for x in [loss, *[m[k] for k in names]]])
            per_phase = len(names) + 1
            if self.mesh is not None:
                keep = torch.zeros_like(flat, dtype=torch.bool)
                keep[::per_phase] = True
                points = mesh_axes(self.mesh).points
                keep |= points.get_local_rank() == 0
                flat = all_reduce_(torch.where(keep, flat, torch.zeros_like(flat)), points.get_group())
            values = flat.tolist()
            for phase, i in zip(phases, range(0, len(values), per_phase)):
                self._record(phase, values[i], dict(zip(names, values[i + 1:i + per_phase])))

    def run_epochs(self, valid=True):
        """One training epoch and, if ``valid`` and there are validation
        batches, one validation epoch, with one device-to-host read."""
        has_valid = valid and self.n_batches['valid'] > 0
        out = [self._run_epoch('train')] + ([self._run_epoch('valid')] if has_valid else [])
        self._record_epochs(out, ('train', 'valid'))
        if has_valid:
            self._update_best('valid')
        elif self.n_batches['valid'] == 0:
            self._update_best('train')

    def fit(self, max_epochs, callbacks=(), tqdm_file=sys.stderr, profile_dir=None, pipeline=True, **kwargs):
        r"""Run ``max_epochs`` epochs of training and validation, tracking the
        best parameters.

        :param max_epochs: Number of epochs to run.
        :param callbacks: callables taking the solver, called after every
            epoch; one may stop training by setting ``_stop_training``.
        :param tqdm_file: file for the tqdm progress bar; None (or no tqdm
            installed) shows none.
        :param profile_dir: if set, the run is traced by ``torch.profiler``
            (the host and, on the card, the device), and the trace is written
            to this directory as a TensorBoard-readable file (TensorBoard's
            profiler plugin or Perfetto open it). Beside PyTorch's own ranges
            (``Optimizer.step#...``, ``Optimizer.zero_grad#...``, the kernel
            wrappers ``_TaylorMLPFn`` and ``_TaylorStreamsFn``, the backward's
            ``autograd::engine::evaluate_function: ...``) it holds the solver
            loop's spans, siblings on the main thread, each with ``args``
            ``'<phase> <epoch>'``: ``solver.batch``, ``solver.forward``,
            ``solver.residual``, ``solver.backward``, ``solver.reduce`` (under
            a mesh), ``solver.readback``, ``solver.best`` and
            ``solver.copy_nets`` (:data:`~neurodiffeq_tpu_torch.tracing.SPANS`).
            The spans are on exactly while a profiler is; otherwise each costs
            one check, under a microsecond. No span is open while the
            callbacks run, so a callback may start or stop a profiler.
        :param pipeline: accepted and without effect. The JAX package
            dispatches its next compiled chunk of epochs ahead of the
            callbacks; eager PyTorch has no such chunk, and the committed
            epochs are the same either way.
        """
        if profile_dir is not None:
            from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == 'cuda' else [])
            with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(profile_dir))):
                return self.fit(max_epochs, callbacks=callbacks, tqdm_file=tqdm_file, pipeline=pipeline, **kwargs)
        monitor = kwargs.pop('monitor', None)
        if monitor:
            warnings.warn("Passing `monitor` is deprecated, use a MonitorCallback and pass a list of callbacks "
                          "instead")
            callbacks = [monitor.to_callback()] + list(callbacks)
        if kwargs:
            raise ValueError(f'Unknown keyword argument(s): {list(kwargs.keys())}')
        self._stop_training = False
        self._max_local_epoch = max_epochs
        self.local_epoch = 0
        pbar = None
        if self.mesh is not None and self.mesh.get_rank() != 0:
            tqdm_file = None  # one progress bar, rank 0's
        if tqdm is not None and tqdm_file is not None:
            pbar = tqdm(total=max_epochs, desc='Training Progress', colour='blue', file=tqdm_file,
                        dynamic_ncols=True)
        try:
            while self.local_epoch < max_epochs and not self._stop_training:
                self.local_epoch += 1
                self.run_epochs()
                for cb in callbacks:
                    cb(self)
                if pbar is not None:
                    pbar.update(1)
        finally:
            if pbar is not None:
                pbar.close()
            # no callback worker (a background monitor draw) outlives fit()
            for cb in callbacks:
                flush = getattr(cb, 'flush', None)
                if callable(flush):
                    flush()

    # ------------------------------------------------------------ inspection
    def _nets_for(self, best):
        """Frozen full-size copies of the nets, loaded with the lowest-loss
        parameters if ``best``. A solution always gets copies, so that later
        training does not change it, as it cannot change the JAX package's
        immutable parameters; their parameters take no gradient, so a
        backward through a solution's inputs accumulates none on them. Under
        a ``'model'`` axis the blocks are gathered: every rank calls it."""
        if best and self.best_params is None:
            raise RuntimeError("The best parameters are not available; check if you disabled "
                               "validation and used best=True")
        with self._span('solver.copy_nets', 'eval', recorded=True):
            nets = plain_copies(self.nets, self._full_states(self.best_params if best else None))
            for net in nets:
                net.requires_grad_(False)
        return nets

    @property
    def best_nets(self):
        """Copies of the nets loaded with the lowest-loss parameters (None
        before the first epoch)."""
        return None if self.best_params is None else self._nets_for(best=True)

    @torch.no_grad()
    def load_jax_params(self, params):
        """Load the JAX package's solver parameters: its ``params`` list, one
        pytree of numpy arrays per distinct net (in order of first
        appearance, as ``_net_param_index`` numbers them), each through the
        matching module's ``load_jax_params``."""
        if len(params) != len(self._unique_nets):
            raise ValueError(f"expected parameters of {len(self._unique_nets)} nets, got {len(params)}")
        for net, p in zip(self._unique_nets, params):
            net.load_jax_params(p)  # a split leaf keeps this rank's block
        return self

    def _get_internal_variables(self):
        """``{name: getter}`` of the internal variables: ``get_internals``
        calls only the getters of the names asked for (under a ``'model'``
        axis a parameter's getter gathers)."""
        return {
            "metrics": lambda: self.metrics_fn,
            "n_batches": lambda: self.n_batches,
            "best_nets": lambda: self.best_nets,
            "best_params": lambda: None if self.best_params is None else self._full_states(self.best_params),
            "criterion": lambda: self.loss_fn,
            "loss_fn": lambda: self.loss_fn,
            "conditions": lambda: self.conditions,
            "global_epoch": lambda: self.global_epoch,
            "lowest_loss": lambda: self.lowest_loss,
            "n_funcs": lambda: self.n_funcs,
            "nets": lambda: self.nets if self._split is None else self._nets_for(best=False),
            "params": lambda: self._full_states(),
            "optimizer": lambda: self.optimizer,
            "diff_eqs": lambda: self.diff_eqs,
            "generator": lambda: self.generator,
            "train_generator": lambda: self.generator['train'],
            "valid_generator": lambda: self.generator['valid'],
        }

    @deprecated_alias(param_names='var_names')
    def get_internals(self, var_names=None, return_type='list'):
        r"""Internal variable(s) of the solver: all of them (as a dict) for
        ``None`` or ``'all'``, one for a name, else a list or dict. The
        parameters are full-size; under a ``'model'`` axis they are gathered
        (every rank calls it) and ``'nets'`` are full-size frozen copies."""
        getters = self._get_internal_variables()
        if var_names == "all" or var_names is None:
            return {name: get() for name, get in getters.items()}
        if isinstance(var_names, str):
            return getters[var_names]()
        if return_type == 'list':
            return [getters[name]() for name in var_names]
        if return_type == "dict":
            return {name: getters[name]() for name in var_names}
        raise ValueError(f"unrecognized return_type = {return_type}")

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
            nets = self._nets_for(best)
            with self._span('solver.forward', 'eval', recorded=True):
                funcs, coord_fields = self._forward(cols, nets=nets, sharded=False)
            with self._span('solver.residual', 'eval', recorded=True):  # the lazy fields evaluate at .value
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

        :param coords: coordinate arrays (numpy or torch), equal shapes. The
            values are differentiable in any tensor that requires grad (an
            equation parameter of a bundle, say); with none, no graph is kept.
        :param to_numpy: return ``numpy.ndarray`` instead of tensors.
        :param no_reshape: skip reshaping output back to the input shape.
        """
        coords = [torch.as_tensor(np.asarray(c) if not torch.is_tensor(c) else c,
                                  dtype=self.dtype, device=self.device) for c in coords]
        shape = coords[0].shape
        points = torch.cat([c.reshape(-1, 1) for c in coords], dim=1)
        with nullcontext() if points.requires_grad else torch.no_grad():
            us = self._eval(points)
        if not no_reshape:
            us = [u.reshape(shape) for u in us]
        if to_numpy:
            us = [u.detach().cpu().numpy() for u in us]
        return us if len(self.nets) > 1 else us[0]

    def _eval(self, points):
        """The (N, 1) values of every function at the (N, d) ``points``."""
        coord_fields = coords_from_points(points)
        return [self._compute_u(net, cond, *coord_fields).value for net, cond in zip(self.nets, self.conditions)]

    def export(self, n_coords, path=None, dtype=None):
        """Serialize the solution's evaluator as a ``torch.export`` program
        (a ``.pt2`` archive) with a dynamic batch dimension: the serving
        counterpart of the JAX package's StableHLO artifact.

        :param n_coords: number of coordinate inputs (1 for ODE solutions,
            2 for 2-D PDEs, 3 for spherical, ...).
        :param path: optional file to write the artifact to.
        :param dtype: input dtype of the artifact (the solution's if None);
            the points are cast to the solution's dtype inside it.
        :return: the serialized bytes; :func:`load_exported_solution` reads them.
        """
        dtype = dtype or self.dtype
        evaluator = _Evaluator(self)
        example = torch.rand(7, n_coords, dtype=dtype, device=self.device)
        with torch.no_grad():
            evaluator(example)  # an eager pass first: the engine's constants are then real tensors
            program = torch.export.export(evaluator, (example,),
                                          dynamic_shapes={'points': {0: torch.export.Dim('batch', min=1)}})
        meta = {'n_coords': n_coords, 'dtype': str(dtype).replace('torch.', ''), 'device': str(self.device)}
        buf = io.BytesIO()
        torch.export.save(program, buf, extra_files={'solution.json': json.dumps(meta)})
        blob = buf.getvalue()
        if path is not None:
            with open(path, 'wb') as f:
                f.write(blob)
        return blob


class _Evaluator(torch.nn.Module):
    """A solution's evaluator as a module: its distinct nets are submodules,
    so that ``torch.export`` lifts their parameters into the program."""

    def __init__(self, solution):
        super().__init__()
        self.nets = torch.nn.ModuleList(list({id(n): n for n in solution.nets}.values()))
        self._solution = [solution]  # a list: not a submodule

    def forward(self, points):
        solution = self._solution[0]
        return tuple(solution._eval(points.to(solution.dtype)))


def load_exported_solution(path_or_bytes):
    """Load a solution artifact written by :meth:`BaseSolution.export`.

    :param path_or_bytes: a file path or the artifact's bytes.
    :return: a callable from ``(N, n_coords)`` points (a tensor or a numpy
        array, N >= 1) to a tuple of ``(N, 1)`` tensors, on the device the
        solution was exported from.
    """
    extra = {'solution.json': ''}
    if isinstance(path_or_bytes, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(path_or_bytes)), extra_files=extra)
    else:
        program = torch.export.load(str(path_or_bytes), extra_files=extra)
    meta = json.loads(extra['solution.json'])
    dtype, device = getattr(torch, meta['dtype']), torch.device(meta['device'])
    module = program.module()

    def serve(points):
        points = torch.as_tensor(np.asarray(points) if not torch.is_tensor(points) else points,
                                 dtype=dtype, device=device)
        with torch.no_grad():
            return tuple(module(points))

    return serve


class GenericSolution(BaseSolution):
    def _compute_u(self, net, condition, *coord_fields):
        return condition.enforce(net, *coord_fields)


class GenericSolver(BaseSolver):
    r"""A dimension-agnostic solver: the generators give the coordinates, as
    many as the problem has, and the conditions take them all. With no
    ``nets``, ``n_input_units`` sizes the default networks. The parameters
    are :class:`BaseSolver`'s."""

    def get_solution(self, copy=True, best=True):
        r"""A callable solution evaluated as ``solution(*coords)``.

        :param copy: copy the conditions. Defaults to True. The networks are
            always copied, so that later training does not change the
            solution.
        :param best: use the lowest-loss parameters. Defaults to True.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        return GenericSolution(self._nets_for(best), conditions)


class Solution1D(BaseSolution):
    def _compute_u(self, net, condition, ts):
        return condition.enforce(net, ts)


class Solver1D(BaseSolver):
    r"""A solver for ODEs (single-input differential equations).

    :param ode_system: maps funcs and the time coordinate to residuals.
    :param conditions: list of conditions, one per target function.
    :param t_min: lower bound of the time domain (ignored if both generators given).
    :param t_max: upper bound of the time domain.

    The default generators are ``Generator1D(32, t_min, t_max)`` with
    ``'equally-spaced-noisy'`` (training) and ``'equally-spaced'``
    (validation). The other parameters are :class:`BaseSolver`'s.
    """

    def __init__(self, ode_system, conditions, t_min=None, t_max=None, nets=None,
                 train_generator=None, valid_generator=None, analytic_solutions=None, optimizer=None,
                 loss_fn=None, n_batches_train=1, n_batches_valid=4, metrics=None, n_output_units=1,
                 residual_weights=None, device=None, dtype=None, generator=None, shuffle=None, batch_size=None,
                 eval_mode=None, mesh=None):
        if train_generator is None or valid_generator is None:
            if t_min is None or t_max is None:
                raise ValueError(
                    f"Either generator is not provided, t_min and t_max should be both provided: \n"
                    f"got t_min={t_min}, t_max={t_max}, "
                    f"train_generator={train_generator}, valid_generator={valid_generator}")
        device, dtype = resolve(device, dtype)
        if train_generator is None:
            train_generator = Generator1D(32, t_min=t_min, t_max=t_max, method='equally-spaced-noisy',
                                          device=device, dtype=dtype)
        if valid_generator is None:
            valid_generator = Generator1D(32, t_min=t_min, t_max=t_max, method='equally-spaced',
                                          device=device, dtype=dtype)
        self.t_min, self.t_max = t_min, t_max
        super().__init__(
            diff_eqs=ode_system, conditions=conditions, nets=nets,
            train_generator=train_generator, valid_generator=valid_generator,
            analytic_solutions=analytic_solutions, optimizer=optimizer, loss_fn=loss_fn,
            n_batches_train=n_batches_train, n_batches_valid=n_batches_valid, metrics=metrics,
            n_input_units=1, n_output_units=n_output_units, residual_weights=residual_weights,
            device=device, dtype=dtype, generator=generator, shuffle=shuffle, batch_size=batch_size,
            eval_mode=eval_mode, mesh=mesh)

    def get_solution(self, copy=True, best=True):
        r"""A callable solution evaluated as ``solution(ts)``.

        :param copy: copy the conditions. Defaults to True. The networks are
            always copied, so that later training does not change the
            solution.
        :param best: use the lowest-loss parameters. Defaults to True.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        return Solution1D(self._nets_for(best), conditions)

    def _get_internal_variables(self):
        d = super()._get_internal_variables()
        d.update({'t_min': lambda: self.t_min, 't_max': lambda: self.t_max})
        return d


class BundleSolution1D(GenericSolution):
    r"""A solution bundle evaluated as ``solution(ts, theta_1, ..., theta_n)``."""


class BundleSolver1D(BaseSolver):
    r"""Solves an ODE *bundle*: one network over the hypercube
    ``(t, theta_1, ..., theta_n)``, whose thetas are equation parameters
    and/or condition values (see :class:`~neurodiffeq_tpu_torch.conditions.BundleIVP`).

    :param ode_system: maps funcs, the time coordinate and the equation
        parameters named by ``eq_param_index`` (in that order) to residuals.
    :param conditions: list of conditions, one per target function; each
        is enforced on ``(t, theta_1, ..., theta_n)``.
    :param t_min: lower bound of the time domain (ignored if both generators given).
    :param t_max: upper bound of the time domain.
    :param theta_min: per-theta lower bounds (a number for one theta).
    :param theta_max: per-theta upper bounds (a number for one theta).
    :param eq_param_index: indices of the thetas that the equation takes.

    The default generators mesh a 32-point ``Generator1D`` per axis with
    ``^``, ``'equally-spaced-noisy'`` for training and ``'equally-spaced'``
    for validation: 32^(1+n) points per batch. The default networks take
    ``1 + n`` inputs. The other parameters are :class:`BaseSolver`'s.
    """

    def __init__(self, ode_system, conditions, t_min, t_max, theta_min=None, theta_max=None, eq_param_index=(),
                 nets=None, train_generator=None, valid_generator=None, analytic_solutions=None, optimizer=None,
                 loss_fn=None, n_batches_train=1, n_batches_valid=4, metrics=None, n_output_units=1,
                 residual_weights=None, device=None, dtype=None, generator=None, batch_size=None, shuffle=None,
                 eval_mode=None, mesh=None):
        if train_generator is None or valid_generator is None:
            if t_min is None or t_max is None:
                raise ValueError(
                    f"Either generator is not provided, t_min and t_max should be both provided: \n"
                    f"got t_min={t_min}, t_max={t_max}, "
                    f"train_generator={train_generator}, valid_generator={valid_generator}")
        theta_min, theta_max = (() if th is None else (th,) if isinstance(th, (float, int)) else tuple(th)
                                for th in (theta_min, theta_max))
        if len(theta_min) != len(theta_max):
            raise ValueError(
                f"length of theta_min and theta_max must be equal, got {len(theta_min)} != {len(theta_max)}")
        self.r_min, self.r_max = (t_min,) + theta_min, (t_max,) + theta_max
        device, dtype = resolve(device, dtype)

        def grid(method):
            gen = None
            for lo, hi in zip(self.r_min, self.r_max):
                axis = Generator1D(32, t_min=lo, t_max=hi, method=method, device=device, dtype=dtype)
                gen = axis if gen is None else gen ^ axis
            return gen

        if train_generator is None:
            train_generator = grid('equally-spaced-noisy')
        if valid_generator is None:
            valid_generator = grid('equally-spaced')

        # the thetas follow the functions and t among the equation wrapper's arguments
        n_leading = len(conditions) + 1
        self.eq_param_index = tuple(n_leading + i for i in eq_param_index)
        self._ode_system = ode_system  # what save() keeps: the wrapper is rebuilt on load

        def _diff_eqs_wrapper(*variables):
            return ode_system(*variables[:n_leading], *(variables[i] for i in self.eq_param_index))

        super().__init__(
            diff_eqs=_diff_eqs_wrapper, conditions=conditions, nets=nets,
            train_generator=train_generator, valid_generator=valid_generator,
            analytic_solutions=analytic_solutions, optimizer=optimizer, loss_fn=loss_fn,
            n_batches_train=n_batches_train, n_batches_valid=n_batches_valid, metrics=metrics,
            n_input_units=len(self.r_min), n_output_units=n_output_units, residual_weights=residual_weights,
            device=device, dtype=dtype, generator=generator, shuffle=shuffle, batch_size=batch_size,
            eval_mode=eval_mode, mesh=mesh)

    def get_solution(self, copy=True, best=True):
        r"""A callable solution evaluated as ``solution(ts, theta_1, ..., theta_n)``.

        :param copy: copy the conditions. Defaults to True. The networks are
            always copied, so that later training does not change the
            solution.
        :param best: use the lowest-loss parameters. Defaults to True.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        return BundleSolution1D(self._nets_for(best), conditions)

    def _get_internal_variables(self):
        d = super()._get_internal_variables()
        d.update({'r_min': lambda: self.r_min, 'r_max': lambda: self.r_max,
                  'eq_param_index': lambda: self.eq_param_index})
        return d

    def _constructor_kwargs(self):
        n_leading = self.n_funcs + 1
        kwargs = {k: v for k, v in super()._constructor_kwargs().items() if k not in ('r_min', 'r_max')}
        kwargs.update(t_min=self.r_min[0], t_max=self.r_max[0], theta_min=self.r_min[1:],
                      theta_max=self.r_max[1:], eq_param_index=tuple(i - n_leading for i in self.eq_param_index))
        return kwargs


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
                 train_generator=None, valid_generator=None, analytic_solutions=None, optimizer=None,
                 loss_fn=None, n_batches_train=1, n_batches_valid=4, metrics=None, n_output_units=1,
                 residual_weights=None, device=None, dtype=None, generator=None, shuffle=None, batch_size=None,
                 eval_mode=None, mesh=None):
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
            analytic_solutions=analytic_solutions, optimizer=optimizer, loss_fn=loss_fn,
            n_batches_train=n_batches_train, n_batches_valid=n_batches_valid, metrics=metrics,
            n_input_units=2, n_output_units=n_output_units, residual_weights=residual_weights,
            device=device, dtype=dtype, generator=generator, shuffle=shuffle, batch_size=batch_size,
            eval_mode=eval_mode, mesh=mesh)

    def get_solution(self, copy=True, best=True):
        r"""A callable solution evaluated as ``solution(xs, ys)``.

        :param copy: copy the conditions. Defaults to True. The networks are
            always copied, so that later training does not change the
            solution.
        :param best: use the lowest-loss parameters. Defaults to True.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        return Solution2D(self._nets_for(best), conditions)

    def _get_internal_variables(self):
        d = super()._get_internal_variables()
        d.update({'xy_min': lambda: self.xy_min, 'xy_max': lambda: self.xy_max})
        return d


class SolutionSpherical(BaseSolution):
    def _compute_u(self, net, condition, rs, thetas, phis):
        return condition.enforce(net, rs, thetas, phis)


class SolutionSphericalHarmonics(SolutionSpherical):
    r"""A solution whose radial networks give harmonic coefficients,
    expanded against a (theta, phi) basis.

    :param harmonics_fn: maps the (theta, phi) Fields to an (N, K) basis Field.
    :param max_degree: **[DEPRECATED]** use ``harmonics_fn``; builds
        ``RealSphericalHarmonics(max_degree)``.
    """

    def __init__(self, nets, conditions, max_degree=None, harmonics_fn=None):
        super().__init__(nets, conditions)
        if (harmonics_fn is None) and (max_degree is None):
            raise ValueError("harmonics_fn should be specified")
        if max_degree is not None:
            warnings.warn("`max_degree` is DEPRECATED; pass `harmonics_fn` instead, which takes precedence",
                          FutureWarning)
            from .function_basis import RealSphericalHarmonics
            self.harmonics_fn = RealSphericalHarmonics(max_degree=max_degree)
        if harmonics_fn is not None:
            self.harmonics_fn = harmonics_fn

    def _compute_u(self, net, condition, rs, thetas, phis):
        products = condition.enforce(net, rs) * self.harmonics_fn(thetas, phis)
        return products.sum(axis=1, keepdims=True)


class SolverSpherical(BaseSolver):
    r"""A solver for PDEs in spherical coordinates (r, theta, phi).

    :param pde_system: maps funcs and the (r, theta, phi) coordinates to residuals.
    :param conditions: list of conditions, one per target function.
    :param r_min: radius of the interior boundary (ignored if both generators given).
    :param r_max: radius of the exterior boundary.
    :param enforcer: optional override ``enforcer(net, cond, coords) -> Field``.

    The default generators are ``GeneratorSpherical(512, r_min, r_max)``
    (``'equally-spaced-noisy'``) for both phases. A condition receives as
    many coordinates as its ``parameterize`` takes, so a basis condition's
    radial net sees ``r`` alone. The other parameters are
    :class:`BaseSolver`'s.
    """

    def __init__(self, pde_system, conditions, r_min=None, r_max=None, nets=None,
                 train_generator=None, valid_generator=None, analytic_solutions=None, optimizer=None,
                 loss_fn=None, n_batches_train=1, n_batches_valid=4, metrics=None, enforcer=None,
                 n_output_units=1, residual_weights=None, device=None, dtype=None, generator=None,
                 shuffle=None, batch_size=None, eval_mode=None, mesh=None):
        if train_generator is None or valid_generator is None:
            if r_min is None or r_max is None:
                raise ValueError(
                    f"Either generator is not provided, r_min and r_max should be both provided: "
                    f"got r_min={r_min}, r_max={r_max}, train_generator={train_generator}, "
                    f"valid_generator={valid_generator}")
        device, dtype = resolve(device, dtype)
        if train_generator is None:
            train_generator = GeneratorSpherical(512, r_min, r_max, method='equally-spaced-noisy',
                                                 device=device, dtype=dtype)
        if valid_generator is None:
            valid_generator = GeneratorSpherical(512, r_min, r_max, method='equally-spaced-noisy',
                                                 device=device, dtype=dtype)
        self.r_min, self.r_max = r_min, r_max
        self.enforcer = enforcer
        super().__init__(
            diff_eqs=pde_system, conditions=conditions, nets=nets,
            train_generator=train_generator, valid_generator=valid_generator,
            analytic_solutions=analytic_solutions, optimizer=optimizer, loss_fn=loss_fn,
            n_batches_train=n_batches_train, n_batches_valid=n_batches_valid, metrics=metrics,
            n_input_units=3, n_output_units=n_output_units, residual_weights=residual_weights,
            device=device, dtype=dtype, generator=generator, shuffle=shuffle, batch_size=batch_size,
            eval_mode=eval_mode, mesh=mesh)

    def _auto_enforce(self, net, cond, *coordinates):
        r"""Enforce the condition with as many coordinates as its
        ``parameterize`` (or an overridden ``enforce``) takes."""
        if self.enforcer:
            return self.enforcer(net, cond, coordinates)
        # the first parameter is `output_tensor` (parameterize) or `net` (enforce)
        counted = cond.parameterize if cond.__class__.enforce == BaseCondition.enforce else cond.enforce
        params = inspect.signature(counted).parameters.values()
        if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
            return cond.enforce(net, *coordinates)  # e.g. NoCondition's *input_tensors
        return cond.enforce(net, *coordinates[:len(params) - 1])

    def compute_func_val(self, net, cond, *coordinates):
        return self._auto_enforce(net, cond, *coordinates)

    def get_solution(self, copy=True, best=True, harmonics_fn=None):
        r"""A callable solution evaluated as ``solution(rs, thetas, phis)``.

        :param copy: copy the conditions. Defaults to True. The networks are
            always copied, so that later training does not change the
            solution.
        :param best: use the lowest-loss parameters. Defaults to True.
        :param harmonics_fn: if given, the nets' outputs are radial
            coefficients expanded against this (theta, phi) basis.
        """
        conditions = deepcopy(self.conditions) if copy else self.conditions
        nets = self._nets_for(best)
        if harmonics_fn:
            return SolutionSphericalHarmonics(nets, conditions, harmonics_fn=harmonics_fn)
        return SolutionSpherical(nets, conditions)

    def _get_internal_variables(self):
        d = super()._get_internal_variables()
        d.update({'r_min': lambda: self.r_min, 'r_max': lambda: self.r_max, 'enforcer': lambda: self.enforcer})
        return d
