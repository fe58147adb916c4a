r"""Legacy functional API (v1) for ODEs: ``solve`` and ``solve_system``
(counterpart of ``neurodiffeq_tpu/ode.py``).

Deprecated thin wrappers that build a
:class:`~neurodiffeq_tpu_torch.solvers.Solver1D` and call ``.fit()``,
defaulting to a single shared multi-output network with per-condition
``set_impose_on``.
"""
import warnings

from .networks import FCNN, Tanh
from .generators import Generator1D
from ._version_utils import warn_deprecate_class
from .monitors import Monitor1D
from .conditions import NoCondition, IVP, DirichletBVP  # noqa: F401 (re-exported for parity)
from .solvers import Solver1D

ExampleGenerator = warn_deprecate_class(Generator1D)
Monitor = warn_deprecate_class(Monitor1D)

_INTERNALS = ['nets', 'conditions', 'train_generator', 'valid_generator', 'optimizer', 'criterion']


def _run_legacy(solver_class, additional_loss_term, max_epochs, monitor, return_internal, return_best, **kwargs):
    """Build the solver (with ``additional_loss_term`` as its
    ``additional_loss``), fit it and return ``(solution, metrics_history[,
    internals])``, as the legacy functions of ``ode``, ``pde`` and
    ``pde_spherical`` do."""
    if additional_loss_term:
        class CustomSolver(solver_class):
            def additional_loss(self, residual, funcs, coords):
                return additional_loss_term(*funcs, *coords)

        solver_class = CustomSolver
    solver = solver_class(**kwargs)
    solver.fit(max_epochs=max_epochs, monitor=monitor)
    solution = solver.get_solution(copy=True, best=return_best)
    ret = (solution, solver.metrics_history)
    if return_internal:
        ret = ret + (solver.get_internals(_INTERNALS, return_type='dict'),)
    return ret


def _shared_nets(single_net, nets, conditions, n_input_units):
    """The nets of a legacy system: by default one FCNN(n_input_units,
    len(conditions), (32, 32), Tanh) whose columns the conditions take with
    ``set_impose_on`` (reference ``ode.py:268-280``)."""
    if single_net and nets:
        raise ValueError('Only one of net and nets should be specified')
    if not (single_net or nets):
        single_net = FCNN(n_input_units=n_input_units, n_output_units=len(conditions), hidden_units=(32, 32),
                          actv=Tanh)
    if single_net:
        for ith, con in enumerate(conditions):
            con.set_impose_on(ith)
        nets = [single_net] * len(conditions)
    return nets


def solve(
        ode,
        condition,
        t_min=None,
        t_max=None,
        net=None,
        train_generator=None,
        valid_generator=None,
        optimizer=None,
        criterion=None,
        n_batches_train=1,
        n_batches_valid=4,
        additional_loss_term=None,
        metrics=None,
        max_epochs=1000,
        monitor=None,
        return_internal=False,
        return_best=False,
        batch_size=None,
        shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve an ODE
    (use :class:`~neurodiffeq_tpu_torch.solvers.Solver1D` instead).

    :param ode: maps (u, t) to the residual F(u, t).
    :param condition: the initial/boundary condition.
    :param optimizer: a ``torch.optim.Optimizer`` over the net's parameters
        (Adam at 1e-3 if None).
    :return: ``(solution, metrics_history[, internals])``.
    """
    return solve_system(
        ode_system=lambda x, t: [ode(x, t)],
        conditions=[condition],
        t_min=t_min,
        t_max=t_max,
        nets=None if not net else [net],
        train_generator=train_generator,
        valid_generator=valid_generator,
        optimizer=optimizer,
        criterion=criterion,
        n_batches_train=n_batches_train,
        n_batches_valid=n_batches_valid,
        additional_loss_term=additional_loss_term,
        metrics=metrics,
        max_epochs=max_epochs,
        monitor=monitor,
        return_internal=return_internal,
        return_best=return_best,
        batch_size=batch_size,
        shuffle=shuffle,
    )


def solve_system(
        ode_system,
        conditions,
        t_min,
        t_max,
        single_net=None,
        nets=None,
        train_generator=None,
        valid_generator=None,
        optimizer=None,
        criterion=None,
        n_batches_train=1,
        n_batches_valid=4,
        additional_loss_term=None,
        metrics=None,
        max_epochs=1000,
        monitor=None,
        return_internal=False,
        return_best=False,
        batch_size=None,
        shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve an ODE system
    (use :class:`~neurodiffeq_tpu_torch.solvers.Solver1D` instead).

    Defaults to a single shared network with ``n_output_units=len(conditions)``
    and per-condition ``set_impose_on`` (reference ``ode.py:268-280``).

    :return: ``(solution, metrics_history[, internals])``.
    """
    warnings.warn(
        "The `solve_system` function is deprecated, use a `neurodiffeq_tpu_torch.solvers.Solver1D` instance instead",
        FutureWarning,
    )
    return _run_legacy(
        Solver1D, additional_loss_term, max_epochs, monitor, return_internal, return_best,
        ode_system=ode_system,
        conditions=conditions,
        t_min=t_min,
        t_max=t_max,
        nets=_shared_nets(single_net, nets, conditions, 1),
        train_generator=train_generator,
        valid_generator=valid_generator,
        optimizer=optimizer,
        loss_fn=criterion,
        n_batches_train=n_batches_train,
        n_batches_valid=n_batches_valid,
        metrics=metrics,
        batch_size=batch_size,
        shuffle=shuffle,
    )
