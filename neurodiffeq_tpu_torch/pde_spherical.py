r"""Legacy functional API (v1) for spherical PDEs (counterpart of
``neurodiffeq_tpu/pde_spherical.py``).

Deprecated ``solve_spherical``/``solve_spherical_system`` wrappers around
:class:`~neurodiffeq_tpu_torch.solvers.SolverSpherical` (including the
harmonics ``enforcer``), plus deprecated class aliases.
"""
import warnings

from .function_basis import RealSphericalHarmonics  # noqa: F401 (re-exported for parity)
from .networks import FCNN  # noqa: F401
from ._version_utils import warn_deprecate_class
from .generators import Generator3D, GeneratorSpherical
from .conditions import NoCondition
from .conditions import DirichletBVPSpherical as _DirichletBVPSpherical
from .conditions import InfDirichletBVPSpherical as _InfDirichletBVPSpherical
from .conditions import DirichletBVPSphericalBasis, InfDirichletBVPSphericalBasis
from .solvers import SolverSpherical
from .monitors import MonitorSpherical, MonitorSphericalHarmonics  # noqa: F401
from .ode import _INTERNALS

# generators defined in this module have been moved to generators.py (and renamed)
ExampleGenerator3D = warn_deprecate_class(Generator3D)
ExampleGeneratorSpherical = warn_deprecate_class(GeneratorSpherical)

# conditions defined in this module have been moved to conditions.py (and renamed)
NoConditionSpherical = warn_deprecate_class(NoCondition)
NoConditionSphericalHarmonics = warn_deprecate_class(NoCondition)
DirichletBVPSpherical = warn_deprecate_class(_DirichletBVPSpherical)
DirichletBVPSphericalHarmonics = warn_deprecate_class(DirichletBVPSphericalBasis)
InfDirichletBVPSpherical = warn_deprecate_class(_InfDirichletBVPSpherical)
InfDirichletBVPSphericalHarmonics = warn_deprecate_class(InfDirichletBVPSphericalBasis)

# old solver name is deprecated
SphericalSolver = warn_deprecate_class(SolverSpherical)


def solve_spherical(
        pde, condition, r_min=None, r_max=None,
        net=None, train_generator=None, valid_generator=None, analytic_solution=None,
        optimizer=None, criterion=None, max_epochs=1000,
        monitor=None, return_internal=False, return_best=False, harmonics_fn=None,
        batch_size=None, shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve one PDE with spherical
    inputs (use :class:`~neurodiffeq_tpu_torch.solvers.SolverSpherical` instead).

    :return: ``(solution, metrics_history[, internals])``.
    """
    warnings.warn("solve_spherical is deprecated, consider using SolverSpherical instead", FutureWarning)
    pde_system = lambda u, r, theta, phi: [pde(u, r, theta, phi)]  # noqa: E731
    conditions = [condition]
    nets = [net] if net is not None else None
    if analytic_solution is None:
        analytic_solutions = None
    else:
        analytic_solutions = lambda r, theta, phi: [analytic_solution(r, theta, phi)]  # noqa: E731

    return solve_spherical_system(
        pde_system=pde_system, conditions=conditions, r_min=r_min, r_max=r_max,
        nets=nets, train_generator=train_generator, shuffle=shuffle, valid_generator=valid_generator,
        analytic_solutions=analytic_solutions, optimizer=optimizer, criterion=criterion,
        batch_size=batch_size, max_epochs=max_epochs, monitor=monitor,
        return_internal=return_internal, return_best=return_best, harmonics_fn=harmonics_fn,
    )


def solve_spherical_system(
        pde_system, conditions, r_min=None, r_max=None,
        nets=None, train_generator=None, valid_generator=None, analytic_solutions=None,
        optimizer=None, criterion=None, max_epochs=1000, monitor=None, return_internal=False,
        return_best=False, harmonics_fn=None, batch_size=None, shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve a PDE system with
    spherical inputs (use :class:`~neurodiffeq_tpu_torch.solvers.SolverSpherical`).

    When ``harmonics_fn`` is given, networks consume only the radius and their
    outputs are expanded against the angular basis via a custom enforcer
    ``enforcer(net, cond, coords)`` (reference ``pde_spherical.py:249-254``).

    :return: ``(solution, metrics_history[, internals])``.
    """
    warnings.warn("solve_spherical_system is deprecated, consider using SolverSpherical instead", FutureWarning)

    if harmonics_fn is None:
        def enforcer(net, cond, points):
            return cond.enforce(net, *points)
    else:
        def enforcer(net, cond, points):
            products = cond.enforce(net, points[0]) * harmonics_fn(*points[1:])
            return products.sum(axis=1, keepdims=True)

    solver = SolverSpherical(
        pde_system=pde_system,
        conditions=conditions,
        r_min=r_min,
        r_max=r_max,
        nets=nets,
        train_generator=train_generator,
        valid_generator=valid_generator,
        analytic_solutions=analytic_solutions,
        optimizer=optimizer,
        loss_fn=criterion,
        n_batches_train=1,
        n_batches_valid=1,
        enforcer=enforcer,
        batch_size=batch_size,
        shuffle=shuffle,
    )

    solver.fit(max_epochs=max_epochs, monitor=monitor)
    solution = solver.get_solution(copy=True, best=return_best, harmonics_fn=harmonics_fn)
    ret = (solution, solver.metrics_history)
    if return_internal:
        ret = ret + (solver.get_internals(_INTERNALS, return_type='dict'),)
    return ret
