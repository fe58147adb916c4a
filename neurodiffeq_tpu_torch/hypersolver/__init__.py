r"""Hypersolver subpackage: neural-corrected numerical ODE integrators
(counterpart of ``neurodiffeq_tpu/hypersolver/``)."""
from .hypersolver import Hypersolver, DiscreteSolution1D
from .numerical_solvers import NumericalSolver, Euler, Heun, RK4

__all__ = ['Hypersolver', 'DiscreteSolution1D', 'NumericalSolver', 'Euler', 'Heun', 'RK4']
