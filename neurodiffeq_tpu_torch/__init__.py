r"""neurodiffeq_tpu_torch: the PyTorch / CUDA port of ``neurodiffeq_tpu``.

A second package beside the JAX one, with the same module names. It covers
the 2-D Laplace, ODE, solution-bundle, spherical, cavity and time-dependent
1-D (heat, Burgers) training paths so far: the ``Field``/``diff`` layer,
with its batched Taylor engine at any order (mixed partials by
polarization) and the per-sample compose fallback (repeated
``torch.autograd.grad``) for fields without a Taylor rule, ``pin`` and
``eval_mode``; the networks (``FCNN``, ``Resnet``, ``FourierFCNN``,
``SIREN``, ``MonomialNN`` and their activations), the generators
(``Generator1D``/``2D``/``3D``/``Spherical``, the ``+``/``*``/``^``
combinators, the Transform, Filter, Resample, Batch and Sampler wrappers
and residual-adaptive sampling), the 1-D, bundle, ``DirichletBVP2D``,
``IBVP1D``, ``DoubleEndedBVP1D`` and spherical conditions, the cartesian,
spherical and cylindrical operators, the function bases, the loss registry,
the callbacks, ``Solver1D``/``BundleSolver1D``/``Solver2D``/
``SolverSpherical``/``GenericSolver`` with
``fit(max_epochs, callbacks, tqdm_file, profile_dir, pipeline)``, save,
load and resume (``solvers_utils``), the monitors, the checkpoint,
monitor, TensorBoard and residual-weight callbacks, solution export
through ``torch.export``, the hypersolver, the penalty-boundary
``temporal`` subsystem and the legacy v1 APIs: ``ode`` (``solve``,
``solve_system``), ``pde`` (``solve2D``, ``solve2D_system``,
``make_animation`` and MacFall's thin-plate-spline boundaries on irregular
domains, ``CustomBoundaryCondition``) and ``pde_spherical``
(``solve_spherical``, ``solve_spherical_system``); and data parallelism
over the collocation points with an optional ``'model'`` axis of Megatron
tensor parallelism over hidden units (``parallel``: ``make_mesh`` and
``mesh=`` on every solver, one process per rank). The fused Taylor-mode
FCNN runs as hand-written CUDA kernels for Hopper (``csrc/taylor_mlp.cu``;
on coordinates, and on the input Taylor streams of a split net's later
layer pairs) on CUDA tensors and as their plain PyTorch twins on CPU
tensors. The package imports ``torch`` and never ``jax``; matplotlib,
dill, requests and tensorboard are imported at first use.
"""
import sys as _sys
import warnings as _warnings

# as the JAX package does, always show deprecation warnings
_warnings.simplefilter('always', FutureWarning)

from . import utils
from . import fields
from . import networks
from . import generators
from . import conditions
from . import operators
from . import function_basis
from . import losses
from . import solvers
from . import solvers_utils
from . import monitors
from . import callbacks
from . import hypersolver
from . import temporal
from . import ode
from . import pde
from . import pde_spherical
from . import parallel

from .fields import diff, safe_diff, unsafe_diff

# the reference names the module of its diff primitive `neurodiffeq.neurodiffeq`;
# here, as in the JAX package, that module is `fields`
_sys.modules[__name__ + '.neurodiffeq'] = fields
neurodiffeq = fields

__version__ = '0.1.0'

__all__ = ['diff', 'safe_diff', 'unsafe_diff', 'neurodiffeq', 'utils', 'fields', 'networks', 'generators', 'conditions', 'operators',
           'function_basis', 'losses', 'solvers', 'solvers_utils', 'monitors', 'callbacks', 'hypersolver', 'temporal', 'ode', 'pde', 'pde_spherical',
           'parallel']
