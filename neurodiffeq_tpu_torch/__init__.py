r"""neurodiffeq_tpu_torch: the PyTorch / CUDA port of ``neurodiffeq_tpu``.

A second package beside the JAX one, with the same module names. It covers
the 2-D Laplace, ODE, solution-bundle, spherical and cavity training paths
so far: the ``Field``/``diff`` layer and its batched Taylor engine (orders
<= 2, mixed partials by polarization), the networks (``FCNN``, ``Resnet``,
``FourierFCNN``, ``SIREN``, ``MonomialNN`` and their activations), the
generators (``Generator1D``/``2D``/``3D``/``Spherical``, the ``+``/``*``/``^``
combinators and the Transform, Filter, Resample, Batch and Sampler
wrappers), the 1-D, bundle, ``DirichletBVP2D`` and spherical conditions,
the cartesian, spherical and cylindrical operators, the function bases,
the loss registry, the callbacks, ``Solver1D``/``BundleSolver1D``/
``Solver2D``/``SolverSpherical``/``GenericSolver`` with
``fit(max_epochs, callbacks, tqdm_file)``, and the hypersolver. The fused
Taylor-mode FCNN runs as a hand-written CUDA kernel for Hopper
(``csrc/taylor_mlp.cu``) on CUDA tensors and as its plain PyTorch twin on
CPU tensors. The package imports ``torch`` and never ``jax``.
"""
from . import utils
from . import fields
from . import networks
from . import generators
from . import conditions
from . import operators
from . import function_basis
from . import losses
from . import solvers
from . import callbacks
from . import hypersolver

from .fields import diff

__version__ = '0.1.0'

__all__ = ['diff', 'utils', 'fields', 'networks', 'generators', 'conditions', 'operators',
           'function_basis', 'losses', 'solvers', 'callbacks', 'hypersolver']
