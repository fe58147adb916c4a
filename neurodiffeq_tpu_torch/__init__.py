r"""neurodiffeq_tpu_torch: the PyTorch / CUDA port of ``neurodiffeq_tpu``.

A second package beside the JAX one, with the same module names. It covers
the 2-D Laplace training path so far: the ``Field``/``diff`` layer and its
batched Taylor engine (orders <= 2), ``FCNN``, ``Generator2D``,
``DirichletBVP2D``, the ``l2`` loss and ``Solver2D``. The fused Taylor-mode
FCNN runs as a hand-written CUDA kernel for Hopper
(``csrc/taylor_mlp.cu``) on CUDA tensors and as its plain PyTorch twin on
CPU tensors. The package imports ``torch`` and never ``jax``.
"""
from . import utils
from . import fields
from . import networks
from . import generators
from . import conditions
from . import losses
from . import solvers

from .fields import diff

__version__ = '0.1.0'

__all__ = ['diff', 'utils', 'fields', 'networks', 'generators', 'conditions', 'losses', 'solvers']
