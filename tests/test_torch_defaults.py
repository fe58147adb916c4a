"""The PyTorch port's default device: the card, with no quiet fallback.

Nets, generators and solvers built without a ``device`` go to ``cuda``; a
caller without a GPU asks for the CPU with ``set_tensor_type('cpu')`` or
``device='cpu'``. Each test restores the defaults it found.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neurodiffeq_tpu_torch import fields as F, diff
from neurodiffeq_tpu_torch.conditions import DirichletBVP2D, DirichletBVPSpherical, DirichletBVPSphericalBasis
from neurodiffeq_tpu_torch.generators import Generator2D, GeneratorSpherical
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.operators import spherical_laplacian
from neurodiffeq_tpu_torch.solvers import Solver2D, SolverSpherical
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, resolve, set_tensor_type

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
CPU = torch.device('cpu')


@pytest.fixture(autouse=True)
def _restore_defaults():
    device, dtype = get_default_device(), get_default_dtype()
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _laplace(**kwargs):
    cond = DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                          y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x), y_max=1.0, y_max_val=lambda x: 0 * x)
    return Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)], conditions=[cond],
                    xy_min=(0.0, 0.0), xy_max=(1.0, 1.0), **kwargs)


def _devices(solver):
    """Devices of the solver, its nets' parameters and a batch of each generator."""
    points = [t for g in solver.generator.values() for t in g.get_examples()]
    return ({solver.device} | {p.device for net in solver.nets for p in net.parameters()}
            | {t.device for t in points})


def test_fresh_default_is_cuda_without_fallback():
    """In a fresh process the default is ``cuda`` and importing makes no CUDA
    context; without a card, building a net or drawing points with no device
    raises torch's own error instead of landing on the CPU."""
    code = (
        "import torch\n"
        "from neurodiffeq_tpu_torch.utils import get_default_device\n"
        "from neurodiffeq_tpu_torch.networks import FCNN\n"
        "from neurodiffeq_tpu_torch.generators import Generator2D\n"
        "print('default', get_default_device())\n"
        "print('cuda initialized', torch.cuda.is_initialized())\n"
        "if not torch.cuda.is_available():\n"
        "    for make in (lambda: FCNN(2, 1, hidden_units=(4,)),\n"
        "                 lambda: Generator2D((4, 4), (0, 0), (1, 1)).get_examples()):\n"
        "        try:\n"
        "            make()\n"
        "        except (AssertionError, RuntimeError):\n"
        "            print('raised')\n"
        "        else:\n"
        "            print('built on the CPU')\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[:2] == ['default cuda', 'cuda initialized False']
    if not torch.cuda.is_available():
        assert lines[2:] == ['raised', 'raised']


def test_set_tensor_type_cpu_routes_net_generator_and_solver():
    set_tensor_type('cpu')
    assert get_default_device() == CPU and get_default_dtype() == torch.float32
    net = FCNN(2, 1, hidden_units=(4,))
    assert {p.device for p in net.parameters()} == {CPU}
    gen = Generator2D((4, 4), (0, 0), (1, 1))
    assert gen.device == CPU and {t.device for t in gen.get_examples()} == {CPU}
    solver = _laplace(nets=[net], n_batches_valid=1)
    assert _devices(solver) == {CPU}
    solver.fit(2)
    assert len(solver.metrics_history['train_loss']) == 2

    set_tensor_type('cpu', float_bits=64)
    solver = _laplace()  # every default: net, generators, device, dtype
    assert _devices(solver) == {CPU}
    assert {p.dtype for p in solver.nets[0].parameters()} == {torch.float64}


def test_explicit_cpu_device_overrides_the_cuda_default():
    set_tensor_type('cuda')
    assert resolve() == (torch.device('cuda'), torch.float32)
    assert resolve('cpu', torch.float64) == (CPU, torch.float64)
    assert {p.device for p in FCNN(2, 1, hidden_units=(4,), device='cpu').parameters()} == {CPU}
    gen = Generator2D((4, 4), (0, 0), (1, 1), device='cpu')
    assert {t.device for t in gen.get_examples()} == {CPU}
    assert _devices(_laplace(device='cpu')) == {CPU}


def test_spherical_entry_points_default_to_cuda():
    """``GeneratorSpherical``, ``SolverSpherical`` and the basis conditions'
    coefficients built without a device go to the card; without one they
    raise instead of landing on the CPU."""
    set_tensor_type('cuda')
    gen = GeneratorSpherical(8, 0.1, 1.0)
    assert gen.device.type == 'cuda'
    makes = [lambda: SolverSpherical(lambda u, r, th, ph: spherical_laplacian(u, r, th, ph),
                                     [DirichletBVPSpherical(0.1, lambda th, ph: 0 * th)], 0.1, 1.0),
             lambda: DirichletBVPSphericalBasis(0.1, [1.0, 2.0]).R_0,
             gen.get_examples]
    if not torch.cuda.is_available():
        for make in makes:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
        return
    solver, coefficients, points = (make() for make in makes)
    assert {d.type for d in _devices(solver)} == {'cuda'}
    assert coefficients.device.type == 'cuda' and {t.device.type for t in points} == {'cuda'}
