"""The PyTorch port's fused Taylor-MLP module against the JAX package.

The plain twin ``fcnn_taylor_reference`` is held against ``_pure_jax_taylor``
and against the Pallas kernel run in interpret mode, in float64, on the same
numpy inputs. Tolerance: 1e-12 relative to the largest entry of each output
(both sides do the same float64 arithmetic in other summation orders). The
CUDA kernel itself is held against the twin by the ``cuda`` test below,
which skips without a GPU. The GPU machine has no JAX, so the JAX side is
imported inside the tests that use it; there the ``cuda`` tests run with
``python -m pytest --noconftest tests/test_torch_taylor_mlp.py -m cuda``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import torch

from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.ops.taylor_mlp import fcnn_taylor, fcnn_taylor_reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12

# (layer widths, activation, order): the chip check's shapes at small widths
CASES = [
    ((2, 32, 1), 'tanh', 2),
    ((2, 16, 16, 1), 'tanh', 2),
    ((2, 16, 16, 1), 'tanh', 1),
    ((1, 16, 16, 1), 'sin', 1),
    ((1, 16, 16, 1), 'sin', 2),
    ((3, 16, 2), 'tanh', 2),
    ((3, 8, 8, 8, 2), 'sin', 2),
    ((2, 1), 'tanh', 2),
    ((2, 1), 'tanh', 1),
]


def _inputs(dims, n=37, seed=0):
    rng = np.random.RandomState(seed)
    layers = [(rng.uniform(-1, 1, (a, b)) / np.sqrt(a), rng.uniform(-1, 1, (b,)) / np.sqrt(a))
              for a, b in zip(dims[:-1], dims[1:])]
    return rng.rand(n, dims[0]), layers


def _jax():
    """The JAX reference: ``(jax, jnp, _pure_jax_taylor, fcnn_taylor_pallas)``."""
    jax = pytest.importorskip('jax')
    from neurodiffeq_tpu.ops.pallas_mlp import _pure_jax_taylor, fcnn_taylor_pallas
    return jax, jax.numpy, _pure_jax_taylor, fcnn_taylor_pallas


def _jax_flat(layers):
    jnp = _jax()[1]
    return tuple(jnp.asarray(x) for W, b in layers for x in (W, b))


def _torch_layers(layers, requires_grad=False):
    return [(torch.tensor(W, requires_grad=requires_grad), torch.tensor(b, requires_grad=requires_grad))
            for W, b in layers]


def _assert_close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.mark.parametrize('dims,actv,order', CASES)
def test_reference_matches_pure_jax_and_pallas(dims, actv, order):
    _, jnp, _pure_jax_taylor, fcnn_taylor_pallas = _jax()
    pts, layers = _inputs(dims)
    d = dims[0]
    want = _pure_jax_taylor(jnp.asarray(pts), _jax_flat(layers), len(layers), order, d, actv)
    pallas = fcnn_taylor_pallas(jnp.asarray(pts), [{'W': jnp.asarray(W), 'b': jnp.asarray(b)}
                                                   for W, b in layers],
                                order, d, interpret=True, actv=actv)
    got = fcnn_taylor_reference(torch.tensor(pts), _torch_layers(layers), order, actv)
    assert len(got) == len(want) == len(pallas) == order + 1
    for g, w, p in zip(got, want, pallas):
        assert g.dtype == torch.float64
        _assert_close(g, w)
        _assert_close(g, p)


def test_cpu_entry_is_the_reference():
    pts, layers = _inputs((2, 16, 1))
    launches = taylor_mlp.LAUNCHES
    a = fcnn_taylor(torch.tensor(pts), _torch_layers(layers), 2)
    b = fcnn_taylor_reference(torch.tensor(pts), _torch_layers(layers), 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert taylor_mlp.LAUNCHES == launches  # the CPU path launches no kernel


def _cotangents(outs, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randn(*np.shape(o)) for o in outs]


@pytest.mark.parametrize('dims,actv', [((2, 32, 1), 'tanh'), ((2, 16, 16, 1), 'sin'), ((3, 8, 2), 'tanh')])
def test_gradients_match_jax_vjp(dims, actv):
    jax, jnp, _pure_jax_taylor, _ = _jax()
    pts, layers = _inputs(dims, n=20)
    d, order = dims[0], 2
    outs, vjp = jax.vjp(lambda p, fp: _pure_jax_taylor(p, fp, len(layers), order, d, actv),
                        jnp.asarray(pts), _jax_flat(layers))
    cts = _cotangents(outs)
    d_pts, d_flat = vjp(tuple(jnp.asarray(c) for c in cts))

    t_pts = torch.tensor(pts, requires_grad=True)
    t_layers = _torch_layers(layers, requires_grad=True)
    t_outs = fcnn_taylor_reference(t_pts, t_layers, order, actv)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(t_outs, cts))
    grads = torch.autograd.grad(loss, [t_pts] + [x for W, b in t_layers for x in (W, b)])
    _assert_close(grads[0], d_pts)
    for g, w in zip(grads[1:], d_flat):
        _assert_close(g, w)


def test_autograd_function_backward_is_the_twin(monkeypatch):
    """``_TaylorMLPFn`` with the kernel launch stood in for by the twin: its
    rematerialized backward must give the twin's own autograd gradients,
    with ``None`` where an input needs none."""
    monkeypatch.setattr(taylor_mlp, '_launch', lambda p, layers, order, actv: tuple(
        o.detach().contiguous() for o in fcnn_taylor_reference(p, layers, order, actv)))
    pts, layers = _inputs((2, 16, 16, 1), n=20)
    cts = [torch.tensor(c) for c in _cotangents([np.zeros((20, 1)), np.zeros((2, 20, 1)),
                                                  np.zeros((2, 20, 1))])]

    def grads(fn, pts_grad):
        t_pts = torch.tensor(pts, requires_grad=pts_grad)
        t_layers = _torch_layers(layers, requires_grad=True)
        flat = [x for W, b in t_layers for x in (W, b)]
        outs = fn(t_pts, t_layers)
        loss = sum((o * c).sum() for o, c in zip(outs, cts))
        wrt = ([t_pts] if pts_grad else []) + flat
        return torch.autograd.grad(loss, wrt)

    via_fn = lambda p, ls: taylor_mlp._TaylorMLPFn.apply(p, 2, 'tanh', *[x for W, b in ls for x in (W, b)])
    via_twin = lambda p, ls: fcnn_taylor_reference(p, ls, 2, 'tanh')
    for pts_grad in (True, False):
        for g, w in zip(grads(via_fn, pts_grad), grads(via_twin, pts_grad)):
            assert torch.allclose(g, w, rtol=1e-13, atol=1e-15)


def test_unsupported_device_raises():
    pts, layers = _inputs((2, 8, 1))
    with pytest.raises(TypeError):
        fcnn_taylor(torch.tensor(pts, device='meta'),
                    [(W.to('meta'), b.to('meta')) for W, b in _torch_layers(layers)], 2)


def test_port_imports_without_nvcc_or_jax():
    """Importing the port builds nothing and needs no ``nvcc``; its sources
    never import jax."""
    code = (
        "import sys; import neurodiffeq_tpu_torch as p; "
        "from neurodiffeq_tpu_torch.ops import _build, taylor_mlp; "
        "assert _build._LIB is None and 'jax' not in sys.modules; "
        "import torch; from neurodiffeq_tpu_torch.networks import FCNN; "
        "print(FCNN(2, 1, hidden_units=(4,))(torch.zeros(3, 2)).shape)")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable), CUDA_HOME='/nonexistent')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert 'torch.Size([3, 1])' in out.stdout
    pattern = re.compile(r'^\s*(import jax|from jax)', re.M)
    for src in (REPO / 'neurodiffeq_tpu_torch').rglob('*.py'):
        assert not pattern.search(src.read_text()), src


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,rtol', [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize('dims,actv,order,n', [((2, 512, 1), 'tanh', 2, 1024),
                                               ((2, 64, 64, 1), 'tanh', 2, 1000),
                                               ((1, 32, 32, 1), 'sin', 1, 37),
                                               ((1, 32, 32, 1), 'sin', 2, 37),
                                               ((3, 16, 2), 'tanh', 2, 37),
                                               ((2, 1), 'tanh', 2, 37)])
def test_cuda_kernel_matches_reference(dims, actv, order, n, dtype, rtol):
    """Kernel against twin on the card. float32 tolerance: the kernel sums
    in another order than cuBLAS."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pts, layers = _inputs(dims, n=n)
    p = torch.tensor(pts, dtype=dtype, device='cuda')
    ls = [(torch.tensor(W, dtype=dtype, device='cuda'), torch.tensor(b, dtype=dtype, device='cuda'))
          for W, b in layers]
    launches = taylor_mlp.LAUNCHES
    got = fcnn_taylor(p, ls, order, actv)
    torch.cuda.synchronize()
    assert taylor_mlp.LAUNCHES == launches + 1
    want = fcnn_taylor_reference(p, ls, order, actv)
    for g, w in zip(got, want):
        _assert_close(g, w.cpu().numpy(), rtol=rtol)
