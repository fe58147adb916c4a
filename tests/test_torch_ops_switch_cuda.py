"""The kernel switch on the card (``cuda``-marked: they skip without a GPU).
Run them on the GPU machine with ``python -m pytest --noconftest
tests/test_torch_ops_switch_cuda.py -m cuda`` (``--noconftest``: that
machine has no JAX, and ``tests/conftest.py`` imports it; this file imports
none).

On the card the kernels launch or the call raises, whatever the switch
says. Under ``enable_pallas(interpret=True)`` each of the three fused
entries, ``fcnn_taylor``, ``fcnn_taylor_streams`` and
``fcnn_taylor_pallas``, raises on a CUDA tensor and launches nothing, as
``fcnn_taylor_pallas(..., interpret=True)`` does under the default switch;
with the switch back at its default the same calls launch their kernels
again. After ``disable_pallas()`` an FCNN's Taylor series on CUDA points
raises and launches nothing.
"""
import re

import pytest
import torch

from neurodiffeq_tpu_torch import ops
from neurodiffeq_tpu_torch.ops import taylor_mlp as T


@pytest.fixture(autouse=True)
def _switch_at_default():
    ops.enable_pallas()
    yield
    ops.enable_pallas()


def _layers(dims, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [(((torch.rand(a, b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5).to('cuda', dtype),
             ((torch.rand(b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5).to('cuda', dtype))
            for a, b in zip(dims[:-1], dims[1:])]


def _points(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(*shape, generator=g, dtype=torch.float64) * 2 - 1).to('cuda', dtype)


def _calls(entry, dtype):
    """(the entry's call, its twin's call, the kernel it launches) on the
    card: the flagship 2-512-1, the cavity 2-(128x5)-3, one model rank's
    slice of the cavity's pair 1 on streams, and the flagship through the
    JAX calling convention."""
    if entry == 'fcnn_taylor-flagship':
        pts, layers = _points((1024, 2), dtype), _layers((2, 512, 1), dtype)
        return (lambda: T.fcnn_taylor(pts, layers, 2), lambda: T.fcnn_taylor_reference(pts, layers, 2),
                'taylor_mlp_1h')
    if entry == 'fcnn_taylor-cavity':
        pts, layers = _points((1024, 2), dtype), _layers((2,) + (128,) * 5 + (3,), dtype)
        return (lambda: T.fcnn_taylor(pts, layers, 2), lambda: T.fcnn_taylor_reference(pts, layers, 2),
                'taylor_mlp')
    if entry == 'fcnn_taylor_streams':
        streams, layers = _points((5, 1024, 128), dtype), _layers((128, 64, 128), dtype)
        return (lambda: T.fcnn_taylor_streams(streams, layers, 2, 'tanh', 'tanh'),
                lambda: T.fcnn_taylor_streams_reference(streams, layers, 2, 'tanh', 'tanh'), 'taylor_mlp_streams')
    pts, layers = _points((1024, 2), dtype), _layers((2, 512, 1), dtype)
    params = [{'W': W, 'b': b} for W, b in layers]
    return (lambda: ops.fcnn_taylor_pallas(pts, params, 2, 2), lambda: T.fcnn_taylor_reference(pts, layers, 2),
            'taylor_mlp_1h')


ENTRIES = ['fcnn_taylor-flagship', 'fcnn_taylor-cavity', 'fcnn_taylor_streams', 'fcnn_taylor_pallas']
NONE = {'taylor_mlp_1h': 0, 'taylor_mlp': 0, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('entry', ENTRIES)
def test_interpreted_entry_raises_on_the_card_and_launches_nothing(entry, dtype):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    call, twin, kernel = _calls(entry, dtype)
    with torch.no_grad():
        want = twin()
        ops.enable_pallas(interpret=True)
        T.reset_launches()
        with pytest.raises(RuntimeError, match='interpret=True'):
            call()
        assert T.LAUNCHES == NONE
        ops.enable_pallas()
        got = call()
        torch.cuda.synchronize()
        assert T.LAUNCHES == {**NONE, kernel: 1}
        for g, w in zip(got, want, strict=True):
            assert g.is_cuda and g.shape == w.shape and torch.isfinite(g).all()


@pytest.mark.cuda
def test_interpret_argument_raises_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    pts, layers = _points((1024, 2), torch.float32), _layers((2, 512, 1), torch.float32)
    params = [{'W': W, 'b': b} for W, b in layers]
    with torch.no_grad():
        T.reset_launches()
        with pytest.raises(RuntimeError, match='fcnn_taylor_pallas: interpret=True'):
            ops.fcnn_taylor_pallas(pts, params, 2, 2, interpret=True)
        assert T.LAUNCHES == NONE
        for g, w in zip(ops.fcnn_taylor_pallas(pts, params, 2, 2, interpret=False), T.fcnn_taylor(pts, layers, 2),
                        strict=True):
            assert torch.equal(g, w)
        assert T.LAUNCHES == {**NONE, 'taylor_mlp_1h': 2}


@pytest.mark.cuda
@pytest.mark.parametrize('kind', ['fcnn', 'siren'])
def test_disabled_network_raises_on_the_card_and_launches_nothing(kind):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    from neurodiffeq_tpu_torch import diff, fields as F, networks as N
    from neurodiffeq_tpu_torch.conditions import NoCondition

    net = (N.FCNN if kind == 'fcnn' else N.SIREN)(2, 1, hidden_units=(32, 32), device='cuda', dtype=torch.float64)
    x, y = F.coords_from_points(_points((64, 2), torch.float64))
    u = NoCondition().enforce(net, x, y)
    T.reset_launches()
    ops.disable_pallas()
    with pytest.raises(RuntimeError, match=re.escape('disable_pallas()')):
        diff(u, x, 2).value
    assert T.LAUNCHES == NONE
    ops.enable_pallas()
    assert torch.isfinite(diff(u, x, 2).value).all()
    assert T.LAUNCHES['taylor_mlp'] > 0
