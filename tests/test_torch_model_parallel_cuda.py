"""The stream-input Taylor-MLP kernel entry on the card (``cuda``-marked:
they skip without a GPU). Run them on the GPU machine with ``python -m
pytest --noconftest tests/test_torch_model_parallel_cuda.py -m cuda``
(``--noconftest``: that machine has no JAX, and ``tests/conftest.py``
imports it; this file imports none).

``taylor_mlp_streams`` at the shape of one model rank's slice of the
primitive cavity's second layer pair (128 -> 64 -> 128 on order-2 streams
of 2 directions, tanh, the input activation inside) against its twin: 1e-4
relative in float32 (the kernel sums in another order than cuBLAS), 1e-10
in float64, and two launches bitwise equal. And ``launch(fn, 4)`` under
gloo: four ranks on one card form a (2, 2) ``(points, model)`` mesh whose
pass goes through both kernel entries and holds the unsharded loss and
gradients (float64, 1e-10 relative).
"""
import numpy as np
import pytest
import torch

import torch_model_parallel_ranks as M
from neurodiffeq_tpu_torch.ops import taylor_mlp as T
from neurodiffeq_tpu_torch.parallel import launch


def _inputs(dtype):
    g = torch.Generator().manual_seed(0)
    streams = torch.rand(5, 2048, 128, generator=g, dtype=torch.float64) * 2 - 1
    layers = [((torch.rand(a, b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5,
               (torch.rand(b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5)
              for a, b in ((128, 64), (64, 128))]
    return streams.to('cuda', dtype), [(W.to('cuda', dtype), b.to('cuda', dtype)) for W, b in layers]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4), (torch.float64, 1e-10)])
def test_stream_entry_matches_its_twin_bitwise_repeatably(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    streams, layers = _inputs(dtype)
    with torch.no_grad():
        before = T.LAUNCHES['taylor_mlp_streams']
        got = T.fcnn_taylor_streams(streams, layers, 2, 'tanh', 'tanh')
        again = T.fcnn_taylor_streams(streams, layers, 2, 'tanh', 'tanh')
        want = T.fcnn_taylor_streams_reference(streams, layers, 2, 'tanh', 'tanh')
        torch.cuda.synchronize()
    assert T.LAUNCHES['taylor_mlp_streams'] == before + 2
    for a, b, w in zip(got, again, want, strict=True):
        assert torch.equal(a, b)
        assert ((a - w).abs().max() / w.abs().max()).item() <= tol


@pytest.mark.cuda
def test_four_gloo_ranks_on_one_card_form_a_2x2_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    _, _, loss, grads, _ = M.cuda_case(None)
    ranks = launch(M.cuda_case, 4, backend='gloo', device_type='cuda', timeout=300, args=(2,),
                   rendezvous=str(tmp_path / 'rendezvous'))
    assert [r[:2] for r in ranks] == [('cuda:0', (p, q)) for p in range(2) for q in range(2)]
    for _, _, got_loss, got_grads, launches in ranks:
        assert launches == {'taylor_mlp_1h': 1, 'taylor_mlp': 0, 'taylor_mlp_streams': 1}
        np.testing.assert_allclose(got_loss, loss, rtol=1e-10)
        for g, w in zip(got_grads, grads, strict=True):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)
