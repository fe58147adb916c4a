"""The port's data parallelism on the card (``cuda``-marked: they skip
without a GPU). Run them on the GPU machine with ``python -m pytest
--noconftest tests/test_torch_parallel_cuda.py -m cuda`` (``--noconftest``:
that machine has no JAX, and ``tests/conftest.py`` imports it; this file
imports none).

The flagship at full width (FCNN 2-512-1 tanh, 32 x 32, float32) through
``taylor_mlp_1h``: a mesh of one NCCL rank must give the unsharded run's
first epoch bit for bit, and two gloo ranks on ``cuda:0`` its first-epoch
loss and gradients to 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from neurodiffeq_tpu_torch.parallel import launch


def _unsharded():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    return R.cuda_case(None, None, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.cuda
def test_one_nccl_rank_is_the_unsharded_run_bitwise(tmp_path):
    loss, grads = _unsharded()
    (got_loss, got_grads), = launch(R.cuda_case, 1, backend='nccl', device_type='cuda', timeout=300,
                                    args=('nccl', None, 1), rendezvous=str(tmp_path / 'rendezvous'))
    assert got_loss == loss
    assert all(np.array_equal(g, w) for g, w in zip(got_grads, grads))


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_hold_the_first_epoch(tmp_path):
    loss, grads = _unsharded()
    ranks = launch(R.cuda_case, 2, backend='gloo', device_type='cuda', timeout=300, args=('gloo', 'cuda:0', 1),
                   rendezvous=str(tmp_path / 'rendezvous'))
    for got_loss, got_grads in ranks:
        assert _rel(got_loss, loss) < 1e-5
        assert max(_rel(g, w) for g, w in zip(got_grads, grads)) < 1e-5
