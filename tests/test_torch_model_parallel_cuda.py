"""The stream-input Taylor-MLP kernel entry on the card (``cuda``-marked:
they skip without a GPU). Run them on the GPU machine with ``python -m
pytest --noconftest tests/test_torch_model_parallel_cuda.py -m cuda``
(``--noconftest``: that machine has no JAX, and ``tests/conftest.py``
imports it; this file imports none).

``taylor_mlp_streams`` at the shape of one model rank's slice of the
primitive cavity's second layer pair (128 -> 64 -> 128 on order-2 streams
of 2 directions, tanh, the input activation inside) against its twin: 1e-4
relative in float32 (the kernel sums in another order than cuBLAS), 1e-10
in float64, and two launches bitwise equal. The same for each design,
the tensor-core kernel with its weights resident wherever they fit and
the staged instance everywhere, and for the planner's pick: at both of
the cavity's stream pairs (-> 128 and -> 3) at a ragged N = 16,383; with
7 streams, where float32 takes one raw input buffer; at widths whose rows
are no multiple of 16 bytes (the input streams copied element by
element); at a single layer; and at a shape whose weights do not fit
shared memory in either type. NaNs in the input streams and in a weight
come out where the twin's do. And ``launch(fn, 4)`` under gloo: four ranks on one card form a (2, 2) ``(points, model)`` mesh whose
pass goes through both kernel entries and holds the unsharded loss and
gradients (float64, 1e-10 relative); two ranks on one card form a (1, 2)
mesh whose pass, after ``disable_pallas()``, raises on each rank as it
does unsharded, launching nothing (the card launches the kernels or
raises); two ranks on one card form a (1, 2) mesh on which each stores its
blocks of the split leaves, trains on the unsharded trajectory, saves a full-size file that loads without a mesh
and onto it, and resumes from it as it would have gone on; and one epoch
of ``torch.optim.LBFGS`` (strong Wolfe) on such a mesh makes the unsharded
epoch's closure calls and lands on its parameters (float64, 1e-9
relative).
"""
import numpy as np
import pytest
import torch

import torch_model_parallel_ranks as M
from neurodiffeq_tpu_torch.ops import taylor_mlp as T
from neurodiffeq_tpu_torch.parallel import launch


def _inputs(dtype, dims=(128, 64, 128), n=2048, d=2, order=2):
    g = torch.Generator().manual_seed(0)
    streams = torch.rand(1 + order * d, n, dims[0], generator=g, dtype=torch.float64) * 2 - 1
    layers = [((torch.rand(a, b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5,
               (torch.rand(b, generator=g, dtype=torch.float64) * 2 - 1) / a ** 0.5)
              for a, b in zip(dims[:-1], dims[1:])]
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


# (widths, N, d, order, input activation) of the stream designs' checks
STREAM_CASES = [
    ((128, 64, 128), 16383, 2, 2, 'tanh'),  # the cavity's pair 1 on one of 2 model ranks, ragged
    ((128, 64, 3), 16383, 2, 2, 'tanh'),    # its pair 2
    ((128, 64, 128), 4097, 3, 2, 'tanh'),   # S = 7: one raw input buffer in float32 (two pass shared memory)
    ((3, 20, 5), 1001, 3, 2, 'sin'),        # 12- and 24-byte rows: element copies; 20 hidden units
    ((6, 40, 24, 7), 300, 10, 1, None),     # order 1, two direction chunks, 2 middle layers
    ((32, 1), 1024, 2, 2, 'tanh'),          # the default FCNN's trailing layer: a single layer
    ((2800, 64, 1), 300, 2, 2, 'tanh'),     # weights past shared memory
]
DTYPES = {torch.float32: 1e-4, torch.float64: 1e-10}


def _fits(dims, d, order, dtype):
    try:
        T._plan_streams(1, d, dims, order, torch.finfo(dtype).bits // 8, 132, 'resident')
    except ValueError:
        return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize('dtype,dims,n,d,order,input_actv,design', [
    (dtype, *case, design) for dtype in DTYPES for case in STREAM_CASES for design in (None, 'resident', 'staged')
    if design != 'resident' or _fits(case[0], case[2], case[3], dtype)])
def test_stream_designs_match_the_twin_bitwise_repeatably(dtype, dims, n, d, order, input_actv, design):
    """Each design (None: the one the planner picks, and counts) against
    the twin at every case where it fits, two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    plan = T._plan_streams(n, d, dims, order, torch.finfo(dtype).bits // 8, T._sm_count(0), design)
    if dims == (128, 64, 128) and d == 3 and dtype == torch.float32 and design != 'staged':
        assert plan.design == 'resident' and plan.buffers == 1
    streams, layers = _inputs(dtype, dims, n, d, order)
    with torch.no_grad():
        T.reset_launches()
        got = T._launch_streams(streams, layers, order, 'tanh', input_actv, design)
        again = T._launch_streams(streams, layers, order, 'tanh', input_actv, design)
        want = T._streams_stacked_reference(streams, layers, order, 'tanh', input_actv)
        torch.cuda.synchronize()
    assert T.LAUNCHES['taylor_mlp_streams'] == T.STREAM_DESIGNS[plan.design] == 2
    assert got.shape == want.shape and torch.equal(got, again)
    assert ((got - want).abs().max() / want.abs().max()).item() <= DTYPES[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('design', ['resident', 'staged'])
@pytest.mark.parametrize('input_actv', [None, 'tanh'])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_nans_come_out_where_the_twins_do(dtype, input_actv, design):
    """A NaN in the input streams (a first-order coefficient of one point)
    and one in the output layer's weights come out as NaN where the twin's
    do, through the input activation, a middle layer's chain rule and the
    products (the float32 products round by integer arithmetic, which must
    keep a NaN one), and every other value as the twin's."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    streams, layers = _inputs(dtype, (32, 40, 24), 300, 2, 2)
    streams[1, 7, 5] = float('nan')
    layers[-1][0][10, 3] = float('nan')
    with torch.no_grad():
        got = T._launch_streams(streams, layers, 2, 'tanh', input_actv, design)
        want = T._streams_stacked_reference(streams, layers, 2, 'tanh', input_actv)
        torch.cuda.synchronize()
    nan = want.isnan()
    assert nan[:, :, 3].all() and nan[1, 7].all() and not nan[0, 7, 0]
    assert torch.equal(got.isnan(), nan)
    assert ((got - want)[~nan].abs().max() / want[~nan].abs().max()).item() <= DTYPES[dtype]


@pytest.mark.cuda
def test_four_gloo_ranks_on_one_card_form_a_2x2_mesh(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    _, _, loss, grads, _ = M.cuda_case(None)
    ranks = launch(M.cuda_case, 4, backend='gloo', device_type='cuda', timeout=300, args=(2,),
                   rendezvous=str(tmp_path / 'rendezvous'))
    assert [r[:2] for r in ranks] == [('cuda:0', (p, q)) for p in range(2) for q in range(2)]
    for _, _, got_loss, got_grads, launches in ranks:
        assert launches == {'taylor_mlp_1h': 1, 'taylor_mlp': 0, 'taylor_mlp_streams': 1, 'taylor_mlp_1h_bwd': 1}
        np.testing.assert_allclose(got_loss, loss, rtol=1e-10)
        for g, w in zip(got_grads, grads, strict=True):
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_disabled_kernels_on_a_1x2_mesh_of_one_card_raise(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    none = {'taylor_mlp_1h': 0, 'taylor_mlp': 0, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}
    _, message, launches = M.cuda_disabled_case(None)
    assert 'disable_pallas()' in message and launches == none
    ranks = launch(M.cuda_disabled_case, 2, backend='gloo', device_type='cuda', timeout=300, args=(2,),
                   rendezvous=str(tmp_path / 'rendezvous'))
    assert ranks == [((0, q), message, none) for q in range(2)]


@pytest.mark.cuda
def test_two_gloo_ranks_on_one_card_store_blocks_and_save_full_size(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    from neurodiffeq_tpu_torch.solvers import Solver1D

    want = M.cuda_store_case(None, str(tmp_path))
    ranks = launch(M.cuda_store_case, 2, backend='gloo', device_type='cuda', timeout=300, args=(2, str(tmp_path)),
                   rendezvous=str(tmp_path / 'rendezvous'))
    full = [(32, 1), (32,), (32, 32), (32,), (1, 32), (1,)]
    assert want['shapes'] == full
    # even layers keep half their output units and biases, odd layers half their input units
    assert all(r['shapes'] == [(16, 1), (16,), (32, 16), (32,), (1, 32), (1,)] for r in ranks)
    for r in ranks:
        for got, ref in zip(r['params'] + list(r['solution']), want['params'] + list(want['solution']), strict=True):
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
        went_on, resumed = r['resumed']
        for a, b in zip(went_on, resumed, strict=True):
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12)
    state = torch.load(ranks[0]['path'], weights_only=True)['state']
    assert [tuple(v.shape) for v in state['nets'][0].values()] == full
    here = Solver1D.load(ranks[0]['path'], config=M.solver_config())
    assert here.mesh is None
    for got, ref in zip(M.full_params(here), ranks[0]['params'], strict=True):
        assert np.array_equal(got, ref)
    here.fit(1, tqdm_file=None)
    for got, ref in zip(M.full_params(here), ranks[0]['resumed'][0], strict=True):
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_lbfgs_epoch_on_two_gloo_ranks_of_one_card_is_unsharded(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (runs on the GPU machine)')
    want, want_calls = M.cuda_lbfgs_case(None)
    ranks = launch(M.cuda_lbfgs_case, 2, backend='gloo', device_type='cuda', timeout=300, args=(2,),
                   rendezvous=str(tmp_path / 'rendezvous'))
    assert want_calls > 1
    for params, calls in ranks:
        assert calls == want_calls
        for got, ref in zip(params, want, strict=True):
            np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)
