"""The PyTorch port's ``'model'`` mesh axis (Megatron tensor parallelism over
hidden units) against the JAX package, on the CPU.

The ranks are gloo processes started by the port's launcher
(``parallel.launch``): one group of 2 on a ``(1, 2)`` ``(points, model)``
mesh and one of 4 on ``(2, 2)``, each running a list of cases
(``tests/torch_model_parallel_ranks.py``, which imports no JAX) whose
results the parametrized tests read. The JAX side runs here, unsharded and
on its own ``(points, model)`` mesh of the same shape, on the 8-device
virtual mesh of ``tests/conftest.py``. The cases mirror
``tests/test_parallel.py:121-223``: the layout of ``megatron_param_shardings``,
the loss and every gradient (the second-order ODE, the flagship at 2-512-1,
a cavity-shaped 2-(16x5)-3 net with three layer pairs; a net whose widths
do not divide the axis and an order-3 ``h1`` loss, which run whole), one
epoch of gradient accumulation and ``fit(3)``. Float64 throughout: loss and
gradients agree to 1e-10 relative and 1e-12 absolute, parameters after an
epoch or a fit to 1e-9.

The twin of the stream-input kernel entry, ``fcnn_taylor_streams_reference``,
is held to the JAX package's layer-by-layer Taylor path on the same input
streams. Every spawn has a time limit.
"""
import contextlib
import functools
import os
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_model_parallel_ranks as M
import torch_parallel_ranks as R
from neurodiffeq_tpu_torch import fields as F
from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.parallel import launch
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

from neurodiffeq_tpu import conditions as JC, generators as JG, networks as JN, solvers as JS
from neurodiffeq_tpu.fields import diff as jdiff
from neurodiffeq_tpu.ops.taylor import TSeries, affine_series
from neurodiffeq_tpu.parallel import make_mesh as jax_make_mesh, megatron_param_shardings as jax_shardings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), 'examples'))
from __graft_entry__ import _flagship_solver  # noqa: E402
import lid_driven_cavity as jldc  # noqa: E402

torch.set_num_threads(2)
TIMEOUT = 150  # seconds for one group of ranks, its collectives included
RTOL, ATOL, TRAJ = 1e-10, 1e-12, 1e-9
MESHES = {'1x2': (2, 2), '2x2': (4, 2)}  # name -> (world size, model axis size)
SPECS = {  # the loss-and-gradient cases: key -> (build spec, fused calls per pass per kernel on each rank)
    'ode': (dict(problem='second', hidden=(32, 32)), (1, 0, 1)),   # a pair and the trailing (32, 1) layer
    'flagship': (dict(problem='flagship', hidden=(512,)), (1, 0, 0)),
    'cavity': (dict(problem='cavity', hidden=(16,) * 5), (1, 0, 2)),  # three pairs
    'not-dividing': (dict(problem='second', hidden=(5, 5)), (0, 1, 0)),  # whole, one taylor_mlp call
    'h1': (dict(problem='second', hidden=(32, 32), loss='h1'), (0, 0, 0)),  # order 3: layer by layer, whole
}
ON_JAX_MESH = ('ode', 'flagship', 'cavity')  # also against the JAX package on its (points, model) mesh
LAYOUTS = [(8, 8), (32, 32), (128,) * 5]
ACCUMULATE = dict(problem='second', hidden=(32, 32), n_batches_train=2)
FIT = dict(problem='second', hidden=(32, 32), method='equally-spaced-noisy')
FIT_EPOCHS = 3


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


# ------------------------------------------------------------ the JAX side
def _jax_solver(spec, mesh=None):
    """The JAX package's counterpart of ``M.build(**spec)`` (key 7)."""
    problem, hidden, n = spec['problem'], spec['hidden'], spec.get('n', 32)
    common = dict(loss_fn=spec.get('loss', 'l2'), n_batches_train=spec.get('n_batches_train', 1),
                  key=jax.random.PRNGKey(7), mesh=mesh)
    method = spec.get('method', 'equally-spaced')
    if problem == 'second':
        return JS.Solver1D(ode_system=lambda u, t: [jdiff(u, t, 2) + jdiff(u, t) + u],
                           conditions=[JC.IVP(0.0, 1.0)], t_min=0.0, t_max=2.0,
                           nets=[JN.FCNN(n_input_units=1, n_output_units=1, hidden_units=hidden)],
                           train_generator=JG.Generator1D(n, 0.0, 2.0, method=method),
                           valid_generator=JG.Generator1D(n, 0.0, 2.0, method='equally-spaced'), **common)
    if problem == 'flagship':
        return _flagship_solver(grid=(4, 4), hidden=hidden, **common)
    conds = [jldc.HardCavityU(), jldc.HardCavityV(), jldc.HardCavityP()]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    net = JN.FCNN(2, 3, hidden_units=hidden)
    gen = JG.Generator2D((4, n // 4), (0, 0), (1, 1), method=method)
    return JS.Solver2D(jldc.navier_stokes(100.0), conds, nets=[net] * 3, train_generator=gen, valid_generator=gen,
                       n_batches_valid=0, **common)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_layout(spec, jax_tree):
    """A JAX parameter (or gradient) pytree list in the port's
    ``_parameters()`` order, through ``load_jax_params``."""
    return R.params(M.build(None, **spec).load_jax_params(_numpy(jax_tree)))


def _jax_mesh(name):
    world, m = MESHES[name]
    return jax_make_mesh(n_devices=world, model_axis_size=m)


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(key, mesh=None):
    """The JAX package's loss and gradients of ``SPECS[key]`` at its
    columns, unsharded or on the mesh named ``mesh``."""
    spec = SPECS[key][0]
    solver = _jax_solver(spec, None if mesh is None else _jax_mesh(mesh))
    cols = [jnp.asarray(c) for c in _cols(spec)]
    fn = jax.jit(jax.value_and_grad(lambda p: solver._loss_and_metrics(p, cols)[0]))
    with solver.mesh if mesh is not None else contextlib.nullcontext():
        loss, grads = fn(solver.params)
    return float(loss), _port_layout(spec, grads)


def _jax_epoch(spec, mesh=None):
    """One compiled training epoch of the JAX package: the parameters after
    it, in the port's layout."""
    solver = _jax_solver(spec, mesh)
    fn = solver._get_compiled('train_epoch', solver._build_train_epoch)
    if mesh is None:
        params = fn(solver.params, solver.opt_state, jax.random.PRNGKey(123))[0]
    else:
        with mesh:
            params = fn(solver.params, solver.opt_state, jax.random.PRNGKey(123))[0]
    return _port_layout(spec, params)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _cols(spec):
    d = 1 if spec['problem'] == 'second' else 2
    cols = M.columns(16 if spec['problem'] == 'flagship' else 32, d, 3)
    return [2.0 * c for c in cols] if spec['problem'] == 'second' else cols


# ------------------------------------------------------------ the ranks
@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every case run by the ranks of each mesh, and without a mesh here:
    ``{'1x2': {key: [per-rank results]}, '2x2': ..., 'plain': {key: result}}``."""
    set_tensor_type('cpu', 64)
    tmp = tmp_path_factory.mktemp('model_parallel')
    cases = {key: ('loss_grads', dict(spec=spec, cols=_cols(spec),
                                      jax_params=[_numpy(p) for p in _jax_solver(spec).params]))
             for key, (spec, _) in SPECS.items()}
    cases['accumulate'] = ('epoch', dict(spec=ACCUMULATE,
                                         jax_params=[_numpy(p) for p in _jax_solver(ACCUMULATE).params]))
    cases['fit'] = ('fit', dict(spec=FIT, epochs=FIT_EPOCHS))
    cases.update({f'layout:{h}': ('layout', dict(hidden=h)) for h in LAYOUTS})
    out = {}
    for name, (world, m) in MESHES.items():
        ranks = launch(M.run_cases, world, device_type='cpu', timeout=TIMEOUT, num_threads=1,
                       args=(m, cases, 3 if world == 4 else None), rendezvous=str(tmp / f'rendezvous_{name}'))
        out[name] = {key: [r[key] for r in ranks] for key in list(cases) + ['index', 'bad', 'imports']}
    out['plain'] = M.run_plain(cases)
    return out


# ------------------------------------------------------------ the tests
@pytest.mark.parametrize('order', [1, 2])
@pytest.mark.parametrize('actv', ['tanh', 'sin'])
@pytest.mark.parametrize('d', [2, 10])
@pytest.mark.parametrize('input_actv', ['same', None])
def test_stream_twin_matches_jax_layer_by_layer(order, actv, d, input_actv):
    """``fcnn_taylor_streams_reference`` against ``affine_series`` and the
    activations' ``taylor_series`` of the JAX package on the same input
    streams: an optional input activation, then 16-24-3."""
    input_actv = actv if input_actv == 'same' else None
    rng = np.random.RandomState(order * 100 + d + (actv == 'sin') * 7 + (input_actv is None) * 3)
    n, dims = 9, (16, 24, 3)
    streams = rng.uniform(-1, 1, (1 + order * d, n, dims[0]))
    layers = [(rng.uniform(-1, 1, (a, b)) / np.sqrt(a), rng.uniform(-1, 1, b)) for a, b in zip(dims[:-1], dims[1:])]
    got = taylor_mlp.fcnn_taylor_streams_reference(torch.tensor(streams), [(torch.tensor(W), torch.tensor(b))
                                                                          for W, b in layers], order, actv,
                                                   input_actv)
    act = (JN.Tanh if actv == 'tanh' else JN.SinActv)()
    ctx = SimpleNamespace(order=order, n_dirs=d)
    series = TSeries(jnp.asarray(streams[0]), [tuple(jnp.asarray(streams[1 + k * d + i]) for i in range(d))
                                               for k in range(order)])
    if input_actv is not None:
        series = act.taylor_series(None, series, ctx)
    for i, (W, b) in enumerate(layers):
        series = affine_series(series, jnp.asarray(W), jnp.asarray(b))
        if i + 1 < len(layers):
            series = act.taylor_series(None, series, ctx)
    want = [np.asarray(series.c0)] + [np.stack([np.asarray(x) for x in dk]) for dk in series.derivs]
    assert len(got) == order + 1
    for g, w in zip(got, want):
        scale = np.abs(w).max()
        assert np.abs(g.numpy() - w).max() <= 1e-10 * scale


@pytest.mark.parametrize('mesh', list(MESHES))
def test_make_mesh_builds_points_by_model(runs, mesh):
    world, m = MESHES[mesh]
    assert runs[mesh]['index'] == [(('points', 'model'), r // m, r % m) for r in range(world)]


def test_make_mesh_raises_where_the_model_axis_does_not_divide(runs):
    assert runs['1x2']['bad'] == [None, None]
    for message in runs['2x2']['bad']:
        assert message is not None and 'model_axis_size=3 must divide the device count 4' in message


@pytest.mark.parametrize('hidden', LAYOUTS, ids=lambda h: 'x'.join(map(str, h)))
def test_megatron_layout_equals_jax(runs, hidden):
    """The JAX package's ``PartitionSpec``s per leaf, and the block of each
    split leaf that each model rank owns (``nn.Linear`` layout)."""
    jparams = JN.FCNN(2, 1, hidden_units=hidden).init(jax.random.PRNGKey(0))
    want = [{'W': tuple(layer['W'].spec), 'b': tuple(layer['b'].spec)}
            for layer in jax_shardings(jparams, _jax_mesh('1x2'))['layers']]
    for name, (world, m) in MESHES.items():
        for rank, (layout, blocks) in enumerate(runs[name][f'layout:{hidden}']):
            assert layout == {'layers': want}
            q, expect = rank % m, {}
            widths = (2,) + hidden + (1,)
            for i, spec in enumerate(want):
                if spec['W']:
                    dim = 0 if spec['W'] == (None, 'model') else 1
                    size = widths[i + 1] // m if dim == 0 else widths[i] // m
                    expect[f'linears.{i}.weight'] = (dim, q * size, (q + 1) * size)
                if spec['b']:
                    size = widths[i + 1] // m
                    expect[f'linears.{i}.bias'] = (0, q * size, (q + 1) * size)
            assert blocks == expect


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('key', list(SPECS))
def test_loss_and_gradients_match_jax(runs, key, mesh):
    """Every rank of the mesh holds the JAX package's loss and every
    gradient, unsharded and (for the nets that split) on its own
    ``(points, model)`` mesh of the same shape."""
    want = [_jax_loss_grads(key)] + ([_jax_loss_grads(key, mesh)] if key in ON_JAX_MESH else [])
    for (loss, grads), _ in runs[mesh][key]:
        for jloss, jgrads in want:
            np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
            _close(grads, jgrads)


@pytest.mark.parametrize('key', list(SPECS))
def test_split_pairs_go_through_the_kernel_entries(runs, key):
    """Per pass and rank: pair 0 through ``fcnn_taylor`` (``taylor_mlp_1h``
    on the card), the pairs after it and a trailing layer through
    ``fcnn_taylor_streams``; what does not split, whole (one
    ``taylor_mlp`` call, or layer by layer at order 3)."""
    want = dict(zip(('taylor_mlp_1h', 'taylor_mlp', 'taylor_mlp_streams'), SPECS[key][1]))
    for mesh in MESHES:
        assert [calls for _, calls in runs[mesh][key]] == [want] * MESHES[mesh][0]


@pytest.mark.parametrize('mesh', list(MESHES))
def test_gradient_accumulation_epoch_lands_on_jax_parameters(runs, mesh):
    """``n_batches_train=2``: two summed gradient passes and one Adam step
    from the JAX package's parameters, on both batches' equally spaced
    points, against its compiled epoch unsharded and on its mesh."""
    want = [_jax_epoch(ACCUMULATE), _jax_epoch(ACCUMULATE, _jax_mesh(mesh))]
    for params, _ in runs[mesh]['accumulate']:
        for wparams in want:
            _close(params, wparams, rtol=TRAJ)
    plain_params, plain_loss = runs['plain']['accumulate']
    for params, loss in runs[mesh]['accumulate']:
        np.testing.assert_allclose(loss, plain_loss, rtol=TRAJ)
        _close(params, plain_params, rtol=TRAJ)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_fit_is_finite_and_the_unsharded_trajectory(runs, mesh):
    whist, wparams = runs['plain']['fit']
    for hist, params in runs[mesh]['fit']:
        assert hist.keys() == whist.keys() and len(hist['train_loss']) == FIT_EPOCHS
        assert np.isfinite(hist['train_loss']).all()
        for k in hist:
            np.testing.assert_allclose(hist[k], whist[k], rtol=TRAJ, atol=ATOL)
        _close(params, wparams, rtol=TRAJ)


def test_no_rank_imports_jax(runs):
    for mesh, (world, _) in MESHES.items():
        assert runs[mesh]['imports'] == [[]] * world
