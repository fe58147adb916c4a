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

Each rank stores only its blocks of the split leaves, as the JAX package's
``shard_params`` leaves 1/m of each on a device: the blocks equal the JAX
package's addressable shards at the rank's ``(points, model)`` coordinate,
the gradients, Adam moments and ``best_params`` follow them, and the
gradient step sums over the points axis alone. The parameters and
gradients the cases compare are gathered to full size. What the solver
hands out (solutions, ``best_nets``, ``get_internals``, exports, saved
files) is full-size and equals the unsharded run's; a file saved on the
mesh resumes without one and the other way round; and monitors and
checkpoints, which read the parameters on every rank and write on rank 0,
run inside ``fit``.

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
from neurodiffeq_tpu.parallel import (make_mesh as jax_make_mesh, megatron_param_shardings as jax_shardings,
                                      shard_params as jax_shard_params)

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
# the elements of the trained parameters each rank holds on a model axis of 2: its blocks and the replicated leaves
LOCAL = {'ode': 609, 'flagship': 1025, 'cavity': 611, 'not-dividing': 46, 'h1': 609}
LAYOUTS = [(8, 8), (32, 32), (128,) * 5]
KINDS = ('fcnn', 'siren')
ACCUMULATE = dict(problem='second', hidden=(32, 32), n_batches_train=2)
FIT = dict(problem='second', hidden=(32, 32), method='equally-spaced-noisy')
FIT_EPOCHS, RESUME_EPOCHS, CALLBACK_EPOCHS = 3, 2, 4
POINTS = np.linspace(0.0, 2.0, 17)  # where the handed-out solutions are evaluated


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


def _jax_net(kind, hidden):
    return JN.SIREN(2, 1, hidden_units=hidden, w0=5.0) if kind == 'siren' else JN.FCNN(2, 1, hidden_units=hidden)


@functools.lru_cache(maxsize=None)
def _jax_shards(kind, hidden, mesh, rank):
    """The JAX package's ``shard_params`` of ``kind`` 2-``hidden``-1 on its
    mesh named ``mesh``: per leaf (``linears.i.weight``/``bias``, in
    ``nn.Linear``'s layout) the addressable shard on the device at rank
    ``rank``'s ``(points, model)`` coordinate."""
    jmesh = _jax_mesh(mesh)
    m = MESHES[mesh][1]
    device = jmesh.devices[rank // m, rank % m]
    out = {}
    for i, layer in enumerate(jax_shard_params(_jax_net(kind, hidden).init(jax.random.PRNGKey(0)), jmesh)['layers']):
        for leaf, name in (('W', 'weight'), ('b', 'bias')):
            data = np.asarray(next(s for s in layer[leaf].addressable_shards if s.device == device).data)
            out[f'linears.{i}.{name}'] = data.T if leaf == 'W' else data
    return out


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
    cases['fit'] = ('fit', dict(spec=FIT, epochs=FIT_EPOCHS, points=POINTS))
    cases['fit:lbfgs'] = ('lbfgs', dict(spec=FIT))
    cases.update({f'layout:{h}': ('layout', dict(hidden=h)) for h in LAYOUTS})
    cases.update({f'store:{kind}:{h}': ('store', dict(kind=kind, hidden=h, jax_params=[
        _numpy(_jax_net(kind, h).init(jax.random.PRNGKey(0)))])) for kind in KINDS for h in LAYOUTS})
    plain = M.build(None, **FIT)  # a file saved without a mesh, for the ranks to resume on theirs
    plain.fit(RESUME_EPOCHS, tqdm_file=None)
    plain.save(str(tmp / 'plain.pt'))
    out = {'tmp': tmp}
    for name, (world, m) in MESHES.items():
        here = tmp / name
        here.mkdir()
        mine = dict(cases, resume=('resume', dict(spec=FIT, epochs=RESUME_EPOCHS, workdir=str(here),
                                                   plain_path=str(tmp / 'plain.pt'))),
                    callbacks=('callbacks', dict(epochs=CALLBACK_EPOCHS, workdir=str(here))))
        ranks = launch(M.run_cases, world, device_type='cpu', timeout=TIMEOUT, num_threads=1,
                       args=(m, mine, 3 if world == 4 else None), rendezvous=str(tmp / f'rendezvous_{name}'))
        out[name] = {key: [r[key] for r in ranks] for key in list(mine) + ['index', 'bad', 'imports']}
    out['plain'] = M.run_plain(dict(cases, callbacks=('callbacks', dict(epochs=CALLBACK_EPOCHS, workdir=str(tmp)))))
    never_saved = M.build(None, **FIT)  # the run that never saved, to resume against
    never_saved.fit(2 * RESUME_EPOCHS, tqdm_file=None)
    out['never saved'] = (never_saved.metrics_history, R.params(never_saved))
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
    for (loss, grads), _, _ in runs[mesh][key]:
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
        assert [launches for _, launches, _ in runs[mesh][key]] == [want] * MESHES[mesh][0]


@pytest.mark.parametrize('mesh', list(MESHES))
def test_gradient_accumulation_epoch_lands_on_jax_parameters(runs, mesh):
    """``n_batches_train=2``: two summed gradient passes and one Adam step
    from the JAX package's parameters, on both batches' equally spaced
    points, against its compiled epoch unsharded and on its mesh."""
    want = [_jax_epoch(ACCUMULATE), _jax_epoch(ACCUMULATE, _jax_mesh(mesh))]
    for params, *_ in runs[mesh]['accumulate']:
        for wparams in want:
            _close(params, wparams, rtol=TRAJ)
    plain_params, plain_loss, *_ = runs['plain']['accumulate']
    for params, loss, *_ in runs[mesh]['accumulate']:
        np.testing.assert_allclose(loss, plain_loss, rtol=TRAJ)
        _close(params, plain_params, rtol=TRAJ)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_fit_is_finite_and_the_unsharded_trajectory(runs, mesh):
    whist, wparams, _ = runs['plain']['fit']
    for hist, params, _ in runs[mesh]['fit']:
        assert hist.keys() == whist.keys() and len(hist['train_loss']) == FIT_EPOCHS
        assert np.isfinite(hist['train_loss']).all()
        for k in hist:
            np.testing.assert_allclose(hist[k], whist[k], rtol=TRAJ, atol=ATOL)
        _close(params, wparams, rtol=TRAJ)


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('hidden', LAYOUTS, ids=lambda h: 'x'.join(map(str, h)))
@pytest.mark.parametrize('kind', KINDS)
def test_stored_blocks_are_the_jax_addressable_shards(runs, kind, hidden, mesh):
    """What each rank stores of every leaf, loaded from the JAX package's
    parameters, equals the JAX package's addressable shard (shape and
    values) on the device at the rank's ``(points, model)`` coordinate:
    1/m of each split leaf, the whole of a replicated one."""
    for rank, (stored, _, counts) in enumerate(runs[mesh][f'store:{kind}:{hidden}']):
        want = _jax_shards(kind, hidden, mesh, rank)
        assert stored.keys() == want.keys()
        for name, block in stored.items():
            assert block.shape == want[name].shape and np.array_equal(block, want[name]), name
        assert counts[0] == sum(a.size for a in want.values())


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('hidden', LAYOUTS, ids=lambda h: 'x'.join(map(str, h)))
@pytest.mark.parametrize('kind', KINDS)
def test_gradients_adam_moments_and_best_params_follow_the_blocks(runs, kind, hidden, mesh):
    """After a training epoch each stored leaf's gradient, both Adam
    moments and its entry of ``best_params`` have the block's shape, and
    the rank holds as many elements of each as of the parameters."""
    for rank, (_, shapes, counts) in enumerate(runs[mesh][f'store:{kind}:{hidden}']):
        want = _jax_shards(kind, hidden, mesh, rank)
        for name, got in shapes.items():
            assert got == (want[name].shape,) * 5, name
        assert counts == [sum(a.size for a in want.values())] * 4


@pytest.mark.parametrize('mesh', list(MESHES))
def test_gradient_step_sums_over_the_points_axis_alone(runs, mesh):
    """The gradient step makes no collective on ``(1, 2)``, and one
    ``all_reduce`` over the points group of the rank's local elements (with
    the loss's share where the pass hands it in) on ``(2, 2)``."""
    world, m = MESHES[mesh]
    points = world // m
    for key, local in LOCAL.items():
        for _, _, calls in runs[mesh][key]:
            assert calls == ([] if points == 1 else [(points, local + 1)]), key
    for _, _, calls, n_local in runs[mesh]['accumulate']:
        assert n_local == LOCAL['ode']
        assert calls == ([] if points == 1 else [(points, n_local)])


@pytest.mark.parametrize('mesh', list(MESHES))
def test_solutions_and_internals_are_full_size_and_unsharded(runs, mesh):
    """``get_solution``, ``best_nets``, ``get_internals``' parameters and
    the exported solution on every rank equal the unsharded run's."""
    _, _, want = runs['plain']['fit']
    for _, _, got in runs[mesh]['fit']:
        np.testing.assert_allclose(got['solution'], want['solution'], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(got['export'], want['export'], rtol=1e-12, atol=1e-12)
        _close(got['best_nets'], want['best_nets'], rtol=1e-12)
        for key in ('params', 'best_params'):
            (g,), (w,) = got['internals'][key], want['internals'][key]
            assert list(g) == list(w)
            _close(list(g.values()), list(w.values()), rtol=1e-12)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_saves_resume_across_the_model_axis(runs, mesh):
    """A file saved on the mesh loads without one (here) and onto the mesh
    (on the ranks), and one saved without a mesh loads onto it: each
    resumes on the trajectory of the run that never saved."""
    from neurodiffeq_tpu_torch.solvers import Solver1D

    whist, wparams = runs['never saved']
    saved = runs['tmp'] / mesh / 'mesh.pt'
    state = torch.load(saved, weights_only=True)['state']
    assert [[(k, tuple(v.shape)) for k, v in sd.items()] for sd in state['nets']] == [
        [(k, tuple(v.shape)) for k, v in M.build(None, **FIT).nets[0].state_dict().items()]]
    here = Solver1D.load(str(saved), device='cpu')
    assert here.mesh is None
    here.fit(RESUME_EPOCHS, tqdm_file=None)
    resumed = [(here.metrics_history, R.params(here))]
    resumed += [r[name] for r in runs[mesh]['resume'] for name in ('mesh', 'plain')]
    for hist, params in resumed:
        for k in whist:
            np.testing.assert_allclose(hist[k], whist[k], rtol=TRAJ, atol=ATOL)
        _close(params, wparams, rtol=TRAJ)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_residual_weights_on_the_mesh_equal_unsharded(runs, mesh):
    want_history, want_weights, _ = runs['plain']['callbacks']
    for history, weights, _ in runs[mesh]['callbacks']:
        assert [h[0] for h in history] == [h[0] for h in want_history] == list(range(1, CALLBACK_EPOCHS + 1))
        for (_, g, w), (_, wg, ww) in zip(history, want_history):
            np.testing.assert_allclose(g, wg, rtol=TRAJ)
            np.testing.assert_allclose(w, ww, rtol=TRAJ)
        np.testing.assert_allclose(weights, want_weights, rtol=TRAJ)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_monitor_and_checkpoints_inside_fit_write_once(runs, mesh):
    """A monitor and two checkpoints fire inside ``fit`` every 2 epochs:
    every rank gathers, rank 0 writes what the unsharded run writes, the
    other ranks nothing (a gather on rank 0 alone would hang the spawn)."""
    written = [w for _, _, w in runs[mesh]['callbacks']]
    _, _, plain = runs['plain']['callbacks']

    def timed(files):  # an 'internals' checkpoint is named by the second it was written
        return [f for f in files if not f.startswith('internals/')]

    assert timed(written[0]) == timed(plain) == ['ckpt/step_2.meta.json', 'ckpt/step_2.pt', 'ckpt/step_4.meta.json',
                                                 'ckpt/step_4.pt', 'figs/epoch-2.png', 'figs/epoch-4.png']
    assert any(f.startswith('internals/') for f in written[0])
    assert all(w == [] for w in written[1:])


@pytest.mark.parametrize('mesh', list(MESHES))
def test_optimizers_that_reduce_over_parameters_are_refused(runs, mesh):
    """L-BFGS (dot products, norms and a line search over its flat
    parameter vector) and Adafactor (factored moments) would step on each
    model rank from its blocks alone: on a model axis ``set_optimizer``
    refuses them, where the unsharded solver takes them."""
    plain, _, _ = runs['plain']['fit:lbfgs']
    assert plain == [None, None]
    for messages, _, _ in runs[mesh]['fit:lbfgs']:
        assert len(messages) == 2
        for name, message in zip(('LBFGS', 'Adafactor'), messages):
            if name == 'Adafactor' and not hasattr(torch.optim, 'Adafactor'):
                assert message is None
                continue
            assert message is not None and message.startswith(name) and "'model' mesh axis" in message


@pytest.mark.parametrize('mesh', list(MESHES))
def test_get_internals_gathers_only_what_is_asked_for(runs, mesh):
    """``get_internals('params')`` gathers each stored block once, and a
    name that holds no parameter makes no collective."""
    _, plain_calls, plain_blocks = runs['plain']['fit:lbfgs']
    assert plain_calls == [0, 0] and plain_blocks == 0
    for _, calls, n_blocks in runs[mesh]['fit:lbfgs']:
        assert n_blocks == 3  # layer 0's weight and bias, layer 1's weight
        assert calls == [n_blocks, 0]


def test_no_rank_imports_jax(runs):
    for mesh, (world, _) in MESHES.items():
        assert runs[mesh]['imports'] == [[]] * world
