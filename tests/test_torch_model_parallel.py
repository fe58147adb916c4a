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

The optimizers whose steps read across their parameters, ``torch.optim``'s
L-BFGS (with and without the strong-Wolfe line search), Adafactor and Muon,
step on each rank's blocks as they step unsharded: parameters after each of
3 epochs within 1e-9 (L-BFGS) and 1e-10 (Adafactor) relative of unsharded
``torch.optim``, Muon's step from one full-size gradient within 1e-12, the
same closure calls on every rank, the model group's reductions per L-BFGS
iteration the same at history 5 and 50, each rank's optimizer state its
blocks' part, and the state saved on the mesh and off it loading the other
way. Burgers' L-BFGS polish (``examples/burgers.py``'s ``polish_lbfgs``:
``set_generator`` with a frozen uniform draw, then L-BFGS through
``set_optimizer`` or the ``SetOptimizer`` callback) runs the unsharded
trajectory, its first closure held to the JAX package on its mesh.

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

from neurodiffeq_tpu import conditions as JC, fields as JF, generators as JG, networks as JN, solvers as JS
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
OPTIM_EPOCHS, MUON_STEPS = 3, 2
LBFGS_RUNS = [name for name, (kind, _) in M.OPTIMIZERS.items() if kind == 'LBFGS']
OPTIM_TOL = {'adafactor': 1e-10}  # relative; L-BFGS TRAJ
# Muon orthogonalizes in bfloat16 (torch.optim._muon's Newton-Schulz), so gradients that differ at round-off (the
# mesh sums them in another order) may round one bfloat16 ulp apart there: per step an element moves by at most
# lr * the largest learning-rate adjustment (sqrt(32) for the 32 x 1 weight) * 2^-8 of an orthogonalized element
# (at most about 1.5), so 3 steps stay within 3 * 1e-2 * sqrt(32) * 2^-8 * 1.5 < 3 * 1e-2 * sqrt(32) * 2^-7
MUON_ATOL = OPTIM_EPOCHS * M.OPTIMIZERS['muon'][1]['lr'] * np.sqrt(32) * 2.0 ** -7
# the optimizer state each rank holds on a model axis of 2, against the unsharded (FIT's FCNN 1-(32, 32)-1: 1,153
# elements, 609 on each rank): L-BFGS 2 history_size + 2 flat vectors of 609 (2 k + 2 of 1,153 unsharded, k pairs of
# history); Adafactor's factors and variances 147 of 195 (the first weight's split row factor 16 of 32 and its column
# factor 1, the first bias 16, the second weight's row factor 32 whole and split column factor 16 of 32, the second
# bias 32, the trailing layer 33 and 1); Muon's momentum 560 of 1,088 (the first weight 16 of 32, the second 512 of
# 1,024, the trailing 32)
STATE_ELEMENTS = {'adafactor': (147, 195), 'muon': (560, 1088)}
# the flat vectors of the rank's elements that L-BFGS may allocate per closure call and per iteration: about 6 read
# (the gradient, its weighted copy and |g| per call; s, y, the weighted (s, y, g), the direction, |d| and the strong
# Wolfe search's copy of the parameters per iteration), with the fit loop's own small tensors
LBFGS_ALLOCATED = 8
POLISH_HIDDEN, POLISH_N, POLISH_EPOCHS = (8,) * 4, 64, 2  # Burgers' 2-(8x4)-1 polished on 64 frozen points


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


def _jax_burgers(mesh=None):
    """``examples/burgers.py``'s problem through the JAX package on an FCNN
    2-``POLISH_HIDDEN``-1 (key 7): ``M.burgers``' counterpart."""
    nu = 0.01 / np.pi
    cond = JC.IBVP1D(x_min=-1.0, x_max=1.0, t_min=0.0, t_min_val=lambda x: -JF.sin(np.pi * x),
                     x_min_val=lambda t: 0 * t, x_max_val=lambda t: 0 * t)
    gen = JG.Generator2D((4, 4), (-1.0, 0.0), (1.0, 1.0))
    return JS.Solver2D(lambda u, x, t: [jdiff(u, t) + u * jdiff(u, x) - nu * jdiff(u, x, order=2)], [cond],
                       xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0), nets=[JN.FCNN(n_input_units=2, hidden_units=POLISH_HIDDEN)],
                       train_generator=gen, valid_generator=gen, key=jax.random.PRNGKey(7), mesh=mesh)


@functools.lru_cache(maxsize=None)
def _jax_polish_closure(mesh=None):
    """The JAX package's loss and gradients on the polish's frozen draw, at
    its initial parameters, unsharded or on the mesh named ``mesh``: what
    the polish's first closure call computes."""
    import chip_smoke as cs

    solver = _jax_burgers(None if mesh is None else _jax_mesh(mesh))
    cols = [jnp.asarray(c.reshape(-1, 1)) for c in cs.polish_draw(POLISH_N)]
    fn = jax.jit(jax.value_and_grad(lambda p: solver._loss_and_metrics(p, cols)[0]))
    with solver.mesh if mesh is not None else contextlib.nullcontext():
        loss, grads = fn(solver.params)
    return float(loss), R.params(M.burgers(None, POLISH_HIDDEN).load_jax_params(_numpy(grads)))


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
    cases['disabled'] = ('loss_grads', dict(cases['cavity'][1], kernels=False))
    cases['accumulate'] = ('epoch', dict(spec=ACCUMULATE,
                                         jax_params=[_numpy(p) for p in _jax_solver(ACCUMULATE).params]))
    cases['fit'] = ('fit', dict(spec=FIT, epochs=FIT_EPOCHS, points=POINTS))
    cases['fit:lbfgs'] = ('lbfgs', dict(spec=FIT))
    weights = [tuple(p.shape) for p in M.build(None, **FIT)._parameters() if p.ndim == 2]
    rng = np.random.RandomState(5)
    cases['muon_step'] = ('muon_step', dict(spec=FIT, grads=[rng.standard_normal(s) for s in weights],
                                            steps=MUON_STEPS))
    cases['schedule'] = ('schedule', dict(spec=FIT, epochs=OPTIM_EPOCHS))
    polish_params = [_numpy(p) for p in _jax_burgers().params]
    cases.update({f'polish:{via}': ('polish', dict(hidden=POLISH_HIDDEN, jax_params=polish_params, n=POLISH_N,
                                                   via=via, epochs=POLISH_EPOCHS))
                  for via in ('set_optimizer', 'callback')})
    cases.update({f'layout:{h}': ('layout', dict(hidden=h)) for h in LAYOUTS})
    cases.update({f'store:{kind}:{h}': ('store', dict(kind=kind, hidden=h, jax_params=[
        _numpy(_jax_net(kind, h).init(jax.random.PRNGKey(0)))])) for kind in KINDS for h in LAYOUTS})
    plain = M.build(None, **FIT)  # a file saved without a mesh, for the ranks to resume on theirs
    plain.fit(RESUME_EPOCHS, tqdm_file=None)
    plain.save(str(tmp / 'plain.pt'))
    out = {'tmp': tmp, 'disabled case': cases['disabled'][1]}
    (tmp / 'plain_optim').mkdir()  # each optimizer's run without a mesh, and its file for the ranks to load
    out['plain optim'] = {name: M.case_optim(None, name, FIT, OPTIM_EPOCHS, str(tmp / 'plain_optim')) for name in M.OPTIMIZERS}
    for name, (world, m) in MESHES.items():
        here = tmp / name
        here.mkdir()
        mine = dict(cases, resume=('resume', dict(spec=FIT, epochs=RESUME_EPOCHS, workdir=str(here),
                                                   plain_path=str(tmp / 'plain.pt'))),
                    callbacks=('callbacks', dict(epochs=CALLBACK_EPOCHS, workdir=str(here))),
                    **{f'optim:{opt}': ('optim', dict(name=opt, spec=FIT, epochs=OPTIM_EPOCHS, workdir=str(here),
                                                      plain_path=str(tmp / 'plain_optim' / f'{opt}.pt')))
                       for opt in M.OPTIMIZERS})
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
    ``taylor_mlp`` call, or layer by layer at order 3). Every pass has a
    graph and every pair 0 at most 128 outputs: its backward is one
    ``taylor_mlp_1h_bwd`` on the card."""
    want = dict(zip(('taylor_mlp_1h', 'taylor_mlp', 'taylor_mlp_streams'), SPECS[key][1]))
    want['taylor_mlp_1h_bwd'] = want['taylor_mlp_1h']
    for mesh in MESHES:
        assert [launches for _, launches, _ in runs[mesh][key]] == [want] * MESHES[mesh][0]


@pytest.mark.parametrize('mesh', list(MESHES))
def test_disabled_kernels_run_the_net_whole_on_every_rank(runs, mesh):
    """After ``disable_pallas()`` the cavity-shaped net goes layer by layer,
    whole on every rank with its split leaves gathered: no fused call, and
    the loss and every gradient of the unsharded fused pass and of the JAX
    package."""
    (want_loss, want_grads), _, _ = M.case_loss_grads(None, **dict(runs['disabled case'], kernels=True))
    jloss, jgrads = _jax_loss_grads('cavity')
    for (loss, grads), launches, _ in runs[mesh]['disabled']:
        assert launches == {'taylor_mlp_1h': 0, 'taylor_mlp': 0, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}
        for wloss, wgrads in ((want_loss, want_grads), (jloss, jgrads)):
            np.testing.assert_allclose(loss, wloss, rtol=RTOL, atol=ATOL)
            _close(grads, wgrads)


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
def test_set_optimizer_takes_lbfgs_adafactor_and_muon_on_the_model_axis(runs, mesh):
    """``set_optimizer`` takes ``torch.optim.LBFGS``, Adafactor and Muon on
    a model axis as it takes them unsharded; a subclass of one, whose step
    may be its own, is refused there."""
    plain, _, _ = runs['plain']['fit:lbfgs']
    assert plain == [None] * 4
    for messages, _, _ in runs[mesh]['fit:lbfgs']:
        assert messages[:3] == [None] * 3
        assert messages[3].startswith('SubclassedLBFGS reads across its parameters') and "'model' mesh" in messages[3]


def _same_state(got, want, rtol=0.0, atol=0.0):
    """Two ``M.plain_state``s: the same keys, None where the other is None,
    the values within the tolerances (equal where both are 0)."""
    assert got.keys() == want.keys()
    for i in want:
        assert got[i].keys() == want[i].keys(), i
        for key, w in want[i].items():
            g = got[i][key]
            pairs = list(zip(g, w, strict=True)) if isinstance(w, list) else [(g, w)]
            for a, b in pairs:
                assert (a is None) == (b is None), (i, key)
                if b is not None:
                    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=f'{i} {key}')


def _tolerance(name):
    return dict(rtol=0.0, atol=MUON_ATOL) if name == 'muon' else dict(rtol=OPTIM_TOL.get(name, TRAJ), atol=ATOL)


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', list(M.OPTIMIZERS))
def test_optimizers_that_read_across_parameters_step_as_unsharded(runs, name, mesh):
    """L-BFGS (no line search and strong Wolfe, history 5 and 50),
    Adafactor and Muon on the rank's blocks: the parameters after each of 3
    epochs are unsharded ``torch.optim``'s (1e-9 relative, Adafactor 1e-10,
    Muon ``MUON_ATOL``), on every rank, as are the train losses."""
    want = runs['plain optim'][name]
    for got in runs[mesh][f'optim:{name}']:
        for params, wparams in zip(got['params'], want['params'], strict=True):
            _close(params, wparams, **_tolerance(name))
        np.testing.assert_allclose(got['history'][0], want['history'][0], rtol=RTOL)
        if name != 'muon':
            np.testing.assert_allclose(got['history'], want['history'], rtol=OPTIM_TOL.get(name, TRAJ))


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', LBFGS_RUNS)
def test_lbfgs_closure_calls_are_equal_on_every_rank_and_unsharded(runs, name, mesh):
    want = [c['closures'] for c in runs['plain optim'][name]['counts']]
    assert sum(want) > OPTIM_EPOCHS  # each epoch an L-BFGS step of several closure calls
    for got in runs[mesh][f'optim:{name}']:
        assert [c['closures'] for c in got['counts']] == want


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('search', ['lbfgs', 'wolfe'])
def test_lbfgs_reductions_per_iteration_do_not_grow_with_the_history(runs, search, mesh):
    """The model group's ``all_reduce`` calls outside the closure's passes
    (the optimizer's own): one per closure call and two per iteration (the
    Gram scalars' new row; the direction's derivative and largest element),
    one fewer in the very first iteration, which has no history: at history
    5, which fills and shifts, and 50 alike. Unsharded, none."""
    for name in (search, search + ':h50'):
        assert all(c['reductions'] == 0 for c in runs['plain optim'][name]['counts'])
        for got in runs[mesh][f'optim:{name}']:
            for epoch, c in enumerate(got['counts']):
                assert c['evaluations'] == c['closures'] and c['iterations'] > 0
                assert c['reductions'] == c['closures'] + 2 * c['iterations'] - (epoch == 0), (name, epoch, c)


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', list(M.OPTIMIZERS))
def test_optimizer_state_per_rank_is_its_blocks_part(runs, name, mesh):
    """Each rank's optimizer state is its blocks' part and the replicated
    leaves' whole: L-BFGS's flat vectors over the rank's 609 elements where
    unsharded they span 1,153 (its history in buffers of ``history_size``
    pairs); Adafactor's factors and Muon's momentum as ``STATE_ELEMENTS``
    counts them."""
    whole, n_whole = runs['plain optim'][name]['elements']
    assert n_whole == 1153
    if name in STATE_ELEMENTS:
        want = STATE_ELEMENTS[name]
        assert whole == want[1]
    else:  # d, the previous gradient and 1 to history_size pairs; the mesh's buffers hold history_size pairs
        history = M.OPTIMIZERS[name][1]['history_size']
        assert whole % n_whole == 0 and 4 <= whole // n_whole <= 2 * history + 2
        want = ((2 * history + 2) * LOCAL['ode'], whole)
    for got in runs[mesh][f'optim:{name}']:
        assert got['elements'] == (want[0], LOCAL['ode'])


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', LBFGS_RUNS)
def test_lbfgs_allocates_no_copy_of_its_history(runs, name, mesh):
    """What L-BFGS allocates outside the closure's passes does not grow with
    its history: at most ``LBFGS_ALLOCATED`` flat vectors of the rank's 609
    elements per closure call and per iteration, plus, once, the history's
    two buffers of ``history_size`` rows. A copy of the history in a step
    (``torch.stack`` of its pairs) would take 4 k vectors per iteration."""
    history = M.OPTIMIZERS[name][1]['history_size']
    for got in runs[mesh][f'optim:{name}']:
        for epoch, c in enumerate(got['counts']):
            limit = LBFGS_ALLOCATED * (c['closures'] + c['iterations']) + (epoch == 0) * 2 * history
            assert c['allocated'] <= limit * LOCAL['ode'], (name, epoch, c)


def _saved_state(path):
    return M.plain_state(torch.load(path, weights_only=True)['state']['optimizer']['state_dict'])


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', list(M.OPTIMIZERS))
def test_optimizer_state_saved_on_the_mesh_loads_without_one(runs, name, mesh):
    """The file saved on the mesh holds ``torch.optim``'s own full-size
    state, the unsharded run's; it loads here without a mesh into the
    ``torch.optim`` class, which goes on as the unsharded run went on."""
    from neurodiffeq_tpu_torch.solvers import Solver1D

    plain = runs['plain optim'][name]
    path = runs['tmp'] / mesh / f'{name}.pt'
    want = _saved_state(runs['tmp'] / 'plain_optim' / f'{name}.pt')
    _same_state(_saved_state(path), want, **_tolerance(name))
    loaded = Solver1D.load(str(path), device='cpu')
    assert loaded.mesh is None and type(loaded.optimizer) is getattr(torch.optim, M.OPTIMIZERS[name][0])
    _same_state(M.plain_state(loaded.optimizer.state_dict()), want, **_tolerance(name))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        loaded.fit(1, tqdm_file=None)
    _close(R.params(loaded), plain['went_on'], **_tolerance(name))


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('name', list(M.OPTIMIZERS))
def test_optimizer_state_saved_without_a_mesh_loads_onto_it(runs, name, mesh):
    """The file saved without a mesh loads onto it: each rank's state,
    gathered to full size, is the saved state bit for bit, and the loaded
    solver goes on as the unsharded run went on; so does the solver that
    saved on the mesh."""
    plain = runs['plain optim'][name]
    want = _saved_state(runs['tmp'] / 'plain_optim' / f'{name}.pt')
    for got in runs[mesh][f'optim:{name}']:
        _same_state(got['loaded_state'], want)
        _close(got['resumed'], plain['went_on'], **_tolerance(name))
        _close(got['went_on'], plain['went_on'], **_tolerance(name))


@pytest.mark.parametrize('mesh', list(MESHES))
def test_a_scheduler_and_step_hooks_made_before_keep_working(runs, mesh):
    """The optimizer stays the user's object on the model axis: a learning
    rate scheduler and a step hook made before ``set_optimizer`` act on the
    model axis's steps as they act unsharded."""
    want, want_fired, want_lr, same = runs['plain']['schedule']
    assert same and want_fired == OPTIM_EPOCHS and want_lr == 1e-2 * 0.5 ** OPTIM_EPOCHS
    for params, fired, lr, same in runs[mesh]['schedule']:
        assert same and fired == want_fired and lr == want_lr
        _close(params, want, rtol=OPTIM_TOL['adafactor'])


@pytest.mark.parametrize('mesh', list(MESHES))
def test_muon_step_from_one_gradient_equals_torch(runs, mesh):
    """Muon over the 2-D weights, 2 steps from the same full-size
    gradients: each rank's gathered parameters are ``torch.optim.Muon``'s
    unsharded ones (1e-12 relative)."""
    want = runs['plain']['muon_step']
    for got in runs[mesh]['muon_step']:
        _close(got, want, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize('mesh', list(MESHES))
def test_polish_first_closure_matches_jax(runs, mesh):
    """The polish's first closure call on the frozen draw (loss and every
    gradient, gathered) equals the JAX package's, unsharded and on its own
    mesh of the same shape."""
    want = [_jax_polish_closure(), _jax_polish_closure(mesh)]
    for (loss, grads), _, _, _ in runs[mesh]['polish:set_optimizer']:
        for jloss, jgrads in want:
            np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
            _close(grads, jgrads)


@pytest.mark.parametrize('mesh', list(MESHES))
@pytest.mark.parametrize('via', ['set_optimizer', 'callback'])
def test_polish_on_the_mesh_is_the_unsharded_polish(runs, via, mesh):
    """Burgers' polish through ``set_generator(PredefinedGenerator)`` and
    L-BFGS, set directly or by the ``SetOptimizer`` callback after an Adam
    epoch: every rank makes the unsharded run's closure calls and lands on
    its parameters and losses."""
    _, want, want_calls, want_hist = runs['plain'][f'polish:{via}']
    assert want_calls[-1] > 1  # an L-BFGS epoch
    for _, params, calls, hist in runs[mesh][f'polish:{via}']:
        assert calls == want_calls
        for p, w in zip(params, want, strict=True):
            _close(p, w, rtol=TRAJ)
        for k in want_hist:
            np.testing.assert_allclose(hist[k], want_hist[k], rtol=TRAJ, atol=ATOL)


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
