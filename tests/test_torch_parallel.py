"""The PyTorch port's data parallelism (``neurodiffeq_tpu_torch.parallel`` and
``mesh=`` on the solvers) against the JAX package, on the CPU.

The port runs one process per rank: the ranks are gloo processes started by
the port's own launcher (``parallel.launch``), one group of 2, one of 3
(uneven blocks: 50 rows over 3 ranks) and one of 1, each running a list of
cases (``tests/torch_parallel_ranks.py``, which imports no JAX) whose
results the parametrized tests read. The JAX side runs here, unsharded and
on the 8-device virtual mesh of ``tests/conftest.py``. The cases mirror
``tests/test_parallel.py``'s points axis; its ``'model'`` axis is
``tests/test_torch_model_parallel.py``'s. Float64 throughout: loss and
every gradient agree to 1e-10 relative and 1e-12 absolute, trajectories to
1e-9.

The STDE probes are the port's own hash, not JAX's threefry stream
(``tests/test_torch_highdim.py``), so the estimators' cases hold the sharded
port to the unsharded port: the probes bit for bit, the loss and gradients
to 1e-10. Every spawn has a time limit, and a hung collective fails its
test.
"""
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_ranks as R
from neurodiffeq_tpu_torch.parallel import launch
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

from neurodiffeq_tpu import conditions as JC, generators as JG, networks as JN, solvers as JS
from neurodiffeq_tpu.fields import diff as jdiff
from neurodiffeq_tpu.losses import causal as jcausal
from neurodiffeq_tpu.parallel import make_mesh as jax_make_mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from __graft_entry__ import _flagship_solver  # noqa: E402

torch.set_num_threads(2)
TIMEOUT = 150  # seconds for one group of ranks, its collectives included
RTOL, ATOL, TRAJ = 1e-10, 1e-12, 1e-9
LOSSES = ['l1', 'l2', 'infinity', 'h1', 'h1 semi', 'variational', 'causal']
N, N_UNEVEN = 64, 50


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


# ------------------------------------------------------------ the JAX side
def _jax_extra_loss(form):
    """``R.extra_loss(form)`` for the JAX package, which computes it on the
    whole batch, on its mesh too."""
    def additional_loss(self, residual, funcs, coords):
        u = funcs[0].value
        return 0.1 * jnp.mean(u ** 2) if form == 'mean' else 0.1 * jnp.max(jnp.abs(u))
    return additional_loss


def _jax_solver(spec, mesh=None):
    """The JAX package's counterpart of ``R.build(**spec)`` (key 7)."""
    problem, net = spec.get('problem', 'first'), spec.get('net', (16, 16))
    n, loss = spec.get('n', N), spec.get('loss', 'l2')
    t1 = 1.0 if problem in ('weighted', 'energy') else 2.0
    if net == 'siren':
        nets = [JN.SIREN(n_input_units=1, n_output_units=1, hidden_units=(16, 16), w0=5.0)]
    elif net == 'fourier':
        nets = [JN.FourierFCNN(n_input_units=1, n_output_units=1, n_features=8, sigma=1.0, hidden_units=(16,))]
    else:
        nets = [JN.FCNN(n_input_units=1, n_output_units=1, hidden_units=net)]
    conditions = [JC.IVP(0.0, 1.0)]
    if problem == 'first':
        eqs = lambda u, t: [jdiff(u, t) + u]  # noqa: E731
    elif problem == 'second':
        eqs = lambda u, t: [jdiff(u, t, 2) + jdiff(u, t) + u]  # noqa: E731
    elif problem == 'weighted':
        eqs = lambda u, t: [jdiff(u, t) + u, 3.0 * (jdiff(u, t) + u)]  # noqa: E731
    else:  # 'energy'
        from neurodiffeq_tpu import fields as JF
        eqs = lambda u, t: [0.5 * jdiff(u, t) ** 2 - (np.pi ** 2) * JF.sin(np.pi * t) * u]  # noqa: E731
        conditions = [JC.DirichletBVP(t_0=0.0, u_0=0.0, t_1=1.0, u_1=0.0)]
    solver_class = JS.Solver1D
    if spec.get('extra') is not None:
        solver_class = type('ExtraLossSolver1D', (JS.Solver1D,), {'additional_loss': _jax_extra_loss(spec['extra'])})
    return solver_class(ode_system=eqs, conditions=conditions, t_min=0.0, t_max=t1, nets=nets,
                        train_generator=JG.Generator1D(n, 0.0, t1, method='equally-spaced'),
                        valid_generator=JG.Generator1D(n, 0.0, t1, method='equally-spaced'),
                        loss_fn=jcausal(epsilon=2.0, n_bins=4) if loss == 'causal' else loss,
                        residual_weights=spec.get('residual_weights'), key=jax.random.PRNGKey(7), mesh=mesh)


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_layout(spec, jax_tree):
    """A JAX parameter (or gradient) pytree list in the port's
    ``_parameters()`` order, through ``load_jax_params``."""
    return R.params(R.build(None, **spec).load_jax_params(_numpy(jax_tree)))


def _jax_loss_grads(spec, cols, mesh):
    solver = _jax_solver(spec, mesh)
    fn = jax.value_and_grad(lambda p: solver._loss_and_metrics(p, [jnp.asarray(c) for c in cols])[0])
    loss, grads = (jax.jit(fn) if mesh is not None else fn)(solver.params)
    return float(loss), _port_layout(spec, grads)


def _close(got, want, rtol=RTOL, atol=ATOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ------------------------------------------------------------ the cases
def _cols(key, n, t1=2.0, d=1):
    """``d`` columns of ``n`` points in [0, t1], a function of ``key``."""
    rng = np.random.RandomState(zlib.crc32(key.encode()))
    if 'causal' in key:  # shuffled, so the sort by time permutes across the ranks' blocks
        return [rng.permutation(np.linspace(0.0, t1, n)).reshape(-1, 1)]
    pts = t1 * rng.rand(n, d)
    return [pts[:, i:i + 1] for i in range(d)]


def _loss_specs():
    specs = {f'loss:{loss}': dict(problem='energy' if loss == 'variational' else 'first', loss=loss)
             for loss in LOSSES}
    specs.update({'order:first': dict(problem='first'), 'order:second': dict(problem='second'),
                  'residual_weights': dict(problem='weighted', residual_weights=[0.25, 1.0]),
                  'extra:mean': dict(problem='first', extra='mean'),
                  'extra:global': dict(problem='first', extra='global'),
                  'net:siren': dict(net='siren'), 'net:fourier': dict(net='fourier')})
    return specs


def _uneven_specs():
    return {'uneven:first': dict(problem='first', n=N_UNEVEN), 'uneven:second': dict(problem='second', n=N_UNEVEN),
            'uneven:causal': dict(problem='first', loss='causal', n=N_UNEVEN),
            'uneven:extra_global': dict(problem='first', extra='global', n=N_UNEVEN)}


def _case_cols(key, spec):
    return _cols(key, spec.get('n', N), 1.0 if spec.get('problem') in ('weighted', 'energy') else 2.0)


def _loss_case(key, spec):
    params = [_numpy(p) for p in _jax_solver(spec).params]
    return ('loss_grads', dict(spec=spec, jax_params=params, cols=_case_cols(key, spec)))


FIT_SPECS = {
    'fit:halton': (dict(problem='halton'), 20),
    'fit:power': (dict(problem='first', method='uniform', adaptive='power'), 5),
    'fit:topk': (dict(problem='first', method='uniform', adaptive='topk'), 5),
    'fit:accumulate': (dict(problem='second', method='equally-spaced-noisy', n_batches_train=2, n_batches_valid=2,
                            metric=True), 3),
    'fit:lbfgs': (dict(problem='first', method='equally-spaced-noisy', optimizer='lbfgs', n_batches_valid=1), 3),
}
FLAGSHIP_EPOCHS, WEIGHT_EPOCHS = 5, 4


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every case run by the ranks (groups of 2, 3 and 1) and without a mesh
    here: ``{'two': {key: [per-rank results]}, 'three': ..., 'one': ...,
    'plain': {key: result}}``."""
    set_tensor_type('cpu', 64)
    tmp = tmp_path_factory.mktemp('parallel')
    two = {key: _loss_case(key, spec) for key, spec in _loss_specs().items()}
    two.update({f'probes:{op}': ('probes', dict(spec=dict(problem=op), cols=_cols(op, N, 1.0, 3)))
                for op in ('stde_laplacian', 'stde_biharmonic')})
    for key, (spec, epochs) in FIT_SPECS.items():
        two[key] = ('fit', dict(spec=spec, epochs=epochs))
    two['fit:flagship'] = ('fit', dict(spec=dict(problem='flagship'), epochs=FLAGSHIP_EPOCHS,
                                       load=[_numpy(p) for p in _flagship_solver(grid=(8, 8), hidden=(16,), key=jax.random.PRNGKey(7)).params]))
    two['weights'] = ('weights', dict(spec=dict(problem='oscillator', method='equally-spaced-noisy'),
                                      epochs=WEIGHT_EPOCHS, workdir=str(tmp)))
    saved = R.build(None, problem='second', method='equally-spaced-noisy', seed=11)
    saved.fit(2, tqdm_file=None)
    saved.save(str(tmp / 'plain.pt'))
    two['save'] = ('save', dict(spec=dict(problem='first', method='equally-spaced-noisy'), epochs=3,
                                path=str(tmp / 'mesh.pt'), load_path=str(tmp / 'plain.pt')))
    two['mesh'] = ('mesh', {})
    two['undeclared_loss'] = ('undeclared', dict(what='loss'))
    two['undeclared_extra'] = ('undeclared', dict(what='extra'))
    three = {key: _loss_case(key, spec) for key, spec in _uneven_specs().items()}
    three['mesh'] = ('mesh', {})
    one = {'fit:one': ('fit', dict(spec=dict(problem='second', method='equally-spaced-noisy', n_batches_valid=2,
                                             metric=True), epochs=3)), 'mesh': ('mesh', {})}
    out = {}
    for name, world, cases in (('two', 2, two), ('three', 3, three), ('one', 1, one)):
        ranks = launch(R.run_cases, world, device_type='cpu', timeout=TIMEOUT, args=(cases,), num_threads=1,
                       rendezvous=str(tmp / f'rendezvous_{name}'))
        out[name] = {key: [r[key] for r in ranks] for key in list(cases) + ['imports']}
    plain_cases = {k: v for k, v in {**two, **one}.items() if v[0] in ('probes', 'fit', 'weights')}
    out['plain'] = R.run_plain(plain_cases)
    out['saved'] = R.params(saved)
    out['tmp'] = tmp
    return out


# ------------------------------------------------------------ the tests
def test_make_mesh_names_size_and_device(runs):
    for name, world in (('two', 2), ('three', 3), ('one', 1)):
        got = runs[name]['mesh']
        assert [m['rank'] for m in got] == list(range(world))
        assert all(m['names'] == ('points',) and m['size'] == world and m['device'] == 'cpu' for m in got)


class _StubMesh:
    """What ``points_sharding`` reads of a mesh."""
    mesh_dim_names = ('points',)

    def __init__(self, world, rank):
        self.world, self.rank = world, rank

    def size(self):
        return self.world

    def get_local_rank(self):
        return self.rank


@pytest.mark.parametrize('n,world', [(64, 2), (50, 3), (7, 4), (4, 4)])
def test_points_sharding_is_contiguous_blocks(n, world):
    from neurodiffeq_tpu_torch.parallel import points_sharding, shard_points
    rows = [points_sharding(_StubMesh(world, r), n) for r in range(world)]
    assert [r.start for r in rows] == [0] + [r.stop for r in rows[:-1]] and rows[-1].stop == n
    assert max(len(r) for r in rows) - min(len(r) for r in rows) <= 1
    pts = torch.arange(2 * n).reshape(n, 2)
    assert torch.equal(torch.cat([shard_points(pts, _StubMesh(world, r)) for r in range(world)]), pts)


def test_points_sharding_needs_a_row_per_rank():
    from neurodiffeq_tpu_torch.parallel import points_sharding
    with pytest.raises(ValueError, match='cannot be sharded over 4 ranks'):
        points_sharding(_StubMesh(4, 0), 3)


def test_a_loss_without_shard_form_raises_under_a_mesh(runs):
    for message in runs['two']['undeclared_loss']:
        assert message is not None and "shard_form = 'mean'" in message


def test_an_additional_loss_without_shard_form_raises_under_a_mesh(runs):
    """A max over the batch, say, is not the sum of the blocks' maxima: an
    ``additional_loss`` override must declare its form, as a loss does."""
    for message in runs['two']['undeclared_extra']:
        assert message is not None and 'ExtraLossSolver1D.additional_loss' in message and "'global'" in message


@pytest.mark.parametrize('key', list(_loss_specs()))
def test_loss_and_gradients_match_jax_on_two_ranks(runs, key):
    """Per loss, static residual weights, an ``additional_loss`` of each
    form (a mean, and a max over the whole batch), first and second order,
    SIREN and FourierFCNN: every rank holds the JAX package's loss and
    gradients, unsharded and on its mesh."""
    spec = _loss_specs()[key]
    cols = _case_cols(key, spec)
    want = [_jax_loss_grads(spec, cols, None), _jax_loss_grads(spec, cols, jax_make_mesh())]
    for loss, grads in runs['two'][key]:
        for jloss, jgrads in want:
            np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
            _close(grads, jgrads)


@pytest.mark.parametrize('key', list(_uneven_specs()))
def test_uneven_blocks_over_three_ranks_match_jax(runs, key):
    """50 rows over 3 ranks (17, 17, 16)."""
    spec = _uneven_specs()[key]
    jloss, jgrads = _jax_loss_grads(spec, _case_cols(key, spec), None)
    for loss, grads in runs['three'][key]:
        np.testing.assert_allclose(loss, jloss, rtol=RTOL, atol=ATOL)
        _close(grads, jgrads)


@pytest.mark.parametrize('op', ['stde_laplacian', 'stde_biharmonic'])
def test_stde_probes_bitwise_and_loss_and_gradients(runs, op):
    (lo0, hi0, lap, bih), (loss0, grads0) = runs['plain'][f'probes:{op}']
    rows = []
    for (lo, hi, lap_r, bih_r), (loss, grads) in runs['two'][f'probes:{op}']:
        rows.append((lo, hi))
        assert np.array_equal(lap_r, lap[lo:hi]) and np.array_equal(bih_r, bih[lo:hi])
        np.testing.assert_allclose(loss, loss0, rtol=RTOL, atol=ATOL)
        _close(grads, grads0)
    assert rows == [(0, N // 2), (N // 2, N)] and (lo0, hi0) == (0, N)


def _same_run(got, want, tol=TRAJ):
    (hist, params, batches), (whist, wparams, wbatches) = got, want
    assert hist.keys() == whist.keys()
    for k in hist:
        np.testing.assert_allclose(hist[k], whist[k], rtol=tol, atol=ATOL)
    _close(params, wparams, rtol=tol)
    return batches, wbatches


@pytest.mark.parametrize('key', ['fit:halton', 'fit:accumulate', 'fit:lbfgs'])
def test_fit_matches_unsharded(runs, key):
    """Scrambled-Halton sampling, gradient accumulation over 2 batches (with
    a metric of the whole batch) and L-BFGS through the closure: the
    trajectory and the parameters equal the unsharded run's."""
    for got in runs['two'][key]:
        _same_run(got, runs['plain'][key])


@pytest.mark.parametrize('strategy', ['power', 'topk'])
def test_adaptive_pick_is_the_unsharded_pick_on_every_rank(runs, strategy):
    key = f'fit:{strategy}'
    for got in runs['two'][key]:
        batches, want = _same_run(got, runs['plain'][key])
        assert len(batches) == FIT_SPECS[key][1]
        assert all(np.array_equal(b[0], w[0]) for b, w in zip(batches, want))


def test_flagship_trajectory_matches_unsharded_and_jax(runs):
    """The slice as a whole at test width: FCNN 2-16-1 on the 8 x 8 grid,
    5 Adam epochs on 2 ranks from the JAX package's parameters, against the
    port unsharded and the JAX package (optax) unsharded."""
    spec = dict(problem='flagship')
    for got in runs['two']['fit:flagship']:
        _same_run(got, runs['plain']['fit:flagship'])
    jsolver = _flagship_solver(grid=(8, 8), hidden=(16,), key=jax.random.PRNGKey(7))
    port = R.build(None, **spec)
    pts = port.generator['train'].sample(port.rng)
    cols = [jnp.asarray(c.numpy().reshape(-1, 1)) for c in pts]
    value_and_grad = jax.jit(jax.value_and_grad(lambda p: jsolver._loss_and_metrics(p, cols)[0]))
    opt, params, losses = optax.adam(1e-3), jsolver.params, []
    state = opt.init(params)
    for _ in range(FLAGSHIP_EPOCHS):
        loss, grads = value_and_grad(params)
        losses.append(float(loss))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    for hist, got_params, _ in runs['two']['fit:flagship']:
        np.testing.assert_allclose(hist['train_loss'], losses, rtol=TRAJ, atol=ATOL)
        _close(got_params, _port_layout(spec, params), rtol=TRAJ)


def test_residual_weight_callback_matches_unsharded(runs):
    want_history, want_weights, _ = runs['plain']['weights']
    for history, weights, _ in runs['two']['weights']:
        assert [h[0] for h in history] == [h[0] for h in want_history] == list(range(1, WEIGHT_EPOCHS + 1))
        for (_, g, w), (_, wg, ww) in zip(history, want_history):
            np.testing.assert_allclose(g, wg, rtol=TRAJ)
            np.testing.assert_allclose(w, ww, rtol=TRAJ)
        np.testing.assert_allclose(weights, want_weights, rtol=TRAJ)


def test_checkpoint_and_tensorboard_files_written_once(runs):
    """Rank 0 writes what the unsharded run writes; rank 1 writes nothing."""
    (_, _, written0), (_, _, written1) = runs['two']['weights']
    _, _, plain = runs['plain']['weights']
    assert written0 == plain == ['ckpt/step_2.meta.json', 'ckpt/step_2.pt', 'ckpt/step_4.meta.json',
                                 'ckpt/step_4.pt', 'scalars.txt']
    assert written1 == []
    lines = (runs['tmp'] / 'rank0' / 'scalars.txt').read_text().splitlines()
    assert len(lines) == WEIGHT_EPOCHS * 2  # train and valid loss, one per epoch each


def test_save_under_a_mesh_loads_without_one_and_back(runs):
    from neurodiffeq_tpu_torch.solvers import Solver1D

    results = runs['two']['save']
    loaded = Solver1D.load(str(runs['tmp'] / 'mesh.pt'), device='cpu')
    assert loaded.mesh is None
    for got_params, history, on_mesh, _, same_mesh in results:
        assert all(np.array_equal(a, b) for a, b in zip(got_params, R.params(loaded)))
        assert history == loaded.metrics_history
        assert same_mesh and all(np.array_equal(a, b) for a, b in zip(on_mesh, runs['saved']))


def test_one_rank_mesh_is_the_unsharded_run_bitwise(runs):
    (hist, params, _), = runs['one']['fit:one']
    whist, wparams, _ = runs['plain']['fit:one']
    assert hist == whist
    assert all(np.array_equal(a, b) for a, b in zip(params, wparams))


def test_no_rank_imports_jax(runs):
    for name in ('two', 'three', 'one'):
        assert runs[name]['imports'] == [[]] * len(runs[name]['mesh'])


def test_launch_raises_a_rank_exception_and_stops_the_others(tmp_path):
    with pytest.raises(RuntimeError, match='rank 1 fails on purpose'):
        launch(R.fail_on, 2, device_type='cpu', timeout=60, args=(1,), rendezvous=str(tmp_path / 'rendezvous'))


def test_launch_ends_a_hung_collective_at_its_time_limit(tmp_path):
    import time
    t0 = time.monotonic()
    with pytest.raises((TimeoutError, RuntimeError)):
        launch(R.hang, 2, device_type='cpu', timeout=5, args=(1,), rendezvous=str(tmp_path / 'rendezvous'))
    assert time.monotonic() - t0 < 30
