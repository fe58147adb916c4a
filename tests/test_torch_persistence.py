"""The PyTorch port's persistence against the JAX package's, in float64.

- ``diff_equation_details`` of both packages' solvers on the same
  parameters (``load_jax_params``): the equation source, the conditions and
  the network descriptions equal, the sampled solution to 1e-10;
- save -> load round trips of the JAX package's own cases
  (``tests/test_solvers_utils.py``): the solution is equal bit for bit, the
  histories, the lowest loss and the optimizer's state are restored, and
  one more epoch from the same generator state gives the same train loss
  on both sides (exactly);
- the path without dill (the tensor part alone, the callables from a
  ``SolverConfig``) and its error message; ``_dill_load_protected``;
- the hub client against a mock and against a server on localhost.
"""
import io
import json
import sys
import threading
import types
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import diff as jdiff, solvers_utils as jsu
from neurodiffeq_tpu.conditions import IVP as JIVP
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import Solver1D as JSolver1D
from neurodiffeq_tpu_torch import diff, fields as F, solvers_utils as su
from neurodiffeq_tpu_torch.conditions import DirichletBoxND, DirichletBVP2D, IVP, NoCondition
from neurodiffeq_tpu_torch.generators import Generator1D, GeneratorHypercube, ResidualAdaptiveGenerator
from neurodiffeq_tpu_torch.losses import causal, variational
from neurodiffeq_tpu_torch.networks import FCNN, SIREN, FourierFCNN, SinActv
from neurodiffeq_tpu_torch.operators import stde_biharmonic
from neurodiffeq_tpu_torch.solvers import GenericSolver, Solver1D, Solver2D
from neurodiffeq_tpu_torch.solvers_utils import SolverConfig, get_source
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()
    yield
    F.reset_taylor_fallback_count()
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _ode(u, t):
    return [diff(u, t) + u]


def _make_eq(d):
    """The same equation source for both packages' solvers."""
    return lambda u, t: [d(u, t) + 0.5 * u]


def _solver(**kwargs):
    kwargs.setdefault('conditions', [IVP(t_0=0.0, u_0=1.0)])
    return Solver1D(ode_system=_ode, t_min=0.0, t_max=2.0, **kwargs)


def _roundtrip(solver, tmp_path, cls=Solver1D, **kwargs):
    path = str(tmp_path / 'solver.pt')
    solver.save(path=path)
    return cls.load(path=path, **kwargs)


def _resume_parity(solver, loaded, seed=777):
    """One more epoch on each side from the same generator state: the same
    parameters, optimizer state and points give the same train loss."""
    solver.rng.manual_seed(seed)
    solver.fit(max_epochs=1, tqdm_file=None)
    loaded.rng.manual_seed(seed)
    loaded.fit(max_epochs=1, tqdm_file=None)
    assert solver.metrics_history['train_loss'][-1] == loaded.metrics_history['train_loss'][-1]
    for a, b in zip(solver._parameters(), loaded._parameters()):
        assert torch.equal(a, b)


def _same_solution(a, b, *coords):
    ua, ub = a.get_solution()(*coords, to_numpy=True), b.get_solution()(*coords, to_numpy=True)
    assert np.array_equal(np.asarray(ua), np.asarray(ub))


def test_diff_equation_details_equal_jax():
    jsolver = JSolver1D(ode_system=_make_eq(jdiff), conditions=[JIVP(0.0, 1.0)], t_min=0.0, t_max=2.0,
                        nets=[JFCNN(1, 1, hidden_units=(8, 4))])
    jsolver.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jsolver.params)
    tsolver = Solver1D(ode_system=_make_eq(diff), conditions=[IVP(0.0, 1.0)], t_min=0.0, t_max=2.0,
                       nets=[FCNN(1, 1, hidden_units=(8, 4))])
    tsolver.load_jax_params(jax.tree.map(np.asarray, jsolver.params))
    jd, td = jsu._diff_equation_details(jsolver), su._diff_equation_details(tsolver)
    assert td['equation'] == jd['equation'] == 'lambda u, t: [d(u, t) + 0.5 * u]'
    assert td['conditions'] == jd['conditions'] == ['IVP']
    assert td['networks'] == jd['networks']
    assert td['sample_loss'] == jd['sample_loss'] == []
    (jt, (ju,)), (tt, (tu,)) = jd['sample_solution'], td['sample_solution']
    assert np.array_equal(jt, tt) and len(tt) == 20
    np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-10)
    assert su.get_parameters(_make_eq(diff)) == jsu.get_parameters(_make_eq(jdiff)) == {}


def test_save_load_roundtrip(tmp_path):
    solver = _solver()
    solver.fit(max_epochs=50, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path)
    assert loaded.global_epoch == 50
    assert loaded.lowest_loss == solver.lowest_loss
    assert loaded.metrics_history == solver.metrics_history
    _same_solution(solver, loaded, np.linspace(0, 2, 17))
    for (pa, sa), (pb, sb) in zip(solver.optimizer.state.items(), loaded.optimizer.state.items()):
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
        assert sb['step'].device.type == 'cpu'
    _resume_parity(solver, loaded)
    loaded.fit(max_epochs=4, tqdm_file=None)
    assert loaded.global_epoch == 55


def test_save_load_restores_the_sampling_generator(tmp_path):
    """The generator's state is part of the file: with no reseeding, the
    loaded solver draws the points the saved one draws next."""
    solver = _solver(generator=torch.Generator().manual_seed(3))
    solver.fit(max_epochs=5, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, generator=torch.Generator().manual_seed(99))
    solver.fit(max_epochs=1, tqdm_file=None)
    loaded.fit(max_epochs=1, tqdm_file=None)
    assert torch.equal(solver.batch['train'][0], loaded.batch['train'][0])
    assert solver.metrics_history['train_loss'][-1] == loaded.metrics_history['train_loss'][-1]


def test_save_load_2d(tmp_path):
    solver = Solver2D(pde_system=lambda u, x, y: [diff(u, x) + diff(u, y)], conditions=[NoCondition()],
                      xy_min=(0, 0), xy_max=(1, 1))
    solver.fit(max_epochs=3, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, cls=Solver2D)
    xs, ys = np.random.rand(5), np.random.rand(5)
    _same_solution(solver, loaded, xs, ys)
    assert loaded.xy_min == (0, 0) and loaded.dtype == torch.float64
    _resume_parity(solver, loaded)


def test_load_with_config_overrides(tmp_path):
    solver = _solver()
    solver.fit(max_epochs=2, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, config=SolverConfig(n_batches_train=3, n_batches_valid=0))
    assert loaded.n_batches == {'train': 3, 'valid': 0}
    # an optimizer from the config keeps its own (empty) state
    opt_solver = _roundtrip(solver, tmp_path, config=SolverConfig(optimizer=torch.optim.SGD(
        [torch.zeros(1, requires_grad=True)], lr=0.1)))
    assert isinstance(opt_solver.optimizer, torch.optim.SGD) and not opt_solver.optimizer.state


def test_save_requires_target():
    solver = _solver()
    with pytest.raises(ValueError):
        solver.save()
    with pytest.raises(ValueError):
        Solver1D.load()


def test_get_source():
    src = get_source(_ode)
    assert src is not None and 'diff' in src


def test_shared_net_is_saved_once_and_solution_stays_frozen(tmp_path):
    net = FCNN(n_input_units=1, n_output_units=2, hidden_units=(8,))
    conds = [IVP(0.0, 1.0), IVP(0.0, 2.0)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    solver = Solver1D(ode_system=lambda u, v, t: [diff(u, t) + u, diff(v, t) + v], conditions=conds,
                      nets=[net, net], t_min=0.0, t_max=2.0)
    solver.fit(max_epochs=3, tqdm_file=None)
    sol = solver.get_solution()
    path = str(tmp_path / 'shared.pt')
    solver.save(path=path)
    saved = torch.load(path, weights_only=True)['state']
    assert len(saved['nets']) == 1 and saved['net_index'] == [0, 0]
    assert all(not p.requires_grad for n in sol.nets for p in n.parameters())
    assert all(p.requires_grad for p in solver._parameters())
    loaded = Solver1D.load(path=path)
    assert loaded.nets[0] is loaded.nets[1]
    _same_solution(solver, loaded, np.linspace(0, 2, 9))
    _resume_parity(solver, loaded)


def test_optimizer_param_order_and_mismatch(tmp_path):
    """The restored state maps to the parameters in their saved places, even
    where the optimizer listed them out of order; an optimizer over tensors
    the solver does not own starts afresh with the saved hyperparameters."""
    net = FCNN(hidden_units=(8, 8))
    solver = _solver(nets=[net], optimizer=torch.optim.Adam(list(net.parameters())[::-1], lr=3e-3))
    solver.fit(max_epochs=4, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path)
    for p, q in zip(solver.optimizer.param_groups[0]['params'], loaded.optimizer.param_groups[0]['params']):
        assert p.shape == q.shape
        assert torch.equal(solver.optimizer.state[p]['exp_avg'], loaded.optimizer.state[q]['exp_avg'])
    assert loaded.optimizer.param_groups[0]['lr'] == 3e-3
    _resume_parity(solver, loaded)

    extra = torch.zeros(3, requires_grad=True)
    net2 = FCNN(hidden_units=(8,))
    other = _solver(nets=[net2], optimizer=torch.optim.Adam(list(net2.parameters()) + [extra], lr=2e-3))
    other.fit(max_epochs=2, tqdm_file=None)
    reloaded = _roundtrip(other, tmp_path)
    assert not reloaded.optimizer.state and reloaded.optimizer.param_groups[0]['lr'] == 2e-3
    assert len(reloaded.optimizer.param_groups[0]['params']) == len(reloaded._parameters())


def test_save_load_preserves_residual_weights_and_adaptive_generator(tmp_path):
    solver = Solver1D(ode_system=lambda u, t: [diff(u, t) + u, 2.0 * (diff(u, t) + u)],
                      conditions=[IVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=2.0, residual_weights=[0.25, 1.0],
                      train_generator=ResidualAdaptiveGenerator(Generator1D(16, 0.0, 2.0, method='uniform'),
                                                                oversample=2),
                      valid_generator=Generator1D(16, 0.0, 2.0, method='equally-spaced'))
    solver.fit(max_epochs=20, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path)
    assert loaded.residual_weights == [0.25, 1.0]
    assert loaded.generator['train'].adaptive and loaded.generator['train'].oversample == 2
    cols = [torch.linspace(0.0, 2.0, 16, dtype=torch.float64).reshape(-1, 1)]
    l0, _ = solver._loss_and_metrics(cols)
    l1, _ = loaded._loss_and_metrics(cols)
    assert l0.item() == l1.item()
    _resume_parity(solver, loaded)


def test_save_load_siren_roundtrip_and_resume(tmp_path):
    solver = _solver(nets=[SIREN(1, 1, hidden_units=(16, 16), w0=5.0, w0_first=7.0)])
    solver.fit(max_epochs=30, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path)
    net = loaded.nets[0]
    assert isinstance(net, SIREN) and net.w0 == 5.0 and net.w0_first == 7.0 and net.hidden_units == (16, 16)
    _same_solution(solver, loaded, np.linspace(0, 2, 33))
    _resume_parity(solver, loaded)


def test_save_load_fourier_fcnn_B_bitexact(tmp_path):
    solver = _solver(nets=[FourierFCNN(1, 1, n_features=8, sigma=2.0, hidden_units=(16,))])
    solver.fit(max_epochs=20, tqdm_file=None)
    B_before = solver.nets[0].B.clone()
    loaded = _roundtrip(solver, tmp_path)
    net = loaded.nets[0]
    assert isinstance(net, FourierFCNN) and net.sigma == 2.0 and net.n_features == 8
    assert torch.equal(net.B, B_before)
    _same_solution(solver, loaded, np.linspace(0, 2, 17))
    _resume_parity(solver, loaded)


def test_save_load_causal_loss_fn(tmp_path):
    solver = _solver(loss_fn=causal(epsilon=5.0, n_bins=8))
    solver.fit(max_epochs=10, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path)
    cols = [torch.linspace(0.0, 2.0, 32, dtype=torch.float64).reshape(-1, 1)]
    assert solver._loss_and_metrics(cols)[0].item() == loaded._loss_and_metrics(cols)[0].item()
    _resume_parity(solver, loaded)


def test_save_load_variational_solver(tmp_path):
    zero = lambda v: 0.0 * v  # noqa: E731
    solver = Solver2D(pde_system=lambda u, x, y: [0.5 * (diff(u, x) ** 2 + diff(u, y) ** 2) - u],
                      conditions=[DirichletBVP2D(x_min=0.0, x_min_val=zero, x_max=1.0, x_max_val=zero,
                                                 y_min=0.0, y_min_val=zero, y_max=1.0, y_max_val=zero)],
                      xy_min=(0, 0), xy_max=(1, 1), loss_fn='variational')
    solver.fit(max_epochs=10, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, cls=Solver2D)
    assert loaded.loss_fn is variational and variational.residual_power == 1
    g = torch.Generator().manual_seed(0)
    cols = [torch.rand(64, 1, generator=g, dtype=torch.float64) for _ in range(2)]
    assert solver._loss_and_metrics(cols)[0].item() == loaded._loss_and_metrics(cols)[0].item()
    _resume_parity(solver, loaded)


def test_save_load_hypercube_halton_generators(tmp_path):
    d = 4
    solver = GenericSolver(diff_eqs=lambda u, *xs: [sum(diff(u, x) for x in xs) + u], conditions=[NoCondition()],
                           nets=[FCNN(n_input_units=d, n_output_units=1, hidden_units=(16,))],
                           train_generator=GeneratorHypercube(64, dim=d, method='halton'),
                           valid_generator=GeneratorHypercube(32, dim=d, r_min=(0.0,) * d, r_max=(1.0, 2.0, 3.0, 4.0)))
    solver.fit(max_epochs=5, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, cls=GenericSolver)
    tr, va = loaded.generator['train'], loaded.generator['valid']
    assert isinstance(tr, GeneratorHypercube) and isinstance(va, GeneratorHypercube)
    assert tr.dim == d and tr.method == 'halton' and tuple(va.r_max) == (1.0, 2.0, 3.0, 4.0)
    _resume_parity(solver, loaded, seed=123)
    loaded.fit(max_epochs=3, tqdm_file=None)
    assert loaded.global_epoch == 9


def test_save_load_clamped_biharmonic_solver(tmp_path):
    d = 3
    solver = GenericSolver(diff_eqs=lambda u, *xs: [stde_biharmonic(u, *xs, n_est=2)
                                                    - sum(F.sin(np.pi * x) for x in xs)],
                           conditions=[DirichletBoxND(d, power=2, mask='sat', k=5)],
                           nets=[FCNN(n_input_units=d, n_output_units=1, hidden_units=(16,))],
                           train_generator=GeneratorHypercube(32, dim=d), valid_generator=GeneratorHypercube(32, dim=d),
                           n_batches_valid=0)
    solver.fit(max_epochs=3, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, cls=GenericSolver)
    cond = loaded.conditions[0]
    assert isinstance(cond, DirichletBoxND) and cond.power == 2 and cond.mask == 'sat' and cond.k == 5
    pts = np.random.default_rng(0).random((16, d))
    pts[:, 0] = 0.0
    vals = loaded.get_solution(best=False)(*[pts[:, i] for i in range(d)], to_numpy=True)
    assert np.allclose(vals, 0.0, atol=1e-6)
    _resume_parity(solver, loaded, seed=321)
    loaded.fit(max_epochs=1, tqdm_file=None)
    assert loaded.global_epoch == 5


def test_save_load_bundle_solver(tmp_path):
    from neurodiffeq_tpu_torch.conditions import BundleIVP
    from neurodiffeq_tpu_torch.solvers import BundleSolver1D

    solver = BundleSolver1D(ode_system=lambda u, t, lam: [diff(u, t) + lam * u],
                            conditions=[BundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0, theta_min=0.5,
                            theta_max=1.5, eq_param_index=(0,), nets=[FCNN(2, 1, hidden_units=(8,))])
    solver.fit(max_epochs=3, tqdm_file=None)
    loaded = _roundtrip(solver, tmp_path, cls=BundleSolver1D)
    assert loaded.r_min == (0.0, 0.5) and loaded.eq_param_index == solver.eq_param_index
    _same_solution(solver, loaded, np.linspace(0, 1, 9), np.full(9, 1.1))
    _resume_parity(solver, loaded)


def _no_dill(monkeypatch):
    monkeypatch.setitem(sys.modules, 'dill', None)


def test_without_dill_the_config_gives_the_callables(tmp_path, monkeypatch):
    solver = _solver(nets=[FCNN(hidden_units=(8,))])
    solver.fit(max_epochs=6, tqdm_file=None)
    path = str(tmp_path / 'nodill.pt')
    _no_dill(monkeypatch)
    solver.save(path=path)
    assert torch.load(path, weights_only=True)['callables'] is None
    with pytest.raises(RuntimeError) as err:
        Solver1D.load(path=path)
    msg = str(err.value)
    for name in ('diff_eqs (ode_system or pde_system)', 'conditions', 'nets', 'train_generator', 'valid_generator'):
        assert name in msg
    assert 'without dill' in msg and 'loss_fn' not in msg and 'optimizer' not in msg
    with pytest.raises(RuntimeError, match='conditions, nets'):
        Solver1D.load(path=path, config=SolverConfig(ode_system=_ode))
    config = SolverConfig(ode_system=_ode, conditions=[IVP(0.0, 1.0)], nets=[FCNN(hidden_units=(8,))],
                          train_generator=Generator1D(32, 0.0, 2.0, method='equally-spaced-noisy'),
                          valid_generator=Generator1D(32, 0.0, 2.0, method='equally-spaced'))
    loaded = Solver1D.load(path=path, config=config)
    assert loaded.global_epoch == 6 and loaded.lowest_loss == solver.lowest_loss
    _same_solution(solver, loaded, np.linspace(0, 2, 11))
    _resume_parity(solver, loaded)


def test_a_dill_file_without_dill_needs_the_config(tmp_path, monkeypatch):
    solver = _solver(loss_fn=causal(epsilon=5.0, n_bins=8), metrics={'u0': lambda u, t: u[:1].mean()})
    solver.fit(max_epochs=2, tqdm_file=None)
    path = str(tmp_path / 'dill.pt')
    solver.save(path=path)
    _no_dill(monkeypatch)
    with pytest.raises(RuntimeError, match='dill is not installed') as err:
        Solver1D.load(path=path)
    assert 'loss_fn' in str(err.value) and 'metrics' in str(err.value)


def test_load_does_not_clobber_module_globals(tmp_path):
    """A lambda that closes over the fields MODULE is pickled with the
    module by value; ``_dill_load_protected`` restores every global the
    load rebound, and the loaded solver still trains."""
    def make_eqs():
        from neurodiffeq_tpu_torch import fields as F_local
        return lambda u, x, y: [F.diff(u, x, 2) + F_local.sin(u)]

    eqs = make_eqs()
    assert any(isinstance(c.cell_contents, type(F)) for c in eqs.__closure__)
    solver = GenericSolver(diff_eqs=eqs, conditions=[DirichletBoxND(2)],
                           nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=(8,))],
                           train_generator=GeneratorHypercube(16, dim=2), valid_generator=GeneratorHypercube(16, dim=2),
                           n_batches_valid=0)
    solver.fit(max_epochs=2, tqdm_file=None)
    before = {name: obj for name, obj in vars(F).items() if not name.startswith('__')}
    loaded = _roundtrip(solver, tmp_path, cls=GenericSolver)
    assert [name for name, obj in before.items() if getattr(F, name, None) is not obj] == []
    x, y = F.coordinates(np.linspace(0.1, 0.9, 7), np.linspace(0.1, 0.9, 7))
    composed = F.diff(x ** 2 * F.sin(x * y), x)
    assert composed._dinfo is not None and composed.value.shape == (7, 1)
    assert F.taylor_fallback_count() == 0
    loaded.fit(max_epochs=2, tqdm_file=None)
    assert loaded.global_epoch == 4


class _FakeResponse:
    status_code = 200
    content = b''

    def raise_for_status(self):
        pass


def _fake_requests(store):
    def fake_post(url, headers=None, files=None, data=None):
        assert 'solutions/upload' in url and headers.get('api-key') == 'test-key'
        store['blob'] = files['file'][1].read()
        return _FakeResponse()

    def fake_get(url, headers=None):
        resp = _FakeResponse()
        resp.content = store['blob']
        return resp

    module = types.ModuleType('requests')
    module.post, module.get = fake_post, fake_get
    return module


def test_hub_upload_download_mocked(monkeypatch):
    solver = _solver(nets=[SIREN(1, 1, hidden_units=(8, 8), w0=5.0)])
    solver.fit(max_epochs=2, tqdm_file=None)
    store = {}
    monkeypatch.setitem(sys.modules, 'requests', _fake_requests(store))
    monkeypatch.setenv('NEURODIFF_API_KEY', 'test-key')
    solver.save(name='my-solution', save_to_hub=True)
    assert torch.load(io.BytesIO(store['blob']), weights_only=True)['state']['type_name'] == 'Solver1D'
    loaded = Solver1D.load(name='my-solution')
    assert loaded.global_epoch == 2 and isinstance(loaded.nets[0], SIREN) and loaded.nets[0].w0 == 5.0
    _same_solution(solver, loaded, np.linspace(0, 2, 9))


def test_hub_upload_requires_api_key(monkeypatch):
    monkeypatch.delenv('NEURODIFF_API_KEY', raising=False)
    with pytest.raises(RuntimeError):
        _solver().save(name='x', save_to_hub=True)


def test_hub_contract_real_http(monkeypatch):
    """A real HTTP exchange with ``requests`` against a server on localhost
    that implements the hub's API: a multipart POST to ``solutions/upload``
    with the ``api-key`` header and the name and description fields, and a
    GET of ``solutions/download/<name>``."""
    pytest.importorskip('requests')
    from email.parser import BytesParser
    from email.policy import default as email_default_policy
    from http.server import BaseHTTPRequestHandler, HTTPServer

    store, seen = {}, {}

    class HubHandler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def do_POST(self):
            assert self.path == '/v1/solutions/upload'
            seen['api_key'] = self.headers.get('api-key')
            body = self.rfile.read(int(self.headers['Content-Length']))
            msg = BytesParser(policy=email_default_policy).parsebytes(
                b'Content-Type: ' + self.headers['Content-Type'].encode() + b'\r\n\r\n' + body)
            fields = {part.get_param('name', header='content-disposition'): part.get_payload(decode=True)
                      for part in msg.iter_parts()}
            seen['form_name'] = fields['name'].decode()
            seen['form_description'] = fields['description'].decode()
            store[seen['form_name']] = fields['file']
            self.send_response(200)
            self.send_header('Content-Type', 'application/json')
            self.end_headers()
            self.wfile.write(b'{"status": "ok"}')

        def do_GET(self):
            prefix = '/v1/solutions/download/'
            blob = store.get(self.path[len(prefix):])
            if blob is None:
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header('Content-Type', 'application/octet-stream')
            self.end_headers()
            self.wfile.write(blob)

    server = HTTPServer(('127.0.0.1', 0), HubHandler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        monkeypatch.setenv('NEURODIFF_API_URL', f'http://127.0.0.1:{server.server_address[1]}/v1/')
        monkeypatch.setenv('NEURODIFF_API_KEY', 'contract-key')
        solver = _solver()
        solver.fit(max_epochs=4, tqdm_file=None)
        solver.save(name='exp-decay', save_to_hub=True, description='contract test')
        assert seen == {'api_key': 'contract-key', 'form_name': 'exp-decay', 'form_description': 'contract test'}
        loaded = Solver1D.load(name='exp-decay')
        assert loaded.global_epoch == 4
        _same_solution(solver, loaded, np.linspace(0, 2, 9))
        import requests
        with pytest.raises(requests.HTTPError):
            Solver1D.load(name='no-such-solution')
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


def test_save_dict_metadata_contract(tmp_path):
    solver = _solver(nets=[FCNN(1, 1, hidden_units=(8, 4))])
    solver.fit(max_epochs=3, tqdm_file=None)
    path = str(tmp_path / 'meta.pt')
    solver.save(path=path)
    state = torch.load(path, weights_only=True)['state']
    assert state['parent_type_name'] == 'BaseSolver' and state['global_epoch'] == 3
    details = state['diff_equation_details']
    assert 'diff' in details['equation'] and details['conditions'] == ['IVP']
    assert details['optimizer']['name'] == 'Adam' and len(details['sample_loss']) == 3
    assert details['networks'] == [{'layers': [
        {'layer': 'Linear', 'in_features': 1, 'out_features': 8, 'bias': True}, {'layer': 'Tanh'},
        {'layer': 'Linear', 'in_features': 8, 'out_features': 4, 'bias': True}, {'layer': 'Tanh'},
        {'layer': 'Linear', 'in_features': 4, 'out_features': 1, 'bias': True}]}]
    ts, (us,) = details['sample_solution']
    assert len(ts) == 20
    got = solver.get_solution()(np.asarray(ts), to_numpy=True)
    np.testing.assert_allclose(us, got, rtol=0, atol=1e-12)


def test_reference_parity_helpers():
    assert su.is_solution_name('user/lotka-volterra') and not su.is_solution_name('./local.pt')

    class Resp:
        def json(self):
            return {'ok': 1}
    assert su.process_response(Resp()) == {'ok': 1}
    lam = 0.5
    eq = lambda u, t: [diff(u, t) + lam * u]  # noqa: E731
    assert su.get_parameters(eq) == {'lam': 0.5}
    conds = su.get_conditions([IVP(t_0=0.0, u_0=1.0)])
    assert conds[0]['condition_type'] == 'IVP' and conds[0]['t_0'] == 0.0
    solver = _solver()
    meta = su.get_generator(solver.generator)
    assert meta.get('size') == 32 and not any(callable(v) for v in meta.values())
    adaptive = _solver(train_generator=ResidualAdaptiveGenerator(Generator1D(16, 0.0, 2.0), oversample=4))
    meta = su.get_generator(adaptive.generator)
    json.dumps(meta, cls=su.JsonEncoder)
    assert 'Generator1D' in meta['generator']
    enc = json.dumps({'a': np.int32(3), 'b': np.float64(1.5), 'c': np.arange(3), 'd': torch.ones(2)},
                     cls=su.JsonEncoder)
    assert json.loads(enc) == {'a': 3, 'b': 1.5, 'c': [0, 1, 2], 'd': [1.0, 1.0]}
    assert su.get_loss('l2') == 'l2' and 'lambda' in su.get_loss(lambda r, f, x: r)
    solver.fit(max_epochs=2, tqdm_file=None)
    xs, us = su.get_sample_solution1D(solver)
    assert len(xs) == len(us[0]) > 0
    assert isinstance(su.DEV, bool) and su.NEURODIFF_API_URL.startswith('http')
