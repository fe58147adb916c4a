"""The PyTorch port's high-dimensional toolkit against the JAX package, in
float64: ``DirichletBoxND``, ``biharmonic``, ``stde_laplacian`` and
``stde_biharmonic``, and the high-dimensional slice through
``GenericSolver``.

- ``DirichletBoxND`` with every mask and power (d = 3 and 5, and the sat
  mask at d = 12), shared net parameters and shared points: the values, the
  exact ``laplacian`` and ``biharmonic`` equal the JAX package's to 1e-10;
  the condition is exact on the faces with an untrained net; every
  validation error has the JAX package's message;
- both estimators, handed the JAX package's own probes, equal its values to
  1e-10; with the port's probes they keep the JAX tests' properties
  (exactness on separable functions, unbiasedness, coordinate subsets, the
  determinism contract, fresh probes per batch, gradients, validation, the
  biased single probe);
- the compose fallbacks per residual equal the JAX package's: 0 for
  ``laplacian``, 1 for each of the others;
- a ``GenericSolver`` step of the d = 3 exact Poisson problem and of the
  d = 4 clamped plate: loss and every parameter gradient equal the JAX
  package's to 1e-10; a d = 5 ``stde_laplacian`` fit trains on the CPU.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, operators as JO
from neurodiffeq_tpu.conditions import DirichletBoxND as JBox
from neurodiffeq_tpu.generators import PredefinedGenerator as JPredefinedGenerator
from neurodiffeq_tpu.networks import FCNN as JFCNN, SinActv as JSinActv
from neurodiffeq_tpu.operators import _stde_probe_key
from neurodiffeq_tpu.solvers import GenericSolver as JGenericSolver
from neurodiffeq_tpu_torch import fields as F, operators as O
from neurodiffeq_tpu_torch.conditions import DirichletBoxND
from neurodiffeq_tpu_torch.generators import GeneratorHypercube, PredefinedGenerator
from neurodiffeq_tpu_torch.networks import FCNN, SinActv
from neurodiffeq_tpu_torch.solvers import GenericSolver
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_seed, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
N = 12
PI = np.pi


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU. The
    fallback counter is global: leave it at 0 for the next test file."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)
    F.reset_taylor_fallback_count()


def _close(got, want, tol=TOL):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


def _extension(FF):
    """A smooth boundary extension g, written once for either package's fields."""
    return lambda *xs: sum(FF.sin(x) for x in xs) / len(xs) + xs[0] * xs[1]


def _box(d):
    """A per-axis box: [-0.5, 0.5 + 0.1 i] on axis i."""
    return -0.5, tuple(0.5 + 0.1 * i for i in range(d))


def _pair(d, seed=0, hidden=(8, 8)):
    """The JAX package's FCNN d-8-8-1 sin with float64 parameters, and the port's with the same."""
    jnet = JFCNN(d, 1, hidden_units=hidden, actv=JSinActv)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(seed)))
    return jnet, params, FCNN(d, 1, hidden_units=hidden, actv=SinActv).load_jax_params(jax.tree.map(np.asarray, params))


def _points(d, n=N, seed=0):
    lo, hi = _box(d)
    return lo + np.random.RandomState(seed).rand(n, d) * (np.asarray(hi) - lo)


def _fields(d, mask, power, pts, boundary=True, box=None):
    """(JAX u, JAX coordinates, port u, port coordinates) of DirichletBoxND on a shared net."""
    jnet, params, tnet = _pair(d)
    lo, hi = box or _box(d)
    jcond = JBox(d, boundary_fn=_extension(JF) if boundary else None, r_min=lo, r_max=hi, mask=mask, power=power)
    tcond = DirichletBoxND(d, boundary_fn=_extension(F) if boundary else None, r_min=lo, r_max=hi, mask=mask,
                           power=power)
    jxs, txs = JF.coords_from_points(jnp.asarray(pts)), F.coords_from_points(torch.tensor(pts))
    return jcond.enforce(jnet, params, *jxs), jxs, tcond.enforce(tnet, *txs), txs


BOX_CASES = [(d, mask, power) for d in (3, 5) for mask in ('product', 'sat', 'adf') for power in (1, 2)] + [
    (12, 'sat', 1), (12, 'sat', 2)]


@pytest.mark.parametrize('d,mask,power', BOX_CASES)
def test_box_values_laplacian_and_biharmonic_match_jax(d, mask, power):
    ju, jxs, tu, txs = _fields(d, mask, power, _points(d))
    F.reset_taylor_fallback_count()
    _close(tu.value, ju.value)
    _close(O.laplacian(tu, *txs).value, JO.laplacian(ju, *jxs).value)
    assert F.taylor_fallback_count() == 0
    _close(O.biharmonic(tu, *txs).value, JO.biharmonic(ju, *jxs).value)
    assert F.taylor_fallback_count() == 1


@pytest.mark.parametrize('mask', ['product', 'sat', 'adf'])
def test_mask_field_matches_jax_and_its_derivatives(mask):
    """The mask as one field over the stacked columns: its value and its
    first and second partials (its own Taylor rule) and a mixed partial (a
    polarization context, through the per-coordinate form) equal the JAX
    package's, on coordinates in any order and on a subset; of arguments
    other than raw coordinates it is the per-coordinate form."""
    d = 4
    pts = _points(d)
    lo, hi = _box(d)
    jc, tc = JBox(d, r_min=lo, r_max=hi, mask=mask), DirichletBoxND(d, r_min=lo, r_max=hi, mask=mask)
    jxs, txs = JF.coords_from_points(jnp.asarray(pts)), F.coords_from_points(torch.tensor(pts))
    for order in ([0, 1, 2, 3], [2, 0, 3, 1]):
        jm, tm = jc.mask_field(*[jxs[i] for i in order]), tc.mask_field(*[txs[i] for i in order])
        _close(tm.value, jm.value)
        for i in range(d):
            _close(F.diff(tm, txs[i]).value, JF.diff(jm, jxs[i]).value)
            _close(F.diff(tm, txs[i], 2).value, JF.diff(jm, jxs[i], 2).value)
            _close(F.diff(tm, txs[i], 3).value, JF.diff(jm, jxs[i], 3).value)
        _close(F.diff(F.diff(tm, txs[0]), txs[2]).value, JF.diff(JF.diff(jm, jxs[0]), jxs[2]).value)
    shifted = [x * 1.0 for x in txs]
    assert tc.mask_field(*shifted)._combine is not None  # an expression of per-coordinate operations
    _close(tc.mask_field(*shifted).value, jc.mask_field(*jxs).value)
    sub = DirichletBoxND(2, r_min=lo, r_max=hi[:2], mask=mask).mask_field(txs[1], txs[3])
    jsub = JBox(2, r_min=lo, r_max=hi[:2], mask=mask).mask_field(jxs[1], jxs[3])
    _close(sub.value, jsub.value)
    _close(O.laplacian(sub, *txs).value, JO.laplacian(jsub, *jxs).value)


@pytest.mark.parametrize('mask', ['product', 'sat', 'adf'])
@pytest.mark.parametrize('power', [1, 2])
def test_box_exact_on_faces_with_an_untrained_net(mask, power):
    """u = g on every face, and with ``power=2`` also du/dn = dg/dn, with an
    untrained net, both through the Taylor path and the compose path. The
    box's sides are longer than 1: across a face of length L <= 1 the 'adf'
    mask's first derivative overflows, 4 / L over the dtype's tiny, in the
    JAX package too."""
    d = 5
    lo, hi = -0.6, tuple(0.6 + 0.1 * i for i in range(d))
    rng = np.random.RandomState(3)
    pts = lo + rng.rand(40, d) * (np.asarray(hi) - lo)
    axis = rng.randint(0, d, 40)
    pts[np.arange(40), axis] = np.where(rng.rand(40) < 0.5, lo, np.asarray(hi)[axis])
    _, _, tu, txs = _fields(d, mask, power, pts, box=(lo, hi))
    g = _extension(F)(*txs)
    assert (tu.value - g.value).abs().max() < 1e-12
    with F.eval_mode('compose'):
        _, _, cu, cxs = _fields(d, mask, power, pts, box=(lo, hi))
        assert (cu.value - _extension(F)(*cxs).value).abs().max() < 1e-12
    if power == 2:
        for i in range(d):
            on = torch.tensor(axis == i)
            du, dg = F.diff(tu, txs[i]).value[on], F.diff(g, txs[i]).value[on]
            assert (du - dg).abs().max() < 1e-10


@pytest.mark.parametrize('args,kw', [
    ((0,), {}), ((3,), dict(power=1.5)), ((3,), dict(power=0)), ((3,), dict(mask='box')),
    ((17,), dict(mask='product')), ((3,), dict(mask='product', k=2)), ((3,), dict(mask='sat', k=0)),
    ((3,), dict(r_min=(0.0, 0.0))), ((2,), dict(r_min=(0.0, 1.0), r_max=(1.0, 1.0))),
    ((3,), dict(boundary_fn=1.0)),
])
def test_box_validation_matches_jax(args, kw):
    with pytest.raises((ValueError, TypeError)) as jerr:
        JBox(*args, **kw)
    with pytest.raises(jerr.type) as err:
        DirichletBoxND(*args, **kw)
    assert str(err.value) == str(jerr.value)


def test_box_auto_mask_and_parameterize_checks():
    assert DirichletBoxND(10).mask == 'product' and DirichletBoxND(11).mask == 'sat'
    assert DirichletBoxND(11).k == 11 and DirichletBoxND(4, mask='sat', k=3).k == 3
    txs = F.coords_from_points(torch.rand(4, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match='expected 2 coordinates, got 3'):
        DirichletBoxND(2).parameterize(txs[0], *txs)


def _jax_probes(pts, idx, n_est, salt, tag, shape):
    key = _stde_probe_key(jnp.asarray(pts), idx, n_est, salt, tag)
    return torch.tensor(np.asarray(jax.random.rademacher(key, shape, dtype=jnp.float64)))


@pytest.mark.parametrize('subset', [False, True])
def test_estimators_with_jax_probes_match_jax(subset):
    """Handed the JAX package's probes (its key and ``jax.random.rademacher``),
    both estimators equal its values to 1e-10, on a DirichletBoxND field."""
    d, n_est = 6, 5
    pts = _points(d, n=10)
    ju, jxs, tu, txs = _fields(d, 'sat', 2, pts)
    sel = [1, 4, 5] if subset else list(range(d))
    jsel, tsel = [jxs[i] for i in sel], [txs[i] for i in sel]
    lap_probes = _jax_probes(pts, sel, n_est, 3, 2, (10, n_est, len(sel)))
    _close(O._stde_laplacian_with(tu, tsel, lap_probes).value,
           JO.stde_laplacian(ju, *jsel, n_est=n_est, salt=3).value)
    bih_probes = _jax_probes(pts, sel, n_est, 0, 4, (10, n_est, 2, len(sel)))
    _close(O._stde_biharmonic_with(tu, tsel, bih_probes).value,
           JO.stde_biharmonic(ju, *jsel, n_est=n_est).value)


@pytest.mark.parametrize('op', ['laplacian', 'stde_laplacian', 'biharmonic', 'stde_biharmonic'])
def test_fallbacks_per_residual_match_jax(op):
    """0 compose fallbacks for ``laplacian``, 1 for each of the others, in a
    residual ``op(u) + f`` on a DirichletBoxND net field, as in JAX."""
    d = 6
    ju, jxs, tu, txs = _fields(d, 'product', 1, _points(d))
    JF.reset_taylor_fallback_count()
    F.reset_taylor_fallback_count()
    np.asarray((getattr(JO, op)(ju, *jxs) + sum(JF.sin(x) for x in jxs)).value)
    (getattr(O, op)(tu, *txs) + sum(F.sin(x) for x in txs)).value
    assert F.taylor_fallback_count() == JF.taylor_fallback_count() == (0 if op == 'laplacian' else 1)


def _coords(n, d, seed=0):
    return F.coords_from_points(torch.tensor(np.random.RandomState(seed).rand(n, d)))


def test_stde_exact_on_quadratic_and_subset():
    xs = _coords(64, 5)
    assert (O.stde_laplacian(sum(c * c for c in xs), *xs, n_est=2).value - 10.0).abs().max() < 1e-10
    x0, x1, x2 = _coords(64, 3)
    assert (O.stde_laplacian(x0 * x0 + 7 * x1 * x1, x0, n_est=2).value - 2.0).abs().max() < 1e-10


def test_stde_unbiased_with_off_diagonal_hessian():
    xs = _coords(256, 4)
    u = xs[0] * xs[0] * xs[1]
    true = 2 * xs[1].value
    err = {n: (O.stde_laplacian(u, *xs, n_est=n).value - true).abs().mean().item() for n in (8, 512)}
    assert err[512] < err[8] and err[512] < 0.15


def test_stde_gradients_flow():
    torch.manual_seed(1)
    net = FCNN(4, 1, hidden_units=(16,))
    xs = F.coords_from_points(torch.rand(32, 4, dtype=torch.float64))
    u = F.network_field(net, xs)
    loss = (O.stde_laplacian(u, *xs, n_est=8).value ** 2).mean() + (O.stde_biharmonic(u, *xs, n_est=4).value ** 2).mean()
    loss.backward()
    # every parameter but the output bias, on which no derivative of u depends
    *inner, out_bias = net.parameters()
    assert out_bias.grad is None
    assert all(p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0 for p in inner)


def test_stde_fresh_probes_per_batch_and_determinism_contract():
    """The probes are a pure function of the seed value, the coordinate
    indices, ``n_est``, ``salt``, the tag and the points: other points draw
    others, the same arguments the same, another salt or seed others, and
    restoring the seed restores them; a biharmonic estimate (tag 4) draws
    other probes than a Laplacian one."""
    pts = torch.rand(64, 4, dtype=torch.float64)

    def est(points, salt=0, op=O.stde_laplacian):
        xs = F.coords_from_points(points)
        return op(xs[0] * xs[0] * xs[1] * xs[1], *xs, n_est=2, salt=salt).value

    set_seed(0)
    a = est(pts)
    assert torch.equal(a, est(pts.clone()))
    assert not torch.allclose(a, est(torch.rand(64, 4, dtype=torch.float64)))
    assert not torch.allclose(a, est(pts, salt=1))
    set_seed(123)
    assert not torch.allclose(a, est(pts))
    set_seed(0)
    assert torch.equal(a, est(pts))
    b = est(pts, op=O.stde_biharmonic)
    assert torch.equal(b, est(pts, op=O.stde_biharmonic))
    v2 = O._stde_probes(pts, range(4), 2, 0, 2, (64, 2, 4))
    v4 = O._stde_probes(pts, range(4), 2, 0, 4, (64, 2, 4))
    assert not torch.equal(v2, v4)


def test_stde_probes_are_balanced_and_uncorrelated():
    """Rademacher signs: each element +-1, about half of each, and
    neighbouring elements (rows, probes, coordinates) uncorrelated."""
    set_seed(0)
    v = O._stde_probes(torch.rand(2048, 10, dtype=torch.float64), range(10), 16, 0, 2, (2048, 16, 10))
    assert v.dtype == torch.float64 and set(v.unique().tolist()) == {-1.0, 1.0}
    assert abs(v.mean().item()) < 4 / np.sqrt(v.numel())
    for a, b in ((v[1:], v[:-1]), (v[:, 1:], v[:, :-1]), (v[..., 1:], v[..., :-1])):
        assert abs((a * b).mean().item()) < 4 / np.sqrt(a.numel())
    # a float32 cast of the points fixes the key: points equal in float32 draw the same probes
    p = torch.rand(8, 3, dtype=torch.float64)
    q = p.float().double()
    assert torch.equal(O._stde_probes(p, range(3), 4, 0, 2, (8, 4, 3)), O._stde_probes(q, range(3), 4, 0, 2, (8, 4, 3)))


@pytest.mark.parametrize('op', [O.stde_laplacian, O.stde_biharmonic, O.biharmonic])
def test_operators_validate_inputs_as_jax(op):
    jop = getattr(JO, op.__name__)
    jxs = JF.coordinates(np.random.rand(8), np.random.rand(8))
    txs = F.coords_from_points(torch.rand(8, 2, dtype=torch.float64))
    for jargs, targs in (((np.zeros(8),) + jxs, (np.zeros(8),) + txs), ((jxs[0] * jxs[1],), (txs[0] * txs[1],)),
                         ((jxs[0] * jxs[1], jxs[0] * 2), (txs[0] * txs[1], txs[0] * 2))):
        with pytest.raises(TypeError) as jerr:
            jop(*jargs)
        with pytest.raises(TypeError) as err:
            op(*targs)
        assert str(err.value) == str(jerr.value)


def test_stde_biharmonic_exact_on_separable_quartic_and_subset():
    xs = _coords(64, 5)
    u = sum((i + 1.0) * c * c * c * c for i, c in enumerate(xs)) + 3 * xs[0] * xs[0] * xs[1]
    assert (O.stde_biharmonic(u, *xs, n_est=2).value - 24.0 * 15).abs().max() < 1e-9
    x0, x1, x2 = _coords(64, 3)
    assert (O.stde_biharmonic(x0 ** 4 + 5 * x2 ** 4, x0, x1, n_est=2).value - 24.0).abs().max() < 1e-9


def test_stde_biharmonic_unbiased_and_single_probe_biased():
    xs = _coords(256, 4)
    u = xs[0] * xs[0] * xs[1] * xs[1]
    err = {n: (O.stde_biharmonic(u, *xs, n_est=n).value - 8.0).abs().mean().item() for n in (8, 1024)}
    assert err[1024] < err[8] and err[1024] < 0.6
    xs = _coords(512, 3)
    est = O.stde_biharmonic(xs[0] * xs[0] * xs[1] * xs[1], *xs, n_est=2048).value.mean().item()
    assert abs(est - 8.0) < 1.0 and abs(est - 24.0) > 10.0


def test_biharmonic_closed_form_subset_and_composed_laplacian():
    xs = _coords(64, 5)
    u = sum((i + 1.0) * c * c * c * c for i, c in enumerate(xs)) + xs[0] * xs[0] * xs[1] * xs[1]
    assert (O.biharmonic(u, *xs).value - (24.0 * 15 + 8.0)).abs().max() < 1e-9
    x0, x1, x2 = _coords(32, 3)
    v = x0 ** 4 + 5 * x2 ** 4 + x0 * x0 * x1 * x1
    assert (O.biharmonic(v, x0, x1).value - 32.0).abs().max() < 1e-9
    torch.manual_seed(2)
    xs = _coords(16, 3)
    u = F.network_field(FCNN(3, 1, hidden_units=(8,), dtype=torch.float64), xs)
    _close(O.biharmonic(u, *xs).value, O.laplacian(O.laplacian(u, *xs), *xs).value)
    with torch.no_grad():
        assert not O.biharmonic(u, *xs).value.requires_grad


def _poisson(FF, OO, d):
    return lambda u, *xs: [OO.laplacian(u, *xs) + sum(FF.sin(PI * x) for x in xs) * (PI ** 2 / d)]


def _plate(FF, OO):
    return lambda u, *xs: [OO.biharmonic(u, *xs) - sum(FF.cos(PI * x) for x in xs)]


@pytest.mark.parametrize('problem', ['poisson', 'plate'])
def test_generic_solver_step_matches_jax(problem):
    """The slice as a whole: a ``GenericSolver`` loss of the d = 3 exact
    Poisson problem (product mask, the kernel path on the card) and of the
    d = 4 clamped plate (``power=2``, the exact biharmonic: a fourth-order
    chain of ``torch.autograd.grad`` under the loss's backward), on fixed
    points: loss and every parameter gradient equal the JAX package's to
    1e-10 relative."""
    d = 3 if problem == 'poisson' else 4
    pts = np.random.RandomState(4).rand(20, d)
    jnet, params, tnet = _pair(d, seed=5)
    power = 1 if problem == 'poisson' else 2
    eqs = (_poisson(JF, JO, d), _poisson(F, O, d)) if problem == 'poisson' else (_plate(JF, JO), _plate(F, O))
    jsolver = JGenericSolver(eqs[0], [JBox(d, boundary_fn=_extension(JF), power=power)], nets=[jnet],
                             train_generator=JPredefinedGenerator(*pts.T), valid_generator=JPredefinedGenerator(*pts.T),
                             n_batches_valid=0)
    tsolver = GenericSolver(eqs[1], [DirichletBoxND(d, boundary_fn=_extension(F), power=power)], nets=[tnet],
                            train_generator=PredefinedGenerator(*pts.T), valid_generator=PredefinedGenerator(*pts.T),
                            n_batches_valid=0)
    cols = [pts[:, i:i + 1] for i in range(d)]
    jloss, (jgrads,) = jax.value_and_grad(
        lambda p: jsolver._loss_and_metrics(p, [jnp.asarray(c) for c in cols])[0])([params])
    F.reset_taylor_fallback_count()
    tloss = tsolver._loss_and_metrics([torch.tensor(c) for c in cols])[0]
    tloss.backward()
    assert F.taylor_fallback_count() == (0 if problem == 'poisson' else 1)
    _close(tloss, jloss)
    for lin, lp in zip(tnet.linears, jgrads['layers'], strict=True):
        _close(lin.weight.grad.T, lp['W'])
        _close(lin.bias.grad, lp['b'])


def test_stde_poisson_trains_on_the_cpu():
    """README's CPU drive: d = 5 Poisson through ``stde_laplacian``,
    ``DirichletBoxND`` and ``GeneratorHypercube`` in float32: one compose
    fallback per residual, no kernel, and the loss falls."""
    set_tensor_type('cpu', 32)
    set_seed(0)
    d = 5
    solver = GenericSolver(
        lambda u, *xs: [O.stde_laplacian(u, *xs, n_est=16) + sum(F.sin(PI * x) for x in xs) * (PI ** 2 / d)],
        [DirichletBoxND(d, boundary_fn=lambda *xs: sum(F.sin(PI * x) for x in xs) / d)],
        nets=[FCNN(d, 1, hidden_units=(32, 32), actv=SinActv)],
        train_generator=GeneratorHypercube(128, d), valid_generator=GeneratorHypercube(128, d), n_batches_valid=0,
        optimizer=None)
    F.reset_taylor_fallback_count()
    solver.fit(60, tqdm_file=None)
    assert F.taylor_fallback_count() == 60
    hist = solver.metrics_history['train_loss']
    assert np.mean(hist[-10:]) < 0.5 * np.mean(hist[:10])


def test_compose_derivatives_under_no_grad_share_first_gradients():
    """F6: under ``no_grad`` (validation, ``get_residuals``), the second
    derivative of a field along one axis freed the graph of its first
    gradients, which its derivative along the next axis reuses, so
    ``laplacian`` in compose mode raised. It now equals Taylor mode."""
    torch.manual_seed(3)
    xs = _coords(16, 3)
    u = F.network_field(FCNN(3, 1, hidden_units=(8,), dtype=torch.float64), xs)
    want = O.laplacian(u, *xs).value
    with F.eval_mode('compose'), torch.no_grad():
        _close(O.laplacian(u, *xs).value, want)


def test_coordinate_run_and_tree_product():
    """``cat`` of a run of raw coordinates is a slice of the points (the
    stacked form the high-dimensional sums use), with the generic cat's
    values and series; the mask's pairwise product equals ``torch.prod``
    and its leave-one-out products the product over the other columns,
    zeros included."""
    from neurodiffeq_tpu_torch.conditions import _leave_one_out, _tree_prod
    pts = torch.rand(9, 5, dtype=torch.float64)
    xs = F.coords_from_points(pts)
    run, gen = F.cat(xs[1:4]), F.cat([xs[1], xs[2] * 1.0, xs[3]])
    assert torch.equal(run.fn(pts), pts[:, 1:4])
    s = F.sin(run).sum(axis=1)
    _close(s.value, F.sin(gen).sum(axis=1).value)
    for i in range(5):
        _close(F.diff(s, xs[i], 2).value, F.diff(F.sin(gen).sum(axis=1), xs[i], 2).value)
    with F.eval_mode('compose'):
        _close(F.diff(F.sin(F.cat(xs)).sum(axis=1), xs[2]).value, torch.cos(pts[:, 2:3]))
    for m in (1, 2, 5, 8, 100):
        cols = torch.rand(6, m, dtype=torch.float64)
        cols[0, m // 2] = 0.0
        _close(_tree_prod(cols), cols.prod(dim=1, keepdim=True))
        loo = _leave_one_out(cols)
        for j in range(m):
            _close(loo[:, j], torch.cat([cols[:, :j], cols[:, j + 1:]], dim=1).prod(dim=1))


def test_solver_trains_every_optimizer_parameter():
    """The solver's backward runs into the optimizer's parameters only (the
    compose path's differentiable copies of the points get none), so an
    unknown coefficient of the equation trained beside the net still gets
    its gradient."""
    d = 3
    k = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    net = FCNN(d, 1, hidden_units=(8,), actv=SinActv)
    pts = np.random.RandomState(0).rand(16, d)
    solver = GenericSolver(lambda u, *xs: [O.stde_laplacian(u, *xs, n_est=4) - k * u],
                           [DirichletBoxND(d)], nets=[net], train_generator=PredefinedGenerator(*pts.T),
                           valid_generator=PredefinedGenerator(*pts.T), n_batches_valid=0,
                           optimizer=torch.optim.Adam(list(net.parameters()) + [k], lr=1e-2))
    solver.fit(3, tqdm_file=None)
    assert k.item() != 0.5


def test_solver_frees_each_batch_without_the_cycle_collector():
    """F7: a batch's coordinate set memoizes fields that refer back to it;
    the solver releases it once the loss is built, so that reference
    counting alone frees the batch's tensors and graphs (with the cycle
    collector off, no coordinate set outlives its step)."""
    import gc
    d = 4
    pts = np.random.RandomState(0).rand(16, d)
    solver = GenericSolver(_poisson(F, O, d), [DirichletBoxND(d, boundary_fn=_extension(F))],
                           nets=[FCNN(d, 1, hidden_units=(8,), actv=SinActv)],
                           train_generator=PredefinedGenerator(*pts.T), valid_generator=PredefinedGenerator(*pts.T),
                           n_batches_valid=1)
    gc.collect()
    gc.disable()
    try:
        solver.fit(2, tqdm_file=None)
        alive = [o for o in gc.get_objects() if isinstance(o, F.CoordSet)]
    finally:
        gc.enable()
    assert not alive
