"""The PyTorch port's residual-adaptive sampling against the JAX package, in float64.

The random streams cannot match, so the selection is held to what does not
depend on them:

- 'power': the port's selection probabilities of given candidates and
  scores equal the frequencies with which the JAX package's
  ``sample_scored`` picks them (4,000 draws, within 5 standard errors), and
  the port's own draws follow its probabilities;
- 'topk': the same candidates and scores give the same points in the same order;
- ``_residual_scores`` of the Burgers solver equals the JAX package's on
  shared parameters and points to 1e-10;
- a buried ``ResidualAdaptiveGenerator`` warns in ``__init__`` and
  ``set_generator``, ``contains_buried_adaptive`` agrees with the JAX
  package's, and a base generator whose batches change size is refused;
- ``examples/burgers.py``'s adaptive problem: exact at the initial line and
  the walls untrained, and 3 epochs that score 16,384 candidates each, with
  6 Taylor-MLP calls per epoch (scoring, train and 4 validation batches).
"""
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from neurodiffeq_tpu import fields as JF, generators as JG
from neurodiffeq_tpu.conditions import IBVP1D as JIBVP1D
from neurodiffeq_tpu.networks import FCNN as JFCNN
from neurodiffeq_tpu.solvers import Solver2D as JSolver2D
from neurodiffeq_tpu_torch import fields as F, generators as G
from neurodiffeq_tpu_torch.conditions import IBVP1D
from neurodiffeq_tpu_torch.networks import FCNN
from neurodiffeq_tpu_torch.ops import taylor_mlp
from neurodiffeq_tpu_torch.solvers import Solver2D
from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type

torch.set_num_threads(2)
TOL = 1e-10
NU = 0.01 / np.pi


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port defaults to the card; these tests ask for the CPU."""
    device, dtype = get_default_device(), get_default_dtype()
    set_tensor_type('cpu', 64)
    F.reset_taylor_fallback_count()  # the counter is global to the process: each test starts at 0
    yield
    set_tensor_type(str(device), 64 if dtype == torch.float64 else 32)


def _close(got, want, tol=TOL):
    got, want = (a.detach().numpy() if torch.is_tensor(a) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max() / scale


POINTS = np.array([0.1, 0.2, 0.3, 0.4, 0.5])
SCORES = np.array([0.3, 2.0, 0.05, 1.1, 0.6])


@pytest.mark.parametrize('alpha,c', [(1.0, 1.0), (2.0, 0.25)])
def test_power_probabilities_match_jax_frequencies(alpha, c):
    """Five points drawn twice (oversample 2), scored by position: the
    probability of each point is the sum over its two copies."""
    scores = np.concatenate([SCORES, SCORES[::-1]])
    jgen = JG.ResidualAdaptiveGenerator(JG.PredefinedGenerator(POINTS), oversample=2, alpha=alpha, c=c)
    draws = jax.jit(jax.vmap(lambda k: jgen.sample_scored(k, lambda cand: jnp.asarray(scores))))(
        jax.random.split(jax.random.PRNGKey(0), 4000))
    jax_freq = np.array([(np.asarray(draws) == p).mean() for p in POINTS])

    gen = G.ResidualAdaptiveGenerator(G.PredefinedGenerator(POINTS), oversample=2, alpha=alpha, c=c)
    p = gen.probabilities(torch.tensor(scores)).numpy()
    want = np.array([p[i] + p[5 + i] for i in range(5)])
    n = draws.size
    assert np.all(np.abs(jax_freq - want) <= 5 * np.sqrt(want * (1 - want) / n)), (jax_freq, want)
    rng = torch.Generator().manual_seed(0)
    port = torch.cat([gen.sample_scored(rng, lambda cand: torch.tensor(scores)) for _ in range(4000)]).numpy()
    port_freq = np.array([(port == q).mean() for q in POINTS])
    assert np.all(np.abs(port_freq - want) <= 5 * np.sqrt(want * (1 - want) / n)), (port_freq, want)


@pytest.mark.parametrize('oversample', [1, 3])
def test_topk_picks_the_same_points_as_jax(oversample):
    rng = np.random.RandomState(oversample)
    pts = rng.rand(6, 2)
    scores = rng.rand(6 * oversample)
    jgen = JG.ResidualAdaptiveGenerator(JG.PredefinedGenerator(pts[:, 0], pts[:, 1]), oversample=oversample,
                                        strategy='topk')
    want = jgen.sample_scored(jax.random.PRNGKey(0), lambda cand: jnp.asarray(scores))
    gen = G.ResidualAdaptiveGenerator(G.PredefinedGenerator(pts[:, 0], pts[:, 1]), oversample=oversample,
                                      strategy='topk')
    got = gen.sample_scored(torch.Generator(), lambda cand: torch.tensor(scores))
    for g, w in zip(got, want, strict=True):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _burgers(mod, sampling='adaptive', n_points=2048, **kwargs):
    """``examples/burgers.py``'s ``build`` in either package."""
    gens, solver_cls = (JG, JSolver2D) if mod is JF else (G, Solver2D)
    cond = (JIBVP1D if mod is JF else IBVP1D)(
        x_min=-1.0, x_max=1.0, t_min=0.0, t_min_val=lambda x: -mod.sin(np.pi * x),
        x_min_val=lambda t: 0 * t, x_max_val=lambda t: 0 * t)
    base = (gens.Generator1D(n_points, -1.0, 1.0, method='uniform')
            * gens.Generator1D(n_points, 0.0, 1.0, method='uniform'))
    train = kwargs.pop('train_generator', None) or (
        gens.ResidualAdaptiveGenerator(base, oversample=8, strategy='power', alpha=1.0, c=1.0)
        if sampling == 'adaptive' else base)
    return solver_cls(
        pde_system=lambda u, x, t: [mod.diff(u, t) + u * mod.diff(u, x) - NU * mod.diff(u, x, order=2)],
        conditions=[cond], xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0), train_generator=train,
        valid_generator=gens.Generator2D((32, 32), xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0), method='equally-spaced'),
        **kwargs)


def test_residual_scores_match_jax():
    jnet = JFCNN(n_input_units=2, hidden_units=(20,) * 8)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jnet.init(jax.random.PRNGKey(1)))
    jsolver = _burgers(JF, nets=[jnet], residual_weights=[2.0])
    solver = _burgers(F, nets=[FCNN(n_input_units=2, hidden_units=(20,) * 8)], residual_weights=[2.0])
    solver.load_jax_params([jax.tree.map(np.asarray, params)])
    pts = np.random.RandomState(2).rand(64, 2) * [2, 1] - [1, 0]
    want = jsolver._residual_scores([params], [jnp.asarray(pts[:, :1]), jnp.asarray(pts[:, 1:])])
    got = solver._residual_scores([torch.tensor(pts[:, :1]), torch.tensor(pts[:, 1:])])
    assert not got.requires_grad
    _close(got, want)


def test_buried_adaptive_warns_and_variable_size_bases_are_refused():
    def gens(mod):
        a = mod.Generator1D(8, 0.0, 1.0)
        rag = mod.ResidualAdaptiveGenerator(a * a)
        return [rag, rag + (a * a), mod.TransformGenerator(rag, [None, None]), mod.SamplerGenerator(rag), a * a]

    assert ([G.contains_buried_adaptive(g) for g in gens(G)]
            == [JG.contains_buried_adaptive(g) for g in gens(JG)] == [False, True, True, True, False])
    a = G.Generator1D(8, 0.0, 1.0)
    buried = G.ResidualAdaptiveGenerator(a * a) + (a * a)
    with pytest.warns(UserWarning, match='OUTERMOST'):
        solver = _burgers(F, n_points=8, nets=[FCNN(2, 1, hidden_units=(4,))], train_generator=buried)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        solver.set_generator(buried, phase='valid')
    with pytest.warns(UserWarning, match='OUTERMOST'):
        solver.set_generator(buried)
    for base in (G.FilterGenerator(a * a, lambda xs: xs[0] > 0.5),
                 G.BatchGenerator(a, 4),
                 G.FilterGenerator(a * a, lambda xs: xs[0] > 0.5) + (a * a)):
        with pytest.raises(ValueError, match='fixed size'):
            G.ResidualAdaptiveGenerator(base)
    G.ResidualAdaptiveGenerator(G.FilterGenerator(a * a, lambda xs: xs[0] > 0.5, fixed_size=True))
    for bad in (dict(strategy='greedy'), dict(oversample=0), dict(c=-1.0)):
        with pytest.raises(ValueError):
            G.ResidualAdaptiveGenerator(a, **bad)


@pytest.mark.parametrize('sampling', ['uniform', 'adaptive'])
def test_untrained_burgers_is_exact_at_the_initial_line_and_walls(sampling):
    """``tests/test_burgers_example.py``'s invariant on the port."""
    sol = _burgers(F, sampling).get_solution(best=False)
    xs, ts = np.linspace(-1.0, 1.0, 17), np.linspace(0.0, 1.0, 9)
    assert np.allclose(sol(xs, np.zeros_like(xs), to_numpy=True), -np.sin(np.pi * xs), atol=1e-8)
    for wall in (-1.0, 1.0):
        assert np.allclose(sol(np.full_like(ts, wall), ts, to_numpy=True), 0.0, atol=1e-8)


def test_short_adaptive_burgers_fit(monkeypatch):
    """3 epochs of ``examples/burgers.py``'s adaptive problem: every epoch
    scores 8 x 2,048 candidates in one network pass, then trains on 2,048
    points and validates on 4 batches of 32 x 32: 6 Taylor-MLP calls (on
    the card, 6 kernel launches), no fallback."""
    calls = []
    real = taylor_mlp.fcnn_taylor
    monkeypatch.setattr(taylor_mlp, 'fcnn_taylor', lambda pts, *a, **k: calls.append(len(pts)) or real(pts, *a, **k))
    torch.manual_seed(0)
    solver = _burgers(F, nets=[FCNN(n_input_units=2, hidden_units=(20,) * 8)],
                      generator=torch.Generator().manual_seed(0))
    F.reset_taylor_fallback_count()
    solver.fit(max_epochs=3, tqdm_file=None)
    assert F.taylor_fallback_count() == 0
    assert calls == [16384, 2048, 1024, 1024, 1024, 1024] * 3
    hist = solver.metrics_history['train_loss']
    assert len(hist) == 3 and np.isfinite(hist).all()
