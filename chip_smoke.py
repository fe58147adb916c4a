"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths through its two hand-written CUDA kernels
(``neurodiffeq_tpu_torch/csrc/taylor_mlp.cu``): ``taylor_mlp_1h`` for nets
with one hidden layer, ``taylor_mlp`` for every other depth. Phases, one
line each or more:

1. device: a CUDA device must be present (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the kernel library from ``neurodiffeq_tpu_torch/csrc``;
3. each kernel against the plain twin on the card, float64 and float32, at
   every shape of ``CHECK_SHAPES`` and ``TABLE_SHAPES``, and two launches
   of each must be bitwise equal. Error = max |kernel - twin| / max |twin|;
   limits 1e-10 (float64) and 1e-4 (float32: the kernel sums in another
   order than cuBLAS). Then SIREN (w0 = 30, ``SIREN_SHAPES``, order 2),
   whose Taylor path folds w0 into its layers and launches the kernel,
   against the plain layer-by-layer engine, with the same limits;
4. gradient through the kernel's autograd function against autograd over
   the twin, flagship shape, float64, limit 1e-10;
5. the paths, each with the launch counts reset just before and read just
   after:
   a. the main path, flagship training (Solver2D, FCNN 2-512-1 tanh,
      32 x 32 grid), float32, ``fit(2000)``: ``taylor_mlp_1h`` must carry
      it, no Taylor fallback may occur, the loss must fall, and
      ``get_solution()`` must be within 1e-2 of the analytic solution on a
      101 x 101 grid; ``get_residuals`` must be finite;
   b. the same problem through ``Solver2D`` with every default (the
      default device, the default FCNN 2-32-32-1, the default generators),
      ``fit(300)``: ``taylor_mlp`` must carry it and the loss must fall;
   c. the ODE path, Lotka-Volterra through ``Solver1D`` (two FCNN 1-32-32-1
      sin nets, ``IVP(0.1, 1.5)`` and ``IVP(0.1, 1.0)``, t in [0.1, 12], the
      default generators of 32 points), float32, ``fit(3000)`` with a
      ``PeriodLocal(500)``-gated callback: ``taylor_mlp`` must carry it, no
      fallback, the loss must fall, the callback must fire at epochs
      500, ..., 3000, max |u - odeint| < 0.05 on 500 points and the initial
      values exact to 1e-5; then ``fit(200)`` of the same problem under the
      ``h1`` loss, which reaches the kernel at order 2;
   d. the spherical path, the Gaussian-charge Poisson problem through
      ``SolverSpherical`` (FCNN 3-64-64-1 tanh, ``DirichletBVPSpherical``
      on r in [0.1, 3], the default ``GeneratorSpherical`` of 512 points,
      ``l2``, Adam under the cosine decay 1e-3 -> 1e-5 as a ``LambdaLR``
      stepped by a callback), on the port's defaults (cuda, float32),
      ``fit(5000)``: ``taylor_mlp`` must carry it at 5 launches per epoch
      (1 train and 4 validation batches) with no ``taylor_mlp_1h`` launch
      and no fallback, the loss must fall, the rate must end at 1e-5,
      ``get_solution()`` must be within ``SPH_LIMIT`` relative error of
      ``K Q / r erf(r / sqrt 2)`` on 256 radii at random angles, hold
      u(0.1) and u(3) to 1e-5, and ``get_residuals`` must be finite;
6. timing: device time per call of kernel and twin at every shape of
   ``TABLE_SHAPES`` (``torch.profiler``) beside the kernel's bound, the
   wrapper's host enqueue time per call, and train-only epochs/s with the
   kernel and with the twin swapped in, interleaved; the Lotka-Volterra
   and the spherical epochs' rates and device-busy shares (full run only);
7. the result.

``python3 chip_smoke.py --times-only`` runs phases 1, 2 and 6 alone, with
nothing but ``fcnn_taylor`` and ``fcnn_taylor_reference`` of the kernel
module, so that it also times an older tree of the port.

Any failure ends the run with a non-zero exit code and no result line. The
card's name and power limit and the kernel record come before the last
line, which is ``{"ok": true, "device": {...}}``.
"""
import inspect
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = 'neurodiffeq_tpu_torch/csrc/taylor_mlp.cu'
REPLACES = 'neurodiffeq_tpu/ops/pallas_mlp.py:115'
GRID, HIDDEN, EPOCHS, DEFAULT_NET_EPOCHS = (32, 32), (512,), 2000, 300
LV_EPOCHS, LV_H1_EPOCHS, LV_PERIOD = 3000, 200, 500
# 5000 epochs keep phase 5d near 1.5 minutes on the card; the limit is about
# twice the 1.747e-2 that the port's CPU float32 run of this phase gave at
# the same epoch count, and under the JAX package's own 0.08 at 2500 epochs
SPH_EPOCHS, SPH_LIMIT = 5000, 0.035
SPH_R0, SPH_R1 = 0.1, 3.0
F32, F64 = torch.float32, torch.float64
CHECK_SHAPES = [  # (layer widths, activation, order, N)
    ((2, 512, 1), 'tanh', 2, 1024),
    ((2, 64, 64, 1), 'tanh', 2, 1000),
    ((1, 32, 32, 1), 'sin', 1, 37),
    ((1, 32, 32, 1), 'sin', 2, 37),
    ((3, 16, 2), 'tanh', 2, 37),
    ((2, 1), 'tanh', 2, 37),
    ((3, 32, 32, 1), 'tanh', 2, 512),
]
TABLE_SHAPES = [  # (layer widths, activation, order, N, dtype timed in phase 6)
    ((2, 512, 1), 'tanh', 2, 1024, F32),     # flagship train and validation batch
    ((2, 512, 1), 'tanh', 2, 1024, F64),
    ((2, 512, 1), 'tanh', 2, 10201, F32),    # get_residuals on 101 x 101
    ((2, 512, 1), 'tanh', 2, 65536, F32),    # large enough to be bound by the arithmetic
    ((8, 64, 1), 'tanh', 2, 1023, F32),      # d = 8: 17 streams; ragged N
    ((2, 50, 3), 'sin', 1, 37, F32),         # width not a multiple of 32, n_out > 1
    ((2, 50, 3), 'sin', 2, 1, F32),
    ((2, 50, 3), 'sin', 2, 37, F32),
    ((2, 32, 32, 1), 'tanh', 2, 1024, F32),  # Solver2D's default net, phase 5b
    ((3, 64, 64, 1), 'tanh', 2, 512, F32),   # spherical Poisson width, phase 5d
    ((3, 32, 32, 1), 'tanh', 2, 512, F32),   # SolverSpherical's default net
    ((2, 128, 128, 128, 128, 128, 3), 'tanh', 2, 16384, F32),  # cavity width
    ((1, 32, 32, 1), 'sin', 1, 32, F32),     # Lotka-Volterra batch, phase 5c
    ((1, 32, 32, 1), 'sin', 2, 32, F32),     # the same under the h1 loss
]
SIREN_SHAPES = [((2, 32, 32, 1), 1024), ((2, 64, 1), 1024)]  # (layer widths, N), w0 = 30, order 2
TOL = {F64: 1e-10, F32: 1e-4}
# H100 SXM peaks outside the tensor cores (float32, float64) and HBM3's rate, NVIDIA's data sheet
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
PEAK_BYTES = 3.35e12


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def shape_name(dims, actv, order, n, dtype=None):
    dt = f"{str(dtype)[6:]} " if dtype is not None else ''
    return f"{dt}{'-'.join(map(str, dims))} {actv} order {order} N={n}"


def rel_err(got, want):
    """max |got - want| / max |want|, in float64 (0 where both are all zero)."""
    diff = (got.double() - want.double()).abs().max().item()
    return diff / max(want.double().abs().max().item(), 1e-300)


def random_layers(dims, seed):
    g = torch.Generator().manual_seed(seed)
    return [((torch.rand(a, b, generator=g, dtype=F64) * 2 - 1) / math.sqrt(a),
             (torch.rand(b, generator=g, dtype=F64) * 2 - 1) / math.sqrt(a))
            for a, b in zip(dims[:-1], dims[1:])]


def inputs(dims, n, dtype, seed):
    """Points and layers on the card; each W is the (n_in, n_out) view of an
    (n_out, n_in) tensor, as ``FCNN.layers()`` gives ``nn.Linear`` weights."""
    g = torch.Generator().manual_seed(100 + seed)
    pts = torch.rand(n, dims[0], generator=g, dtype=F64).to('cuda', dtype)
    return pts, [(W.t().contiguous().to('cuda', dtype).t(), b.to('cuda', dtype))
                 for W, b in random_layers(dims, seed)]


def taylor_cost(dims, actv, order, n, esize):
    """(floating-point operations, bytes) that one Taylor-mode forward must
    do and move. Per point: a hidden unit of the first layer costs 2d for
    z, one for the activation (two for sin: sin and cos), the chain rule
    (4 for tanh: a^2, 1 - a^2, -2a, times f'; 1 for sin: -a), d for the
    first-order tangents and 2d more at order 2; a middle layer costs
    2 S h_in h_out for the S = 1 + order*d streams plus, per unit, the
    activation and chain rule and d (order 1) or 5d (order 2) for the
    tangent updates; the output layer 2 S h_in n_out. Bytes: the points,
    the parameters and the S outputs, each once."""
    d, n_out, s = dims[0], dims[-1], 1 + order * dims[0]
    act = (1 + 4) if actv == 'tanh' else (2 + 1)
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = esize * (n * d + params + n * n_out * s)
    if len(dims) == 2:
        return n * 2 * d * n_out, nbytes
    flops = dims[1] * (2 * d + act + d + (2 * d if order == 2 else 0))
    for h_in, h_out in zip(dims[1:-2], dims[2:-1]):
        flops += 2 * s * h_in * h_out + h_out * (act + (5 * d if order == 2 else d))
    flops += 2 * s * dims[-2] * n_out
    return n * flops, nbytes


def bound_ms(dims, actv, order, n, dtype):
    """(least milliseconds the card could take, 'operations' or 'bytes')."""
    flops, nbytes = taylor_cost(dims, actv, order, n, torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def flagship_solver(**kwargs):
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN

    dev, dt = torch.device('cuda'), F32
    return laplace_solver(
        nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=HIDDEN, device=dev, dtype=dt)],
        train_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced-noisy', device=dev, dtype=dt),
        valid_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced', device=dev, dtype=dt),
        device=dev, dtype=dt, **kwargs)


def laplace_solver(**kwargs):
    """The flagship's 2-D Laplace Dirichlet problem; ``kwargs`` go to ``Solver2D``."""
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.solvers import Solver2D

    cond = DirichletBVP2D(
        x_min=0.0, x_min_val=lambda y: 0 * y,
        x_max=1.0, x_max_val=lambda y: 0 * y,
        y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x),
        y_max=1.0, y_max_val=lambda x: 0 * x)
    return Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)],
                    conditions=[cond], xy_min=(0.0, 0.0), xy_max=(1.0, 1.0), **kwargs)


def lv_solver(**kwargs):
    """Lotka-Volterra, the BASELINE config of ``benchmarks/configs.py``: two
    FCNN 1-32-32-1 sin nets through ``Solver1D`` with its default
    generators, on the port's default device and dtype (cuda, float32)."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.conditions import IVP
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv
    from neurodiffeq_tpu_torch.solvers import Solver1D

    return Solver1D(ode_system=lambda u, v, t: [diff(u, t) - (u - u * v), diff(v, t) - (u * v - v)],
                    conditions=[IVP(0.1, 1.5), IVP(0.1, 1.0)], t_min=0.1, t_max=12.0,
                    nets=[FCNN(actv=SinActv), FCNN(actv=SinActv)], **kwargs)


def lv_reference(ts):
    """(prey, predator) of Lotka-Volterra at ``ts`` by ``scipy.integrate.odeint``."""
    from scipy.integrate import odeint
    ref = odeint(lambda y, t: [y[0] - y[0] * y[1], y[0] * y[1] - y[1]], [1.5, 1.0], ts, rtol=1e-10, atol=1e-10)
    return ref[:, 0], ref[:, 1]


def sph_exact(r):
    """The potential of the unit Gaussian charge: K Q / r erf(r / sqrt 2)."""
    from scipy.special import erf
    return 1 / (4 * np.pi) / r * erf(r / np.sqrt(2))


def sph_solver(epochs):
    """Spherical Poisson, the BASELINE config of ``benchmarks/configs.py``,
    on the port's default device and dtype (cuda, float32), with the cosine
    decay 1e-3 -> 1e-5 over ``epochs`` (optax's ``cosine_decay_schedule``,
    alpha = 1e-2) as a ``LambdaLR``. Returns the solver and a callback that
    steps the schedule once per epoch."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBVPSpherical
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.operators import spherical_laplacian
    from neurodiffeq_tpu_torch.solvers import SolverSpherical

    coeff = 1 / np.power(2 * np.pi, 1.5)
    v0, v1 = float(sph_exact(SPH_R0)), float(sph_exact(SPH_R1))
    solver = SolverSpherical(
        pde_system=lambda u, r, th, ph: [spherical_laplacian(u, r, th, ph) + coeff * F.exp(-(r ** 2) / 2)],
        conditions=[DirichletBVPSpherical(SPH_R0, lambda th, ph: v0 + 0 * th, SPH_R1, lambda th, ph: v1 + 0 * th)],
        r_min=SPH_R0, r_max=SPH_R1, nets=[FCNN(n_input_units=3, n_output_units=1, hidden_units=(64, 64))])
    alpha = 1e-2
    sched = torch.optim.lr_scheduler.LambdaLR(
        solver.optimizer, lambda k: alpha + (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(k, epochs) / epochs)))
    return solver, lambda s: sched.step()


def run_sph(F, taylor_mlp):
    """Phase 5d: the spherical path. Returns its launch counts."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(0)
    solver, step_schedule = sph_solver(SPH_EPOCHS)
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(SPH_EPOCHS, callbacks=[step_schedule], tqdm_file=None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    lr = solver.optimizer.param_groups[0]['lr']
    rng = np.random.RandomState(42)  # the angles as benchmarks/configs.py samples them
    rs = np.linspace(SPH_R0, SPH_R1, 256)
    ths, phs = rng.rand(256) * np.pi * 0.9 + 0.05, rng.rand(256) * 2 * np.pi
    sol = solver.get_solution()
    u = sol(rs, ths, phs, to_numpy=True)
    rel = float((np.abs(u - sph_exact(rs)) / np.abs(sph_exact(rs))).max())
    ub = sol(np.array([SPH_R0, SPH_R0, SPH_R1, SPH_R1]), np.array([0.3, 2.5, 1.0, 3.0]),
             np.array([0.1, 4.0, 2.0, 6.0]), to_numpy=True)
    bc_err = float(np.abs(ub - sph_exact(np.array([SPH_R0, SPH_R0, SPH_R1, SPH_R1]))).max())
    res = solver.get_residuals(rs, ths, phs, to_numpy=True)
    checks = {
        'taylor_mlp carried it at 5 launches per epoch': launches['taylor_mlp'] == 5 * SPH_EPOCHS,
        'taylor_mlp_1h not launched': launches['taylor_mlp_1h'] == 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': late < early,
        'rate ended at 1e-5': abs(lr - 1e-5) < 1e-12,
        f'max rel error < {SPH_LIMIT}': bool(np.isfinite(u).all()) and rel < SPH_LIMIT,
        'u(0.1) and u(3) exact to 1e-5': bc_err < 1e-5,
        'residuals finite': res.shape == rs.shape and bool(np.isfinite(res).all()),
    }
    phase('5d spherical', f"SolverSpherical fit({SPH_EPOCHS}) float32 in {fit_s:.1f} s ({SPH_EPOCHS / fit_s:.1f} "
                          f"epochs/s with validation): launches {launches} "
                          f"({launches['taylor_mlp'] / SPH_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} "
                          f"fallbacks, train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), final "
                          f"lr {lr:.3e}, max |u - exact| / |exact| on 256 radii {rel:.4e}, boundary error "
                          f"{bc_err:.1e}, max |residual| {np.abs(res).max():.3e}; "
                          + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: spherical Poisson check failed")
    return launches


def check_siren():
    """Phase 3, SIREN: {(dims, n, dtype): max abs error} of the kernel path
    against the plain layer-by-layer engine, or SystemExit."""
    from neurodiffeq_tpu_torch.networks import SIREN
    from neurodiffeq_tpu_torch.ops.taylor import TContext, TSeries

    errors = {}
    with torch.no_grad():
        for dtype in (F64, F32):
            for i, (dims, n) in enumerate(SIREN_SHAPES):
                torch.manual_seed(i)
                net = SIREN(dims[0], dims[-1], hidden_units=dims[1:-1], w0=30.0, device='cuda', dtype=dtype)
                pts = torch.rand(n, dims[0], generator=torch.Generator().manual_seed(200 + i),
                                 dtype=F64).to('cuda', dtype)
                d1 = torch.eye(dims[0], dtype=dtype, device='cuda')[:, None, :]
                ctx = TContext(pts, 2)

                def series(meta):
                    return net.taylor_apply(TSeries(pts, [d1, torch.zeros_like(d1)], meta=meta), ctx)

                got, again, want = series('raw_coords'), series('raw_coords'), series(None)
                torch.cuda.synchronize()
                got, again, want = ([s.c0] + s.derivs for s in (got, again, want))
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = same and all(e <= TOL[dtype] for e in errs)
                phase('3 kernel', f"SIREN w0=30 {shape_name(dims, 'sin', 2, n, dtype)} against the plain engine: "
                                  f"rel err {' '.join(f'{e:.2e}' for e in errs)} (limit {TOL[dtype]:.0e}), "
                                  f"two launches {'bitwise equal' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: SIREN's kernel path disagrees with the plain engine")
                errors[(dims, n, dtype)] = max((a - b).abs().max().item() for a, b in zip(got, want))
    return errors


def run_lv(F, taylor_mlp):
    """Phase 5c: the ODE path. Returns the launch counts of the l2 and h1 fits."""
    from neurodiffeq_tpu_torch.callbacks import ActionCallback, PeriodLocal
    from neurodiffeq_tpu_torch.utils import set_seed

    class Record(ActionCallback):
        """Records the epochs and losses at which it fires."""

        def __init__(self):
            super().__init__()
            self.fired = []

        def __call__(self, solver):
            self.fired.append((solver.local_epoch, solver.metrics_history['train_loss'][-1]))

    set_seed(0)
    solver = lv_solver()
    record = Record()
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(LV_EPOCHS, callbacks=[record.conditioned_on(PeriodLocal(LV_PERIOD))], tqdm_file=None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    ts = np.linspace(0.1, 12, 500)
    prey, pred = solver.get_solution()(ts, to_numpy=True)
    ref_prey, ref_pred = lv_reference(ts)
    max_err = float(max(np.abs(prey - ref_prey).max(), np.abs(pred - ref_pred).max()))
    u0 = [float(u[0]) for u in solver.get_solution()(np.array([0.1]), to_numpy=True)]
    ic_err = max(abs(u0[0] - 1.5), abs(u0[1] - 1.0))
    checks = {
        'taylor_mlp launched during fit': launches['taylor_mlp'] > 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': late < early,
        'callback fired every 500 epochs': [e for e, _ in record.fired] == list(range(LV_PERIOD, LV_EPOCHS + 1,
                                                                                     LV_PERIOD)),
        'max error vs odeint < 0.05': bool(np.isfinite(prey).all() and np.isfinite(pred).all()) and max_err < 0.05,
        'initial values exact to 1e-5': ic_err < 1e-5,
    }
    phase('5c Lotka-Volterra', f"Solver1D fit({LV_EPOCHS}) float32 in {fit_s:.1f} s ({LV_EPOCHS / fit_s:.1f} "
                               f"epochs/s with validation): launches {launches} "
                               f"({launches['taylor_mlp'] / LV_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} "
                               f"fallbacks, train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), "
                               f"callback fired at {[e for e, _ in record.fired]}, max |u - odeint| on 500 points "
                               f"{max_err:.3e}, u(0.1) = {u0} (error {ic_err:.1e}); "
                               + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: Lotka-Volterra check failed")

    set_seed(0)
    solver = lv_solver(loss_fn='h1')
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    solver.fit(LV_H1_EPOCHS, tqdm_file=None)
    torch.cuda.synchronize()
    launches_h1 = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:20])), float(np.mean(hist[-20:]))
    checks = {
        'taylor_mlp launched during fit': launches_h1['taylor_mlp'] > 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': bool(np.isfinite(hist).all()) and late < early,
    }
    phase('5c Lotka-Volterra', f"h1 loss, fit({LV_H1_EPOCHS}): launches {launches_h1} "
                               f"({launches_h1['taylor_mlp'] / LV_H1_EPOCHS:.2f} taylor_mlp per epoch, order 2), "
                               f"{fallbacks} fallbacks, train loss mean {early:.3e} (first 20) -> {late:.3e} "
                               f"(last 20); " + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: Lotka-Volterra h1 check failed")
    return launches, launches_h1


def time_epochs(card, label, solver, callbacks=()):
    """Phase 6: the epoch as ``fit`` runs it (train and validation):
    epochs/s over three 300-epoch windows, and device time per epoch and
    kernels per epoch from the profiler, as a share of the epoch."""
    from torch.profiler import ProfilerActivity, profile

    solver.fit(50, callbacks=callbacks, tqdm_file=None)
    rates = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.fit(300, callbacks=callbacks, tqdm_file=None)
        torch.cuda.synchronize()
        rates.append(300 / (time.perf_counter() - t0))
    n = 50
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.fit(n, callbacks=callbacks, tqdm_file=None)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == 'CUDA']
    dev_ms = sum(e.device_time for e in kernels) / n / 1e3
    med = float(np.median(rates))
    phase('6 timing', f"{card}: {label} epochs/s in 300-epoch windows: {' '.join(f'{r:.2f}' for r in rates)} "
                      f"(median {med:.2f}, {1e3 / med:.3f} ms per epoch); profiler over {n} epochs: "
                      f"{len(kernels) / n:.1f} device kernels and {dev_ms:.4f} ms of device time per epoch, "
                      f"device busy {dev_ms * med / 1e3:.1%} of the unprofiled epoch")


def cuda_time_ms(fn, calls=200, warmup=10):
    """Mean milliseconds per call over ``calls`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def enqueue_us(fn, calls=200, warmup=10):
    """Host microseconds per call to enqueue ``calls`` calls, without a sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_us(fn, calls=100):
    """(device microseconds, device kernels) per call, summed over the CUDA
    kernel events of ``calls`` calls under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == 'CUDA']
    return sum(e.device_time for e in kernels) / calls, len(kernels) / calls


def check_kernels(fcnn_taylor, fcnn_taylor_reference):
    """Phase 3: {(dims, actv, order, n, dtype): max abs error} for every
    shape, or SystemExit at the first disagreement."""
    errors = {}
    shapes = list(dict.fromkeys([s for s in CHECK_SHAPES] + [s[:4] for s in TABLE_SHAPES]))
    with torch.no_grad():
        for dtype in (F64, F32):
            for i, (dims, actv, order, n) in enumerate(shapes):
                pts, layers = inputs(dims, n, dtype, seed=i)
                got = fcnn_taylor(pts, layers, order, actv)
                again = fcnn_taylor(pts, layers, order, actv)
                torch.cuda.synchronize()
                want = fcnn_taylor_reference(pts, layers, order, actv)
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = len(got) == order + 1 and all(a.shape == b.shape for a, b in zip(got, want))
                ok = ok and same and all(e <= TOL[dtype] for e in errs)
                phase('3 kernel', f"{shape_name(dims, actv, order, n, dtype)}: rel err "
                                  f"{' '.join(f'{e:.2e}' for e in errs)} (limit {TOL[dtype]:.0e}), "
                                  f"two launches {'bitwise equal' if same else 'DIFFER'} "
                                  f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: kernel disagrees with its twin or with itself")
                errors[(dims, actv, order, n, dtype)] = max(
                    (a - b).abs().max().item() for a, b in zip(got, want))
    return errors


def time_shapes(card, fcnn_taylor, fcnn_taylor_reference):
    """Phase 6: {(dims, actv, order, n, dtype): (kernel us, twin us, bound ms, bound_by)}."""
    out = {}
    with torch.no_grad():
        for i, (dims, actv, order, n, dtype) in enumerate(TABLE_SHAPES):
            pts, layers = inputs(dims, n, dtype, seed=50 + i)
            k_us, k_launches = device_us(lambda: fcnn_taylor(pts, layers, order, actv))
            t_us, t_launches = device_us(lambda: fcnn_taylor_reference(pts, layers, order, actv))
            b_ms, b_by = bound_ms(dims, actv, order, n, dtype)
            out[(dims, actv, order, n, dtype)] = (k_us, t_us, b_ms, b_by)
            phase('6 timing', f"{card}: {shape_name(dims, actv, order, n, dtype)}: device time per "
                              f"call (profiler) kernel {k_us:.2f} us in {k_launches:.0f} launches, "
                              f"twin {t_us:.2f} us in {t_launches:.0f} launches; bound "
                              f"{b_ms * 1e3:.3f} us ({b_by}), kernel at {b_ms * 1e3 / k_us:.1%} "
                              f"of the bound")
    return out


def time_end_to_end(card, taylor_mlp):
    """Phase 6: host enqueue per flagship forward, and train-only epochs/s
    with the kernel and with the twin swapped in, interleaved."""
    fcnn_taylor, twin = taylor_mlp.fcnn_taylor, taylor_mlp.fcnn_taylor_reference
    n = GRID[0] * GRID[1]
    bench = flagship_solver(n_batches_valid=0)  # train-only epochs, as bench.py counts them
    # no progress bar; an older tree's fit takes no tqdm_file and shows none
    quiet = {'tqdm_file': None} if 'tqdm_file' in inspect.signature(bench.fit).parameters else {}
    bench.fit(100, **quiet)
    with torch.no_grad():
        pts = torch.rand(n, 2, device='cuda')
        ls = [(W.detach(), b.detach()) for W, b in bench.nets[0].layers()]
        enq = [enqueue_us(lambda: fcnn_taylor(pts, ls, 2)), enqueue_us(lambda: twin(pts, ls, 2)),
               enqueue_us(lambda: twin(pts, ls, 2)), enqueue_us(lambda: fcnn_taylor(pts, ls, 2))]
        ev = [cuda_time_ms(lambda: fcnn_taylor(pts, ls, 2)), cuda_time_ms(lambda: twin(pts, ls, 2))]
    phase('6 timing', f"{card}: host enqueue per forward call, 2-512-1 tanh order 2 N={n} float32: "
                      f"kernel wrapper {(enq[0] + enq[3]) / 2:.1f} us ({enq[0]:.1f}, {enq[3]:.1f}), "
                      f"twin {(enq[1] + enq[2]) / 2:.1f} us ({enq[1]:.1f}, {enq[2]:.1f}) over 200 calls; "
                      f"CUDA events over 200 back-to-back calls: kernel {ev[0]:.4f} ms, twin {ev[1]:.4f} ms")
    rates = {'kernel': [], 'twin': []}
    for arm in ('kernel', 'twin', 'twin', 'kernel', 'kernel', 'twin'):
        taylor_mlp.fcnn_taylor = fcnn_taylor if arm == 'kernel' else (
            lambda p, layers, order, actv='tanh': twin(p, layers, order, actv))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.fit(300, **quiet)
        torch.cuda.synchronize()
        rates[arm].append(300 / (time.perf_counter() - t0))
    taylor_mlp.fcnn_taylor = fcnn_taylor
    med = {k: float(np.median(v)) for k, v in rates.items()}
    phase('6 timing', f"{card}: flagship train-only epochs/s in interleaved 300-epoch windows: "
                      f"kernel {' '.join(f'{r:.2f}' for r in rates['kernel'])} (median {med['kernel']:.2f} "
                      f"= {med['kernel'] * n:.0f} points/s), twin swapped in "
                      f"{' '.join(f'{r:.2f}' for r in rates['twin'])} (median {med['twin']:.2f})")


def main():
    times_only = sys.argv[1:] == ['--times-only']
    if sys.argv[1:] and not times_only:
        raise SystemExit(f"usage: python3 chip_smoke.py [--times-only]; got {sys.argv[1:]}")
    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs the GPU")
    import neurodiffeq_tpu_torch
    if Path(neurodiffeq_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported neurodiffeq_tpu_torch from "
                         f"{neurodiffeq_tpu_torch.__file__}, not from this checkout")
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.ops import _build, taylor_mlp
    from neurodiffeq_tpu_torch.ops.taylor_mlp import fcnn_taylor, fcnn_taylor_reference
    from neurodiffeq_tpu_torch.utils import full_precision_matmuls, set_seed

    full_precision_matmuls()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase('1 device', f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
                      f"torch {torch.__version__} cuda {torch.version.cuda}; nvidia-smi: {card}")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log = _build.BUILD_INFO['log']
    regs = [int(r) for r in re.findall(r'Used (\d+) registers', log)]
    spills = [int(b) for b in re.findall(r'(\d+) bytes spill stores', log)]
    phase('2 build', f"{_build.BUILD_INFO['path']} in {time.perf_counter() - t0:.1f} s "
                     f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s); ptxas: {len(regs)} kernel instances, "
                     f"registers per thread {min(regs, default=0)}-{max(regs, default=0)}, "
                     f"{sum(b > 0 for b in spills)} with spill stores (at most {max(spills, default=0)} "
                     f"bytes)")

    if times_only:
        time_shapes(card, fcnn_taylor, fcnn_taylor_reference)
        time_end_to_end(card, taylor_mlp)
        return

    # ---- 3. kernels against the twin; SIREN against the plain engine
    errors = check_kernels(fcnn_taylor, fcnn_taylor_reference)
    check_siren()

    # ---- 4. gradient
    from neurodiffeq_tpu_torch.ops.taylor_mlp import _TaylorMLPFn
    dims, n = (2,) + HIDDEN + (1,), GRID[0] * GRID[1]
    g = torch.Generator().manual_seed(7)
    pts, layers = inputs(dims, n, F64, seed=7)
    cts = [torch.randn(s, generator=g, dtype=F64).cuda() for s in [(n, 1), (2, n, 1), (2, n, 1)]]

    def grads(fn):
        p = pts.clone().requires_grad_()
        ls = [(W.clone().requires_grad_(), b.clone().requires_grad_()) for W, b in layers]
        loss = sum((o * c).sum() for o, c in zip(fn(p, ls), cts))
        return torch.autograd.grad(loss, [p] + [x for W, b in ls for x in (W, b)])

    via_kernel = grads(lambda p, ls: _TaylorMLPFn.apply(p, 2, 'tanh', *[x for W, b in ls for x in (W, b)]))
    via_twin = grads(lambda p, ls: fcnn_taylor_reference(p, ls, 2, 'tanh'))
    torch.cuda.synchronize()
    gerr = max(rel_err(a, b) for a, b in zip(via_kernel, via_twin))
    phase('4 gradient', f"float64 2-512-1 N={n}: max rel err over point and parameter grads "
                        f"{gerr:.2e} (limit 1e-10) {'ok' if gerr <= 1e-10 else 'FAIL'}")
    if gerr > 1e-10:
        raise SystemExit("chip_smoke: gradient through the kernel disagrees with the twin")

    # ---- 5a. the main path: flagship training
    set_seed(0)
    solver = flagship_solver()
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(EPOCHS, tqdm_file=None)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches_main = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    xs, ys = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
    exact = np.sin(np.pi * xs) * np.sinh(np.pi * (1 - ys)) / np.sinh(np.pi)
    u = solver.get_solution()(xs, ys, to_numpy=True)
    max_err = float(np.abs(u - exact).max())
    res = solver.get_residuals(xs, ys, to_numpy=True)
    checks = {
        'taylor_mlp_1h launched during fit': launches_main['taylor_mlp_1h'] > 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': late < early,
        'max error < 1e-2': bool(np.isfinite(u).all()) and max_err < 1e-2,
        'residuals finite': res.shape == xs.shape and bool(np.isfinite(res).all()),
    }
    phase('5a flagship', f"fit({EPOCHS}) float32 in {fit_s:.1f} s: launches {launches_main}, "
                         f"{fallbacks} fallbacks, train loss mean {early:.3e} (first 100) -> "
                         f"{late:.3e} (last 100), max |u - exact| on 101x101 {max_err:.3e}, "
                         f"max |residual| {np.abs(res).max():.3e}; "
                         + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: flagship training check failed")

    # ---- 5b. Solver2D with every default (device, net 2-32-32-1, generators)
    set_seed(0)
    solver = laplace_solver()
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    solver.fit(DEFAULT_NET_EPOCHS, tqdm_file=None)
    torch.cuda.synchronize()
    launches_default = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:30])), float(np.mean(hist[-30:]))
    net = solver.nets[0]
    checks = {
        'default device is cuda': next(net.parameters()).device.type == 'cuda',
        'default net 2-32-32-1': tuple(net.hidden_units) == (32, 32),
        'taylor_mlp launched during fit': launches_default['taylor_mlp'] > 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': late < early,
    }
    phase('5b default Solver2D', f"fit({DEFAULT_NET_EPOCHS}): launches {launches_default}, "
                                 f"{fallbacks} fallbacks, train loss mean {early:.3e} (first 30) -> "
                                 f"{late:.3e} (last 30); "
                                 + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: default Solver2D check failed")

    # ---- 5c. the ODE path: Lotka-Volterra through Solver1D
    launches_lv, launches_h1 = run_lv(F, taylor_mlp)

    # ---- 5d. the spherical path: Poisson through SolverSpherical
    launches_sph = run_sph(F, taylor_mlp)

    # ---- 6. timing
    times = time_shapes(card, fcnn_taylor, fcnn_taylor_reference)
    time_end_to_end(card, taylor_mlp)
    time_epochs(card, 'Lotka-Volterra (train + 4 validation batches, 2 nets)', lv_solver())
    solver, step_schedule = sph_solver(SPH_EPOCHS)
    time_epochs(card, 'spherical Poisson (train + 4 validation batches of 512 points)', solver, [step_schedule])

    # ---- 7. result: launches summed over the paths of phase 5
    paths = {'5a': launches_main, '5b': launches_default, '5c': launches_lv, '5c h1': launches_h1,
             '5d': launches_sph}
    phase('7 result', f"launches per path: {paths}")
    record = {'kernels': []}
    # each kernel timed at the shape of the newest path it carries
    for name, key in (('taylor_mlp_1h', ((2, 512, 1), 'tanh', 2, 1024, F32)),
                      ('taylor_mlp', ((3, 64, 64, 1), 'tanh', 2, 512, F32))):
        launches = sum(p[name] for p in paths.values())
        k_us, t_us, b_ms, b_by = times[key]
        record['kernels'].append({
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCE, 'replaces': REPLACES,
            'launches': launches, 'max_abs_err': errors[key], 'ms': k_us / 1e3,
            'plain_ms': t_us / 1e3, 'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
    print(card)
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
