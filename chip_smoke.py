"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the flagship 2-D Laplace training run
(Solver2D, FCNN 2-512-1 tanh, 32 x 32 grid), through the hand-written CUDA
kernel, in seven phases, one line each:

1. device: a CUDA device must be present (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the kernel library from ``neurodiffeq_tpu_torch/csrc``;
3. kernel against its plain twin on the card, float64 and float32, at the
   flagship shape and at ragged, deeper, sin, multi-output and single-layer
   shapes. Error = max |kernel - twin| / max |twin|; limits 1e-10 (float64)
   and 1e-4 (float32: the kernel sums in another order than cuBLAS);
4. gradient through the kernel's autograd function against autograd over
   the twin, flagship shape, float64, limit 1e-10;
5. flagship training, float32: ``fit(2000)`` with the launch count reset
   just before; the kernel must carry it, no Taylor fallback may occur, the
   loss must fall, and ``get_solution()`` must be within 1e-2 of the
   analytic solution on a 101 x 101 grid; ``get_residuals`` must be finite;
6. timing: steady-state training epochs/s and points/s, and the kernel's
   time against the twin's at the flagship shape: per call over 200 calls
   by CUDA events (which at this size include host dispatch), and device
   time alone from ``torch.profiler``;
7. the result line.

Any failure ends the run with a non-zero exit code and no result line. The
line before the last is the kernel record; the last is
``{"ok": true, "device": {...}}``.
"""
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = 'neurodiffeq_tpu_torch/csrc/taylor_mlp.cu'
REPLACES = 'neurodiffeq_tpu/ops/pallas_mlp.py:115'
GRID, HIDDEN, EPOCHS = (32, 32), (512,), 2000
CHECK_SHAPES = [  # (layer widths, activation, order, N)
    ((2, 512, 1), 'tanh', 2, 1024),
    ((2, 64, 64, 1), 'tanh', 2, 1000),
    ((1, 32, 32, 1), 'sin', 1, 37),
    ((1, 32, 32, 1), 'sin', 2, 37),
    ((3, 16, 2), 'tanh', 2, 37),
    ((2, 1), 'tanh', 2, 37),
]
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def rel_err(got, want):
    """max |got - want| / max |want|, in float64 (0 where both are all zero)."""
    diff = (got.double() - want.double()).abs().max().item()
    return diff / max(want.double().abs().max().item(), 1e-300)


def random_layers(dims, seed):
    g = torch.Generator().manual_seed(seed)
    return [((torch.rand(a, b, generator=g, dtype=torch.float64) * 2 - 1) / math.sqrt(a),
             (torch.rand(b, generator=g, dtype=torch.float64) * 2 - 1) / math.sqrt(a))
            for a, b in zip(dims[:-1], dims[1:])]


def on(layers, dtype):
    return [(W.to('cuda', dtype), b.to('cuda', dtype)) for W, b in layers]


def flagship_solver(**kwargs):
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D

    dev, dt = torch.device('cuda'), torch.float32
    cond = DirichletBVP2D(
        x_min=0.0, x_min_val=lambda y: 0 * y,
        x_max=1.0, x_max_val=lambda y: 0 * y,
        y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x),
        y_max=1.0, y_max_val=lambda x: 0 * x)
    return Solver2D(
        pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)],
        conditions=[cond], xy_min=(0.0, 0.0), xy_max=(1.0, 1.0),
        nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=HIDDEN, device=dev, dtype=dt)],
        train_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced-noisy', device=dev, dtype=dt),
        valid_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced', device=dev, dtype=dt),
        device=dev, dtype=dt, **kwargs)


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


def main():
    # ---- 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs the GPU")
    import neurodiffeq_tpu_torch
    if Path(neurodiffeq_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: imported neurodiffeq_tpu_torch from "
                         f"{neurodiffeq_tpu_torch.__file__}, not from this checkout")
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.ops import _build, taylor_mlp
    from neurodiffeq_tpu_torch.ops.taylor_mlp import _TaylorMLPFn, fcnn_taylor, fcnn_taylor_reference
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
    ptxas = [ln.strip() for ln in _build.BUILD_INFO['log'].splitlines() if 'registers' in ln or 'spill' in ln]
    phase('2 build', f"{_build.BUILD_INFO['path']} in {time.perf_counter() - t0:.1f} s "
                     f"(nvcc {_build.BUILD_INFO['seconds']:.1f} s); ptxas: {' | '.join(ptxas)}")

    # ---- 3. kernel against twin
    flagship_err = None
    with torch.no_grad():
        for dtype in (torch.float64, torch.float32):
            for i, (dims, actv, order, n) in enumerate(CHECK_SHAPES):
                g = torch.Generator().manual_seed(100 + i)
                pts = torch.rand(n, dims[0], generator=g, dtype=torch.float64).to('cuda', dtype)
                layers = on(random_layers(dims, seed=i), dtype)
                got = fcnn_taylor(pts, layers, order, actv)
                torch.cuda.synchronize()
                want = fcnn_taylor_reference(pts, layers, order, actv)
                torch.cuda.synchronize()
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                ok = len(got) == order + 1 and all(a.shape == b.shape for a, b in zip(got, want))
                ok = ok and all(e <= TOL[dtype] for e in errs)
                phase('3 kernel', f"{str(dtype)[6:]} {'-'.join(map(str, dims))} {actv} order {order} "
                                  f"N={n}: rel err {' '.join(f'{e:.2e}' for e in errs)} "
                                  f"(limit {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: kernel disagrees with its twin")
                if i == 0 and dtype == torch.float32:
                    flagship_err = max((a - b).abs().max().item() for a, b in zip(got, want))

    # ---- 4. gradient
    dims, n = (2,) + HIDDEN + (1,), GRID[0] * GRID[1]
    g = torch.Generator().manual_seed(7)
    pts = torch.rand(n, 2, generator=g, dtype=torch.float64).cuda()
    layers = on(random_layers(dims, seed=7), torch.float64)
    cts = [torch.randn(s, generator=g, dtype=torch.float64).cuda() for s in [(n, 1), (2, n, 1), (2, n, 1)]]

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

    # ---- 5. flagship training (the main path; launches counted from here)
    set_seed(0)
    solver = flagship_solver()
    F.reset_taylor_fallback_count()
    taylor_mlp.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.fit(EPOCHS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = taylor_mlp.LAUNCHES
    fallbacks = F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    xs, ys = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
    exact = np.sin(np.pi * xs) * np.sinh(np.pi * (1 - ys)) / np.sinh(np.pi)
    u = solver.get_solution()(xs, ys, to_numpy=True)
    max_err = float(np.abs(u - exact).max())
    res = solver.get_residuals(xs, ys, to_numpy=True)
    checks = {
        'kernel launched during fit': launches > 0,
        'no Taylor fallback': fallbacks == 0,
        'loss fell': late < early,
        'max error < 1e-2': bool(np.isfinite(u).all()) and max_err < 1e-2,
        'residuals finite': res.shape == xs.shape and bool(np.isfinite(res).all()),
    }
    phase('5 flagship', f"fit({EPOCHS}) float32 in {fit_s:.1f} s: {launches} kernel launches, "
                        f"{fallbacks} fallbacks, train loss mean {early:.3e} (first 100) -> "
                        f"{late:.3e} (last 100), max |u - exact| on 101x101 {max_err:.3e}, "
                        f"max |residual| {np.abs(res).max():.3e}; "
                        + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: flagship training check failed")

    # ---- 6. timing
    bench = flagship_solver(n_batches_valid=0)  # train-only epochs, as bench.py counts them
    bench.fit(100)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bench.fit(500)
    torch.cuda.synchronize()
    eps = 500 / (time.perf_counter() - t0)
    with torch.no_grad():
        pts = torch.rand(n, 2, device='cuda')
        ls = [(W.detach(), b.detach()) for W, b in bench.nets[0].layers()]
        ms_k1 = cuda_time_ms(lambda: fcnn_taylor(pts, ls, 2))
        ms_t1 = cuda_time_ms(lambda: fcnn_taylor_reference(pts, ls, 2))
        ms_t2 = cuda_time_ms(lambda: fcnn_taylor_reference(pts, ls, 2))
        ms_k2 = cuda_time_ms(lambda: fcnn_taylor(pts, ls, 2))
        dev_kernel = device_us(lambda: fcnn_taylor(pts, ls, 2))
        dev_twin = device_us(lambda: fcnn_taylor_reference(pts, ls, 2))
    ms_kernel, ms_twin = (ms_k1 + ms_k2) / 2, (ms_t1 + ms_t2) / 2
    phase('6 timing', f"{card}: flagship train-only {eps:.1f} epochs/s = {eps * n:.0f} points/s; "
                      f"forward 2-512-1 tanh order 2 N={n} float32: kernel {ms_kernel:.4f} ms "
                      f"({ms_k1:.4f}, {ms_k2:.4f}), twin {ms_twin:.4f} ms ({ms_t1:.4f}, {ms_t2:.4f}) "
                      f"per call over 200 calls (CUDA events; host dispatch included); device time "
                      f"per call (profiler): kernel {dev_kernel[0]:.2f} us in {dev_kernel[1]:.0f} "
                      f"launches, twin {dev_twin[0]:.2f} us in {dev_twin[1]:.0f} launches")

    # ---- 7. result
    record = {'kernels': [{
        'name': 'taylor_mlp', 'route': 'cuda', 'source': KERNEL_SOURCE, 'replaces': REPLACES,
        'launches': launches, 'max_abs_err': flagship_err, 'ms': ms_kernel, 'plain_ms': ms_twin}]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
