"""CPU rehearsal of ``chip_smoke.py``'s training phases.

``python3 cpu_rehearsal.py [5l] [5m] [5n] [5a] [5g] [5d] [5i] [5o] [5o-jax] [5p] [5p-jax] [5q] [5q-jax] [5r] [5r-jax] [5s] [5s-jax] [--epochs N] [--seed S]``
trains the problems of phases 5l (d = 10 Poisson, exact laplacian), 5m
(d = 100 Poisson, ``stde_laplacian``), 5n (d = 4 clamped plate, exact
``biharmonic``), 5a (the flagship, with its save, load, resume and
export), 5g (``GenericSolver`` 3-D Poisson), 5d (spherical Poisson), 5i (heat with
Dirichlet ends, then under ``h1``) and 5o
(the stiff oscillator with the weight, checkpoint and TensorBoard
callbacks), 5p (the temporal subsystem: heat, and the RE100 cavity
through one FCNN 2-256-3) and 5q (the legacy ``ode``, ``pde`` and
``pde_spherical`` functions and the irregular-domain hexagram) and 5r (the
flagship on a mesh of 2 gloo ranks, against the unsharded run) and 5s (the
flagship and the primitive cavity on a (1, 2) ``(points, model)`` mesh of
2 gloo ranks, against the unsharded runs), built by
the same functions of ``chip_smoke.py``, on the CPU in float32. ``5o-jax``
runs the same arm through the JAX package (``benchmarks/balancing_ab.py``'s
``run_arm`` with its ``AutoResidualWeightCallback``, seed 11) for
comparison, ``5p-jax`` and ``5q-jax`` the problems of 5p and of 5q (a)-(c)
through the JAX package's ``temporal`` and legacy functions, ``5r-jax``
the flagship on the JAX package's mesh of 2 virtual devices, ``5s-jax`` on
its ``make_mesh(n_devices=2, model_axis_size=2)``; only the
``-jax`` arms import JAX. The Taylor-MLP entry point (``ops.taylor_mlp.fcnn_taylor``) is
wrapped with a counter, each call counted as the kernel launch it is on the
card (``fcnn_taylor_streams`` too; a one-hidden-layer backward that takes the
closed form as ``taylor_mlp_1h_bwd``'s). For 5l-5n it prints per phase the launches and the compose fallbacks per
epoch, the first and last 100-epoch mean train loss, the relative L2 error
against the analytic solution on 4,096 points, the boundary defect and the
seconds (``--seed`` picks the seed of 5l, 5m, 5o, 5r, 5r-jax, 5s and 5s-jax; 5o's default is its
phase's 11); 5a, 5g, 5d, 5i, 5o, 5p, 5q, 5r and 5s run ``chip_smoke.py``'s own phase
function, which prints its lines of errors and checks. ``chip_smoke.py``'s limits on those errors are about twice what
this gives at the same epochs, and its launch checks use the counts per
epoch. Needs no GPU; the epochs default to the chip phases'.
"""
import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def counted(taylor_mlp):
    """Wrap ``fcnn_taylor`` so that every call counts one launch of the kernel
    the card would run: ``taylor_mlp_1h`` for one hidden layer of at most
    65,535 outputs, ``taylor_mlp`` otherwise; and ``fcnn_taylor_streams``,
    ``taylor_mlp_streams``. A call with a graph goes through the card's
    autograd function, its launch stood in for by the twin, so that its
    backward takes the card's route; each closed-form backward counts as the
    ``taylor_mlp_1h_bwd`` launch it is there."""
    inner, streams = taylor_mlp.fcnn_taylor, taylor_mlp.fcnn_taylor_streams
    twin, closed = taylor_mlp.fcnn_taylor_reference, taylor_mlp.taylor_mlp_1h_backward_reference

    def counting(points, layers, order, actv='tanh'):
        one_hidden = len(layers) == 2 and layers[-1][1].shape[0] <= 65535
        taylor_mlp.LAUNCHES['taylor_mlp_1h' if one_hidden else 'taylor_mlp'] += 1
        flat = [t for W, b in layers for t in (W, b)]
        if torch.is_grad_enabled() and any(t.requires_grad for t in [points, *flat]):
            return taylor_mlp._TaylorMLPFn.apply(points, order, actv, *flat)
        return inner(points, layers, order, actv)

    def counting_closed(*args, **kwargs):
        taylor_mlp.LAUNCHES['taylor_mlp_1h_bwd'] += 1
        return closed(*args, **kwargs)

    def counting_streams(*args, **kwargs):
        taylor_mlp.LAUNCHES['taylor_mlp_streams'] += 1
        return streams(*args, **kwargs)

    taylor_mlp.fcnn_taylor, taylor_mlp.fcnn_taylor_streams = counting, counting_streams
    taylor_mlp.taylor_mlp_1h_backward_reference = counting_closed
    taylor_mlp._launch = lambda points, layers, order, actv: tuple(
        o.detach().contiguous() for o in twin(points, layers, order, actv))
    return inner


def rehearse(name, build, d, epochs):
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.ops import taylor_mlp

    solver = build()
    taylor_mlp.reset_launches()
    F.reset_taylor_fallback_count()
    t0 = time.perf_counter()
    solver.fit(epochs, tqdm_file=None)
    seconds = time.perf_counter() - t0
    calls, fallbacks = sum(taylor_mlp.LAUNCHES.values()), F.taylor_fallback_count()
    hist = solver.metrics_history['train_loss']
    rel, bdef = cs.highdim_errors(solver, d)
    print(f"{name}: fit({epochs}) float32 on the CPU in {seconds:.1f} s: {calls / epochs:.2f} Taylor-MLP launches "
          f"and {fallbacks / epochs:.2f} fallbacks per epoch, train loss mean {np.mean(hist[:100]):.4e} (first 100) -> "
          f"{np.mean(hist[-100:]):.4e} (last 100), rel L2 error {rel:.4e}, boundary defect {bdef:.1e}", flush=True)


def rehearse_jax_oscillator(epochs):
    """The JAX package's run of phase 5o's arm on the CPU (float32):
    ``benchmarks/balancing_ab.py``'s ``run_arm`` with its
    ``AutoResidualWeightCallback`` on ``OnFirstLocal() | PeriodLocal(500)``."""
    import os
    os.environ['JAX_PLATFORMS'] = 'cpu'
    sys.path.insert(0, 'benchmarks')
    import balancing_ab
    from neurodiffeq_tpu.callbacks import AutoResidualWeightCallback

    t0 = time.perf_counter()
    err = balancing_ab.run_arm('auto (JAX)', epochs, callback=AutoResidualWeightCallback(), seed=cs.OSC_SEED)
    print(f"5o-jax: the JAX package's run_arm('auto', {epochs}) on the CPU in {time.perf_counter() - t0:.1f} s: "
          f"max error {err:.4e}", flush=True)


def _jax_cpu():
    import os
    os.environ['JAX_PLATFORMS'] = 'cpu'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    return jax


def rehearse_jax_temporal(epochs):
    """5p's two problems (``chip_smoke.temporal_problem``) through the JAX
    package's ``temporal`` on the CPU (float32, optax.adam; the epoch losses
    compiled, the same values)."""
    jax = _jax_cpu()
    import optax
    from neurodiffeq_tpu import fields as F, temporal as T
    from neurodiffeq_tpu.fields import diff
    from neurodiffeq_tpu.networks import FCNN
    from neurodiffeq_tpu.utils import set_seed

    for kind, lr in (('heat', 3e-3), ('cavity', 1e-3)):
        set_seed(cs.TEMPORAL_SEED)
        approx, solve = cs.temporal_problem(kind, T, F, diff, FCNN)
        approx._loss = jax.jit(approx._loss)
        t0 = time.perf_counter()
        loss = solve(optax.adam(lr), epochs)[1]['train_loss']
        if kind == 'heat':
            xs = np.linspace(0, cs.THEAT_L, 21)
            exact = np.sin(np.pi * xs / cs.THEAT_L) * np.exp(-cs.THEAT_K * (np.pi / cs.THEAT_L) ** 2)
            result = f"max error at t = 1 {np.abs(np.asarray(approx(xs, np.ones(21))) - exact).max():.4e}"
        else:
            result = (f"train loss mean {np.mean(loss[:10]):.4e} (first 10) -> {np.mean(loss[-10:]):.4e} (last 10), "
                      f"{np.mean(loss[:10]) / np.mean(loss[-10:]):.2f}x")
        print(f"5p-jax: {kind}, {epochs} epochs on the CPU in {time.perf_counter() - t0:.1f} s: {result}", flush=True)


def rehearse_jax_legacy(epochs):
    """5q (a)-(c) (``chip_smoke.legacy_cases``) through the JAX package's
    legacy functions on the CPU (float32, their default nets and
    generators)."""
    import warnings
    _jax_cpu()
    from neurodiffeq_tpu import conditions as C, fields as F, ode, pde
    from neurodiffeq_tpu.fields import diff
    from neurodiffeq_tpu.utils import set_seed

    for seed, (label, (fn, n, kwargs, error)) in enumerate(cs.legacy_cases(ode, pde, C, F, diff).items()):
        set_seed(seed)
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            solution, _ = fn(max_epochs=epochs or n, **kwargs)
        print(f"5q-jax: {label}, {epochs or n} epochs on the CPU in {time.perf_counter() - t0:.1f} s: max error "
              f"{error(solution):.4e}", flush=True)

def rehearse_jax_sharded(epochs, seed, model_axis_size=None):
    """5r's problem through the JAX package on its own mesh: the flagship
    (``__graft_entry__._flagship_solver``, FCNN 2-512-1 tanh on 32 x 32) with
    ``mesh=make_mesh()`` over 2 virtual CPU devices, float32; 5s's with
    ``make_mesh(n_devices=2, model_axis_size=2)``, a (1, 2) (points, model)
    mesh."""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    _jax_cpu()
    from __graft_entry__ import _flagship_solver
    from neurodiffeq_tpu.parallel import make_mesh
    from neurodiffeq_tpu.utils import set_seed

    set_seed(seed)
    solver = _flagship_solver(mesh=make_mesh(n_devices=2, model_axis_size=model_axis_size))
    t0 = time.perf_counter()
    solver.fit(max_epochs=epochs, tqdm_file=None)
    xs, ys = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
    exact = np.sin(np.pi * xs) * np.sinh(np.pi * (1 - ys)) / np.sinh(np.pi)
    err = float(np.abs(np.asarray(solver.get_solution()(xs, ys)) - exact).max())
    hist = solver.metrics_history['train_loss']
    name = '5r-jax' if model_axis_size is None else '5s-jax'
    print(f"{name}: the flagship on a 2-device mesh {dict(solver.mesh.shape)}, {epochs} epochs float32 on the CPU in "
          f"{time.perf_counter() - t0:.1f} s (seed {seed}): train loss mean {np.mean(hist[:10]):.4e} (first 10) -> "
          f"{np.mean(hist[-10:]):.4e} (last 10), max |u - exact| on 101x101 {err:.4e}", flush=True)


def main():
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.ops import taylor_mlp
    from neurodiffeq_tpu_torch.utils import set_tensor_type

    args = sys.argv[1:]
    opts = {}
    for opt in ('--epochs', '--seed'):
        if opt in args:
            i = args.index(opt)
            opts[opt] = int(args[i + 1])
            args = args[:i] + args[i + 2:]
    epochs, seed = opts.get('--epochs'), opts.get('--seed', 0)
    if '--seed' in opts:
        cs.OSC_SEED = cs.SHARD_SEED = seed
    chosen = args or ['5l', '5m', '5n']
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *a, **k: None  # the phase functions time the card
    set_tensor_type('cpu', 32)
    counted(taylor_mlp)
    phases = {'5l': (lambda: cs.highdim_solver(10, 'exact', seed), 10, cs.POISSON10_EPOCHS),
              '5m': (lambda: cs.highdim_solver(100, 'stde', seed), 100, cs.POISSON100_EPOCHS),
              '5n': (lambda: cs.plate_solver(cs.PLATE_DIM), cs.PLATE_DIM, cs.PLATE_EPOCHS)}
    done = {}  # 5k's result, which 5t polishes where both run
    own = {'5a': (cs.run_flagship, 'EPOCHS'), '5g': (cs.run_generic_3d, 'GEN3D_EPOCHS'),
           '5d': (cs.run_sph, 'SPH_EPOCHS'), '5o': (cs.run_oscillator, 'OSC_EPOCHS'),
           '5p': (cs.run_temporal, 'TEMPORAL_EPOCHS'), '5q': (cs.run_legacy, 'LEGACY_ODE_EPOCHS'),
           '5r': (lambda F, taylor_mlp: cs.run_sharded(F, taylor_mlp, chosen=('5r',)), 'SHARD_EPOCHS'),
           '5s': (lambda F, taylor_mlp: cs.run_sharded(F, taylor_mlp, chosen=('5s',)), 'SHARD_EPOCHS'),
           '5k': (lambda F, taylor_mlp: done.setdefault('5k', cs.run_burgers(F, taylor_mlp)), 'BURGERS_EPOCHS'),
           '5t': (lambda F, taylor_mlp: cs.run_sharded(F, taylor_mlp, chosen=('5t',),
                                                       burgers=done['5k'][1] if '5k' in done else None),
                  'POLISH_EPOCHS'),
           '5i': (cs.run_heat, 'HEAT_EPOCHS')}
    for name in chosen:
        if name == '5o-jax':
            rehearse_jax_oscillator(epochs or cs.OSC_EPOCHS)
            continue
        if name == '5p-jax':
            rehearse_jax_temporal(epochs or cs.TEMPORAL_EPOCHS)
            continue
        if name == '5q-jax':
            rehearse_jax_legacy(epochs)
            continue
        if name in ('5r-jax', '5s-jax'):
            rehearse_jax_sharded(epochs or cs.SHARD_EPOCHS, seed, 2 if name == '5s-jax' else None)
            continue
        if name in own:
            run, constant = own[name]
            if epochs:
                setattr(cs, constant, epochs)
            try:
                run(F, taylor_mlp)
            except SystemExit as failed:  # the phase line, checks included, is printed before
                print(f"{name}: {failed}", flush=True)
            continue
        build, d, default = phases[name]
        rehearse(name, build, d, epochs or default)


if __name__ == '__main__':
    main()
