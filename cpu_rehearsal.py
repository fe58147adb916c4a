"""CPU rehearsal of ``chip_smoke.py``'s training phases.

``python3 cpu_rehearsal.py [5l] [5m] [5n] [5a] [5g] [5d] [5o] [5o-jax] [--epochs N] [--seed S]``
trains the problems of phases 5l (d = 10 Poisson, exact laplacian), 5m
(d = 100 Poisson, ``stde_laplacian``), 5n (d = 4 clamped plate, exact
``biharmonic``), 5a (the flagship, with its save, load, resume and
export), 5g (``GenericSolver`` 3-D Poisson), 5d (spherical Poisson) and 5o
(the stiff oscillator with the weight, checkpoint and TensorBoard
callbacks), built by the same functions of ``chip_smoke.py``, on the CPU in
float32. ``5o-jax`` runs the same arm through the JAX package
(``benchmarks/balancing_ab.py``'s ``run_arm`` with its
``AutoResidualWeightCallback``, seed 11) for comparison; only it imports
JAX. The Taylor-MLP entry point (``ops.taylor_mlp.fcnn_taylor``) is
wrapped with a counter, each call counted as the kernel launch it is on the
card. For 5l-5n it prints per phase the calls and the compose fallbacks per
epoch, the first and last 100-epoch mean train loss, the relative L2 error
against the analytic solution on 4,096 points, the boundary defect and the
seconds (``--seed`` picks the seed of 5l, 5m and 5o; 5o's default is its
phase's 11); 5a, 5g, 5d and 5o run ``chip_smoke.py``'s own phase
function, which prints its line of errors and checks. ``chip_smoke.py``'s limits on those errors are about twice what
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
    65,535 outputs, ``taylor_mlp`` otherwise."""
    inner = taylor_mlp.fcnn_taylor

    def counting(points, layers, *args, **kwargs):
        one_hidden = len(layers) == 2 and layers[-1][1].shape[0] <= 65535
        taylor_mlp.LAUNCHES['taylor_mlp_1h' if one_hidden else 'taylor_mlp'] += 1
        return inner(points, layers, *args, **kwargs)

    taylor_mlp.fcnn_taylor = counting
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
    print(f"{name}: fit({epochs}) float32 on the CPU in {seconds:.1f} s: {calls / epochs:.2f} Taylor-MLP calls "
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
        cs.OSC_SEED = seed
    chosen = args or ['5l', '5m', '5n']
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *a, **k: None  # the phase functions time the card
    set_tensor_type('cpu', 32)
    counted(taylor_mlp)
    phases = {'5l': (lambda: cs.highdim_solver(10, 'exact', seed), 10, cs.POISSON10_EPOCHS),
              '5m': (lambda: cs.highdim_solver(100, 'stde', seed), 100, cs.POISSON100_EPOCHS),
              '5n': (lambda: cs.plate_solver(cs.PLATE_DIM), cs.PLATE_DIM, cs.PLATE_EPOCHS)}
    own = {'5a': (cs.run_flagship, 'EPOCHS'), '5g': (cs.run_generic_3d, 'GEN3D_EPOCHS'),
           '5d': (cs.run_sph, 'SPH_EPOCHS'), '5o': (cs.run_oscillator, 'OSC_EPOCHS')}
    for name in chosen:
        if name == '5o-jax':
            rehearse_jax_oscillator(epochs or cs.OSC_EPOCHS)
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
