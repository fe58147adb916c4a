"""Smoke run of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's paths through its hand-written CUDA kernels
(``neurodiffeq_tpu_torch/csrc/``): ``taylor_mlp_1h`` for nets with one
hidden layer, ``taylor_mlp`` for every other depth (``taylor_mlp.cu``), and
``taylor_mlp_streams`` for the layer pairs after the first of a net split
over a ``'model'`` mesh axis (``taylor_mlp_streams.cu``: tensor cores,
weights resident in shared memory; its staged instance in
``taylor_mlp.cu`` for narrow nets and where the weights do not fit).
Phases, one line each or more:

1. device: a CUDA device must be present (no CPU fallback); prints
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the kernel library from ``neurodiffeq_tpu_torch/csrc``;
3. each kernel against the plain twin on the card, float64 and float32, at
   every shape of ``CHECK_SHAPES``, ``TABLE_SHAPES`` and ``REACH_SHAPES``, and two launches
   of each must be bitwise equal. Error = max |kernel - twin| / max |twin|;
   limits 1e-10 (float64) and 1e-4 (float32: the kernel sums in another
   order than cuBLAS). Then SIREN (w0 = 30, ``SIREN_SHAPES``, order 2),
   whose Taylor path folds w0 into its layers and launches the kernel,
   against the plain layer-by-layer engine, with the same limits.
   ``taylor_mlp_streams`` against its twin at every shape of
   ``STREAM_SHAPES`` with the same limits and repeatability, in the design
   the planner picks and in the other one where it fits: one model
   rank's slices of the cavity's pairs 1 and 2, the default FCNN's
   trailing layer, order 1, d = 10 (direction chunks), a width past shared
   memory (the global scratch), no input activation, and 7 streams (one
   raw input buffer in float32); then NaNs in the input streams and in a
   weight must come out where the twin's do.
   ``CHECK_SHAPES`` include nets at the edges of the kernels' reach:
   more than 8 inputs (direction chunks), 20 layers, hidden
   widths whose streams overflow shared memory (a global scratch) and a
   one-hidden-layer net of more than 65,535 outputs. Then an FCNN 9-32-32-1
   tanh at order 2 through ``GenericSolver``'s ``_forward`` on 1,000 points
   must launch ``taylor_mlp`` exactly once, and its u_xx and u_x on every
   axis must equal double-backward ``torch.autograd`` on the module (the
   same limits);
   b. mixed partials: u_xy of the cavity net 2-(128x5)-3 at N = 1,024 by
   polarization against double-backward ``torch.autograd`` on the plain
   module (the same limits), and the cartesian div-grad and curl-grad and
   the spherical div-grad identities on FCNN 3-16-16-1 fields at 1,000
   points, |lhs - rhs| < 1e-4 (``tests/test_operators.py``), float64 and
   float32;
   c. orders 3 and 4, pure and mixed, and ``pin`` at k = 0 and 1, of an
   FCNN 2-32-32-1 tanh field and a SIREN field on the card (float64 and
   float32) against the port on the CPU in float64 (the same limits), and
   every ``IBVP1D`` and ``DoubleEndedBVP1D`` variant exact at its anchors
   with an untrained net (values, slopes and the initial line, 1e-5);
   d. the high-dimensional operators: ``biharmonic`` at d = 4 and 10 and
   both estimators (``n_est = 16``) at d = 10 and 100, of an FCNN
   d-64-64-1 sin field under ``DirichletBoxND`` at 256 points, on the card
   in float64 and float32 against the port on the CPU in float64 (the same
   limits; one compose fallback each), with the same probes, which must be
   equal on the card and the CPU; ``stde_laplacian`` exact on sum x_i^2 and
   ``stde_biharmonic`` on sum c_i x_i^4 at d = 100; the exact ``laplacian``
   of an FCNN 100-64-64-1 sin field under ``DirichletBoxND`` (sat) through
   ``GenericSolver._forward`` on 768 points in exactly one ``taylor_mlp``
   launch (13 direction chunks), equal to double-backward ``torch.autograd``
   (the compose path); ``DirichletBoxND`` at d = 10 with an untrained net
   exact on its faces for the three masks, u = g and, with ``power=2``,
   du/dn = dg/dn, to 1e-5 (a box of side 1.3: across a side of at most 1
   the 'adf' mask's slope overflows on its faces, in the JAX package too);
   e. the ``ops`` package's surface (``check_ops``): ``fcnn_taylor_pallas``
   on the flagship's weights as the JAX package's ``{'W', 'b'}`` dicts
   (2-512-1 tanh, order 2, N = 1,024, float32) bitwise ``fcnn_taylor`` in
   exactly one ``taylor_mlp_1h`` launch; under ``enable_pallas(interpret=
   True)`` ``fcnn_taylor`` at 2-512-1 and 2-(128x5)-3,
   ``fcnn_taylor_streams`` at d = 2 128-64-128 and ``fcnn_taylor_pallas``
   raise with no launch, as ``fcnn_taylor_pallas(..., interpret=True)``
   does (on the card the kernels launch or the call raises); under
   ``disable_pallas()`` the flagship's ``fit(1)`` raises with no launch;
   then ``enable_pallas()`` back at the default and the same ``fit(1)``
   through ``taylor_mlp_1h``; and FourierFCNN on
   ``examples/poisson_high_frequency.py`` (k = 4, 64 x 64 points)
   ``fit(30)``: no launch, its first epoch within ``SHARD_GRAD_TOL`` of the
   port's CPU float32 run on the same points from the same weights, the
   loss falling, its epochs/s;
4. gradient through the kernel's autograd function against autograd over
   the twin, flagship shape, float64, limit 1e-10;
5. the paths, each with the launch counts reset just before and read just
   after:
   a. the main path, flagship training (Solver2D, FCNN 2-512-1 tanh,
      32 x 32 grid), float32, ``fit(700)``: ``taylor_mlp_1h`` must carry
      it, no Taylor fallback may occur, the loss must fall, and
      ``get_solution()`` must be within 1e-2 of the analytic solution on a
      101 x 101 grid; ``get_residuals`` must be finite; then the trained
      solver is saved and loaded into a new solver on the card through a
      ``SolverConfig`` (the path without dill), whose ``get_solution()``
      must equal the original's bitwise on the grid; both resume
      ``fit(1)`` from one generator state through ``taylor_mlp_1h``, their
      train losses within ``RESUME_LIMIT`` relative (bitwise equality
      reported); and the solution exported (``torch.export``) and served
      by ``load_exported_solution`` must equal it to ``EXPORT_LIMIT`` at N
      = 1, 7 and 10,201;
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
      ``fit(3500)``: ``taylor_mlp`` must carry it at 5 launches per epoch
      (1 train and 4 validation batches) with no ``taylor_mlp_1h`` launch
      and no fallback, the loss must fall, the rate must end at 1e-5,
      ``get_solution()`` must be within ``SPH_LIMIT`` relative error of
      ``K Q / r erf(r / sqrt 2)`` on 256 radii at random angles, hold
      u(0.1) and u(3) to 1e-5, and ``get_residuals`` must be finite;
   e. the primitive deep cavity (``cavity_problem``: FCNN 2-(128x5)-3 shared
      by the u, v, p conditions, 16,384 fresh uniform points per epoch,
      Re = 100, no validation, Adam under the cosine anneal 1e-3 -> 1e-5 over
      80,000 epochs), ``fit(1000)``: ``taylor_mlp`` exactly once per epoch,
      no ``taylor_mlp_1h``, no fallback, the loss must fall, and with the
      trained net u = v = 0 on the walls, u = u_lid on the lid and p = 0 on
      x = 0 and y = 0 to float32 round-off;
   f. the streamfunction-vorticity cavity (FCNN 2-(128x5)-2, residual
      weights [0.09, 1]), ``fit(6000)`` annealed over 6,000: the same launch
      checks, the loss must fall, and the centerline velocities must lie
      within 0.16 (u) and 0.11 (v) of Ghia et al. (1982);
   g. ``GenericSolver`` on ``tests/test_generic_3d.py``'s 3-D Poisson problem
      (FCNN 3-32-32-1, ``Generator3D`` 10^3), ``fit(700)``: 5 launches per
      epoch, max error < 5e-2 on 200 points, the faces exact to 1e-6;
   h. the solution bundle (``benchmarks/configs.py:216-258``): du/dt + lam u
      = 0 over lam in [0.5, 1.5] through ``BundleSolver1D`` with every
      default (FCNN 2-32-32-1 tanh on (t, lam), 32 x 32 meshes), ``fit(1500)``:
      exactly 5 ``taylor_mlp`` launches per epoch (d = 2, order 1), no
      ``taylor_mlp_1h``, no fallback, max |u - exp(-lam t)| < 2e-2 on 40
      points at lam = 0.6, 1.0, 1.4; then through the frozen solution 300
      Adam steps on lam (the inverse workflow of ``tests/test_inverse.py``)
      must recover lam = 1.23 within 0.05, and ``Hypersolver(Euler(),
      n_steps=50)`` against the solution at lam = 1, ``fit(1000)``, must
      come within 2e-2 of exp(-t), and within 1e-3 of the solution it was
      trained on and 10 times closer to it than plain Euler on the same
      grid; neither launches a kernel (plain forwards);
   i. heat with Dirichlet ends (``examples/heat_equation.py``: ``IBVP1D``
      through ``Solver2D``, the default FCNN 2-32-32-1, 32 x 32),
      ``fit(3000)``: exactly 5 ``taylor_mlp`` launches per epoch, no
      fallback, max error < 5e-2 on 200 random points; then ``fit(200)``
      under ``h1`` (Taylor order 3, layer by layer): no launch, no
      fallback, the loss must fall;
   j. heat with insulated ends, ``fit(1000)``: the pinned anchors compose,
      exactly 2 fallbacks per residual and no launch, max error <
      ``NEUMANN_LIMIT``, u_x = 0 at both ends to 1e-5 through ``diff`` of
      the solution's field;
   k. Burgers (``examples/burgers.py`` 'adaptive': FCNN 2-(20x8)-1,
      ``ResidualAdaptiveGenerator`` over 8 x 2,048 uniform candidates),
      ``fit(2500)``: exactly 6 ``taylor_mlp`` launches per epoch (scoring,
      train, 4 validation), exact on the initial line and the walls before
      and after, the train loss's lowest 100-epoch mean 10x below its first
      epoch, mean error against the Cole-Hopf solution on 201 x 101 <
      ``BURGERS_MEAN_LIMIT``;
   l. d = 10 Poisson (``benchmarks/stde_ab.py``'s exact arm: -lap u =
      (pi^2/d) sum sin(pi x_i) on [0, 1]^d, ``DirichletBoxND`` product mask
      with the benchmark's perturbed extension, FCNN 10-64-64-1 sin,
      ``GeneratorHypercube(768, 10)``, no validation) through
      ``GenericSolver``, ``fit(1000)``: exactly ``POISSON10_LAUNCHES``
      ``taylor_mlp`` launch per epoch (two direction chunks), no fallback,
      the loss must fall, relative L2 error against u* on 4,096 points <
      ``POISSON10_LIMIT``, boundary defect on 1,024 face points < 1e-5;
   m. the same problem at d = 100 through ``stde_laplacian(n_est=16)`` and
      the sat mask (``examples/poisson_highdim.py``), ``fit(2000)``: no
      launch, exactly one fallback per residual, the loss must fall, error
      < ``POISSON100_LIMIT``, boundary defect < 1e-5;
   n. the clamped plate (``benchmarks/biharmonic_ab.py``'s exact arm at d =
      4: ``DirichletBoxND(power=2)``, the exact ``biharmonic``, 512
      points), ``fit(300)``: no launch, one fallback per residual, the loss
      must fall, u = u* and du/dn = du*/dn on the faces to 1e-5, the
      relative L2 error reported;
   o. the control plane on the stiff oscillator (``benchmarks/balancing_ab.py``:
      u' = v, v' = -100 u, two FCNN 1-64-64-1 sin, ``Solver1D``'s defaults),
      ``fit(1500)`` with ``AutoResidualWeightCallback`` on
      ``OnFirstLocal() | PeriodLocal(500)``, ``CheckpointCallback`` in the
      'state_dict' format on ``PeriodLocal(500)`` and
      ``SimpleTensorboardCallback`` with a recording writer: exactly
      ``OSC_LAUNCHES`` ``taylor_mlp`` launches (10 per epoch and 2 per weight
      fire, the CPU rehearsal's count), none of ``taylor_mlp_1h``, no
      fallback, 4 weight fires with w_2 < 1 after the first and max(w) = 1
      after each, one scalar per metric per epoch, the loss must fall, the
      error against cos(10 t) and -sin(10 t) (``oscillator_error``) below
      ``OSC_LIMIT``, and the last checkpoint restored into a new solver must
      give its parameters, Adam state and histories bitwise;
   p. the temporal subsystem (``neurodiffeq_tpu_torch.temporal``): (a) the heat
      problem of ``tests/test_temporal.py`` through
      ``SingleNetworkApproximator1DSpatialTemporal`` (FCNN 2-32-32-1, penalty
      ends, 32 x 32 points from numpy's stream in batches of 512, Adam 3e-3),
      300 epochs: exactly ``THEAT_LAUNCHES`` ``taylor_mlp`` launches per epoch
      (two mini-batch steps, the epoch loss, validation; order-0 reads run
      the plain forward), no fallback, the error at t = 1 on 21 points <
      ``THEAT_LIMIT``, u(x, 0) = u0 to 1e-6; (b) the RE100 cavity through
      ``SingleNetworkApproximator2DSpatialSystem`` on one FCNN 2-256-3 with
      penalty walls, 300 epochs: exactly ``TCAV_LAUNCHES`` ``taylor_mlp_1h``
      launches per epoch, one per collocation set for the three columns,
      no fallback, the loss's fall > ``TCAV_DROP``;
   q. the legacy APIs on their defaults (FCNN 1-32-32-n, 2-32-32-1 and
      3-32-32-1 tanh): ``ode.solve`` (u' + u = 0) and ``ode.solve_system``
      (u1' = u2, u2' = -u1, one shared net) for 1,000 epochs, ``pde.solve2D``
      (Laplace) for 500 and ``pde_spherical.solve_spherical`` (the Gaussian
      charge) for 300, each with exactly the rehearsal's launches per epoch,
      no fallback and a falling loss, the errors against exp(-t), (sin t,
      cos t) (initial values exact to 1e-6) and the analytic Laplace
      solution below their limits; then the hexagram of
      ``tests/test_pde_irregular.py`` through ``pde.solve2D`` and
      ``CustomBoundaryCondition`` (FCNN 2-100-100-1 ELU, one epoch) in
      float64: the Dirichlet control points within 1e-4 and the normal
      derivatives at the Neumann ones within 1e-2 (``BASELINE.md``), no
      launch, ``HEXAGRAM_FALLBACKS`` compose fallbacks, the float32
      deviations reported beside them;
   r. the data-parallel slice (``neurodiffeq_tpu_torch.parallel``): the
      flagship (5a's config, FCNN 2-512-1 tanh, 32 x 32) on a mesh over
      the points, 2 ranks on one card over gloo (one rank per card over
      NCCL, at most 4, where there are more), started by
      ``parallel.launch``: from the unsharded run's initialization and
      generator state the first epoch's loss and every gradient within
      ``SHARD_GRAD_TOL`` relative of the unsharded run's, each rank
      ``taylor_mlp_1h`` exactly 5 times per epoch on its block of each
      batch (N = 512 on 2 ranks) with no fallback, every rank the same
      history, the loss falling over ``SHARD_EPOCHS`` epochs and the error
      against the analytic solution below ``SHARD_LIMIT``; one batch of
      5m's d = 100 ``stde_laplacian`` problem gives every rank its rows of
      the unsharded probes bit for bit and the unsharded loss and
      gradients; one NCCL rank equals the unsharded first epoch bit for
      bit. A line before the check prints each rank's epochs/s, the
      unsharded rate and the collectives' time per epoch (one card's
      numbers, not a scaling claim);
   s. the model axis (``make_mesh(model_axis_size=2)``, a (1, 2)
      ``(points, model)`` mesh over the same ranks as 5r, in the same
      spawn): the flagship at full width from 5r's initialization and
      generator state for ``SHARD_EPOCHS`` epochs, each model rank on its
      256 columns (``taylor_mlp_1h`` exactly 5 times per epoch), and the
      primitive cavity (5e's config at full width, 16,384 points, from 5e's
      seed) for ``MODEL_CAV_EPOCHS`` epochs, each model rank on its slices
      of the three layer pairs (exactly 1 ``taylor_mlp_1h`` and 2
      ``taylor_mlp_streams`` per epoch), each loaded through the solver:
      each rank stores its blocks of the split leaves, and its parameters,
      gradients and both Adam moments hold ``MODEL_PER_RANK`` elements;
      first-epoch loss and each rank's block of every gradient within
      ``SHARD_GRAD_TOL`` relative of the unsharded runs', no all-reduce
      over the points axis (gradients, records), no fallback, every rank
      the same histories, falling losses, the flagship's error below
      ``SHARD_LIMIT`` and the cavity's walls exact as 5e holds them; the
      cavity saved on the mesh and loaded in this process without one
      gives the mesh run's gathered solution bit for bit; each rank's
      epochs/s and the model group's ``all_reduce`` time per epoch are
      reported;
   t. the optimizers that read across their parameters on the model axis
      (``neurodiffeq_tpu_torch/parallel/optim.py``), on the same mesh in the
      same spawn: (a) Burgers' L-BFGS polish (``examples/burgers.py``'s
      ``polish_lbfgs``): 5k's Adam-trained solver (where 5k ran; else the
      Burgers net at ``POLISH_SEED``) saved and loaded onto the mesh,
      ``set_generator`` with a ``PredefinedGenerator`` of one frozen uniform
      draw of ``POLISH_POINTS`` points and ``set_optimizer`` with
      ``torch.optim.LBFGS`` (strong Wolfe, ``POLISH_ITERS`` iterations and a
      history of ``POLISH_HISTORY`` per epoch) for ``POLISH_EPOCHS`` epochs,
      against the same polish unsharded in this process: the first epoch's
      loss and parameters within ``SHARD_GRAD_TOL`` of unsharded, its closure
      calls equal to unsharded and every epoch's equal on every rank, the
      optimizer's model-group ``all_reduce`` calls one per closure call and
      two per iteration (one fewer in the first), the loss on the frozen
      draw falling, every rank the same history, ``POLISH_PASS`` launches per
      pass on each rank (one ``taylor_mlp`` unsharded), no fallback, and
      after 5k the mean error against Cole-Hopf below 5k's and below
      ``POLISH_MEAN_LIMIT``; the L-BFGS history's elements per rank,
      the model group's ``all_reduce`` time per closure call and each
      rank's epochs/s are reported; (b) ``torch.optim.Adafactor`` and
      ``torch.optim.Muon`` (over the 2-D weights) on the flagship at full
      width from 5r's initialization for ``OPT_EPOCHS`` epochs each against
      unsharded: Adafactor within ``SHARD_GRAD_TOL`` after each epoch, Muon's
      step from the unsharded first-epoch gradient within ``MUON_STEP_TOL``
      and its epochs within ``MUON_EPOCH_TOL``, the optimizer state per rank
      ``OPT_PER_RANK``;
6. timing: device time per call of kernel and twin at every shape of
   ``TABLE_SHAPES`` and ``REACH_SHAPES`` (``torch.profiler`` over 10 calls;
   the latter only where the tree's kernels take them) beside the kernel's
   bound (``taylor_mlp_streams`` at the first ``STREAM_TIMED`` shapes of
   ``STREAM_SHAPES``, with the design that ran, the other design's time,
   and a bound whose products run on tensor cores, ``stream_bound_ms``;
   beside pair 1 the two plain float32 ``torch.matmul`` products of its
   layers, TF32 off, as a yardstick; both designs at ``ROUTE_SHAPES``, on
   each side of each bound of the planner's narrow-net rule), ``taylor_mlp_1h_bwd`` at every shape of
   ``BWD_SHAPES``, checked against its closed form in float64 (``TOL``, two launches bitwise equal) and
   then timed beside its bound (``backward_cost``) and the twin's autograd, the wrapper's host enqueue
   time per call, and train-only epochs/s
   with the kernel and with the twin swapped in, interleaved in 50-epoch
   windows (the twin's must launch nothing); the backward of the kernel's autograd function at both cavity
   widths; the Lotka-Volterra epoch's rate in 50-epoch windows and the spherical,
   both cavity, the bundle, heat and Burgers epochs' rates from the
   300-epoch windows of their own fits in 5d-5f and 5h-5k, device time
   split by kernel kind over 2 profiled epochs, and device-busy shares;
   the same for 5l-5n, for 5o (its rate from its own fit), and for 5p's two
   problems and 5q's ``solve``, ``solve_system`` and ``solve2D`` (their rates
   from their own runs); and, only
   when named (``--phases 6b``), 5m's epoch in the design before this
   slice's batching (per-coordinate fields, one Hessian-vector product per
   probe: 3.5-13 s per epoch), one profiled;
7. the result (full run only).

``python3 chip_smoke.py --phases 3d,5l,5m,5n`` runs phases 1 and 2 and the listed
ones of ``PHASES`` (phase 6 times the paths among them) and prints no
result line: for development, and, as ``--phases 6``, to time an older tree
of the port (copy the script there). With no arguments every phase runs;
the whole run is meant to stay within about 900 s, build included, and
within the 509 s it took before the high-dimensional phases (on a host
whose 5a took 17.9 s per 1,000 epochs) plus 90 s, scaled by 5a's rate to
the host. With those phases it did not (579 s against 570 s, then 654 s
against 625 s), so the older work was cut in this order: phase 6's own windows and
profiled epochs and its calls per kernel shape (they check nothing), 5g
from 1,000 to 700 epochs (5l carries ``GenericSolver`` too), 5d from 4,000
to 3,500 and 5a from 1,000 to 700, each with its CPU float32 rehearsal's
error beside its limit (the constants below). Phase 5r (the data-parallel
slice) adds about 55 s: with it the whole run took 688 s on a host where 5a
ran at 18.3 s per 1,000 epochs (before the phase: 640 s at 20.7 s), about
925 s scaled to a host whose 5a takes 24.6 s, the host the 900 s were set
for, so the work was cut again, in the order above: phase 6's profiled
epochs per path (3 to 2) and calls per kernel shape (25 to 10); not 5g, 5d
or 5a, whose errors at a shallower cut come too near their limits (5g's CPU
float32 run at 500 epochs: 4.397e-2 of 5e-2; 5d's card 2.856e-2 of 0.03 at
3,500; 5a's card 6.622e-3 of 1e-2 at 700); and inside 5r, its unsharded
rate window from 299 to 100 epochs and its NCCL world of one, which now
runs in this process instead of a spawned rank (whose start-up took about
20 s). Phase 5s runs in 5r's spawn of ranks, so that it pays no start-up of
its own; should the whole run pass its budget again, the cavity's epochs
in 5s are cut first. Phase 5t runs in that spawn too; alone with 5k it took
about 46 s at 25 polish epochs of at most 8 iterations, so before it was
added the cavity's epochs in 5s were cut from 20 to 12 and the polish to
20 epochs of at most 4 iterations (its CPU float32 rehearsal's error
against Cole-Hopf from a 5k-trained net: 0.0403 before, 0.0177 after 10
epochs of 8 iterations, 0.0169 after 15 and 0.0152 after 25; 0.0393
before and 0.0199 after the 20 epochs of 4).

Any failure ends the run with a non-zero exit code and no result line. The
card's name and power limit and the kernel record come before the last
line, which is ``{"ok": true, "device": {...}}``.
"""
import contextlib
import functools
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
STREAMS_SOURCE = 'neurodiffeq_tpu_torch/csrc/taylor_mlp_streams.cu'
REPLACES = 'neurodiffeq_tpu/ops/pallas_mlp.py:115'
BWD_REPLACES = 'neurodiffeq_tpu/ops/pallas_mlp.py:259'  # _fused_bwd, jax.vjp over the pure-JAX twin
# 5a's 2,000 epochs cut to 1,000 when a full run with the heat and Burgers phases
# passed 900 s (the port's CPU float32 run of the phase: max error 4.746e-3 at
# 1,000 epochs, under the 1e-2 limit), and to 700 when the script with the
# high-dimensional phases took 654 s against its budget of 625 s (the module docstring;
# cpu_rehearsal.py at 700: 6.425e-3, the card 6.622e-3)
GRID, HIDDEN, EPOCHS, DEFAULT_NET_EPOCHS = (32, 32), (512,), 700, 300
LV_EPOCHS, LV_H1_EPOCHS, LV_PERIOD = 3000, 200, 500
# 5d's 5,000 epochs cut to 4,000 when a full run with the heat and Burgers phases
# passed 900 s, and to 3,500 in the same cut as 5a's to 700; the limit is about twice
# the 1.4699e-2 that the port's CPU float32 run of this phase gave at 3,500 epochs
# (cpu_rehearsal.py; 1.651e-2 at 4,000, 1.747e-2 at 5,000; the card 2.856e-2 at 3,500,
# 2.6655e-2 at 4,000), and under the JAX package's own 0.08 at 2500 epochs (cut to
# 2,500 epochs, the card read 4.1e-2)
SPH_EPOCHS, SPH_LIMIT = 3500, 0.03
SPH_R0, SPH_R1 = 0.1, 3.0
# the cavities (benchmarks/configs.py:179-213 and :261-289): FCNN 2-(128x5)-3
# (psi-omega: -2) shared by the conditions, 16,384 fresh uniform points per
# epoch, Re = 100, one cosine anneal 1e-3 -> 1e-5. 5e runs the primitive
# config's 1,000-epoch A/B segment of its 80,000-epoch anneal; 5f anneals over
# the 6,000 epochs it runs, where the JAX package records Ghia deviations of
# u 0.081 and v 0.054 (benchmarks/RESULTS.md:592, a quality record); the limits
# are about twice those
CAV_HIDDEN, CAV_POINTS, CAV_RE = (128,) * 5, 16384, 100.0
CAV_EPOCHS, CAV_ANNEAL, PSI_EPOCHS = 1000, 80000, 6000
PSI_LIMIT_U, PSI_LIMIT_V = 0.16, 0.11
# tests/test_generic_3d.py's problem and limit, its 3,000 epochs cut to 1,000 to
# keep the script's time (the port's CPU float32 run of this phase gave 4.08e-3
# at 1,000 epochs), and to 700 (5l carries GenericSolver too) in the same cut as 5a's
# (cpu_rehearsal.py at 700: 1.330e-2; the card 1.184e-2)
GEN3D_EPOCHS, GEN3D_LIMIT = 700, 5e-2
# BASELINE config 5 (benchmarks/configs.py:216-258): its 1,500 epochs and its
# 300 inverse steps and 1,000 hypersolver epochs; the limits are about 2.5
# times the JAX package's 7.8e-3 and 7.5e-3 (benchmarks/RESULTS.md:57, quality
# records) and tests/test_inverse.py's 0.05
BUNDLE_EPOCHS, BUNDLE_LIMIT, INVERSE_STEPS, INVERSE_LIMIT = 1500, 2e-2, 300, 0.05
HYPER_EPOCHS, HYPER_STEPS, HYPER_LIMIT = 1000, 50, 2e-2
# the corrected Euler against the bundle solution it learns: the port's CPU
# float32 runs of this phase gave 8.8e-5 and 2.2e-4 (seeds 0, 1), plain Euler
# 8.6e-3 and 1.1e-2; a corrector that does nothing or the wrong thing fails both
HYPER_SOL_LIMIT, HYPER_GAIN = 1e-3, 10
# examples/heat_equation.py: u_t = K u_xx on [0, L] x [0, T], Generator2D 32 x 32, Solver2D's
# default FCNN 2-32-32-1 tanh. 5i runs the Dirichlet variant for the example's 3,000 epochs
# with tests/test_ibvp_training.py's limit (that test trains 1,500 epochs on 16 x 16), then
# 200 epochs under the h1 loss (Taylor order 3); 5j runs the Neumann variant (pin anchors, the
# compose path) for 1,000 of its 3,000 epochs, its limit about twice the port's CPU float32
# run of this phase at that cut (1.888e-3)
HEAT_K, HEAT_L, HEAT_T = 0.3, 2.0, 1.5
HEAT_EPOCHS, HEAT_LIMIT, HEAT_H1_EPOCHS = 3000, 5e-2, 200
NEUMANN_EPOCHS, NEUMANN_LIMIT = 1000, 4e-3
# examples/burgers.py 'adaptive': FCNN 2-(20x8)-1 tanh, Generator1D(2048) * Generator1D(2048)
# uniform, ResidualAdaptiveGenerator(oversample=8, 'power', alpha=1, c=1), validation on
# 32 x 32; its 10,000 Adam epochs cut to 2,500 and its L-BFGS polish left out. The loss
# sits near 0.57 until the shock resolves (epoch 1,200-1,500), then falls with spikes (a
# CPU float32 run: 0.0707 over epochs 2,501-2,600, 1.52 over the next 100), so the train
# loss must fall 10x from the first epoch in its lowest 100-epoch mean (18.6x in a CPU
# float32 run at 2,500); the limit on the mean error against Cole-Hopf is about twice that
# run's 0.0403 (0.0509 at 2,000)
BURGERS_NU, BURGERS_HIDDEN, BURGERS_POINTS, BURGERS_OVERSAMPLE = 0.01 / np.pi, (20,) * 8, 2048, 8
BURGERS_EPOCHS, BURGERS_MEAN_LIMIT, BURGERS_DROP = 2500, 0.1, 10
POLISH_POINTS = 8192  # examples/burgers.py's polish_lbfgs: one frozen uniform draw
# phase 3c's 1-D conditions: IBVP1D on [0, 2] with u(x, 0) = cos x + x / 2, the end values
# and slopes compatible with it at t = 0; DoubleEndedBVP1D on [0, 1]
ANCHOR_DATA = {'x_min_val': lambda t: 1 + 0.3 * t, 'x_max_val': lambda t: math.cos(2.0) + 1 + 0.3 * t,
               'x_min_prime': lambda t: 0.5 - 0.4 * t, 'x_max_prime': lambda t: 0.5 - math.sin(2.0) + 0.2 * t}
DE_ANCHOR_DATA = {'x_min_val': 0.5, 'x_min_prime': -0.7, 'x_max_val': 1.5, 'x_max_prime': 0.3}
# the high-dimensional slice (benchmarks/stde_ab.py, examples/poisson_highdim.py and
# benchmarks/biharmonic_ab.py at their published widths): FCNN d-64-64-1 sin, n_est = 16,
# 768 points for Poisson (512 + 256, all interior under the exact condition), 512 for the
# plate, errors on 4,096 points. 5l runs 1,000 of the benchmark's 2,000 epochs at d = 10
# (the JAX package's TPU record is 0.0005 at 2,000, benchmarks/RESULTS.md:437), with
# exactly the launches per epoch that the port's CPU float32 rehearsal counted
# (cpu_rehearsal.py); 5m the example's 2,000 at d = 100 (JAX 0.1043); 5n 300 of the
# benchmark's 3,000 at d = 4 (JAX 0.0010). The limits are about twice the errors of the
# port's CPU float32 rehearsal at the same epochs (cpu_rehearsal.py): 5l's 1.8175e-2; for
# 5m the mean over seeds 0-3, 0.2364, since the outcome there is bimodal over seeds (the
# loss stays near 1e8-1e9 or falls to 1e6-1e7; CPU 0.0860, 0.0239, 0.5406, 0.2952)
HD_HIDDEN, HD_POINTS, HD_EVAL, HD_N_EST, HD_CHECK_POINTS = (64, 64), 768, 4096, 16, 256
POISSON10_EPOCHS, POISSON10_LIMIT, POISSON10_LAUNCHES = 1000, 0.036, 1
POISSON100_EPOCHS, POISSON100_LIMIT = 2000, 0.47
PLATE_DIM, PLATE_POINTS, PLATE_EPOCHS = 4, 512, 300
# 5a's persistence: the loaded solver's resumed train loss against the saved one's (relative)
RESUME_LIMIT, EXPORT_LIMIT, EXPORT_SIZES = 1e-6, 1e-6, (1, 7, 101 * 101)
# the stiff oscillator of benchmarks/balancing_ab.py:42-55 at its published widths (u' = v,
# v' = -omega^2 u, omega = 10, two FCNN 1-64-64-1 sin, Solver1D's defaults, its seed 11), with
# AutoResidualWeightCallback on OnFirstLocal() | PeriodLocal(500) as its 'auto' arm runs it, for
# 1,500 of the study's 10,000 epochs (its TPU record: 0.0397 at 10,000); OSC_LAUNCHES is the CPU
# float32 rehearsal's count (cpu_rehearsal.py 5o): 10 per epoch (2 nets x (1 train + 4
# validation batches)) plus 2 per weight fire (one forward of each net); the limit is about twice
# that rehearsal's error at 1,500 epochs, 1.1544 (seeds 0-5: 0.908-1.148; the JAX package's
# run_arm on the CPU: 0.9964), far from converged at this cut
OSC_OMEGA, OSC_HIDDEN, OSC_SEED, OSC_EPOCHS, OSC_PERIOD = 10.0, (64, 64), 11, 1500, 500
OSC_FIRES, OSC_LAUNCHES, OSC_LIMIT = 4, 10 * 1500 + 2 * 4, 2.3
# the temporal subsystem (5p): (a) the heat problem of tests/test_temporal.py:40-76 (k = 0.3, L = 2, T = 3,
# u0 = sin(pi x / L), penalty u = 0 at both ends, FCNN 2-32-32-1 tanh, 32 x 32 points drawn from numpy's
# stream, batch 512, Adam 3e-3, 300 epochs, shuffled), whose error at t = 1 the JAX test holds to 0.12; (b)
# the RE100 cavity of the temporal-API experiment at its published width (one FCNN 2-256-3 tanh,
# SURVEY.md:344, BASELINE.md:25) through SingleNetworkApproximator2DSpatialSystem, the penalty walls of
# examples/lid_driven_cavity.py::build_penalty (strictness 10), 32 x 32 points in one batch, Adam 1e-3, 300
# epochs; no Ghia check: this shallow configuration is basin-unstable under its own protocol
# (benchmarks/configs.py:180-186). The launch counts are exactly the port's CPU float32 rehearsal's
# (cpu_rehearsal.py 5p) per epoch. The heat limit is about twice the largest error of that rehearsal over
# seeds 0-4 (1.598e-3, 4.344e-3, 3.544e-3, 2.219e-3, 2.588e-3: the card's float32 run is another draw);
# the cavity's fall over the first to the last 10 epochs must pass half the rehearsal's 2.38x (seeds 1-4:
# 1.88x-3.49x)
TEMPORAL_EPOCHS, TEMPORAL_BATCH, TEMPORAL_SEED = 300, 512, 0
THEAT_K, THEAT_L, THEAT_T, THEAT_LIMIT, THEAT_LAUNCHES = 0.3, 2.0, 3.0, 8.7e-3, 4
TCAV_HIDDEN, TCAV_BATCH, TCAV_STRICTNESS, TCAV_DROP, TCAV_LAUNCHES = (256,), 1024, 10.0, 1.19, 3
# the legacy APIs (5q), on their default nets and generators: (a) ode.solve on u' + u = 0, IVP(0, 1), t in
# [0, 2], 1,000 epochs; (b) ode.solve_system on u1' = u2, u2' = -u1 with the shared FCNN 1-32-32-2, 1,000
# epochs; (c) pde.solve2D on the Laplace problem
# of tests/test_legacy_apis.py:76-91, 500 epochs, error on 101 x 101; (d) pde_spherical.solve_spherical on
# the direct electric potential of tests/test_pde_spherical.py:44-57, 300 epochs; (e) the hexagram of
# tests/test_pde_irregular.py through pde.solve2D with FCNN 2-100-100-1 ELU for one epoch, in float64 (and
# float32, reported), against the anchors of BASELINE.md:15-16. The launch and fallback counts are exactly
# the port's CPU float32 rehearsal's (cpu_rehearsal.py 5q); the limits about twice its largest error over
# the seeds LEGACY_SEED = 0, 10, 20, 30 (a: 1.151e-3, 2.172e-3, 1.251e-3, 9.489e-4; b: 5.967e-3, 7.837e-3,
# 1.026e-2, 4.284e-3; c: 2.751e-2, 2.516e-2, 1.539e-2, 5.640e-3)
LEGACY_ODE_EPOCHS, LEGACY_2D_EPOCHS, LEGACY_SPH_EPOCHS, LEGACY_LAUNCHES, LEGACY_SEED = 1000, 500, 300, 5, 0
LEGACY_ODE_LIMIT, LEGACY_SYSTEM_LIMIT, LEGACY_2D_LIMIT, LEGACY_SPH_LAUNCHES = 4.4e-3, 2.1e-2, 5.5e-2, 2
HEXAGRAM_HIDDEN, HEXAGRAM_DIRICHLET, HEXAGRAM_NEUMANN, HEXAGRAM_FALLBACKS = (100, 100), 1e-4, 1e-2, 25
# the data-parallel slice (5r): the flagship (5a's config at full width) on a mesh over the points, 2 ranks on one
# card over gloo (one rank per card over NCCL where there are more), each rank's block of every batch of 1,024 points
# (N = 512 each on 2 ranks); 300 epochs from seed 0, the last 20 with every collective timed, and the unsharded rate
# over 100 epochs after the unsharded first epoch (cut from 299 with the cuts of the module docstring). The first epoch's loss and
# gradients against the unsharded run: float32, relative. SHARD_LIMIT is about twice the largest error of the CPU
# float32 rehearsal of this phase over seeds 0-2 (cpu_rehearsal.py 5r: 1.4901e-2, 1.5154e-2, 1.4915e-2; the JAX
# package's run on its mesh of 2 CPU devices, 5r-jax: 1.4700e-2, 1.5194e-2, 1.5182e-2)
SHARD_RANKS, SHARD_EPOCHS, SHARD_COLL_EPOCHS, SHARD_SEED, SHARD_GRAD_TOL = 2, 300, 20, 0, 1e-5
SHARD_LIMIT, SHARD_TIMEOUT, SHARD_CPU_THREADS, SHARD_RATE_EPOCHS = 0.03, 240, 2, 100
WIDE_INPUTS = (9, 32, 32, 1)  # more inputs than one direction chunk: two chunks in one launch
# the model axis (5s): the flagship (5r's config) and the primitive cavity (5e's config at full width, 16,384 points,
# its anneal) on a (points, model) mesh of 2 model ranks, 2 gloo ranks on one card; the flagship over SHARD_EPOCHS
# epochs from 5r's initialization and generator state, the cavity over MODEL_CAV_EPOCHS from 5e's seed (cut from 20
# to 12 when 5t was added: the module docstring). Per epoch
# and rank the CPU rehearsal (cpu_rehearsal.py 5s) counts 5 taylor_mlp_1h launches for the flagship (one layer
# pair, its 256 columns on each rank) and 1 taylor_mlp_1h and 2 taylor_mlp_streams for the cavity (three pairs);
# the flagship's error limit is 5r's SHARD_LIMIT, about twice that rehearsal's errors over seeds 0-2 (1.4901e-2,
# 1.5154e-2, 1.4915e-2, 5r's own; the JAX package on its (1, 2) mesh, 5s-jax: 1.4700e-2, 1.5194e-2, 1.5182e-2)
MODEL_AXIS, MODEL_CAV_EPOCHS, MODEL_CAV_COLL_EPOCHS = 2, 12, 5
# each rank stores its blocks of the split leaves (the JAX package's addressable shards): the elements of its
# parameters, gradients and each Adam moment on a model axis of 2, against the whole net's (2,049 and 66,819)
MODEL_PER_RANK = {'flagship': 1025, 'cavity': 33539}
# Burgers' L-BFGS polish on the model axis (5t): examples/burgers.py's polish_lbfgs (one frozen uniform draw of
# POLISH_POINTS, set_generator, then L-BFGS through set_optimizer) from 5k's Adam-trained solver, saved and loaded
# onto a (1, 2) mesh, against the same polish unsharded in this process: torch.optim.LBFGS with the strong-Wolfe line
# search, POLISH_ITERS iterations and a history of POLISH_HISTORY (optax.lbfgs's memory) per epoch, POLISH_EPOCHS
# epochs (or from the Burgers net at POLISH_SEED where 5k did not run). Each closure call runs every kernel entry on
# each model rank: pair 0 through taylor_mlp_1h (2-10-20), pairs 1-3 through taylor_mlp_streams (20-10-20) and the
# trailing 20 -> 1 layer whole through its staged instance: POLISH_PASS per pass (a closure call or a validation
# batch), the CPU rehearsal's count (cpu_rehearsal.py 5t); unsharded, one taylor_mlp per pass. The optimizer's own
# model-group all_reduce calls are one per closure call and two per iteration, one fewer in the first iteration
# (tests/test_torch_model_parallel.py counts the same). After 5k the polish's mean error against Cole-Hopf must fall
# below 5k's and below POLISH_MEAN_LIMIT, 1.4 times the largest of the CPU float32 rehearsal (cpu_rehearsal.py 5k 5t:
# from 0.03929 to 0.01985 on the ranks and 0.01967 unsharded) and under every error the polish started from (the card
# read 0.0331-0.0355 after 5k and 0.0181-0.0233 after the polish; a polish that leaves 5k's error fails). At most
# POLISH_ITERS iterations per epoch keep the first epoch's float32 round-off within SHARD_GRAD_TOL of the unsharded
# run's: L-BFGS amplifies it from iteration to iteration (the card read 4.05e-6 and 7.33e-6 at 8 iterations; the
# rehearsal 4.81e-8 at 4)
POLISH_EPOCHS, POLISH_ITERS, POLISH_HISTORY, POLISH_SEED = 20, 4, 10, 0
POLISH_PASS = {'taylor_mlp_1h': 1, 'taylor_mlp': 0, 'taylor_mlp_streams': 4}
POLISH_MEAN_LIMIT = 0.028
# Adafactor and Muon (over the 2-D weights) on the flagship at full width (5r's initialization and generator state)
# on the same mesh, OPT_EPOCHS epochs each at OPT_LR against the unsharded runs: Adafactor within SHARD_GRAD_TOL after
# each epoch, Muon's first step from the unsharded gradient within MUON_STEP_TOL (float32 round-off) and its epochs
# within MUON_EPOCH_TOL. Muon orthogonalizes in bfloat16, so gradients that differ at float32 round-off (the mesh sums
# in another order) may round one bfloat16 ulp (2^-8) apart there: 3 such steps move an element of the first weight
# by at most 3 x OPT_LR x 16 (its learning-rate adjustment, sqrt(512 / 2)) x 2^-8 x 1.5 (an orthogonalized element's
# largest size) = 2.8e-3 against its largest element of about 0.7 (4e-3 relative), and of the second weight by
# 3 x OPT_LR x 2^-8 x 1.5 against about 0.05 (2.3e-3): MUON_EPOCH_TOL holds both; the CPU rehearsal (cpu_rehearsal.py
# 5t) reads 0. Each rank's optimizer state: Adafactor 772 of 1,540 elements (the first weight's split row factor and
# its column factor, the first bias's half, the second weight's row factor and split column factor, the bias),
# Muon's momentum 768 of 1,536
OPT_EPOCHS, OPT_LR, MUON_STEP_TOL, MUON_EPOCH_TOL = 3, 1e-2, 1e-6, 1e-2
OPT_PER_RANK = {'Adafactor': (772, 1540), 'Muon': (768, 1536)}
# phase 3e, the ops package's surface: fcnn_taylor_pallas and the switch at the flagship's width on OPS_N points,
# the flagship's fit refused under disable_pallas(); and examples/poisson_high_frequency.py:42-66 (k = 4: FourierFCNN(2, 1,
# n_features=64, sigma=4, hidden_units=(64, 64)) on a 64 x 64 'equally-spaced-noisy' grid) for FOURIER_EPOCHS of its
# 20,000 epochs, its first epoch within SHARD_GRAD_TOL of the port's CPU float32 run on the same points from the same
# weights, the mean of its last 5 epochs' losses below its first 5's
OPS_N = 1024
FOURIER_K, FOURIER_GRID, FOURIER_FEATURES, FOURIER_HIDDEN, FOURIER_EPOCHS = 4.0, (64, 64), 64, (64, 64), 30
PHASES = ('3', '3c', '3d', '3e', '4', '5a', '5b', '5c', '5d', '5e', '5f', '5g', '5h', '5i', '5j', '5k', '5l', '5m',
          '5n', '5o', '5p', '5q', '5r', '5s', '5t', '6')
EXTRA_PHASES = ('6b',)  # run only when named: a baseline that PERF.md records, too slow for every run
WINDOW = 300  # epochs per timing window of a path's own fit
# phase 6's own work, which checks nothing, cut when the whole run with the high-dimensional
# phases took 579 s, past its budget of 570 s on that host (the module docstring):
# its windows (LV, the flagship interleaved) halved from 100 epochs, their warm-ups cut,
# and the profiled epochs per path cut from 20 to 5; cut again when the committed tree
# took 654 s against 625 s on a host slower for every older path than 5a's rate says: the
# windows from 3 to 2 (LV) and 6 to 4 (the flagship), 3 profiled epochs per path, and the
# calls timed per kernel shape from 100 to 25; and when the script with phase 5r took 688 s against
# its budget (about 925 s scaled by 5a's rate; the module docstring): 2 profiled epochs
# per path and 10 calls per kernel shape
OWN_WINDOW, PROFILED, SHAPE_CALLS = 50, 2, 10
IDENTITY_EPS = 1e-4  # tests/test_operators.py, BASELINE.md:17
F32, F64 = torch.float32, torch.float64
CHECK_SHAPES = [  # (layer widths, activation, order, N)
    ((2, 512, 1), 'tanh', 2, 1024),
    ((2, 512, 1), 'tanh', 2, 512),  # one rank's block of the flagship's batch on 2 ranks, phase 5r
    ((2, 256, 1), 'tanh', 2, 1024),  # one model rank's slice of the flagship on 2 model ranks, phase 5s
    ((2, 64, 128), 'tanh', 2, 16384),  # one model rank's slice of the cavity's pair 0, phase 5s
    ((2, 10, 20), 'tanh', 2, 8192),  # one model rank's slice of Burgers' pair 0 in the polish, phase 5t
    ((2, 64, 64, 1), 'tanh', 2, 1000),
    ((1, 32, 32, 1), 'sin', 1, 37),
    ((1, 32, 32, 1), 'sin', 2, 37),
    ((3, 16, 2), 'tanh', 2, 37),
    ((2, 1), 'tanh', 2, 37),
    ((3, 32, 32, 1), 'tanh', 2, 512),
    # the edges of the kernels' reach: d > 8 (2 and 3 chunks, the last shifted
    # back), 20 layers, streams past shared memory (float32 from width
    # 2,700 at d = 2, float64 from 1,247; the d = 12 net in float64 only), and a
    # one-hidden-layer net whose outputs exceed the 1h kernel's grid
    (WIDE_INPUTS, 'tanh', 2, 1000),
    ((20, 64, 1), 'tanh', 2, 333),
    ((10, 1), 'sin', 2, 37),
    ((2,) + (16,) * 19 + (1,), 'tanh', 2, 100),
    ((2, 2800, 2800, 1), 'tanh', 2, 300),
    ((12, 1000, 1000, 2), 'sin', 2, 200),
    ((3, 32, 70000), 'tanh', 1, 5),
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
    ((2, 128, 128, 128, 128, 128, 3), 'tanh', 2, 16384, F32),  # primitive cavity, phase 5e
    ((2, 128, 128, 128, 128, 128, 2), 'tanh', 2, 16384, F32),  # psi-omega cavity, phase 5f
    ((3, 32, 32, 1), 'tanh', 2, 1000, F32),  # GenericSolver 3-D Poisson on Generator3D 10^3, phase 5g
    ((1, 32, 32, 1), 'sin', 1, 32, F32),     # Lotka-Volterra batch, phase 5c
    ((1, 32, 32, 1), 'sin', 2, 32, F32),     # the same under the h1 loss
    ((1, 64, 64, 1), 'sin', 1, 32, F32),     # the stiff oscillator's batch, phase 5o
    ((2, 32, 32, 1), 'tanh', 1, 1024, F32),  # the bundle on (t, lam), phase 5h
    ((2,) + (20,) * 8 + (1,), 'tanh', 2, 16384, F32),  # Burgers, scoring 8 x 2,048 candidates, phase 5k
    ((2,) + (20,) * 8 + (1,), 'tanh', 2, 2048, F32),   # Burgers train batch
    ((2,) + (20,) * 8 + (1,), 'tanh', 2, 1024, F32),   # Burgers validation batch
    ((10, 64, 64, 1), 'sin', 2, 768, F32),   # d = 10 Poisson, exact laplacian: 2 direction chunks, phase 5l
    ((100, 64, 64, 1), 'sin', 2, 768, F32),  # the d = 100 exact laplacian's forward: 13 chunks, phase 3d
    ((2, 32, 32, 1), 'tanh', 2, 512, F32),   # the temporal heat's mini-batch, phase 5p
    ((2, 256, 3), 'tanh', 2, 1024, F32),     # the temporal cavity system, one pass for its 3 columns, phase 5p
    ((1, 32, 32, 1), 'tanh', 1, 32, F32),    # ode.solve's default net, phase 5q
    ((1, 32, 32, 2), 'tanh', 1, 32, F32),    # ode.solve_system's shared default net, phase 5q
    ((2, 512, 1), 'tanh', 2, 512, F32),      # one rank's block of the flagship's batch on 2 ranks, phase 5r
    ((2, 256, 1), 'tanh', 2, 1024, F32),     # one model rank's slice of the flagship on 2 model ranks, phase 5s
    ((2, 64, 128), 'tanh', 2, 16384, F32),   # one model rank's slice of the cavity's pair 0, phase 5s
    ((2, 10, 20), 'tanh', 2, 8192, F32),     # one model rank's slice of Burgers' pair 0 in the polish, phase 5t
]
# taylor_mlp_streams, phase 3 against its twin and phase 6 timed (the first STREAM_TIMED, float32): (stream width and
# layer widths, directions d, activation, input activation, order, N)
STREAM_SHAPES = [
    ((128, 64, 128), 2, 'tanh', 'tanh', 2, 16384),  # one model rank's slice of the cavity's pair 1, phase 5s
    ((128, 64, 3), 2, 'tanh', 'tanh', 2, 16384),    # its pair 2
    ((32, 1), 2, 'tanh', 'tanh', 2, 1024),          # the default FCNN's trailing layer, whole on each model rank
    ((20, 10, 20), 2, 'tanh', 'tanh', 2, 8192),     # Burgers' pairs 1-3 on one of 2 model ranks, the polish (5t)
    ((20, 1), 2, 'tanh', 'tanh', 2, 8192),          # its trailing 20 -> 1 layer, whole on each model rank
    ((128, 64, 128), 2, 'sin', 'sin', 1, 1024),     # order 1
    ((32, 16, 32), 10, 'tanh', 'tanh', 2, 1000),    # d > 8: two direction chunks, the last shifted back
    ((2800, 64, 1), 2, 'tanh', 'tanh', 2, 300),     # streams past shared memory: the global scratch
    ((16, 16, 2), 3, 'sin', None, 2, 37),           # no input activation; ragged N
    ((128, 64, 128), 3, 'tanh', 'tanh', 2, 4097),  # 7 streams: one raw input buffer in float32
]
STREAM_TIMED = 5
# taylor_mlp_streams' routing (ops/taylor_mlp.py::_narrow), phase 6: both designs timed in float32 (d = 2, tanh,
# input tanh, order 2) on each side of each bound of the narrow-net rule: (layer widths, N)
ROUTE_SHAPES = [
    ((32, 1), 16384), ((32, 8), 1024),       # the output under one mma n tile, or not
    ((64, 1), 16384), ((128, 3), 1024),      # the input at most 64 wide, or not
    ((32, 32, 1), 1024), ((64, 64, 1), 1024),  # 1,056 or 4,160 multiply-adds per point and stream
]
# the result line times taylor_mlp_1h at the flagship's shape and taylor_mlp at
# the primitive cavity's, its heaviest path (taylor_mlp_streams at STREAM_SHAPES[0])
RECORD_SHAPES = {'taylor_mlp_1h': ((2, 512, 1), 'tanh', 2, 1024, F32),
                 'taylor_mlp': ((2, 128, 128, 128, 128, 128, 3), 'tanh', 2, 16384, F32)}
# nets at the edges of the kernels' reach, timed too: two and three direction
# chunks, and streams in the global scratch (past shared memory from width 2,700)
REACH_SHAPES = [
    (WIDE_INPUTS, 'tanh', 2, 1000, F32),
    ((20, 64, 1), 'tanh', 2, 1024, F32),
    ((2, 2800, 2800, 1), 'tanh', 2, 1024, F32),
]
# the gradient of every one-hidden-layer shape of TABLE_SHAPES and REACH_SHAPES that taylor_mlp_1h_bwd takes (at most 128
# outputs), timed in phase 6 against the twin's autograd, and the flagship at the benchmark's batch
BWD_SHAPES = [s for s in TABLE_SHAPES + REACH_SHAPES if len(s[0]) == 3 and s[0][-1] <= 128] + [
    ((2, 512, 1), 'tanh', 2, 262144, F32)]
BWD_RECORD = ((2, 512, 1), 'tanh', 2, 1024, F32)  # the backward's shape in the result line: the flagship's batch
SIREN_SHAPES = [((2, 32, 32, 1), 1024), ((2, 64, 1), 1024)]  # (layer widths, N), w0 = 30, order 2
TOL = {F64: 1e-10, F32: 1e-4}
# H100 SXM peaks outside the tensor cores (float32, float64) and HBM3's rate, NVIDIA's data sheet
PEAK_FLOPS = {F32: 67e12, F64: 34e12}
# and on them: a float32 product in 3xTF32 is three TF32 products (495 TFLOP/s), float64 in DMMA
PEAK_MMA = {F32: 495e12 / 3, F64: 67e12}
PEAK_BYTES = 3.35e12


START = time.perf_counter()


def phase(name, msg):
    print(f"[{name}] (+{time.perf_counter() - START:.0f} s) {msg}", flush=True)


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


def backward_cost(dims, actv, order, n, esize, points_grad=False):
    """(floating-point operations, bytes) that the gradient of a one-hidden-
    layer net's Taylor series must do and move (``taylor_mlp_1h_bwd``),
    counted as ``taylor_cost`` counts the forward. Per point and hidden unit:
    z, the activation and its third derivative (tanh 4: f'^2 + a f'', times
    -2; sin 1); per output 2 for p0, 2d each for r1 and p1 (and r2, p2 at
    order 2), 2 each for q1 (q2) and 2 + 2 (+ 2) for dW2; then dz (3, or 5),
    db1 1, and per direction 4 (7) for dW1 and, with the points' gradient, 2.
    Bytes: the points, the cotangents, the parameters and their gradients
    (and the points' gradient), each once."""
    d, h, m = dims
    act = (1 + 4 + 4) if actv == 'tanh' else (2 + 1 + 1)
    per_out = 8 + 4 * d if order == 1 else 12 + 8 * d
    per_unit = 2 * d + act + m * per_out + (3 if order == 1 else 5) + 1 + d * (4 if order == 1 else 7)
    per_unit += 2 * d if points_grad else 0
    params = d * h + h + h * m + m
    nbytes = esize * (n * d * (2 if points_grad else 1) + n * m * (1 + order * d) + 2 * params)
    return n * h * per_unit, nbytes


def stream_cost(dims, d, actv, input_actv, order, n, esize):
    """(product operations, elementwise operations, bytes) of one
    ``taylor_mlp_streams`` call on ``(1 + order d, n, dims[0])`` input
    streams, as ``taylor_cost`` counts them: 2 S h_in h_out per layer (S =
    1 + order*d), and the input activation and every hidden unit's
    activation and chain rule per point. Bytes: the input streams, the
    parameters and the S outputs, each once."""
    s = 1 + order * d
    act = (1 + 4) if actv == 'tanh' else (2 + 1)
    chain = 5 * d if order == 2 else d
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    products = sum(2 * s * h_in * h_out for h_in, h_out in zip(dims[:-1], dims[1:]))
    elementwise = (dims[0] * (act + chain) if input_actv else 0) + sum(h * (act + chain) for h in dims[1:-1])
    return n * products, n * elementwise, esize * (n * s * (dims[0] + dims[-1]) + params)


def stream_bound_ms(dims, d, actv, input_actv, order, n, dtype):
    """(least milliseconds the card could take, 'operations' or 'bytes') for
    one ``taylor_mlp_streams`` call: the larger of its bytes at HBM3's rate
    and its products on tensor cores (``PEAK_MMA``) plus its elementwise
    work at ``PEAK_FLOPS``; and, for comparison, the CUDA-core bound that
    counts every operation at ``PEAK_FLOPS``."""
    products, elementwise, nbytes = stream_cost(dims, d, actv, input_actv, order, n, torch.finfo(dtype).bits // 8)
    t_ops = (products / PEAK_MMA[dtype] + elementwise / PEAK_FLOPS[dtype]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')
    return bound, bound_ms(dims, actv, order, n, dtype, (products + elementwise, nbytes))


def bound_ms(dims, actv, order, n, dtype, cost=None):
    """(least milliseconds the card could take, 'operations' or 'bytes');
    ``cost``: (operations, bytes) given, else ``taylor_cost``'s."""
    flops, nbytes = cost or taylor_cost(dims, actv, order, n, torch.finfo(dtype).bits // 8)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def stream_inputs(dims, d, order, n, dtype, seed):
    """Input streams ``(1 + order d, n, dims[0])`` in [-1, 1) and layers on
    the card, as ``inputs`` makes them."""
    g = torch.Generator().manual_seed(200 + seed)
    streams = (torch.rand(1 + order * d, n, dims[0], generator=g, dtype=F64) * 2 - 1).to('cuda', dtype)
    return streams, [(W.t().contiguous().to('cuda', dtype).t(), b.to('cuda', dtype))
                     for W, b in random_layers(dims, seed)]


def stream_name(dims, d, actv, input_actv, order, n, dtype=None):
    dt = f"{str(dtype)[6:]} " if dtype is not None else ''
    return f"{dt}streams d={d} {'-'.join(map(str, dims))} {actv} (input {input_actv}) order {order} N={n}"


def flagship_solver(**kwargs):
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN

    from neurodiffeq_tpu_torch.utils import get_default_device

    dev, dt = get_default_device(), F32  # the card (cpu_rehearsal.py asks for the CPU)
    return laplace_solver(
        nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=HIDDEN, device=dev, dtype=dt)],
        train_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced-noisy', device=dev, dtype=dt),
        valid_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced', device=dev, dtype=dt),
        device=dev, dtype=dt, **kwargs)


def laplace_problem():
    """(equation, condition) of the flagship's 2-D Laplace Dirichlet problem."""
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D

    cond = DirichletBVP2D(
        x_min=0.0, x_min_val=lambda y: 0 * y,
        x_max=1.0, x_max_val=lambda y: 0 * y,
        y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x),
        y_max=1.0, y_max_val=lambda x: 0 * x)
    return (lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)]), cond


def laplace_solver(**kwargs):
    """The flagship's 2-D Laplace Dirichlet problem; ``kwargs`` go to ``Solver2D``."""
    from neurodiffeq_tpu_torch.solvers import Solver2D

    pde, cond = laplace_problem()
    return Solver2D(pde_system=pde, conditions=[cond], xy_min=(0.0, 0.0), xy_max=(1.0, 1.0), **kwargs)


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
    """Phase 5d: the spherical path. Returns what :func:`run_cavity` returns."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(0)
    solver, step_schedule = sph_solver(SPH_EPOCHS)
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, SPH_EPOCHS, [step_schedule], windowed=True)
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
    return launches, solver, step_schedule, rates


# Ghia, Ghia & Shin (1982), Re = 100: u on the vertical centerline x = 0.5 and
# v on the horizontal one y = 0.5 (examples/lid_driven_cavity.py:174-185)
GHIA_Y = np.array([1.0000, 0.9766, 0.9688, 0.9609, 0.9531, 0.8516, 0.7344, 0.6172, 0.5000, 0.4531, 0.2813,
                   0.1719, 0.1016, 0.0703, 0.0625, 0.0547, 0.0000])
GHIA_U = np.array([1.00000, 0.84123, 0.78871, 0.73722, 0.68717, 0.23151, 0.00332, -.13641, -.20581, -.21090,
                   -.15662, -.10150, -.06434, -.04775, -.04192, -.03717, 0.00000])
GHIA_X = np.array([1.0000, 0.9688, 0.9609, 0.9531, 0.9453, 0.9063, 0.8594, 0.8047, 0.5000, 0.2344, 0.2266,
                   0.1563, 0.0938, 0.0781, 0.0703, 0.0625, 0.0000])
GHIA_V = np.array([0.00000, -.05906, -.07391, -.08864, -.10313, -.16914, -.22445, -.24533, 0.05454, 0.17527,
                   0.17507, 0.16077, 0.12317, 0.10890, 0.10091, 0.09233, 0.00000])


def cavity_problem(form):
    """(conditions, equations, residual weights) of the primitive (u, v, p)
    cavity (examples/lid_driven_cavity.py:42-79) or of the streamfunction-
    vorticity one (examples/cavity_streamfunction.py:58-115), each condition
    imposed on its column of the shared net."""
    import warnings
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import BaseCondition

    nu = 1.0 / CAV_RE
    if form == 'primitive':
        def u_lid(x):
            return (1 - F.exp(-50.0 * x)) * (1 - F.exp(50.0 * (x - 1)))

        class HardCavityU(BaseCondition):
            def parameterize(self, out, x, y):
                return x * (1 - x) * y * (1 - y) * out + y * u_lid(x)

        class HardCavityV(BaseCondition):
            def parameterize(self, out, x, y):
                return x * (1 - x) * y * (1 - y) * out

        class HardCavityP(BaseCondition):
            def parameterize(self, out, x, y):
                return (1 - F.exp(-x)) * (1 - F.exp(-y)) * out

        equations = steady_navier_stokes(diff, nu)
        conds, weights = [HardCavityU(), HardCavityV(), HardCavityP()], None
    else:
        def u_lid(x):  # C^1 at the corners, A = 50
            return (1 - F.exp(-((50.0 * x) ** 2))) * (1 - F.exp(-((50.0 * (x - 1)) ** 2)))

        class PsiCavity(BaseCondition):
            def parameterize(self, out, x, y):
                bump = x * (1 - x) * y * (1 - y)
                return y * y * (y - 1) * F.exp(-20.0 * (1 - y)) * u_lid(x) + bump * bump * out

        class ScaledOutput(BaseCondition):
            def parameterize(self, out, x, y):
                return 50.0 * out

        def equations(psi, w, x, y):
            u, v = diff(psi, y), -diff(psi, x)
            return [w + diff(psi, x, 2) + diff(psi, y, 2),
                    u * diff(w, x) + v * diff(w, y) - nu * (diff(w, x, 2) + diff(w, y, 2))]

        conds, weights = [PsiCavity(), ScaledOutput()], [0.3 ** 2, 1.0]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    return conds, equations, weights


def cavity_solver(form, anneal, **kwargs):
    """The deep cavity of ``form`` through ``Solver2D`` on the port's defaults
    (cuda, float32): one FCNN 2-(128x5)-n shared by the conditions,
    ``Generator1D(16384, 'uniform') * Generator1D(16384, 'uniform')``, no
    validation batches, Adam under the cosine anneal 1e-3 -> 1e-5 over
    ``anneal`` epochs as a ``LambdaLR``; ``kwargs`` go to ``Solver2D``.
    Returns the solver and a callback that steps the schedule once per
    epoch."""
    from neurodiffeq_tpu_torch.generators import Generator1D, Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D

    conds, equations, weights = cavity_problem(form)
    net = FCNN(n_input_units=2, n_output_units=len(conds), hidden_units=CAV_HIDDEN)
    solver = Solver2D(
        pde_system=equations, conditions=conds, xy_min=(0, 0), xy_max=(1, 1), nets=[net] * len(conds),
        train_generator=Generator1D(CAV_POINTS, 0.0, 1.0, method='uniform') * Generator1D(
            CAV_POINTS, 0.0, 1.0, method='uniform'),
        valid_generator=Generator2D((32, 32), (0, 0), (1, 1), method='equally-spaced'),
        n_batches_valid=0, residual_weights=weights, **kwargs)
    alpha = 1e-2
    sched = torch.optim.lr_scheduler.LambdaLR(
        solver.optimizer, lambda k: alpha + (1 - alpha) * 0.5 * (1 + math.cos(math.pi * min(k, anneal) / anneal)))
    return solver, lambda s: sched.step()


def fit_path(F, taylor_mlp, solver, epochs, callbacks=(), windowed=False):
    """``epochs`` epochs of ``fit`` with the launch and fallback counts reset
    just before and read just after; returns (seconds, launches, fallbacks,
    epochs/s of each ``WINDOW``-epoch window). ``windowed`` runs them as
    ``fit(epochs % WINDOW)`` and then ``fit(WINDOW)`` calls, each timed (the
    training is the same: ``fit`` keeps the optimizer, and the callbacks
    step once per epoch)."""
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if windowed:
        solver.fit(epochs % WINDOW, callbacks=callbacks, tqdm_file=None)
    rates = []
    for _ in range(epochs // WINDOW if windowed else 0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        solver.fit(WINDOW, callbacks=callbacks, tqdm_file=None)
        torch.cuda.synchronize()
        rates.append(WINDOW / (time.perf_counter() - t1))
    if not windowed:
        solver.fit(epochs, callbacks=callbacks, tqdm_file=None)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count(), rates


def launch_checks(launches, fallbacks, per_epoch, epochs):
    return {f'taylor_mlp launched {per_epoch} per epoch': launches['taylor_mlp'] == per_epoch * epochs,
            'taylor_mlp_1h not launched': launches['taylor_mlp_1h'] == 0,
            'no Taylor fallback': fallbacks == 0}


def report(name, msg, checks, failure):
    phase(name, msg + '; ' + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit(f"chip_smoke: {failure}")


def run_cavity(F, taylor_mlp):
    """Phase 5e: the primitive deep cavity. Returns its launch counts, the
    trained solver, its schedule's callback and its epochs/s per window."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(4)
    solver, step_schedule = cavity_solver('primitive', CAV_ANNEAL)
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, CAV_EPOCHS, [step_schedule], windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    wall_err, lid_err, gauge_err = cavity_walls(solver)
    checks = launch_checks(launches, fallbacks, 1, CAV_EPOCHS)
    checks.update({'loss fell': late < early, **wall_checks(wall_err, lid_err, gauge_err)})
    report('5e primitive cavity',
           f"Solver2D FCNN 2-(128x5)-3 shared by 3 conditions, {CAV_POINTS} uniform points, fit({CAV_EPOCHS}) of "
           f"the {CAV_ANNEAL}-epoch anneal, float32, in {fit_s:.1f} s ({CAV_EPOCHS / fit_s:.1f} epochs/s, no "
           f"validation): launches {launches} ({launches['taylor_mlp'] / CAV_EPOCHS:.2f} taylor_mlp per epoch), "
           f"{fallbacks} fallbacks, train loss mean {early:.4e} (first 100) -> {late:.4e} (last 100); trained "
           f"net: max |u|, |v| on the walls {wall_err:.2e}, lid error {lid_err:.2e}, max |p| on x = 0 and y = 0 "
           f"{gauge_err:.2e}", checks, "primitive cavity check failed")
    return launches, solver, step_schedule, rates


def cavity_walls(solver):
    """The primitive cavity's trained solution on its boundary: (max |u|,
    |v| on the walls, the lid's error in u and max |v| there, max |p| on x
    = 0 and y = 0)."""
    s = np.linspace(0, 1, 101).astype(np.float32).astype(np.float64)  # the float32 points, exactly
    zeros, ones = np.zeros_like(s), np.ones_like(s)
    sol = solver.get_solution()
    walls = [sol(xs, ys, to_numpy=True) for xs, ys in ((zeros, s), (ones, s), (s, zeros), (s, ones))]
    wall_err = max(float(np.abs(w[k]).max()) for w in walls[:3] for k in (0, 1))
    lid_want = (1 - np.exp(-50.0 * s)) * (1 - np.exp(50.0 * (s - 1)))
    lid_err = max(float(np.abs(walls[3][0] - lid_want).max()), float(np.abs(walls[3][1]).max()))
    gauge_err = max(float(np.abs(walls[0][2]).max()), float(np.abs(walls[2][2]).max()))
    return wall_err, lid_err, gauge_err


def wall_checks(wall_err, lid_err, gauge_err):
    return {'u = v = 0 on the walls to 1e-6': wall_err <= 1e-6, 'u = u_lid, v = 0 on the lid to 2e-6': lid_err <= 2e-6,
            'p(0, y) = p(x, 0) = 0 to 1e-6': gauge_err <= 1e-6}


def psi_velocities(solver, xs, ys):
    """u = psi_y and v = -psi_x of the trained streamfunction at (xs, ys)."""
    from neurodiffeq_tpu_torch import diff

    cols = [torch.as_tensor(a, dtype=solver.dtype, device=solver.device).reshape(-1, 1) for a in (xs, ys)]
    with torch.no_grad():
        (psi, _), (x, y) = solver._forward(cols)
        return diff(psi, y).value.cpu().numpy()[:, 0], -diff(psi, x).value.cpu().numpy()[:, 0]


def run_psi(F, taylor_mlp):
    """Phase 5f: the streamfunction-vorticity cavity. Returns what
    :func:`run_cavity` returns."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(4)
    solver, step_schedule = cavity_solver('psi-omega', PSI_EPOCHS)
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, PSI_EPOCHS, [step_schedule], windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    u_mid, _ = psi_velocities(solver, 0.5 * np.ones_like(GHIA_Y), GHIA_Y)
    _, v_mid = psi_velocities(solver, GHIA_X, 0.5 * np.ones_like(GHIA_X))
    u_err, v_err = float(np.abs(u_mid - GHIA_U).max()), float(np.abs(v_mid - GHIA_V).max())
    checks = launch_checks(launches, fallbacks, 1, PSI_EPOCHS)
    checks.update({
        'loss fell': late < early,
        f'Ghia u deviation <= {PSI_LIMIT_U}': bool(np.isfinite(u_mid).all()) and u_err <= PSI_LIMIT_U,
        f'Ghia v deviation <= {PSI_LIMIT_V}': bool(np.isfinite(v_mid).all()) and v_err <= PSI_LIMIT_V,
    })
    report('5f psi-omega cavity',
           f"Solver2D FCNN 2-(128x5)-2 shared by 2 conditions, residual weights [0.09, 1], {CAV_POINTS} uniform "
           f"points, fit({PSI_EPOCHS}) annealed over {PSI_EPOCHS}, float32, in {fit_s:.1f} s "
           f"({PSI_EPOCHS / fit_s:.1f} epochs/s, no validation): launches {launches} "
           f"({launches['taylor_mlp'] / PSI_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} fallbacks, train loss "
           f"mean {early:.4e} (first 100) -> {late:.4e} (last 100), final lr "
           f"{solver.optimizer.param_groups[0]['lr']:.3e}; max centerline deviation from Ghia et al. (1982): "
           f"u {u_err:.4f}, v {v_err:.4f}", checks, "psi-omega cavity check failed")
    return launches, solver, step_schedule, rates


def run_generic_3d(F, taylor_mlp):
    """Phase 5g: GenericSolver on tests/test_generic_3d.py's 3-D Poisson
    problem. Returns its launch counts."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.conditions import BaseCondition
    from neurodiffeq_tpu_torch.generators import Generator3D
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import GenericSolver
    from neurodiffeq_tpu_torch.utils import set_seed

    class ZeroBoundaryBox(BaseCondition):
        def parameterize(self, out, x, y, z):
            return 64 * x * (1 - x) * y * (1 - y) * z * (1 - z) * out

    def pde(u, x, y, z):
        src = -3 * np.pi ** 2 * F.sin(np.pi * x) * F.sin(np.pi * y) * F.sin(np.pi * z)
        return [diff(u, x, 2) + diff(u, y, 2) + diff(u, z, 2) - src]

    set_seed(0)
    solver = GenericSolver(
        diff_eqs=pde, conditions=[ZeroBoundaryBox()],
        nets=[FCNN(n_input_units=3, n_output_units=1, hidden_units=(32, 32))],
        train_generator=Generator3D((10, 10, 10), (0, 0, 0), (1, 1, 1), method='equally-spaced-noisy'),
        valid_generator=Generator3D((10, 10, 10), (0, 0, 0), (1, 1, 1), method='equally-spaced'))
    fit_s, launches, fallbacks, _ = fit_path(F, taylor_mlp, solver, GEN3D_EPOCHS)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    sol = solver.get_solution()
    rng = np.random.RandomState(0)
    pts = rng.rand(200, 3)
    u = sol(pts[:, 0], pts[:, 1], pts[:, 2], to_numpy=True)
    max_err = float(np.abs(u - np.prod(np.sin(np.pi * pts), axis=1)).max())
    face = rng.rand(20, 2)
    face_err = 0.0
    for axis in range(3):
        for val in (0.0, 1.0):
            coords = [face[:, 0], face[:, 1]]
            coords.insert(axis, np.full(20, val))
            face_err = max(face_err, float(np.abs(sol(*coords, to_numpy=True)).max()))
    checks = launch_checks(launches, fallbacks, 5, GEN3D_EPOCHS)
    checks.update({'loss fell': late < early,
                   f'max error < {GEN3D_LIMIT}': bool(np.isfinite(u).all()) and max_err < GEN3D_LIMIT,
                   'faces exact to 1e-6': face_err <= 1e-6})
    report('5g GenericSolver 3-D',
           f"Poisson on the unit cube, FCNN 3-32-32-1, Generator3D 10^3, fit({GEN3D_EPOCHS}) float32 in "
           f"{fit_s:.1f} s ({GEN3D_EPOCHS / fit_s:.1f} epochs/s with 4 validation batches): launches {launches} "
           f"({launches['taylor_mlp'] / GEN3D_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} fallbacks, train "
           f"loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), max |u - exact| on 200 points "
           f"{max_err:.3e}, max |u| on the faces {face_err:.1e}", checks, "GenericSolver 3-D check failed")
    return launches


def check_wide_inputs(F, taylor_mlp):
    """Phase 3: an FCNN of more inputs than one direction chunk
    (``WIDE_INPUTS``, order 2) through ``GenericSolver._forward`` launches
    ``taylor_mlp`` once, and its u_xx and u_x on every axis equal double
    backward, float64 and float32. Returns nothing, or SystemExit."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.conditions import NoCondition
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import GenericSolver

    d = WIDE_INPUTS[0]
    for dtype in (F64, F32):
        torch.manual_seed(0)
        net = FCNN(d, 1, hidden_units=WIDE_INPUTS[1:-1], device='cuda', dtype=dtype)
        pts = torch.rand(1000, d, generator=torch.Generator().manual_seed(500), dtype=F64).to('cuda', dtype)
        gen = PredefinedGenerator(*pts.T, device='cuda', dtype=dtype)
        solver = GenericSolver(diff_eqs=lambda u, *xs: [sum(diff(u, x, 2) for x in xs)], conditions=[NoCondition()],
                               nets=[net], train_generator=gen, valid_generator=gen, device='cuda', dtype=dtype)
        F.reset_taylor_fallback_count()
        taylor_mlp.reset_launches()
        with torch.no_grad():
            (u,), xs = solver._forward([pts[:, i:i + 1] for i in range(d)])
            got = torch.stack([diff(u, x, 2).value[:, 0] for x in xs] + [diff(u, x).value[:, 0] for x in xs])
        torch.cuda.synchronize()
        launched = dict(taylor_mlp.LAUNCHES)
        leaf = pts.clone().requires_grad_()
        (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
        want = torch.stack([torch.autograd.grad(g[:, i].sum(), leaf, retain_graph=True)[0][:, i]
                            for i in range(d)] + [g[:, i] for i in range(d)]).detach()
        err = rel_err(got, want)
        ok = (launched == {'taylor_mlp_1h': 0, 'taylor_mlp': 1, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}
              and F.taylor_fallback_count() == 0 and err <= TOL[dtype])
        phase('3 kernel', f"{str(dtype)[6:]} FCNN {'-'.join(map(str, WIDE_INPUTS))} tanh order 2 N=1000 through "
                          f"GenericSolver._forward: launches {launched}, u_xx and u_x on the {d} axes against "
                          f"double backward rel err {err:.2e} (limit {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: a net of more inputs than one chunk did not run in one launch")


def bundle_solver():
    """BASELINE config 5's bundle: du/dt + lam u = 0, u(0) = 1, over t in
    [0, 1] and lam in [0.5, 1.5] through ``BundleSolver1D`` with every
    default (cuda, float32, FCNN 2-32-32-1 tanh, 32 x 32 meshes)."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.conditions import BundleIVP
    from neurodiffeq_tpu_torch.solvers import BundleSolver1D

    return BundleSolver1D(ode_system=lambda u, t, lam: [diff(u, t) + lam * u],
                          conditions=[BundleIVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=1.0,
                          theta_min=0.5, theta_max=1.5, eq_param_index=(0,))


def run_bundle(F, taylor_mlp):
    """Phase 5h: the bundle, the inverse workflow through its solution and
    the hypersolver against it. Returns what :func:`run_cavity` returns,
    with no schedule."""
    from neurodiffeq_tpu_torch.hypersolver import DiscreteSolution1D, Euler, Hypersolver
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(0)
    solver = bundle_solver()
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, BUNDLE_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    sol = solver.get_solution()
    ts = np.linspace(0, 1, 40)
    errs = {lam: float(np.abs(sol(ts, lam * np.ones(40), to_numpy=True) - np.exp(-lam * ts)).max())
            for lam in (0.6, 1.0, 1.4)}

    taylor_mlp.reset_launches()
    t_data = torch.linspace(0, 1, 25, device='cuda')
    data = torch.exp(-1.23 * t_data)
    lam = torch.tensor(0.5, device='cuda', requires_grad=True)
    opt = torch.optim.Adam([lam], lr=5e-2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(INVERSE_STEPS):
        opt.zero_grad(set_to_none=True)
        mse = ((sol(t_data, torch.ones_like(t_data) * lam) - data) ** 2).mean()
        mse.backward()
        opt.step()
    lam_found, mse = lam.item(), mse.item()
    inverse_s = time.perf_counter() - t0

    hs = Hypersolver(func=lambda u, t: [-u], u0=1.0, t0=0.0, tn=1.0, n_steps=HYPER_STEPS,
                     sol=lambda grid: [sol(grid, torch.ones_like(grid))], numerical_solver=Euler())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs.fit(HYPER_EPOCHS)
    torch.cuda.synchronize()
    hyper_s = time.perf_counter() - t0
    grid = torch.as_tensor(ts, dtype=F32, device='cuda')
    (us,) = hs.get_solution()(grid)
    hyper_err = float(np.abs(us.cpu().numpy() - np.exp(-ts)).max())
    (plain,) = DiscreteSolution1D(*Euler().solve(lambda u, t: [-u], 1.0, 0.0, 1.0, HYPER_STEPS))(grid)
    plain_err = float(np.abs(plain.cpu().numpy() - np.exp(-ts)).max())
    target = sol(grid, torch.ones_like(grid))  # what the corrector is trained toward
    hyper_sol, plain_sol = (float((u - target).abs().max()) for u in (us, plain))
    torch.cuda.synchronize()
    plain_launches = sum(taylor_mlp.LAUNCHES.values())
    checks = launch_checks(launches, fallbacks, 5, BUNDLE_EPOCHS)
    checks.update({
        'loss fell': late < early,
        f'bundle error < {BUNDLE_LIMIT}': all(np.isfinite(e) and e < BUNDLE_LIMIT for e in errs.values()),
        f'|lam - 1.23| < {INVERSE_LIMIT}': abs(lam_found - 1.23) < INVERSE_LIMIT,
        f'hypersolver error < {HYPER_LIMIT}': bool(np.isfinite(hyper_err)) and hyper_err < HYPER_LIMIT,
        f'hypersolver within {HYPER_SOL_LIMIT} of its target': bool(np.isfinite(hyper_sol)) and hyper_sol < HYPER_SOL_LIMIT,
        f'hypersolver {HYPER_GAIN}x closer to its target than plain Euler': hyper_sol * HYPER_GAIN < plain_sol,
        'inverse and hypersolver launch no kernel': plain_launches == 0,
    })
    report('5h bundle',
           f"BundleSolver1D FCNN 2-32-32-1 on (t, lam), 32 x 32 meshes, fit({BUNDLE_EPOCHS}) float32 in "
           f"{fit_s:.1f} s ({BUNDLE_EPOCHS / fit_s:.1f} epochs/s with 4 validation batches): launches {launches} "
           f"({launches['taylor_mlp'] / BUNDLE_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} fallbacks, train loss "
           f"mean {early:.3e} (first 100) -> {late:.3e} (last 100), max |u - exp(-lam t)| on 40 points "
           + ', '.join(f"lam={k} {v:.3e}" for k, v in errs.items())
           + f"; inverse: {INVERSE_STEPS} Adam steps on lam through the solution in {inverse_s:.1f} s, lam "
           f"{lam_found:.5f} (true 1.23), mse {mse:.3e}; Hypersolver(Euler, {HYPER_STEPS} steps) fit({HYPER_EPOCHS}) "
           f"in {hyper_s:.1f} s, max |u - exp(-t)| {hyper_err:.3e} (plain Euler {plain_err:.3e}), max |u - "
           f"solution| {hyper_sol:.3e} (plain Euler {plain_sol:.3e}), "
           f"{plain_launches} launches in both", checks, "bundle check failed")
    return launches, solver, None, rates


def heat_solver(variant, **kwargs):
    """``examples/heat_equation.py``'s ``build(variant)`` on the port's defaults
    (cuda, float32): IBVP1D with u(x, 0) = sin(pi x / L) and zero values
    ('dirichlet') or u(x, 0) = cos(pi x / L) and zero slopes ('neumann') at
    both ends, through ``Solver2D`` with its default net."""
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import IBVP1D
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.solvers import Solver2D

    ends = ('x_min_val', 'x_max_val') if variant == 'dirichlet' else ('x_min_prime', 'x_max_prime')
    initial = F.sin if variant == 'dirichlet' else F.cos
    cond = IBVP1D(x_min=0.0, x_max=HEAT_L, t_min=0.0, t_min_val=lambda x: initial(np.pi / HEAT_L * x),
                  **{k: (lambda t: 0 * t) for k in ends})
    box = (HEAT_L, HEAT_T)
    return Solver2D(pde_system=lambda u, x, t: [diff(u, t) - HEAT_K * diff(u, x, 2)], conditions=[cond],
                    xy_min=(0, 0), xy_max=box,
                    train_generator=Generator2D((32, 32), (0, 0), box, method='equally-spaced-noisy'),
                    valid_generator=Generator2D((32, 32), (0, 0), box, method='equally-spaced'), **kwargs)


def heat_exact(variant, x, t):
    mode = np.sin if variant == 'dirichlet' else np.cos
    return mode(np.pi * x / HEAT_L) * np.exp(-HEAT_K * (np.pi / HEAT_L) ** 2 * t)


def heat_error(variant, solver):
    """max |u - exact| on 200 random points, as examples/heat_equation.py measures it."""
    rng = np.random.RandomState(0)
    xs, ts = rng.rand(200) * HEAT_L, rng.rand(200) * HEAT_T
    u = solver.get_solution()(xs, ts, to_numpy=True)
    return float(np.abs(u - heat_exact(variant, xs, ts)).max()) if np.isfinite(u).all() else float('inf')


def run_heat(F, taylor_mlp):
    """Phase 5i: the heat equation with Dirichlet ends, the kernel path (u keeps
    its Taylor rule), then under the h1 loss (order 3, layer by layer).
    Returns what :func:`run_cavity` returns, and the h1 fit's launch counts."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(1)
    solver = heat_solver('dirichlet')
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, HEAT_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    err = heat_error('dirichlet', solver)
    checks = launch_checks(launches, fallbacks, 5, HEAT_EPOCHS)
    checks.update({'loss fell': late < early, f'max error < {HEAT_LIMIT}': err < HEAT_LIMIT})
    report('5i heat', f"IBVP1D Dirichlet through Solver2D, FCNN 2-32-32-1, 32 x 32, fit({HEAT_EPOCHS}) float32 in "
                      f"{fit_s:.1f} s ({HEAT_EPOCHS / fit_s:.1f} epochs/s with 4 validation batches): launches "
                      f"{launches} ({launches['taylor_mlp'] / HEAT_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} "
                      f"fallbacks, train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), max |u - "
                      f"sin(pi x/L) exp(-K (pi/L)^2 t)| on 200 points {err:.3e}", checks, "heat check failed")

    set_seed(1)
    h1 = heat_solver('dirichlet', loss_fn='h1')
    h1_s, launches_h1, fallbacks, _ = fit_path(F, taylor_mlp, h1, HEAT_H1_EPOCHS)
    hist = h1.metrics_history['train_loss']
    early, late = float(np.mean(hist[:20])), float(np.mean(hist[-20:]))
    # every series of the h1 loss is taken at order 3, which no kernel serves (the
    # JAX package's kernel stops at order 2 too): the CPU rehearsal counted no call
    checks = {'no kernel launch (order 3)': sum(launches_h1.values()) == 0, 'no Taylor fallback': fallbacks == 0,
              'loss fell': bool(np.isfinite(hist).all()) and late < early}
    report('5i heat', f"h1 loss (order 3), fit({HEAT_H1_EPOCHS}) in {h1_s:.1f} s ({HEAT_H1_EPOCHS / h1_s:.2f} "
                      f"epochs/s): launches {launches_h1}, {fallbacks} fallbacks, train loss mean {early:.3e} "
                      f"(first 20) -> {late:.3e} (last 20)", checks, "heat h1 check failed")
    return launches, solver, None, rates, launches_h1


def run_heat_neumann(F, taylor_mlp):
    """Phase 5j: the heat equation with insulated ends, the compose path (the
    pinned anchors have no Taylor rule, as in the JAX package). Returns what
    :func:`run_cavity` returns."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(1)
    solver = heat_solver('neumann')
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, NEUMANN_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    err = heat_error('neumann', solver)
    per_residual = fallbacks / (NEUMANN_EPOCHS * 5)  # 1 train and 4 validation batches per epoch
    ts = np.linspace(0, HEAT_T, 64)
    slopes = []
    for end in (0.0, HEAT_L):
        cols = [torch.as_tensor(a, dtype=solver.dtype, device=solver.device).reshape(-1, 1)
                for a in (np.full_like(ts, end), ts)]
        with torch.no_grad():
            (u,), (x, _) = solver._forward(cols)
            slopes.append(diff(u, x).value.abs().max().item())
    checks = {'no kernel launch': sum(launches.values()) == 0,
              '2 fallbacks per residual, as in JAX': per_residual == 2,
              'loss fell': late < early,
              f'max error < {NEUMANN_LIMIT}': err < NEUMANN_LIMIT,
              'u_x = 0 at both ends to 1e-5': max(slopes) < 1e-5}
    report('5j heat Neumann', f"IBVP1D Neumann through Solver2D, FCNN 2-32-32-1, 32 x 32, fit({NEUMANN_EPOCHS}) "
                              f"float32 in {fit_s:.1f} s ({NEUMANN_EPOCHS / fit_s:.1f} epochs/s with 4 validation "
                              f"batches): launches {launches}, {fallbacks} fallbacks ({per_residual:.2f} per "
                              f"residual), train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), max "
                              f"|u - cos(pi x/L) exp(-K (pi/L)^2 t)| on 200 points {err:.3e}, max |u_x| at x = 0 "
                              f"and x = L {slopes[0]:.1e}, {slopes[1]:.1e}", checks, "heat Neumann check failed")
    return launches, solver, None, rates


def burgers_exact(x, t, n_quad=64):
    """The Cole-Hopf solution of viscous Burgers by Gauss-Hermite quadrature
    (a numpy copy of examples/burgers.py's evaluator)."""
    x, t = np.broadcast_arrays(np.asarray(x, dtype=np.float64), np.asarray(t, dtype=np.float64))
    eta, w = np.polynomial.hermite.hermgauss(n_quad)
    out = np.empty(x.shape)
    for i, (xi, ti) in enumerate(zip(x.ravel(), t.ravel())):
        if ti < 1e-12:
            out.ravel()[i] = -np.sin(np.pi * xi)
            continue
        y = xi - np.sqrt(4.0 * BURGERS_NU * ti) * eta
        expo = -np.cos(np.pi * y) / (2.0 * np.pi * BURGERS_NU)
        f = np.exp(expo - expo.max())
        out.ravel()[i] = -np.sum(w * f * np.sin(np.pi * y)) / np.sum(w * f)
    return out


@functools.lru_cache(maxsize=None)
def burgers_reference():
    """``(X, T, u)``: the 201 x 101 grid on which Burgers' errors are taken
    and the Cole-Hopf solution on it."""
    X, Tm = np.meshgrid(np.linspace(-1.0, 1.0, 201), np.linspace(0.0, 1.0, 101), indexing='ij')
    return X, Tm, burgers_exact(X, Tm)


def burgers_solution(solver):
    """``solver.get_solution()`` on :func:`burgers_reference`'s grid."""
    X, Tm, _ = burgers_reference()
    return solver.get_solution()(X.ravel(), Tm.ravel(), to_numpy=True).reshape(X.shape)


def burgers_problem():
    """``examples/burgers.py``'s equation and its conditions: ``(pde_system, conditions)``."""
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import IBVP1D

    cond = IBVP1D(x_min=-1.0, x_max=1.0, t_min=0.0, t_min_val=lambda x: -F.sin(np.pi * x),
                  x_min_val=lambda t: 0 * t, x_max_val=lambda t: 0 * t)
    return (lambda u, x, t: [diff(u, t) + u * diff(u, x) - BURGERS_NU * diff(u, x, order=2)]), [cond]


def burgers_solver():
    """``examples/burgers.py``'s ``build('adaptive')`` on the port's defaults (cuda, float32)."""
    from neurodiffeq_tpu_torch.generators import Generator1D, Generator2D, ResidualAdaptiveGenerator
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D

    pde_system, conditions = burgers_problem()
    base = (Generator1D(BURGERS_POINTS, -1.0, 1.0, method='uniform')
            * Generator1D(BURGERS_POINTS, 0.0, 1.0, method='uniform'))
    return Solver2D(
        pde_system=pde_system, conditions=conditions, xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0),
        nets=[FCNN(n_input_units=2, hidden_units=BURGERS_HIDDEN)],
        train_generator=ResidualAdaptiveGenerator(base, oversample=BURGERS_OVERSAMPLE, strategy='power',
                                                  alpha=1.0, c=1.0),
        valid_generator=Generator2D((32, 32), xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0), method='equally-spaced'))


def polish_draw(n_points=POLISH_POINTS, seed=1):
    """The frozen uniform draw of Burgers' L-BFGS polish (a numpy copy of
    ``examples/burgers.py``'s ``polish_lbfgs``, its default branch): ``n_points``
    of ``8 n_points`` uniform candidates on [-1, 1] x [0, 1], picked without
    replacement, numpy seed 1; ``(x, t)``."""
    rng = np.random.default_rng(seed)
    cand_x = rng.uniform(-1.0, 1.0, size=8 * n_points)
    cand_t = rng.uniform(0.0, 1.0, size=8 * n_points)
    p = np.ones_like(cand_x)
    idx = rng.choice(len(p), size=n_points, replace=False, p=p / p.sum())
    return cand_x[idx], cand_t[idx]


def burgers_constraint_error(solver):
    """max |u - u(x, 0)| on the initial line and max |u| on the walls."""
    sol = solver.get_solution(best=False)
    xs, ts = np.linspace(-1.0, 1.0, 17), np.linspace(0.0, 1.0, 9)
    errs = [np.abs(sol(xs, np.zeros_like(xs), to_numpy=True) + np.sin(np.pi * xs)).max()]
    errs += [np.abs(sol(np.full_like(ts, wall), ts, to_numpy=True)).max() for wall in (-1.0, 1.0)]
    return float(max(errs))


def run_burgers(F, taylor_mlp):
    """Phase 5k: Burgers with residual-adaptive sampling. Returns what
    :func:`run_cavity` returns."""
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(0)
    solver = burgers_solver()
    untrained = burgers_constraint_error(solver)
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, BURGERS_EPOCHS, windowed=True)
    hist = np.asarray(solver.metrics_history['train_loss'])
    first, late = float(hist[0]), float(np.mean(hist[-100:]))
    lowest = float(np.mean(hist[:len(hist) // 100 * 100].reshape(-1, 100), axis=1).min())
    trained = burgers_constraint_error(solver)
    err = np.abs(burgers_solution(solver) - burgers_reference()[2])
    max_err, mean_err = float(err.max()), float(err.mean())
    # per epoch: the scoring pass over 8 x 2,048 candidates, 1 train and 4 validation batches
    checks = launch_checks(launches, fallbacks, 6, BURGERS_EPOCHS)
    checks.update({
        'initial line and walls exact to 1e-6, untrained and trained': max(untrained, trained) < 1e-6,
        f'train loss fell {BURGERS_DROP}x': lowest * BURGERS_DROP <= first,
        f'mean error < {BURGERS_MEAN_LIMIT}': bool(np.isfinite(mean_err)) and mean_err < BURGERS_MEAN_LIMIT,
    })
    report('5k Burgers', f"IBVP1D through Solver2D, FCNN 2-(20x8)-1, ResidualAdaptiveGenerator(8 x 2048, power), "
                         f"fit({BURGERS_EPOCHS}) float32 in {fit_s:.1f} s ({BURGERS_EPOCHS / fit_s:.1f} epochs/s with "
                         f"4 validation batches): launches {launches} ({launches['taylor_mlp'] / BURGERS_EPOCHS:.2f} "
                         f"taylor_mlp per epoch), {fallbacks} fallbacks, train loss {first:.3e} (first epoch) -> "
                         f"lowest 100-epoch mean {lowest:.3e}, mean {late:.3e} (last 100), constraint error "
                         f"untrained {untrained:.1e} trained {trained:.1e}, against Cole-Hopf on 201 x 101: max "
                         f"{max_err:.4f} mean {mean_err:.5f}", checks,
           "Burgers check failed")
    return launches, solver, None, rates


def check_high_order():
    """Phase 3c: orders 3 and 4 on the card, pure and mixed, of an FCNN
    2-32-32-1 tanh field and a SIREN field against the port on the CPU in
    float64; pin at k = 0 and 1 the same way; and every IBVP1D and
    DoubleEndedBVP1D variant exact at its anchors with an untrained net.
    Returns nothing, or SystemExit."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DoubleEndedBVP1D, IBVP1D
    from neurodiffeq_tpu_torch.networks import FCNN, SIREN

    def partials(net, pts):
        x, y = F.coords_from_points(pts)
        u = F.network_field(net, (x, y))
        fields = {'u_xxx': F.diff(u, x, 3), 'u_yyyy': F.diff(u, y, 4), 'u_xxy': F.diff(F.diff(u, x, 2), y),
                  'u_xxyy': F.diff(F.diff(u, x, 2), y, 2), 'pin x=0.5': F.pin(u, 0, 0.5),
                  'pin_x x=0.5': F.pin(u, 0, 0.5, derivative_order=1),
                  'd/dy pin_x x=0.5': F.diff(F.pin(u, 0, 0.5, derivative_order=1), y)}
        return {k: f.value for k, f in fields.items()}

    pts = torch.rand(1024, 2, generator=torch.Generator().manual_seed(600), dtype=F64)
    for name, make in (('FCNN 2-32-32-1 tanh', lambda: FCNN(2, 1, hidden_units=(32, 32))),
                       ('SIREN 2-32-32-1 w0=30', lambda: SIREN(2, 1, hidden_units=(32, 32)))):
        torch.manual_seed(0)
        cpu = make().to('cpu', F64)
        with torch.no_grad():
            want = partials(cpu, pts)
        for dtype in (F64, F32):
            card = make().to('cuda', dtype)
            card.load_state_dict(cpu.state_dict())
            with torch.no_grad():
                got = partials(card, pts.to('cuda', dtype))
            errs = {k: rel_err(got[k].cpu(), want[k]) for k in want}
            ok = all(e <= TOL[dtype] for e in errs.values())
            phase('3c high order', f"{str(dtype)[6:]} {name} N=1024 against the port on the CPU in float64: rel err "
                                   + ', '.join(f"{k} {v:.2e}" for k, v in errs.items())
                                   + f" (limit {TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("chip_smoke: an order 3-4 partial or a pin disagrees on the card")

    # the anchors of every 1-D condition variant, untrained, float32 on the card
    g = torch.Generator().manual_seed(601)
    worst = {}
    for variant in ('dd', 'dn', 'nd', 'nn'):
        keys = ['x_min_val' if variant[0] == 'd' else 'x_min_prime', 'x_max_val' if variant[1] == 'd' else 'x_max_prime']
        ibvp = IBVP1D(x_min=0.0, x_max=2.0, t_min=0.0, t_min_val=lambda x: F.cos(x) + 0.5 * x,
                      **{k: ANCHOR_DATA[k] for k in keys})
        errs = []
        torch.manual_seed(1)
        net = FCNN(2, 1, hidden_units=(16, 16))
        for end, kind in ((0.0, variant[0]), (2.0, variant[1])):
            ts = torch.rand(64, 1, generator=g).to('cuda')
            x, t = F.coords_from_points(torch.cat([torch.full_like(ts, end), ts], dim=1))
            with torch.no_grad():
                u = ibvp.enforce(net, x, t)
                side = 'x_min' if end == 0.0 else 'x_max'
                got = u if kind == 'd' else F.diff(u, x)
                errs.append((got.value - ANCHOR_DATA[f"{side}_{'val' if kind == 'd' else 'prime'}"](t).value)
                            .abs().max().item())
        xs = torch.rand(64, 1, generator=g).to('cuda') * 2
        x, t = F.coords_from_points(torch.cat([xs, torch.zeros_like(xs)], dim=1))
        with torch.no_grad():
            errs.append((ibvp.enforce(net, x, t).value - (F.cos(x) + 0.5 * x).value).abs().max().item())
        worst[f'IBVP1D {variant}'] = max(errs)

        de = DoubleEndedBVP1D(x_min=0.0, x_max=1.0, **{k: DE_ANCHOR_DATA[k] for k in keys})
        torch.manual_seed(2)
        net = FCNN(1, 1, hidden_units=(16, 16))
        errs = []
        for end, kind in ((0.0, variant[0]), (1.0, variant[1])):
            (x,) = F.coords_from_points(torch.full((4, 1), end, device='cuda'))
            with torch.no_grad():
                u = de.enforce(net, x)
                got = (u if kind == 'd' else F.diff(u, x)).value
            side = 'x_min' if end == 0.0 else 'x_max'
            errs.append((got - DE_ANCHOR_DATA[f"{side}_{'val' if kind == 'd' else 'prime'}"]).abs().max().item())
        worst[f'DoubleEndedBVP1D {variant}'] = max(errs)
    ok = all(v < 1e-5 for v in worst.values())
    phase('3c high order', "float32 anchors with an untrained net (values, slopes, initial line), max error "
                           + ', '.join(f"{k} {v:.1e}" for k, v in worst.items()) + f" (limit 1e-5) "
                           f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: a 1-D condition is not exact at its anchors on the card")


# ------------------------------------------------------------------ the high-dimensional slice

def stacked_sum_sin(F, xs):
    """sum_i sin(pi x_i) as one field over the stacked coordinates (``F.cat``
    of all of them is the points themselves): a few tensor operations at any
    d, where a sum of d per-coordinate fields is 3 d operations and as many
    again per derivative level of the compose path."""
    return F.sin(np.pi * F.cat(xs)).sum(axis=1)


def highdim_solver(d, arm, seed=0, **kwargs):
    """``benchmarks/stde_ab.py``'s ``build_solver(d, arm, bc='exact')`` on the
    port's defaults (cuda, float32): -lap u = (pi^2 / d) sum_i sin(pi x_i) on
    [0, 1]^d through ``GenericSolver``, ``DirichletBoxND(d)`` ('auto' mask:
    product to d = 10, sat above) with the benchmark's perturbed extension
    g = u* + mask * cos(pi x_1) cos(pi x_2), FCNN d-64-64-1 sin,
    ``GeneratorHypercube(768, d)`` (512 + 256 points, all interior under the
    exact condition), no validation; ``arm`` 'exact' (``laplacian``) or
    'stde' (``stde_laplacian(n_est=16)``); ``seed`` for ``set_seed``;
    ``kwargs`` go to ``GenericSolver``."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBoxND
    from neurodiffeq_tpu_torch.generators import GeneratorHypercube
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv
    from neurodiffeq_tpu_torch.operators import laplacian, stde_laplacian
    from neurodiffeq_tpu_torch.solvers import GenericSolver
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(seed)
    mask = DirichletBoxND(d)

    def extension(*xs):
        return stacked_sum_sin(F, xs) / d + mask.mask_field(*xs) * F.cos(np.pi * xs[0]) * F.cos(np.pi * xs[1])

    def pde(u, *xs):
        lap = stde_laplacian(u, *xs, n_est=HD_N_EST) if arm == 'stde' else laplacian(u, *xs)
        return [lap + stacked_sum_sin(F, xs) * (np.pi ** 2 / d)]

    return GenericSolver(diff_eqs=pde, conditions=[DirichletBoxND(d, boundary_fn=extension)],
                         nets=[FCNN(n_input_units=d, n_output_units=1, hidden_units=HD_HIDDEN, actv=SinActv)],
                         train_generator=GeneratorHypercube(HD_POINTS, dim=d),
                         valid_generator=GeneratorHypercube(512, dim=d), n_batches_valid=0, **kwargs)


def plate_solver(d=PLATE_DIM):
    """``benchmarks/biharmonic_ab.py``'s ``build_solver(d, 'exact')`` on the
    port's defaults: the clamped plate lap^2 u = (pi^4 / d) sum_i sin(pi x_i)
    on [0, 1]^d, ``DirichletBoxND(d, power=2)`` with g = u* + mask^2 cos(pi
    x_1) cos(pi x_2), the exact ``biharmonic``, FCNN d-64-64-1 sin,
    ``GeneratorHypercube(512, d)``, no validation."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBoxND
    from neurodiffeq_tpu_torch.generators import GeneratorHypercube
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv
    from neurodiffeq_tpu_torch.operators import biharmonic
    from neurodiffeq_tpu_torch.solvers import GenericSolver
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(0)
    mask = DirichletBoxND(d)

    def extension(*xs):
        phi = mask.mask_field(*xs)
        return stacked_sum_sin(F, xs) / d + phi * phi * F.cos(np.pi * xs[0]) * F.cos(np.pi * xs[1])

    return GenericSolver(
        diff_eqs=lambda u, *xs: [biharmonic(u, *xs) - stacked_sum_sin(F, xs) * (np.pi ** 4 / d)],
        conditions=[DirichletBoxND(d, boundary_fn=extension, power=2)],
        nets=[FCNN(n_input_units=d, n_output_units=1, hidden_units=HD_HIDDEN, actv=SinActv)],
        train_generator=GeneratorHypercube(PLATE_POINTS, dim=d), valid_generator=GeneratorHypercube(PLATE_POINTS, dim=d),
        n_batches_valid=0)


def highdim_u_star(pts):
    """The analytic solution (1/d) sum_i sin(pi x_i) at an (n, d) array."""
    return np.sin(np.pi * pts).sum(axis=1, keepdims=True) / pts.shape[1]


def highdim_errors(solver, d):
    """(relative L2 error against u* on 4,096 points, max |u - u*| on 1,024
    points snapped onto random faces), drawn as the benchmarks draw them."""
    rng = np.random.default_rng(7)
    pts = rng.random((HD_EVAL, d))
    sol = solver.get_solution(best=False)
    pred = np.asarray(sol(*[pts[:, i] for i in range(d)], to_numpy=True)).reshape(-1, 1)
    rel = float(np.linalg.norm(pred - highdim_u_star(pts)) / np.linalg.norm(highdim_u_star(pts)))
    bpts = rng.random((1024, d))
    bpts[np.arange(1024), rng.integers(0, d, 1024)] = rng.integers(0, 2, 1024).astype(float)
    bpred = np.asarray(sol(*[bpts[:, i] for i in range(d)], to_numpy=True)).reshape(-1, 1)
    return rel, float(np.abs(bpred - highdim_u_star(bpts)).max()) if np.isfinite(bpred).all() else float('inf')


def run_poisson10(F, taylor_mlp):
    """Phase 5l: ``benchmarks/stde_ab.py``'s exact arm at d = 10, the kernel
    path. Returns what :func:`run_cavity` returns."""
    solver = highdim_solver(10, 'exact')
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, POISSON10_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    rel, bdef = highdim_errors(solver, 10)
    checks = launch_checks(launches, fallbacks, POISSON10_LAUNCHES, POISSON10_EPOCHS)
    checks.update({'loss fell': late < early,
                   f'rel L2 error < {POISSON10_LIMIT}': np.isfinite(rel) and rel < POISSON10_LIMIT,
                   'boundary defect < 1e-5': bdef < 1e-5})
    report('5l Poisson d=10', f"GenericSolver, exact laplacian, DirichletBoxND product mask, FCNN 10-64-64-1 sin, "
                              f"GeneratorHypercube({HD_POINTS}, 10), fit({POISSON10_EPOCHS}) float32 in {fit_s:.1f} s "
                              f"({POISSON10_EPOCHS / fit_s:.1f} epochs/s, no validation): launches {launches} "
                              f"({launches['taylor_mlp'] / POISSON10_EPOCHS:.2f} taylor_mlp per epoch), {fallbacks} "
                              f"fallbacks, train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), rel L2 "
                              f"error against u* on {HD_EVAL} points {rel:.4e}, boundary defect on 1024 face points "
                              f"{bdef:.1e}", checks, "d = 10 Poisson check failed")
    return launches, solver, None, rates


def run_poisson100(F, taylor_mlp):
    """Phase 5m: the same problem at d = 100 through ``stde_laplacian``, the
    compose path (``examples/poisson_highdim.py``). Returns what
    :func:`run_cavity` returns."""
    solver = highdim_solver(100, 'stde')
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, POISSON100_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    rel, bdef = highdim_errors(solver, 100)
    checks = {'no kernel launch': sum(launches.values()) == 0,
              '1 fallback per residual, as in JAX': fallbacks == POISSON100_EPOCHS,
              'loss fell': late < early,
              f'rel L2 error < {POISSON100_LIMIT}': np.isfinite(rel) and rel < POISSON100_LIMIT,
              'boundary defect < 1e-5': bdef < 1e-5}
    report('5m Poisson d=100', f"GenericSolver, stde_laplacian(n_est={HD_N_EST}), DirichletBoxND sat mask, FCNN "
                               f"100-64-64-1 sin, GeneratorHypercube({HD_POINTS}, 100), fit({POISSON100_EPOCHS}) "
                               f"float32 in {fit_s:.1f} s ({POISSON100_EPOCHS / fit_s:.1f} epochs/s, no validation): "
                               f"launches {launches}, {fallbacks} fallbacks ({fallbacks / POISSON100_EPOCHS:.2f} per "
                               f"residual), train loss mean {early:.3e} (first 100) -> {late:.3e} (last 100), rel L2 "
                               f"error against u* on {HD_EVAL} points {rel:.4e}, boundary defect on 1024 face points "
                               f"{bdef:.1e}", checks, "d = 100 Poisson check failed")
    return launches, solver, None, rates


def run_plate(F, taylor_mlp):
    """Phase 5n: ``benchmarks/biharmonic_ab.py``'s exact arm at d = 4, the
    clamped plate. Returns what :func:`run_cavity` returns."""
    from neurodiffeq_tpu_torch import diff

    d = PLATE_DIM
    solver = plate_solver(d)
    fit_s, launches, fallbacks, rates = fit_path(F, taylor_mlp, solver, PLATE_EPOCHS, windowed=True)
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:50])), float(np.mean(hist[-50:]))
    rel, bdef = highdim_errors(solver, d)
    # the clamped faces: u = u* and du/dn = du*/dn, through the trained net
    rng = np.random.default_rng(8)
    pts = rng.random((256, d))
    axis = rng.integers(0, d, 256)
    pts[np.arange(256), axis] = rng.integers(0, 2, 256).astype(float)
    cols = [torch.as_tensor(pts[:, i:i + 1], dtype=solver.dtype, device=solver.device) for i in range(d)]
    with torch.no_grad():
        (u,), xs = solver._forward(cols)
        slopes = torch.stack([diff(u, x).value[:, 0] for x in xs], dim=1).cpu().double().numpy()
    want = np.pi * np.cos(np.pi * pts) / d
    slope_err = float(np.abs(slopes[np.arange(256), axis] - want[np.arange(256), axis]).max())
    checks = {'no kernel launch': sum(launches.values()) == 0,
              '1 fallback per residual, as in JAX': fallbacks == PLATE_EPOCHS,
              'loss fell': late < early,
              'clamped faces: u = u* to 1e-5': bdef < 1e-5,
              'clamped faces: du/dn = du*/dn to 1e-5': slope_err < 1e-5}
    report('5n clamped plate', f"GenericSolver, exact biharmonic, DirichletBoxND(power=2) product mask, FCNN "
                               f"{d}-64-64-1 sin, GeneratorHypercube({PLATE_POINTS}, {d}), fit({PLATE_EPOCHS}) float32 in "
                               f"{fit_s:.1f} s ({PLATE_EPOCHS / fit_s:.1f} epochs/s, no validation): launches "
                               f"{launches}, {fallbacks} fallbacks ({fallbacks / PLATE_EPOCHS:.2f} per residual), train "
                               f"loss mean {early:.3e} (first 50) -> {late:.3e} (last 50), rel L2 error against u* on "
                               f"{HD_EVAL} points {rel:.4e}, on 1024 face points max |u - u*| {bdef:.1e}, on 256 max "
                               f"|du/dn - du*/dn| {slope_err:.1e}", checks, "clamped plate check failed")
    return launches, solver, None, rates


def highdim_field(d, dtype, device, seed, mask='auto', power=1, box=(0.0, 1.0)):
    """(condition, net) of an FCNN d-64-64-1 sin under ``DirichletBoxND`` with
    the extension g = (1/d) sum_i sin(pi x_i) + x_1 x_2, the net's
    parameters from ``seed``."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBoxND
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv

    torch.manual_seed(seed)
    net = FCNN(d, 1, hidden_units=HD_HIDDEN, actv=SinActv, device='cpu', dtype=F64).to(device, dtype)
    cond = DirichletBoxND(d, boundary_fn=lambda *xs: stacked_sum_sin(F, xs) / d + xs[0] * xs[1],
                          r_min=box[0], r_max=box[1], mask=mask, power=power)
    return cond, net


def check_highdim(F, taylor_mlp):
    """Phase 3d: the high-dimensional operators on the card against the port
    on the CPU in float64 (the same probes), the estimators exact where they
    must be, the d = 100 exact laplacian in one launch, and DirichletBoxND
    exact on its faces. Returns nothing, or SystemExit."""
    from neurodiffeq_tpu_torch import operators as O

    ops = {'biharmonic': lambda u, xs: O.biharmonic(u, *xs),
           'stde_laplacian': lambda u, xs: O.stde_laplacian(u, *xs, n_est=HD_N_EST),
           'stde_biharmonic': lambda u, xs: O.stde_biharmonic(u, *xs, n_est=HD_N_EST)}
    for name, d in (('biharmonic', 4), ('biharmonic', 10), ('stde_laplacian', 10), ('stde_laplacian', 100),
                    ('stde_biharmonic', 10), ('stde_biharmonic', 100)):
        # float32 points, so that every copy casts to the same float32 bits: the probes' key
        pts = torch.rand(HD_CHECK_POINTS, d, generator=torch.Generator().manual_seed(700 + d)).to(F64)
        values, probes = {}, {}
        for dev, dtype in (('cpu', F64), ('cuda', F64), ('cuda', F32)):
            cond, net = highdim_field(d, dtype, dev, seed=d)
            p = pts.to(dev, dtype)
            xs = F.coords_from_points(p)
            F.reset_taylor_fallback_count()
            with torch.no_grad():
                values[(dev, dtype)] = ops[name](cond.enforce(net, *xs), xs).value.cpu()
            if F.taylor_fallback_count() != 1:
                raise SystemExit(f"chip_smoke: {name} took {F.taylor_fallback_count()} fallbacks, not 1")
            if name.startswith('stde'):
                shape = (len(p), HD_N_EST, len(xs)) if name == 'stde_laplacian' else (len(p), HD_N_EST, 2, len(xs))
                probes[(dev, dtype)] = O._stde_probes(p, range(d), HD_N_EST, 0, 2 if name == 'stde_laplacian' else 4,
                                                      shape).cpu()
        want = values[('cpu', F64)]
        errs = {str(dtype)[6:]: rel_err(values[('cuda', dtype)], want) for dtype in (F64, F32)}
        same = all(torch.equal(v.double(), probes[('cpu', F64)]) for v in probes.values())
        ok = same and all(errs[str(dt)[6:]] <= TOL[dt] for dt in (F64, F32))
        phase('3d high-dimensional', f"{name} d={d} of FCNN {d}-64-64-1 sin under DirichletBoxND, N={HD_CHECK_POINTS}: "
                                     f"card against the port on the CPU in float64, rel err "
                                     + ', '.join(f"{k} {v:.2e}" for k, v in errs.items())
                                     + (f"; probes equal on the card and the CPU: {same}" if probes else '')
                                     + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: a high-dimensional operator disagrees on the card")

    # exactness: stde_laplacian of sum x_i^2 is 2d, stde_biharmonic of sum c_i x_i^4 is 24 sum c_i
    d = 100
    xs = F.coords_from_points(torch.rand(HD_POINTS, d, generator=torch.Generator().manual_seed(710)).to('cuda'))
    quad = F.cat(xs)
    coef = torch.linspace(0.5, 1.5, d, device='cuda')
    with torch.no_grad():
        lap = O.stde_laplacian((quad * quad).sum(axis=1), *xs, n_est=HD_N_EST).value
        bih = O.stde_biharmonic((coef * quad ** 4).sum(axis=1), *xs, n_est=HD_N_EST).value
    lap_err = ((lap - 2 * d).abs().max() / (2 * d)).item()
    bih_err = ((bih - 24 * coef.sum()).abs().max() / (24 * coef.sum())).item()
    ok = lap_err <= TOL[F32] and bih_err <= TOL[F32]
    phase('3d high-dimensional', f"float32 d=100 N={HD_POINTS}: stde_laplacian(sum x_i^2) against 2d rel err "
                                 f"{lap_err:.2e}, stde_biharmonic(sum c_i x_i^4) against 24 sum c_i rel err "
                                 f"{bih_err:.2e} (limit {TOL[F32]:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: an estimator is not exact where it must be")

    check_highdim_laplacian(F, taylor_mlp)
    check_box_faces(F)


def check_highdim_laplacian(F, taylor_mlp):
    """Phase 3d: the exact laplacian of an FCNN 100-64-64-1 sin under
    DirichletBoxND (sat mask) through ``GenericSolver._forward`` on 768
    points: one ``taylor_mlp`` launch (13 direction chunks), no fallback,
    equal to double-backward ``torch.autograd`` (the compose path) of the
    same field, float64 and float32."""
    from neurodiffeq_tpu_torch import operators as O
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator
    from neurodiffeq_tpu_torch.solvers import GenericSolver

    d = 100
    pts = torch.rand(HD_POINTS, d, generator=torch.Generator().manual_seed(720), dtype=F64)
    for dtype in (F64, F32):
        cond, net = highdim_field(d, dtype, 'cuda', seed=720)
        p = pts.to('cuda', dtype)
        gen = PredefinedGenerator(*p.t(), device='cuda', dtype=dtype)
        solver = GenericSolver(diff_eqs=lambda u, *xs: [O.laplacian(u, *xs)], conditions=[cond], nets=[net],
                               train_generator=gen, valid_generator=gen, device='cuda', dtype=dtype)
        cols = [p[:, i:i + 1] for i in range(d)]
        F.reset_taylor_fallback_count()
        taylor_mlp.reset_launches()
        with torch.no_grad():
            (u,), xs = solver._forward(cols)
            got = O.laplacian(u, *xs).value
        torch.cuda.synchronize()
        launched, fallbacks = dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count()
        with F.eval_mode('compose'), torch.no_grad():
            (u,), xs = solver._forward(cols)
            want = O.laplacian(u, *xs).value
        err = rel_err(got, want)
        ok = (launched == {'taylor_mlp_1h': 0, 'taylor_mlp': 1, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}
              and fallbacks == 0
              and err <= TOL[dtype])
        phase('3d high-dimensional', f"{str(dtype)[6:]} exact laplacian of FCNN 100-64-64-1 sin under DirichletBoxND "
                                     f"(sat) through GenericSolver._forward, N={HD_POINTS}: launches {launched}, "
                                     f"{fallbacks} fallbacks, against double backward rel err {err:.2e} (limit "
                                     f"{TOL[dtype]:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: the d = 100 laplacian did not run in one launch or disagrees")


def check_box_faces(F):
    """Phase 3d: DirichletBoxND at d = 10 with an untrained FCNN 10-64-64-1
    sin, float32 on the card, on 256 points snapped onto random faces of a
    box of side 1.3 (across a side of at most 1, the 'adf' mask's slope
    overflows float32 and float64 on its faces, in the JAX package too):
    u = g for every mask and power, and du/dn = dg/dn with ``power=2``."""
    d = 10
    lo, hi = -0.6, 0.7
    rng = np.random.default_rng(730)
    pts = lo + rng.random((256, d)) * (hi - lo)
    axis = rng.integers(0, d, 256)
    pts[np.arange(256), axis] = np.where(rng.random(256) < 0.5, lo, hi)
    worst = {}
    for mask in ('product', 'sat', 'adf'):
        for power in (1, 2):
            cond, net = highdim_field(d, F32, 'cuda', seed=731, mask=mask, power=power, box=(lo, hi))
            xs = F.coords_from_points(torch.as_tensor(pts, dtype=F32, device='cuda'))
            with torch.no_grad():
                u, g = cond.enforce(net, *xs), cond.boundary_fn(*xs)
                err = (u.value - g.value).abs().max().item()
                if power == 2:
                    on = torch.as_tensor(axis, device='cuda')[:, None] == torch.arange(d, device='cuda')
                    du = torch.cat([F.diff(u, x).value for x in xs], dim=1)
                    dg = torch.cat([F.diff(g, x).value for x in xs], dim=1)
                    err = max(err, (du - dg)[on].abs().max().item())
            worst[f'{mask} power={power}'] = err
    ok = all(v < 1e-5 for v in worst.values())
    phase('3d high-dimensional', "float32 DirichletBoxND d=10 on 256 face points with an untrained net, max |u - g| "
                                 "(and |du/dn - dg/dn| at power 2) " + ', '.join(f"{k} {v:.1e}" for k, v in worst.items())
                                 + f" (limit 1e-5) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("chip_smoke: DirichletBoxND is not exact on its faces on the card")


def naive_highdim_solver():
    """Phase 6's baseline for the d = 100 epoch: 5m's problem written as the
    JAX package's structure transcribed to eager torch, the design before
    this slice's batching: the mask and the extension's and the source's
    sums as per-coordinate operations, and one Hessian-vector product per
    probe (the same probes). Measured for its device kernels per epoch."""
    from neurodiffeq_tpu_torch import fields as F, operators as O
    from neurodiffeq_tpu_torch.conditions import DirichletBoxND
    from neurodiffeq_tpu_torch.generators import GeneratorHypercube
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv
    from neurodiffeq_tpu_torch.solvers import GenericSolver
    from neurodiffeq_tpu_torch.utils import set_seed

    class PerCoordinateBox(DirichletBoxND):
        def mask_field(self, *xs):
            return self._mask_expression(*xs)

    def stde_per_probe(u, xs):
        pts = u.coords.points
        probes = O._stde_probes(pts, [x.index for x in xs], HD_N_EST, 0, 2, (len(pts), HD_N_EST, len(xs)))

        def fn(p):
            keep = torch.is_grad_enabled()
            with torch.enable_grad():
                z = p if p.requires_grad else p.detach().requires_grad_()
                (g,) = torch.autograd.grad(F._call(u, z).sum(), z, create_graph=True)
                total = 0
                for j in range(HD_N_EST):
                    (h,) = torch.autograd.grad((g * probes[:, j]).sum(), z, create_graph=keep, retain_graph=True)
                    total = total + (h * probes[:, j]).sum(dim=1, keepdim=True)
            return total / HD_N_EST if keep else (total / HD_N_EST).detach()

        return F.Field(u.coords, 1, fn)

    d = 100
    set_seed(0)
    mask = PerCoordinateBox(d)

    def extension(*xs):
        return sum(F.sin(np.pi * x) for x in xs) / d + mask.mask_field(*xs) * F.cos(np.pi * xs[0]) * F.cos(np.pi * xs[1])

    return GenericSolver(
        diff_eqs=lambda u, *xs: [stde_per_probe(u, xs) + sum(F.sin(np.pi * x) for x in xs) * (np.pi ** 2 / d)],
        conditions=[PerCoordinateBox(d, boundary_fn=extension)],
        nets=[FCNN(n_input_units=d, n_output_units=1, hidden_units=HD_HIDDEN, actv=SinActv)],
        train_generator=GeneratorHypercube(HD_POINTS, dim=d), valid_generator=GeneratorHypercube(512, dim=d),
        n_batches_valid=0)


def fourier_solver(device, dtype=F32, train_generator=None):
    """``examples/poisson_high_frequency.py``'s problem at k = 4: lap u =
    -2 W^2 sin(W x) sin(W y) on the unit square, u = 0 on its edges, W = 2
    pi k, on FourierFCNN(2, 1, n_features=64, sigma=4, hidden_units=(64,
    64)) on ``device``; the 64 x 64 'equally-spaced-noisy' grid unless
    ``train_generator`` is given."""
    from neurodiffeq_tpu_torch import fields as F, diff
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.networks import FourierFCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D

    w = 2 * np.pi * FOURIER_K
    cond = DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                          y_min=0.0, y_min_val=lambda x: 0 * x, y_max=1.0, y_max_val=lambda x: 0 * x)

    def grid(method):
        return Generator2D(FOURIER_GRID, (0, 0), (1, 1), method=method, device=device, dtype=dtype)

    net = FourierFCNN(2, 1, n_features=FOURIER_FEATURES, sigma=FOURIER_K, hidden_units=FOURIER_HIDDEN, device=device,
                      dtype=dtype)
    return Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)
                                                + 2 * w ** 2 * F.sin(w * x) * F.sin(w * y)],
                    conditions=[cond], xy_min=(0.0, 0.0), xy_max=(1.0, 1.0), nets=[net],
                    train_generator=train_generator or grid('equally-spaced-noisy'),
                    valid_generator=grid('equally-spaced'), device=device, dtype=dtype)


def fourier_first_loss(batch, init, dtype):
    """The first epoch's train loss of :func:`fourier_solver` on the CPU in
    ``dtype`` on the points ``batch`` from the net state ``init``."""
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator

    solver = fourier_solver('cpu', dtype, PredefinedGenerator(*batch, device='cpu', dtype=dtype))
    solver.nets[0].load_state_dict({k: v.to(dtype) for k, v in init.items()})
    solver.fit(1, tqdm_file=None)
    return solver.metrics_history['train_loss'][0]


def check_ops(F, taylor_mlp, card):
    """Phase 3e, the ``ops`` package's surface on the card: (a)
    ``fcnn_taylor_pallas`` with the flagship's weights as the JAX package's
    dicts equals ``fcnn_taylor`` bitwise in exactly one ``taylor_mlp_1h``
    launch; (b) under ``enable_pallas(interpret=True)`` ``fcnn_taylor`` (the
    flagship's and the cavity's widths), ``fcnn_taylor_streams`` (one model
    rank's slice of the cavity's pair 1) and ``fcnn_taylor_pallas`` raise and
    launch nothing, as ``fcnn_taylor_pallas(..., interpret=True)`` does
    under the default switch: on the card the kernels launch or the call
    raises; (c) under ``disable_pallas()`` the flagship's ``fit(1)`` raises
    for the same reason and launches nothing; (d) ``enable_pallas()``
    restores the default, and the same solver's ``fit(1)`` launches
    ``taylor_mlp_1h``. Then FourierFCNN, the port's own user of
    ``elementwise_series`` and ``concat_series``:
    ``examples/poisson_high_frequency.py`` for ``FOURIER_EPOCHS``, no launch
    (its FCNN sees features, not raw coordinates), its first epoch against
    the CPU's float32 run on the same points from the same weights, and a
    falling loss."""
    from neurodiffeq_tpu_torch import ops
    from neurodiffeq_tpu_torch.utils import set_seed

    none = {'taylor_mlp_1h': 0, 'taylor_mlp': 0, 'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0}

    def refused(run, match):
        """Whether ``run()`` raised the switch's error, whose message holds
        ``match``, and launched nothing; any other error propagates."""
        taylor_mlp.reset_launches()
        try:
            run()
        except RuntimeError as e:
            if match not in str(e):
                raise
        else:
            return False
        torch.cuda.synchronize()
        return taylor_mlp.LAUNCHES == none

    checks = {}
    set_seed(0)
    solver = flagship_solver()
    layers = [(W.detach(), b.detach()) for W, b in solver.nets[0].layers()]
    params = [{'W': W, 'b': b} for W, b in layers]
    pts = torch.rand(OPS_N, 2, generator=torch.Generator().manual_seed(3), dtype=F64).to('cuda', F32)
    with torch.no_grad():  # (a)
        want = taylor_mlp.fcnn_taylor(pts, layers, 2)
        taylor_mlp.reset_launches()
        got = ops.fcnn_taylor_pallas(pts, params, 2, 2)
        torch.cuda.synchronize()
        checks['(a) fcnn_taylor_pallas bitwise fcnn_taylor'] = all(
            torch.equal(a, b) for a, b in zip(got, want, strict=True))
        checks['(a) in one taylor_mlp_1h launch'] = taylor_mlp.LAUNCHES == {**none, 'taylor_mlp_1h': 1}
        checks['(b) fcnn_taylor_pallas(interpret=True) raises, no launch'] = refused(
            lambda: ops.fcnn_taylor_pallas(pts, params, 2, 2, interpret=True), 'interpret=True')
        ops.enable_pallas(interpret=True)
        for dims in ((2,) + HIDDEN + (1,), (2,) + CAV_HIDDEN + (3,), 'streams'):
            if dims == 'streams':
                streams, ls = stream_inputs((128, 64, 128), 2, 2, OPS_N, F32, seed=13)
                name = stream_name((128, 64, 128), 2, 'tanh', 'tanh', 2, OPS_N)
                run = lambda: taylor_mlp.fcnn_taylor_streams(streams, ls, 2, 'tanh', 'tanh')  # noqa: E731
            else:
                p, ls = inputs(dims, OPS_N, F32, seed=13)
                name = shape_name(dims, 'tanh', 2, OPS_N)
                run = lambda: taylor_mlp.fcnn_taylor(p, ls, 2)  # noqa: E731
            checks[f'(b) interpreted {name} raises, no launch'] = refused(run, 'interpret=True')
        checks['(b) interpreted fcnn_taylor_pallas raises, no launch'] = refused(
            lambda: ops.fcnn_taylor_pallas(pts, params, 2, 2), 'interpret=True')
    ops.disable_pallas()  # (c)
    checks['(c) disabled flagship fit(1) raises, no launch'] = refused(lambda: solver.fit(1, tqdm_file=None),
                                                                       'disable_pallas()')
    checks['(c) disabled'] = not ops.pallas_enabled()
    ops.enable_pallas()  # (d)
    checks['(d) enable_pallas() restores the default'] = ops.pallas_config() == {'enabled': True, 'interpret': False}
    _, _, launched, fallbacks = count_path(F, taylor_mlp, lambda: solver.fit(1, tqdm_file=None))
    loss = solver.metrics_history['train_loss'][-1]
    checks['(d) then fit(1) launches taylor_mlp_1h, a finite loss'] = (
        launched['taylor_mlp_1h'] > 0 and fallbacks == 0 and bool(np.isfinite(loss)))
    phase('3e ops', f"fcnn_taylor_pallas {shape_name((2,) + HIDDEN + (1,), 'tanh', 2, OPS_N, F32)} with the "
                    f"flagship's weights as dicts; the entries under enable_pallas(interpret=True) and the flagship "
                    f"under disable_pallas() refused on the card; back on, fit(1) launches {launched}, loss "
                    f"{loss:.6e}; " + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the ops surface or the kernel switch failed a check")

    set_seed(0)
    solver = fourier_solver('cuda')
    init = {k: v.detach().cpu().clone() for k, v in solver.nets[0].state_dict().items()}
    _, _, launched, fallbacks = count_path(F, taylor_mlp, lambda: solver.fit(1, tqdm_file=None))
    batch = [c.detach().cpu().reshape(-1) for c in solver._batch['train']]  # the first epoch's points
    _, fit_s, more, more_fallbacks = count_path(F, taylor_mlp, lambda: solver.fit(FOURIER_EPOCHS - 1, tqdm_file=None))
    launched, fallbacks = {k: v + more[k] for k, v in launched.items()}, fallbacks + more_fallbacks
    hist = solver.metrics_history['train_loss']
    cpu32, cpu64 = fourier_first_loss(batch, init, F32), fourier_first_loss(batch, init, F64)
    card_err, cpu_err = abs(hist[0] - cpu32) / abs(cpu32), abs(cpu32 - cpu64) / abs(cpu64)
    early, late = float(np.mean(hist[:5])), float(np.mean(hist[-5:]))
    checks = {'no launch, no fallback': launched == none and fallbacks == 0,
              f'first epoch within {SHARD_GRAD_TOL:.0e} of the CPU float32 run': card_err <= SHARD_GRAD_TOL,
              'loss fell': late < early}
    phase('3e ops', f"{card}: FourierFCNN 2-(64 features)-64-64-1 on 64 x 64 points (poisson_high_frequency, k = 4), "
                    f"float32, fit({FOURIER_EPOCHS}): {(FOURIER_EPOCHS - 1) / fit_s:.2f} epochs/s over the last "
                    f"{FOURIER_EPOCHS - 1}, launches {launched}, {fallbacks} fallbacks, first epoch {hist[0]:.6e} "
                    f"against the CPU's float32 {cpu32:.6e} (rel {card_err:.2e}; the CPU's float32 against its float64 "
                    f"{cpu_err:.2e}), mean train loss {early:.4e} (first 5) -> {late:.4e} (last 5); "
                    + ', '.join(f"{k}: {'ok' if v else 'FAIL'}" for k, v in checks.items()))
    if not all(checks.values()):
        raise SystemExit("chip_smoke: FourierFCNN on the card failed a check")


def check_mixed():
    """Phase 3b: u_xy of the cavity net by polarization against double
    backward, and three vector identities on random net fields, float64 and
    float32. Returns nothing, or SystemExit."""
    from neurodiffeq_tpu_torch import fields as F, operators as O
    from neurodiffeq_tpu_torch.networks import FCNN

    F.reset_taylor_fallback_count()
    for dtype in (F64, F32):
        torch.manual_seed(0)
        net = FCNN(2, 3, hidden_units=CAV_HIDDEN, dtype=dtype)
        pts = torch.rand(1024, 2, generator=torch.Generator().manual_seed(300), dtype=F64).to('cuda', dtype)
        x, y = F.coords_from_points(pts)
        with torch.no_grad():
            got = F.diff(F.diff(F.network_field(net, (x, y)).sum(axis=1), x), y).value[:, 0]
        leaf = pts.clone().requires_grad_()
        (g,) = torch.autograd.grad(net(leaf).sum(), leaf, create_graph=True)
        (hx,) = torch.autograd.grad(g[:, 0].sum(), leaf)
        err = rel_err(got, hx[:, 1])
        ok = err <= TOL[dtype] and F.taylor_fallback_count() == 0
        phase('3b mixed', f"{str(dtype)[6:]} u_xy of FCNN 2-(128x5)-3 (columns summed) N=1024 by polarization "
                          f"against double backward: rel err {err:.2e} (limit {TOL[dtype]:.0e}) "
                          f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: a mixed partial disagrees with double backward")

        g = torch.Generator().manual_seed(301)
        cart = torch.rand(1000, 3, generator=g, dtype=F64) * 2 - 1
        sph = torch.stack([torch.rand(1000, generator=g, dtype=F64) + 0.5,
                           torch.rand(1000, generator=g, dtype=F64) * math.pi * 0.9 + 0.05,
                           torch.rand(1000, generator=g, dtype=F64) * 2 * math.pi], dim=1)
        worst = {}
        with torch.no_grad():
            for name, pts3 in (('cartesian div grad = laplacian', cart), ('cartesian curl grad = 0', cart),
                               ('spherical div grad = laplacian', sph)):
                torch.manual_seed(1)
                c = F.coords_from_points(pts3.to('cuda', dtype))
                s = F.network_field(FCNN(3, 1, hidden_units=(16, 16), dtype=dtype), c)
                if name.startswith('cartesian div'):
                    out = [O.div(*O.grad(s, *c), *c) - O.laplacian(s, *c)]
                elif name.startswith('cartesian curl'):
                    out = O.curl(*O.grad(s, *c), *c)
                else:
                    out = [O.spherical_div(*O.spherical_grad(s, *c), *c) - O.spherical_laplacian(s, *c)]
                worst[name] = max(f.value.abs().max().item() for f in out)
        ok = all(v < IDENTITY_EPS for v in worst.values()) and F.taylor_fallback_count() == 0
        phase('3b mixed', f"{str(dtype)[6:]} identities on FCNN 3-16-16-1 fields at 1000 points, max |lhs - rhs| "
                          + ', '.join(f"{k} {v:.2e}" for k, v in worst.items())
                          + f" (limit {IDENTITY_EPS:.0e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: a vector identity does not hold on the card")


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


def time_epochs(card, label, solver, callbacks=(), rates=None, own=(10, OWN_WINDOW, 2), profiled=PROFILED):
    """Phase 6: the epoch as ``fit`` runs it (train and validation):
    epochs/s over windows of ``own = (warm-up epochs, window, windows)`` (or
    the ``rates`` of the ``WINDOW``-epoch windows that a path's own windowed
    fit measured), and device time per epoch and kernels per epoch from the
    profiler over ``profiled`` epochs, as a share of the epoch."""
    from torch.profiler import ProfilerActivity, profile

    window = WINDOW
    if rates is None:
        solver.fit(own[0], callbacks=callbacks, tqdm_file=None)
        rates, window = [], own[1]
        for _ in range(own[2]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.fit(window, callbacks=callbacks, tqdm_file=None)
            torch.cuda.synchronize()
            rates.append(window / (time.perf_counter() - t0))
    n = profiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solver.fit(n, callbacks=callbacks, tqdm_file=None)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == 'CUDA']
    dev_ms = sum(e.device_time for e in kernels) / n / 1e3
    # by kernel name: the Taylor-MLP kernels, cuBLAS/CUTLASS matrix products
    # (only the twin's rematerialized backward multiplies matrices), the rest
    split = {'taylor_mlp': 0.0, 'matmul': 0.0, 'other': 0.0}
    for e in kernels:
        name = e.name.lower()
        kind = ('taylor_mlp' if 'taylor_mlp' in name else
                'matmul' if any(k in name for k in ('gemm', 'xmma', 'cutlass')) else 'other')
        split[kind] += e.device_time / n / 1e3
    med = float(np.median(rates))
    phase('6 timing', f"{card}: {label} epochs/s in {window}-epoch windows: {' '.join(f'{r:.2f}' for r in rates)} "
                      f"(median {med:.2f}, {1e3 / med:.3f} ms per epoch); profiler over {n} epochs: "
                      f"{len(kernels) / n:.1f} device kernels and {dev_ms:.4f} ms of device time per epoch ("
                      + ', '.join(f"{k} {v:.4f} ms" for k, v in split.items())
                      + f"), device busy {dev_ms * med / 1e3:.1%} of the unprofiled epoch")


def time_backward(card, dims, n):
    """Phase 6: device time of one backward of the kernel's autograd function
    (autograd over the twin, rematerialized) at ``dims`` and N = ``n``, float32."""
    from neurodiffeq_tpu_torch.ops.taylor_mlp import _TaylorMLPFn

    pts, layers = inputs(dims, n, F32, seed=400)
    leaves = [t.clone().requires_grad_() for W, b in layers for t in (W, b)]
    outs = _TaylorMLPFn.apply(pts, 2, 'tanh', *leaves)
    g = torch.Generator().manual_seed(401)
    cts = [torch.randn(o.shape, generator=g).to('cuda') for o in outs]
    us, count = device_us(lambda: torch.autograd.grad(outs, leaves, cts, retain_graph=True), calls=20)
    phase('6 timing', f"{card}: {shape_name(dims, 'tanh', 2, n, F32)}: backward of the kernel's autograd "
                      f"function (the twin re-run and differentiated) {us:.2f} us of device time in {count:.0f} "
                      f"kernels per call")
    return us


def time_backward_kernel(card, taylor_mlp):
    """Phase 6: {(dims, actv, order, n, dtype): (kernel us, twin us, bound ms, bound_by, max abs error)}
    for the gradient of every one-hidden-layer shape of ``BWD_SHAPES``: ``taylor_mlp_1h_bwd`` (its
    two launches), against autograd over the twin on the same cotangents. First each shape is
    checked, or SystemExit: the timed call (no points' gradient) and one with the points' gradient
    against ``taylor_mlp_1h_backward_reference`` in float64 on the same card inputs, each gradient
    within ``TOL`` of its largest entry, and two launches bitwise equal."""
    out = {}
    for i, (dims, actv, order, n, dtype) in enumerate(BWD_SHAPES):
        pts, layers = inputs(dims, n, dtype, seed=90 + i)
        outs = taylor_mlp.fcnn_taylor_reference(pts, layers, order, actv)
        g = torch.Generator().manual_seed(91 + i)
        cts = [torch.randn(o.shape, generator=g, dtype=dtype).to('cuda') for o in outs]
        errs, abs_err, same = [], 0.0, True
        for need_points in (False, True):
            got = taylor_mlp._launch_bwd(pts, layers, order, actv, cts, need_points)
            again = taylor_mlp._launch_bwd(pts, layers, order, actv, cts, need_points)
            torch.cuda.synchronize()
            want = taylor_mlp.taylor_mlp_1h_backward_reference(
                pts.double(), [(W.double(), b.double()) for W, b in layers], order, actv,
                [c.double() for c in cts], need_points)
            same = same and all(torch.equal(a, b) for a, b in zip(got, again) if a is not None)
            errs += [rel_err(a, b) for a, b in zip(got, want) if b is not None]
            abs_err = max([abs_err] + [(a.double() - b).abs().max().item() for a, b in zip(got, want) if b is not None])
            del got, again, want
        ok = same and all(e <= TOL[dtype] for e in errs)
        phase('6 timing', f"{shape_name(dims, actv, order, n, dtype)}: taylor_mlp_1h_bwd against the closed "
                          f"form in float64, rel err {' '.join(f'{e:.2e}' for e in errs)} (limit {TOL[dtype]:.0e}; "
                          f"the parameters', then with the points' too), two launches "
                          f"{'bitwise equal' if same else 'DIFFER'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: taylor_mlp_1h_bwd disagrees with its closed form or with itself")
        k_us, k_launches = device_us(lambda: taylor_mlp._launch_bwd(pts, layers, order, actv, cts, False),
                                     calls=SHAPE_CALLS)
        leaves = [t.clone().requires_grad_() for W, b in layers for t in (W, b)]
        twin = taylor_mlp.fcnn_taylor_reference(pts, list(zip(leaves[0::2], leaves[1::2])), order, actv)
        t_us, t_launches = device_us(lambda: torch.autograd.grad(twin, leaves, cts, retain_graph=True),
                                     calls=SHAPE_CALLS)
        del twin
        b_ms, b_by = bound_ms(dims, actv, order, n, dtype, backward_cost(dims, actv, order, n, dtype.itemsize))
        out[(dims, actv, order, n, dtype)] = (k_us, t_us, b_ms, b_by, abs_err)
        phase('6 timing', f"{card}: {shape_name(dims, actv, order, n, dtype)}: backward, device time per call "
                          f"(profiler) taylor_mlp_1h_bwd {k_us:.2f} us in {k_launches:.0f} launches, twin's autograd "
                          f"{t_us:.2f} us in {t_launches:.0f}; bound {b_ms * 1e3:.3f} us ({b_by}), kernel at "
                          f"{b_ms * 1e3 / k_us:.1%} of the bound")
    return out


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
    kernel events of ``calls`` calls under ``torch.profiler``. A trace that
    recorded no kernel (the profiler dropped one in a full run on the card)
    is taken again, up to three times; then the time comes from CUDA events
    and the kernel count is nan."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == 'CUDA']
        if kernels:
            return sum(e.device_time for e in kernels) / calls, len(kernels) / calls
    return cuda_time_ms(fn, calls) * 1e3, float('nan')


def check_kernels(fcnn_taylor, fcnn_taylor_reference):
    """Phase 3: {(dims, actv, order, n, dtype): max abs error} for every
    shape, or SystemExit at the first disagreement."""
    errors = {}
    shapes = list(dict.fromkeys([s for s in CHECK_SHAPES] + [s[:4] for s in TABLE_SHAPES + REACH_SHAPES]))
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


def check_streams(taylor_mlp):
    """Phase 3: ``taylor_mlp_streams`` against its twin at every shape of
    ``STREAM_SHAPES``, float64 and float32, two launches bitwise equal;
    {(shape, dtype): max abs error}, or SystemExit at the first
    disagreement."""
    errors = {}
    with torch.no_grad():
        for dtype in (F64, F32):
            for i, shape in enumerate(STREAM_SHAPES):
                dims, d, actv, input_actv, order, n = shape
                streams, layers = stream_inputs(dims, d, order, n, dtype, seed=i)
                before = dict(taylor_mlp.STREAM_DESIGNS)
                got = taylor_mlp.fcnn_taylor_streams(streams, layers, order, actv, input_actv)
                again = taylor_mlp.fcnn_taylor_streams(streams, layers, order, actv, input_actv)
                torch.cuda.synchronize()
                want = taylor_mlp.fcnn_taylor_streams_reference(streams, layers, order, actv, input_actv)
                torch.cuda.synchronize()
                picked = [k for k, v in taylor_mlp.STREAM_DESIGNS.items() if v > before[k]]
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok = len(got) == order + 1 and all(a.shape == b.shape for a, b in zip(got, want))
                ok = ok and same and all(e <= TOL[dtype] for e in errs) and len(picked) == 1
                # the design the planner does not pick, where it fits, through the launcher itself
                other = {'resident': 'staged', 'staged': 'resident'}.get(''.join(picked))
                stacked = taylor_mlp._streams_stacked_reference(streams, layers, order, actv, input_actv)
                try:
                    alt = taylor_mlp._launch_streams(streams, layers, order, actv, input_actv, other)
                    alt_again = taylor_mlp._launch_streams(streams, layers, order, actv, input_actv, other)
                    torch.cuda.synchronize()
                    alt_err, alt_same = rel_err(alt, stacked), torch.equal(alt, alt_again)
                    ok = ok and alt_same and alt_err <= TOL[dtype]
                    alt_note = (f"; {other} design rel err {alt_err:.2e}, two launches "
                                f"{'bitwise equal' if alt_same else 'DIFFER'}")
                except ValueError:  # the resident kernel does not fit
                    alt_note = f"; {other} design does not fit"
                phase('3 kernel', f"{stream_name(*shape, dtype)}: {'+'.join(picked)} design (the planner's) rel err "
                                  f"{' '.join(f'{e:.2e}' for e in errs)} (limit {TOL[dtype]:.0e}), two launches "
                                  f"{'bitwise equal' if same else 'DIFFER'}{alt_note} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit("chip_smoke: taylor_mlp_streams disagrees with its twin or with itself")
                errors[(shape, dtype)] = max((a - b).abs().max().item() for a, b in zip(got, want))
            # a NaN in the input streams and one in the output layer's weights come out where the twin's do
            dims, d, actv, input_actv, order, _ = STREAM_SHAPES[1]
            streams, layers = stream_inputs(dims, d, order, 1000, dtype, seed=len(STREAM_SHAPES))
            streams[1, 7, 5] = float('nan')
            layers[-1][0][10, 1] = float('nan')
            got = taylor_mlp.fcnn_taylor_streams(streams, layers, order, actv, input_actv)
            want = taylor_mlp.fcnn_taylor_streams_reference(streams, layers, order, actv, input_actv)
            torch.cuda.synchronize()
            nans = [int(w.isnan().sum()) for w in want]
            ok = all(torch.equal(a.isnan(), b.isnan()) for a, b in zip(got, want)) and 0 < sum(nans)
            errs = [rel_err(a[~b.isnan()], b[~b.isnan()]) for a, b in zip(got, want)]
            ok = ok and all(e <= TOL[dtype] for e in errs)
            phase('3 kernel', f"{stream_name(dims, d, actv, input_actv, order, 1000, dtype)} with a NaN in the "
                              f"streams and one in a weight: NaNs where the twin's ({'+'.join(map(str, nans))}), "
                              f"{'equal' if ok else 'DIFFER'}; elsewhere rel err "
                              f"{' '.join(f'{e:.2e}' for e in errs)} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit("chip_smoke: taylor_mlp_streams loses or makes NaNs")
    return errors


def time_streams(card, taylor_mlp):
    """Phase 6: {shape: (kernel us, twin us, bound ms, bound_by)} of
    ``taylor_mlp_streams`` at the first ``STREAM_TIMED`` shapes of
    ``STREAM_SHAPES`` in float32, each with the design that ran (an older
    tree's wrapper counts no designs) and, for pair 1, its two layers'
    products as plain float32 ``torch.matmul`` calls (TF32 off): a
    yardstick, not the same function, so the record's ``library_ms`` stays
    null."""
    out = {}
    designs = getattr(taylor_mlp, 'STREAM_DESIGNS', {})
    with torch.no_grad():
        for i, shape in enumerate(STREAM_SHAPES[:STREAM_TIMED]):
            dims, d, actv, input_actv, order, n = shape
            streams, layers = stream_inputs(dims, d, order, n, F32, seed=50 + i)
            before = dict(designs)
            k_us, k_launches = device_us(lambda: taylor_mlp.fcnn_taylor_streams(streams, layers, order, actv,
                                                                                input_actv), calls=SHAPE_CALLS)
            ran = [name for name in designs if designs[name] > before[name]] or ['not counted']
            if len(ran) == 1 and ran[0] in designs:  # the design the planner did not pick, timed beside it
                other = 'staged' if ran[0] == 'resident' else 'resident'
                other_us = design_us(taylor_mlp, other, streams, layers, order, actv, input_actv)
                ran = [f"{ran[0]} (the planner's; {other} "
                       f"{'does not fit' if other_us is None else f'{other_us:.2f} us'})"]
            t_us, t_launches = device_us(lambda: taylor_mlp.fcnn_taylor_streams_reference(
                streams, layers, order, actv, input_actv), calls=SHAPE_CALLS)
            (b_ms, b_by), (old_ms, old_by) = stream_bound_ms(dims, d, actv, input_actv, order, n, F32)
            out[shape] = (k_us, t_us, b_ms, b_by)
            yardstick = ''
            if i == 0:
                assert not torch.backends.cuda.matmul.allow_tf32
                rows = streams.shape[0] * n
                mm = [(torch.rand(rows, a, device='cuda', dtype=F32),
                       torch.rand(a, b, device='cuda', dtype=F32))
                      for a, b in zip(dims[:-1], dims[1:])]
                mm_us = [device_us(lambda a=a, b=b: torch.matmul(a, b), calls=SHAPE_CALLS)[0] for a, b in mm]
                yardstick = (f"; yardstick, not the same function: torch.matmul float32 (TF32 off) "
                             + ' + '.join(f"({rows} x {a.shape[1]}) @ ({b.shape[0]} x {b.shape[1]}) {us:.2f} us"
                                          for (a, b), us in zip(mm, mm_us)))
            phase('6 timing', f"{card}: {stream_name(*shape, F32)}: design {'+'.join(ran)}: device time per call "
                              f"(profiler) kernel {k_us:.2f} us in {k_launches:.0f} launches, twin {t_us:.2f} us in "
                              f"{t_launches:.0f} launches; bound {b_ms * 1e3:.3f} us ({b_by}; products on tensor "
                              f"cores), kernel at {b_ms * 1e3 / k_us:.1%} of the bound (all on CUDA cores "
                              f"{old_ms * 1e3:.3f} us, {old_by}){yardstick}")
        for i, (dims, n) in enumerate(ROUTE_SHAPES if hasattr(taylor_mlp, '_narrow') else []):
            streams, layers = stream_inputs(dims, 2, 2, n, F32, seed=60 + i)
            us = {design: design_us(taylor_mlp, design, streams, layers, 2, 'tanh', 'tanh')
                  for design in ('resident', 'staged')}
            picked = taylor_mlp._plan_streams(n, 2, dims, 2, 4, torch.cuda.get_device_properties(0)
                                              .multi_processor_count).design
            faster = min(us, key=us.get)
            phase('6 timing', f"{card}: routing: {stream_name(dims, 2, 'tanh', 'tanh', 2, n, F32)}: device time "
                              f"per call (profiler) resident {us['resident']:.2f} us, staged {us['staged']:.2f} us; "
                              f"the planner picks {picked}, {'the faster' if picked == faster else 'the SLOWER'}")
    return out


def design_us(taylor_mlp, design, streams, layers, order, actv, input_actv):
    """Device microseconds per ``taylor_mlp_streams`` call in ``design``,
    whatever the planner picks, or None where that design does not fit."""
    try:
        taylor_mlp._plan_streams(streams.shape[1], (streams.shape[0] - 1) // order, tuple(
            [layers[0][0].shape[0]] + [W.shape[1] for W, _ in layers]), order, streams.element_size(), 1, design)
    except ValueError:
        return None
    return device_us(lambda: taylor_mlp._launch_streams(streams, layers, order, actv, input_actv, design),
                     calls=SHAPE_CALLS)[0]


def time_shapes(card, taylor_mlp):
    """Phase 6: {(dims, actv, order, n, dtype): (kernel us, twin us, bound ms, bound_by)}
    over ``TABLE_SHAPES``, and ``REACH_SHAPES`` where the kernels take 128
    layers (an older tree's took 16 layers and 8 inputs)."""
    fcnn_taylor, fcnn_taylor_reference = taylor_mlp.fcnn_taylor, taylor_mlp.fcnn_taylor_reference
    shapes = TABLE_SHAPES + (REACH_SHAPES if taylor_mlp._MAX_LAYERS >= 128 else [])
    out = {}
    with torch.no_grad():
        for i, (dims, actv, order, n, dtype) in enumerate(shapes):
            pts, layers = inputs(dims, n, dtype, seed=50 + i)
            k_us, k_launches = device_us(lambda: fcnn_taylor(pts, layers, order, actv), calls=SHAPE_CALLS)
            t_us, t_launches = device_us(lambda: fcnn_taylor_reference(pts, layers, order, actv), calls=SHAPE_CALLS)
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
    with the kernel and with the twin swapped in, interleaved (the twin
    windows must launch nothing)."""
    fcnn_taylor, twin = taylor_mlp.fcnn_taylor, taylor_mlp.fcnn_taylor_reference
    n = GRID[0] * GRID[1]
    bench = flagship_solver(n_batches_valid=0)  # train-only epochs, as bench.py counts them
    # no progress bar; an older tree's fit takes no tqdm_file and shows none
    quiet = {'tqdm_file': None} if 'tqdm_file' in inspect.signature(bench.fit).parameters else {}
    bench.fit(OWN_WINDOW, **quiet)
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
    rates, twin_launches = {'kernel': [], 'twin': []}, []
    for arm in ('kernel', 'twin', 'twin', 'kernel'):
        taylor_mlp.fcnn_taylor = fcnn_taylor if arm == 'kernel' else (
            lambda p, layers, order, actv='tanh': twin(p, layers, order, actv))
        taylor_mlp.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bench.fit(OWN_WINDOW, **quiet)
        torch.cuda.synchronize()
        rates[arm].append(OWN_WINDOW / (time.perf_counter() - t0))
        if arm == 'twin':
            twin_launches.append(sum(taylor_mlp.LAUNCHES.values()))
    taylor_mlp.fcnn_taylor = fcnn_taylor
    med = {k: float(np.median(v)) for k, v in rates.items()}
    phase('6 timing', f"{card}: flagship train-only epochs/s in interleaved {OWN_WINDOW}-epoch windows: "
                      f"kernel {' '.join(f'{r:.2f}' for r in rates['kernel'])} (median {med['kernel']:.2f} "
                      f"= {med['kernel'] * n:.0f} points/s), twin swapped in "
                      f"{' '.join(f'{r:.2f}' for r in rates['twin'])} (median {med['twin']:.2f}), launches in the "
                      f"twin windows {twin_launches} {'ok' if twin_launches == [0, 0] else 'FAIL'}")
    if twin_launches != [0, 0]:
        raise SystemExit("chip_smoke: a window with the twin swapped in launched a kernel")


def check_gradient(fcnn_taylor_reference):
    """Phase 4: the gradient through the kernel's autograd function against
    autograd over the twin, flagship shape, float64, limit 1e-10."""
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


def run_flagship(F, taylor_mlp):
    """Phase 5a, the main path: flagship training. Returns its launch counts."""
    from neurodiffeq_tpu_torch.utils import set_seed

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
        'one taylor_mlp_1h_bwd per epoch, no twin backward': (launches_main['taylor_mlp_1h_bwd'] == EPOCHS
                                                               and not taylor_mlp.TWIN_BACKWARDS),
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
    resumed = check_persistence(F, taylor_mlp, solver, xs, ys)
    return {k: launches_main[k] + resumed[k] for k in launches_main}


def check_persistence(F, taylor_mlp, solver, xs, ys):
    """Phase 5a, continued: the trained flagship saved, loaded into a new
    solver on the card through a ``SolverConfig`` (the path without dill),
    resumed on both from the same generator state, and its solution
    exported. Returns the launch counts of the two resumed epochs."""
    import tempfile

    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D, load_exported_solution
    from neurodiffeq_tpu_torch.solvers_utils import SolverConfig

    pde, cond = laplace_problem()
    config = SolverConfig(pde_system=pde, conditions=[cond],
                          nets=[FCNN(n_input_units=2, n_output_units=1, hidden_units=HIDDEN)],
                          train_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced-noisy'),
                          valid_generator=Generator2D(GRID, (0, 0), (1, 1), method='equally-spaced'))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / 'flagship.pt')
        solver.save(path)
        size = Path(path).stat().st_size
        loaded = Solver2D.load(path, config=config)
    save_s = time.perf_counter() - t0
    u, u_loaded = (s.get_solution()(xs, ys, to_numpy=True) for s in (solver, loaded))
    restored = loaded.metrics_history == solver.metrics_history and loaded.global_epoch == solver.global_epoch
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    losses, per = [], []
    for s in (solver, loaded):
        s.rng.manual_seed(2024)
        before = taylor_mlp.LAUNCHES['taylor_mlp_1h']
        s.fit(1, tqdm_file=None)
        per.append(taylor_mlp.LAUNCHES['taylor_mlp_1h'] - before)
        losses.append(s.metrics_history['train_loss'][-1])
    torch.cuda.synchronize()
    launches = dict(taylor_mlp.LAUNCHES)
    fallbacks = F.taylor_fallback_count()
    resume_rel = abs(losses[1] - losses[0]) / abs(losses[0])
    t0 = time.perf_counter()
    sol = solver.get_solution()
    blob = sol.export(n_coords=2)
    serve = load_exported_solution(blob)
    export_s = time.perf_counter() - t0
    pts = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1)
    export_err = {}
    for n in EXPORT_SIZES:
        (out,) = serve(pts[:n])
        want = sol(pts[:n, 0], pts[:n, 1], to_numpy=True)
        export_err[n] = float(np.abs(out.cpu().numpy()[:, 0] - want).max()) if out.shape == (n, 1) else np.inf
    checks = {
        "loaded on the solver's device": next(loaded.nets[0].parameters()).device.type == solver.device.type,
        'reloaded solution bitwise equal': bool(np.array_equal(u, u_loaded)),
        'histories and epoch restored': restored,
        'both resumed epochs launch taylor_mlp_1h': min(per) > 0,
        'no Taylor fallback': fallbacks == 0,
        f'resumed train losses agree to {RESUME_LIMIT} relative': resume_rel <= RESUME_LIMIT,
        f'export equals the solution to {EXPORT_LIMIT} at N = {EXPORT_SIZES}': max(export_err.values()) <= EXPORT_LIMIT,
    }
    report('5a flagship', f"save -> Solver2D.load(config=SolverConfig(...)) on {loaded.device.type}: {size} bytes, {save_s:.1f} s; "
                          f"resumed fit(1) on both from one generator state: taylor_mlp_1h launches {per}, train "
                          f"losses {losses[0]:.9e} and {losses[1]:.9e} (bitwise equal: {losses[0] == losses[1]}, "
                          f"rel diff {resume_rel:.1e}); export -> load_exported_solution {len(blob)} bytes in "
                          f"{export_s:.1f} s, max |served - solution| {export_err}", checks,
           "flagship persistence check failed")
    return launches


def run_default_solver2d(F, taylor_mlp):
    """Phase 5b: Solver2D with every default (device, net 2-32-32-1,
    generators). Returns its launch counts."""
    from neurodiffeq_tpu_torch.utils import set_seed

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
    return launches_default


def oscillator_solver():
    """The stiff oscillator of ``benchmarks/balancing_ab.py:42-55``: u' = v,
    v' = -omega^2 u, ``IVP(0, 1)`` and ``IVP(0, 0)`` on t in [0, 1], two
    FCNN 1-64-64-1 sin nets, ``Solver1D``'s defaults, on the port's default
    device and dtype (cuda, float32)."""
    from neurodiffeq_tpu_torch import diff
    from neurodiffeq_tpu_torch.conditions import IVP
    from neurodiffeq_tpu_torch.networks import FCNN, SinActv
    from neurodiffeq_tpu_torch.solvers import Solver1D

    return Solver1D(ode_system=lambda u, v, t: [diff(u, t) - v, diff(v, t) + OSC_OMEGA ** 2 * u],
                    conditions=[IVP(0.0, 1.0), IVP(0.0, 0.0)], t_min=0.0, t_max=1.0,
                    nets=[FCNN(hidden_units=OSC_HIDDEN, actv=SinActv) for _ in range(2)])


def oscillator_error(solver):
    """``benchmarks/balancing_ab.py``'s error: the larger of max |u - cos(omega t)|
    and max |v + omega sin(omega t)| / omega on 400 points."""
    ts = np.linspace(0.0, 1.0, 400)
    u, v = solver.get_solution()(ts, to_numpy=True)
    return float(max(np.abs(u - np.cos(OSC_OMEGA * ts)).max(),
                     np.abs(v + OSC_OMEGA * np.sin(OSC_OMEGA * ts)).max() / OSC_OMEGA))


class ScalarRecorder:
    """A writer for ``SimpleTensorboardCallback``: (tag, value, step) per call."""

    def __init__(self):
        self.records = []

    def add_scalar(self, tag, scalar_value, global_step):
        self.records.append((tag, float(scalar_value), global_step))


def run_oscillator(F, taylor_mlp):
    """Phase 5o: the control plane on the stiff oscillator: residual weights
    adapted by ``AutoResidualWeightCallback``, ``CheckpointCallback`` in the
    'state_dict' format and ``SimpleTensorboardCallback`` through one
    ``fit``; the last checkpoint restored into a new solver. Returns the
    launch counts, the solver, no schedule and the epochs/s of the fit."""
    import tempfile

    from neurodiffeq_tpu_torch import callbacks as cb
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(OSC_SEED)
    solver = oscillator_solver()
    weights, recorder = cb.AutoResidualWeightCallback(), ScalarRecorder()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        callbacks = [weights.conditioned_on(cb.OnFirstLocal() | cb.PeriodLocal(OSC_PERIOD)),
                     cb.CheckpointCallback(ckpt_dir, format='state_dict').conditioned_on(cb.PeriodLocal(OSC_PERIOD)),
                     cb.SimpleTensorboardCallback(writer=recorder)]
        fit_s, launches, fallbacks, _ = fit_path(F, taylor_mlp, solver, OSC_EPOCHS, callbacks)
        saved = sorted(p.name for p in Path(ckpt_dir).iterdir())
        set_seed(OSC_SEED + 1)
        fresh = oscillator_solver()
        cb.CheckpointCallback.restore(fresh, ckpt_dir, OSC_EPOCHS)
    params_equal = all(torch.equal(p, q) for p, q in zip(solver._parameters(), fresh._parameters()))
    adam_equal = all(all(torch.equal(solver.optimizer.state[p][k], fresh.optimizer.state[q][k])
                         for k in solver.optimizer.state[p])
                     for p, q in zip(solver._parameters(), fresh._parameters()))
    hist = solver.metrics_history['train_loss']
    early, late = float(np.mean(hist[:100])), float(np.mean(hist[-100:]))
    err = oscillator_error(solver)
    history = weights.weight_history
    steps = [s for _, _, s in recorder.records]
    names = list(solver.metrics_history)
    checks = {
        f'taylor_mlp launched {OSC_LAUNCHES} times': launches['taylor_mlp'] == OSC_LAUNCHES,
        'taylor_mlp_1h not launched': launches['taylor_mlp_1h'] == 0,
        'no Taylor fallback': fallbacks == 0,
        f'weights fired {OSC_FIRES} times': [e for e, _, _ in history] == [1] + list(range(OSC_PERIOD, OSC_EPOCHS + 1,
                                                                                             OSC_PERIOD)),
        'w_2 < 1 after the first fire': history[0][2][1] < 1.0,
        'max(w) = 1 after every fire': all(max(w) == 1.0 for _, _, w in history),
        'one scalar per metric per epoch': (len(recorder.records) == len(names) * OSC_EPOCHS
                                            and steps == [e for e in range(1, OSC_EPOCHS + 1) for _ in names]),
        'loss fell': late < early,
        f'max error < {OSC_LIMIT}': np.isfinite(err) and err < OSC_LIMIT,
        'checkpoint restored bitwise (parameters, Adam state, histories)': (
            params_equal and adam_equal and fresh.metrics_history == solver.metrics_history),
    }
    report('5o control plane', f"stiff oscillator, two FCNN 1-64-64-1 sin, fit({OSC_EPOCHS}) float32 in {fit_s:.1f} s "
                               f"({OSC_EPOCHS / fit_s:.1f} epochs/s with validation and 3 callbacks): launches "
                               f"{launches}, {fallbacks} fallbacks, weight fires "
                               f"{[(e, [round(x, 6) for x in w]) for e, _, w in history]}, gradient norms at the first "
                               f"fire {[round(x, 4) for x in history[0][1]]}, checkpoints {saved}, "
                               f"{len(recorder.records)} scalars recorded, train loss mean {early:.3e} (first 100) -> "
                               f"{late:.3e} (last 100), max error against cos(10t) and -sin(10t) {err:.4e}", checks,
           "control-plane check failed")
    return launches, solver, None, [OSC_EPOCHS / fit_s]


class EpochRunner:
    """A temporal training routine as ``fit(n)``: ``n`` more epochs of
    ``solve(max_epochs=n)`` (the approximator and the optimizer keep their
    state), so that phase 6 profiles its epochs as it does a solver's."""

    def __init__(self, solve):
        self.solve = solve

    def fit(self, n, callbacks=(), tqdm_file=None):
        return self.solve(max_epochs=n)


class SolverGrab:
    """A monitor for the legacy functions' ``monitor=`` that draws nothing:
    its callback keeps the solver that ``fit`` runs, for phase 6."""

    def __init__(self):
        self.solver = None

    def to_callback(self):
        def grab(solver):
            self.solver = solver
        return grab


@contextlib.contextmanager
def no_progress_bar():
    """The legacy functions' ``fit`` without its progress bar (they pass no
    ``tqdm_file``), restored after."""
    from neurodiffeq_tpu_torch import solvers
    bar, solvers.tqdm = solvers.tqdm, None
    try:
        yield
    finally:
        solvers.tqdm = bar


@contextlib.contextmanager
def default_dtype(dtype):
    """The port's default dtype set to ``dtype`` on its default device, and restored."""
    from neurodiffeq_tpu_torch.utils import get_default_device, get_default_dtype, set_tensor_type
    device, before = str(get_default_device()), get_default_dtype()
    set_tensor_type(device, 64 if dtype == F64 else 32)
    try:
        yield
    finally:
        set_tensor_type(device, 64 if before == F64 else 32)


def count_path(F, taylor_mlp, run):
    """``run()`` with the launch and fallback counts reset just before and
    read just after: (its result, seconds, launches, fallbacks)."""
    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count()


def steady_navier_stokes(diff, nu):
    """The steady incompressible Navier-Stokes residuals of (u, v, p) in 2-D
    with viscosity ``nu`` (examples/lid_driven_cavity.py), in the package of
    ``diff``."""
    def equations(u, v, p, x, y):
        return [u * diff(u, x) + v * diff(u, y) + diff(p, x) - nu * (diff(u, x, 2) + diff(u, y, 2)),
                u * diff(v, x) + v * diff(v, y) + diff(p, y) - nu * (diff(v, x, 2) + diff(v, y, 2)),
                diff(u, x) + diff(v, y)]

    return equations


def temporal_problem(kind, T, F, diff, FCNN):
    """Phase 5p's approximator of ``kind`` and its training routine, a
    function of ``(optimizer, max_epochs)``, in the package whose
    ``temporal`` and ``fields`` modules, ``diff`` and ``FCNN`` are passed:
    the port's here, the JAX package's in ``cpu_rehearsal.py 5p-jax``.
    'heat': the heat problem of tests/test_temporal.py; 'cavity': the
    steady Re = 100 cavity on one FCNN 2-256-3 with penalty walls."""
    if kind == 'heat':
        approx = T.SingleNetworkApproximator1DSpatialTemporal(
            single_network=FCNN(n_input_units=2, hidden_units=(32, 32)),
            pde=lambda u, x, t: diff(u, t) - THEAT_K * diff(u, x, 2),
            initial_condition=T.FirstOrderInitialCondition(u0=lambda x: F.sin(np.pi / THEAT_L * x)),
            boundary_conditions=[T.BoundaryCondition(form=lambda u, x, t: u,
                                                     points_generator=T.generator_1dspatial(4, a, a, random=False))
                                 for a in (0.0, THEAT_L)])
        gens = (T.generator_1dspatial(32, 0, THEAT_L), T.generator_temporal(32, 0, THEAT_T),
                T.generator_1dspatial(32, 0, THEAT_L, random=False),
                T.generator_temporal(32, 0, THEAT_T, random=False))
        return approx, lambda optimizer, max_epochs: T._solve_1dspatial_temporal(
            *gens, approx, optimizer, batch_size=TEMPORAL_BATCH, max_epochs=max_epochs, shuffle=True, metrics={},
            monitor=None)

    def u_lid(x):  # examples/lid_driven_cavity.py:42-44
        return (1 - F.exp(-50.0 * x)) * (1 - F.exp(50.0 * (x - 1)))

    walls = [((0, 0), (1, 0)), ((1, 0), (1, 1)), ((0, 1), (0, 0))]
    bcs = [T.BoundaryCondition(form=lambda u, v, p, x, y: F.cat([u, v]),
                               points_generator=T.generator_2dspatial_segment(32, a, b)) for a, b in walls]
    bcs.append(T.BoundaryCondition(form=lambda u, v, p, x, y: F.cat([u - u_lid(x), v]),
                                   points_generator=T.generator_2dspatial_segment(32, (1, 1), (0, 1))))
    approx = T.SingleNetworkApproximator2DSpatialSystem(
        single_network=FCNN(n_input_units=2, n_output_units=3, hidden_units=TCAV_HIDDEN),
        pde=steady_navier_stokes(diff, 1.0 / CAV_RE), boundary_conditions=bcs, boundary_strictness=TCAV_STRICTNESS)
    gens = (T.generator_2dspatial_rectangle((32, 32), 0, 1, 0, 1),
            T.generator_2dspatial_rectangle((32, 32), 0, 1, 0, 1, random=False))
    return approx, lambda optimizer, max_epochs: T._solve_2dspatial(
        *gens, approx, optimizer, batch_size=TCAV_BATCH, max_epochs=max_epochs, shuffle=True, metrics={},
        monitor=None)


def temporal_runner(kind):
    """The port's 5p problem of ``kind``: the approximator and an
    :class:`EpochRunner` over its routine with Adam (3e-3 for the heat, 1e-3
    for the cavity)."""
    from neurodiffeq_tpu_torch import diff, fields as F, temporal as T
    from neurodiffeq_tpu_torch.networks import FCNN

    approx, solve = temporal_problem(kind, T, F, diff, FCNN)
    opt = torch.optim.Adam(approx.parameters(), lr=3e-3 if kind == 'heat' else 1e-3)
    return approx, EpochRunner(lambda max_epochs: solve(opt, max_epochs))


def run_temporal(F, taylor_mlp):
    """Phase 5p: the temporal subsystem on the card. Returns the launch
    counts and phase 6's entries for its two problems."""
    from neurodiffeq_tpu_torch.utils import set_seed

    n = TEMPORAL_EPOCHS
    set_seed(TEMPORAL_SEED)  # the net's initialization and numpy's stream, from which the samplers draw
    approx, runner = temporal_runner('heat')
    (_, hist), heat_s, launches, fallbacks = count_path(F, taylor_mlp, lambda: runner.fit(n))
    xs = np.linspace(0, THEAT_L, 21)
    err = float(np.abs(approx(xs, np.ones(21)) - np.sin(np.pi * xs / THEAT_L)
                       * np.exp(-THEAT_K * (np.pi / THEAT_L) ** 2)).max())
    ic = float(np.abs(approx(xs, np.zeros(21)) - np.sin(np.pi * xs / THEAT_L)).max())
    checks = launch_checks(launches, fallbacks, THEAT_LAUNCHES, n)
    checks.update({'loss fell': hist['train_loss'][-1] < hist['train_loss'][0],
                   f'max error at t = 1 < {THEAT_LIMIT}': err < THEAT_LIMIT, 'u(x, 0) = u0 to 1e-6': ic < 1e-6})
    report('5p temporal', f"heat through SingleNetworkApproximator1DSpatialTemporal, FCNN 2-32-32-1, 32 x 32 points "
                          f"in batches of {TEMPORAL_BATCH}, {n} epochs float32 in {heat_s:.1f} s ({n / heat_s:.1f} "
                          f"epochs/s with validation): launches {launches} ({launches['taylor_mlp'] / n:.2f} "
                          f"taylor_mlp per epoch), {fallbacks} fallbacks, train loss {hist['train_loss'][0]:.3e} -> "
                          f"{hist['train_loss'][-1]:.3e}, max error at t = 1 on 21 points {err:.4e}, max |u(x, 0) - "
                          f"u0| {ic:.1e}", checks, "temporal heat check failed")
    timed = {'temporal heat (2 steps of 512, the epoch loss and validation on 1,024)': (
        launches, runner, None, [n / heat_s])}

    set_seed(TEMPORAL_SEED)
    _, runner = temporal_runner('cavity')
    (_, hist), cav_s, cav_launches, fallbacks = count_path(F, taylor_mlp, lambda: runner.fit(n))
    loss = hist['train_loss']
    drop = float(np.mean(loss[:10]) / np.mean(loss[-10:]))
    checks = {f'taylor_mlp_1h launched {TCAV_LAUNCHES} per epoch (one per collocation set, 3 columns)':
              cav_launches['taylor_mlp_1h'] == TCAV_LAUNCHES * n,
              'taylor_mlp not launched': cav_launches['taylor_mlp'] == 0, 'no Taylor fallback': fallbacks == 0,
              f'loss fell {TCAV_DROP}x': bool(np.isfinite(loss).all()) and drop > TCAV_DROP}
    report('5p temporal', f"RE100 cavity through SingleNetworkApproximator2DSpatialSystem, FCNN 2-256-3, penalty "
                          f"walls, 32 x 32 points, {n} epochs float32 in {cav_s:.1f} s ({n / cav_s:.1f} epochs/s): "
                          f"launches {cav_launches}, {fallbacks} fallbacks, train loss mean {np.mean(loss[:10]):.4e} "
                          f"(first 10) -> {np.mean(loss[-10:]):.4e} (last 10), {drop:.2f}x", checks,
           "temporal cavity check failed")
    timed['temporal cavity system (one batch of 1,024, the epoch loss and validation)'] = (
        cav_launches, runner, None, [n / cav_s])
    return {k: launches[k] + cav_launches[k] for k in launches}, timed


def hexagram(P):
    """The hexagram of tests/test_pde_irregular.py:29-100 through the port's
    ``pde`` module: the condition and the Dirichlet and Neumann control
    points on the hexagram (the dummy points on two circles close each)."""
    def exact(x, y):
        return np.log(1 + x ** 2 + y ** 2)

    def grad(x, y):
        return 2 * x / (1 + x ** 2 + y ** 2), 2 * y / (1 + x ** 2 + y ** 2)

    step = 2.0 / np.sin(np.pi / 3) / 4 / 10
    left, right = np.pi / 3, -np.pi * 2 / 3
    dirichlet, direction, (px, py) = [], np.pi * 2 / 3, (0.0, -1.0)
    for i in range(6):
        for _ in range(10):
            dirichlet.append(P.DirichletControlPoint(loc=(px, py), val=exact(px, py)))
            px, py = px + step * np.cos(direction), py + step * np.sin(direction)
        direction += left if i % 2 == 0 else right
    radius = 1.0 / np.sin(np.pi / 6)
    cx = radius * np.cos(np.pi / 6)
    dummy = [P.DirichletControlPoint(loc=(cx + radius * np.cos(th), radius * np.sin(th)),
                                     val=exact(cx + radius * np.cos(th), radius * np.sin(th)))
             for th in np.linspace(-np.pi * 5 / 6, np.pi * 5 / 6, 60)]
    neumann, normal, direction, (px, py) = [], np.pi / 6, -np.pi / 3, (0.0, 1.0)
    for i in range(6):
        nx, ny = np.cos(normal), np.sin(normal)
        px, py = px + step * np.cos(direction), py + step * np.sin(direction)
        for _ in range(9):
            gx, gy = grad(px, py)
            neumann.append(P.NeumannControlPoint(loc=(px, py), val=gx * nx + gy * ny, normal_vector=(nx, ny)))
            px, py = px + step * np.cos(direction), py + step * np.sin(direction)
        turn = left if i % 2 == 0 else right
        direction, normal = direction + turn, normal + turn
    ndummy = []
    for th in np.linspace(np.pi / 6, np.pi * 11 / 6, 60):
        px, py = -cx + radius * np.cos(th), radius * np.sin(th)
        gx, gy = grad(px, py)
        ndummy.append(P.NeumannControlPoint(loc=(px, py), val=gx * np.cos(th) + gy * np.sin(th),
                                            normal_vector=(np.cos(th), np.sin(th))))
    cbc = P.CustomBoundaryCondition(P.Point((0.0, 0.0)), dirichlet + dummy, neumann + ndummy)
    return cbc, dirichlet, neumann, exact


def run_hexagram(F, taylor_mlp, dtype):
    """Phase 5q (e): the irregular-domain anchor through ``pde.solve2D`` in
    ``dtype`` on the card, one epoch of an FCNN 2-100-100-1 ELU (no Taylor
    rule: the enforced solution composes). Returns (max deviation at the
    Dirichlet control points, max normal-derivative deviation at the Neumann
    ones, launches, fallbacks, seconds)."""
    import warnings

    from neurodiffeq_tpu_torch import diff, pde as P
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.utils import set_seed

    class ELU(torch.nn.Module):
        def forward(self, x):
            return torch.nn.functional.elu(x)

    set_seed(0)
    with default_dtype(dtype):
        cbc, dirichlet, neumann, exact = hexagram(P)
        grid = [np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n)) for n in (28, 10)]
        gens = [PredefinedGenerator(xx[cbc.in_domain(xx, yy)], yy[cbc.in_domain(xx, yy)]) for xx, yy in grid]
        F.reset_taylor_fallback_count()
        taylor_mlp.reset_launches()
        t0 = time.perf_counter()
        with warnings.catch_warnings(), no_progress_bar():
            warnings.simplefilter('ignore')  # the deprecation warnings: this is the deprecated API
            solution, _ = P.solve2D(
                pde=lambda u, x, y: (diff(u, x, 2) + diff(u, y, 2) + F.exp(u) - 1.0 - x ** 2 - y ** 2
                                     - 4.0 / (1.0 + x ** 2 + y ** 2) ** 2),
                condition=cbc, xy_min=(-1, -1), xy_max=(1, 1), train_generator=gens[0], valid_generator=gens[1],
                net=FCNN(n_input_units=2, hidden_units=HEXAGRAM_HIDDEN, actv=ELU), max_epochs=1)
        torch.cuda.synchronize()
        seconds, launches, fallbacks = time.perf_counter() - t0, dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count()
        xs, ys = (np.array([p.loc[i] for p in dirichlet]) for i in (0, 1))
        d_dev = float(np.abs(solution(xs, ys, to_numpy=True) - exact(xs, ys)).max())
        xs, ys = (np.array([p.loc[i] for p in neumann]) for i in (0, 1))
        nx, ny = (np.array([p.normal_vector[i] for p in neumann])[:, None] for i in (0, 1))
        xf, yf = F.coordinates(xs, ys)
        uf = solution.conditions[0].enforce(solution.nets[0], xf, yf)
        dn = (nx * diff(uf, xf).value.detach().cpu().numpy() + ny * diff(uf, yf).value.detach().cpu().numpy()).ravel()
        n_dev = float(np.abs(dn - np.array([p.val for p in neumann])).max())
    return d_dev, n_dev, launches, fallbacks, seconds


def legacy_cases(ode, pde, C, F, diff):
    """Phase 5q (a)-(c) in the package whose ``ode`` and ``pde`` modules,
    ``conditions``, ``fields`` and ``diff`` are passed (the port's here, the
    JAX package's in ``cpu_rehearsal.py 5q-jax``): name -> (function,
    epochs, keyword arguments, the max error of its solution)."""
    ts = np.linspace(0, 2, 201)
    xx, yy = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
    laplace = np.sin(np.pi * xx) * np.sinh(np.pi * (1 - yy)) / np.sinh(np.pi)

    def system_error(sol):
        u1, u2 = (np.asarray(u) for u in sol(ts, to_numpy=True))
        return float(max(np.abs(u1 - np.sin(ts)).max(), np.abs(u2 - np.cos(ts)).max()))

    cond = C.DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                            y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x), y_max=1.0, y_max_val=lambda x: 0 * x)
    return {
        'ode.solve': (ode.solve, LEGACY_ODE_EPOCHS,
                      dict(ode=lambda u, t: diff(u, t) + u, condition=C.IVP(t_0=0.0, u_0=1.0), t_min=0.0, t_max=2.0),
                      lambda sol: float(np.abs(np.asarray(sol(ts, to_numpy=True)) - np.exp(-ts)).max())),
        'ode.solve_system': (ode.solve_system, LEGACY_ODE_EPOCHS,
                             dict(ode_system=lambda u1, u2, t: [diff(u1, t) - u2, diff(u2, t) + u1],
                                  conditions=[C.IVP(t_0=0.0, u_0=0.0), C.IVP(t_0=0.0, u_0=1.0)], t_min=0.0, t_max=2.0),
                             system_error),
        'pde.solve2D': (pde.solve2D, LEGACY_2D_EPOCHS,
                        dict(pde=lambda u, x, y: diff(u, x, 2) + diff(u, y, 2), condition=cond, xy_min=(0, 0),
                             xy_max=(1, 1)),
                        lambda sol: float(np.abs(np.asarray(sol(xx, yy, to_numpy=True)) - laplace).max())),
    }


def run_legacy(F, taylor_mlp):
    """Phase 5q: the legacy APIs on the card, on their default nets and
    generators, and the irregular-domain anchor. Returns the launch counts
    and phase 6's entries for ``solve``, ``solve_system`` and ``solve2D``."""
    import warnings

    from neurodiffeq_tpu_torch import conditions as C, diff, ode, pde, pde_spherical
    from neurodiffeq_tpu_torch.operators import spherical_laplacian
    from neurodiffeq_tpu_torch.utils import set_seed

    total, timed = {k: 0 for k in taylor_mlp.LAUNCHES}, {}

    def legacy(timing_label, fn, epochs, per_epoch, seed, **kwargs):
        """``fn`` trained with the counts read around it; phase 6 times its
        solver under ``timing_label`` (None: not timed)."""
        set_seed(LEGACY_SEED + seed)
        grab = SolverGrab()
        with warnings.catch_warnings(), no_progress_bar():
            warnings.simplefilter('ignore')  # the deprecation warnings: these are the deprecated APIs
            (solution, hist), secs, launches, fallbacks = count_path(
                F, taylor_mlp, lambda: fn(max_epochs=epochs, monitor=grab, **kwargs))
        for k in total:
            total[k] += launches[k]
        loss = hist['train_loss']
        checks = launch_checks(launches, fallbacks, per_epoch, epochs)
        checks['loss fell'] = bool(np.isfinite(loss).all()) and np.mean(loss[-10:]) < np.mean(loss[:10])
        if timing_label:
            timed[timing_label] = (launches, grab.solver, None, [epochs / secs])
        return solution, secs, launches, checks

    cases = legacy_cases(ode, pde, C, F, diff)
    what = {'ode.solve': ("u' + u = 0 on [0, 2], default FCNN 1-32-32-1", 'max |u - exp(-t)| on 201 points',
                          LEGACY_ODE_LIMIT, 'train + 4 validation batches of 32'),
            'ode.solve_system': ("u1' = u2, u2' = -u1 on [0, 2], shared default FCNN 1-32-32-2",
                                 'max error against (sin t, cos t) on 201 points', LEGACY_SYSTEM_LIMIT,
                                 'shared net; train + 4 validation batches of 32'),
            'pde.solve2D': ('Laplace on the unit square, default FCNN 2-32-32-1',
                            'max error against sin(pi x) sinh(pi (1 - y)) / sinh(pi) on 101 x 101', LEGACY_2D_LIMIT,
                            'train + 4 validation batches of 32 x 32')}
    for seed, (label, (fn, n, kwargs, error)) in enumerate(cases.items()):
        problem, measure, limit, batches = what[label]
        sol, secs, launches, checks = legacy(f'{label} ({batches})', fn, n, LEGACY_LAUNCHES, seed, **kwargs)
        err = error(sol)
        checks[f'{measure} < {limit}'] = err < limit
        note = ''
        if label == 'ode.solve_system':
            u1, u2 = sol(np.zeros(1), to_numpy=True)
            ic = float(max(abs(u1[0]), abs(u2[0] - 1)))
            checks.update({'initial values exact to 1e-6': ic < 1e-6,
                           'one shared net': sol.nets[0] is sol.nets[1] and sol.nets[0].n_output_units == 2})
            note = f", initial values off by {ic:.1e}"
        report('5q legacy', f"{label}, {problem}, {n} epochs float32 in {secs:.1f} s ({n / secs:.1f} epochs/s): "
                            f"launches {launches}, {measure} {err:.4e}{note}", checks, f"legacy {label} check failed")

    n = LEGACY_SPH_EPOCHS
    r0, r1 = 0.1, 3.0
    v0, v1 = float(sph_exact(r0)), float(sph_exact(r1))
    coeff = 1 / (2 * np.pi) ** 1.5
    sol, secs, launches, checks = legacy(
        None, pde_spherical.solve_spherical, n, LEGACY_SPH_LAUNCHES, 3, pde=lambda u, r, th, ph: spherical_laplacian(u, r, th, ph) + coeff * F.exp(-r ** 2 / 2),
        condition=C.DirichletBVPSpherical(r0, lambda th, ph: v0 + 0 * th, r1, lambda th, ph: v1 + 0 * th),
        r_min=r0, r_max=r1)
    report('5q legacy', f"pde_spherical.solve_spherical, the Gaussian charge's potential, default FCNN 3-32-32-1, {n} "
                        f"epochs in {secs:.1f} s ({n / secs:.1f} epochs/s): launches {launches}", checks,
           "legacy solve_spherical check failed")

    d64, n64, launches, fallbacks, secs = run_hexagram(F, taylor_mlp, F64)
    d32, n32, _, _, secs32 = run_hexagram(F, taylor_mlp, F32)
    checks = {f'Dirichlet control points within {HEXAGRAM_DIRICHLET} (float64)': d64 < HEXAGRAM_DIRICHLET,
              f'normal derivatives within {HEXAGRAM_NEUMANN} (float64)': n64 < HEXAGRAM_NEUMANN,
              'no kernel launch (the ELU net has no Taylor rule)': sum(launches.values()) == 0,
              f'{HEXAGRAM_FALLBACKS} compose fallbacks': fallbacks == HEXAGRAM_FALLBACKS}
    report('5q legacy', f"the hexagram through pde.solve2D and CustomBoundaryCondition, FCNN 2-100-100-1 ELU, 1 epoch "
                        f"({secs:.1f} s float64, {secs32:.1f} s float32; {fallbacks} compose fallbacks): max deviation "
                        f"at the Dirichlet control points {d64:.3e} (float32 {d32:.3e}), of the normal derivative at "
                        f"the Neumann ones {n64:.3e} (float32 {n32:.3e})", checks, "irregular-domain anchor failed")
    return total, timed


def timed_collective(name, sync, spent, group=None):
    """Replace ``torch.distributed.<name>`` by a version that synchronizes
    and adds its seconds and one call to ``spent`` (of the calls on
    ``group`` only, if given); returns a function that restores it."""
    original = getattr(torch.distributed, name)

    def run(*args, **kwargs):
        if group is not None and kwargs.get('group') is not group:
            return original(*args, **kwargs)
        sync()
        t1 = time.perf_counter()
        result = original(*args, **kwargs)
        sync()
        spent[0] += time.perf_counter() - t1
        spent[1] += 1
        return result

    setattr(torch.distributed, name, run)
    return lambda: setattr(torch.distributed, name, original)


def model_rank(backend, devices, flagship, cavity, sync, save_path):
    """Phase 5s in one rank: ``make_mesh(model_axis_size=MODEL_AXIS)`` over
    the ranks, and on it the flagship from ``flagship = (parameters,
    generator state, epochs)`` and the primitive cavity from ``cavity``
    (the same for it), each loaded through the solver: each one's first
    epoch (loss, and this rank's block of each gradient with its place),
    the elements of its stored parameters, gradients and Adam moments,
    launches and fallbacks, history, its epochs/s over the epochs between
    the first and the last ones, and the seconds of the model group's
    ``all_reduce`` calls over its last epochs (synchronized) and the number
    of the other ``all_reduce`` calls (the points axis: gradients and
    records); the flagship's error and the cavity's walls. The cavity is
    saved to ``save_path`` at the end (every rank gathers, rank 0 writes),
    with its gathered ``get_solution()`` on a grid."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.ops import taylor_mlp
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes, stored_blocks
    from neurodiffeq_tpu_torch.utils import get_default_device

    mesh = make_mesh(devices=devices, backend=backend, model_axis_size=MODEL_AXIS)
    axes, dev = mesh_axes(mesh), get_default_device()
    out = {'index': (tuple(mesh.mesh_dim_names), axes.points.get_local_rank(), axes.model.get_local_rank())}
    runs = (('flagship', lambda **kw: (flagship_solver(**kw), []), flagship, SHARD_COLL_EPOCHS),
            ('cavity', lambda **kw: (lambda s, step: (s, [step]))(*cavity_solver('primitive', CAV_ANNEAL, **kw)),
             cavity, MODEL_CAV_COLL_EPOCHS))
    for name, build, (init, rng_state, epochs), coll in runs:
        gen = torch.Generator(device=dev)
        gen.set_state(rng_state)
        solver, callbacks = build(mesh=mesh, generator=gen)
        solver.load_params([init])
        F.reset_taylor_fallback_count()
        taylor_mlp.reset_launches()
        solver.fit(1, callbacks=callbacks, tqdm_file=None)
        params, blocks, moments = solver._parameters(), stored_blocks(solver._unique_nets), solver.optimizer.state
        first = (solver.metrics_history['train_loss'][0], [p.grad.detach().cpu().numpy() for p in params],
                 [(blocks[p].dim, blocks[p].lo, blocks[p].hi) if p in blocks else None for p in params])
        counts = [sum(t.numel() for t in tensors) for tensors in zip(*[
            (p, p.grad, moments[p]['exp_avg'], moments[p]['exp_avg_sq']) for p in params])]
        coll = min(coll, epochs - 1)
        sync()
        t0 = time.perf_counter()
        solver.fit(epochs - 1 - coll, callbacks=callbacks, tqdm_file=None)
        sync()
        rate = (epochs - 1 - coll) / (time.perf_counter() - t0)
        spent, every = [0.0, 0], [0.0, 0]
        restore = [timed_collective('all_reduce', sync, spent, axes.model.get_group()),
                   timed_collective('all_reduce', sync, every)]
        try:
            solver.fit(coll, callbacks=callbacks, tqdm_file=None)
        finally:
            for undo in reversed(restore):
                undo()
        run = {'first': first, 'counts': counts, 'rate': rate, 'launches': dict(taylor_mlp.LAUNCHES),
               'fallbacks': F.taylor_fallback_count(), 'history': list(solver.metrics_history['train_loss']),
               'model_ms': (spent[0] / max(coll, 1) * 1e3, spent[1] / max(coll, 1)),
               'points_calls': (every[1] - spent[1]) / max(coll, 1)}
        if name == 'flagship':
            xs, ys = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
            exact = np.sin(np.pi * xs) * np.sinh(np.pi * (1 - ys)) / np.sinh(np.pi)
            run['error'] = float(np.abs(solver.get_solution()(xs, ys, to_numpy=True) - exact).max())
        else:
            run['walls'] = cavity_walls(solver)
            solver.save(save_path)
            xs, ys = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 33))
            run['solution'] = solver.get_solution()(xs, ys, to_numpy=True)
        out[name] = run
    return out


def shard_rank(backend, devices, init, rng_state, epochs, hd, model=None, polish=None):
    """Phases 5r and 5s, one rank of the mesh (``neurodiffeq_tpu_torch.parallel.launch``
    runs it). With ``epochs`` (5r): the flagship on ``make_mesh(devices=devices, backend=backend)``
    from the parameters ``init`` and the generator state ``rng_state``,
    ``fit(1)`` and then ``fit(epochs - 1)``, the last ``SHARD_COLL_EPOCHS``
    of them with every collective synchronized and timed; and, with ``hd =
    (points, parameters)``, one batch of 5m's d = 100 problem. With
    ``model = (flagship epochs, cavity parameters, cavity generator state,
    cavity epochs, cavity save path)`` (5s): ``model_rank`` over the same
    ranks; with ``polish = (path, gradients, epochs)`` (5t): ``polish_rank``.
    Returns what the parent checks."""
    from neurodiffeq_tpu_torch import fields as F, operators as O
    from neurodiffeq_tpu_torch.ops import taylor_mlp
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import RowShard
    from neurodiffeq_tpu_torch.utils import full_precision_matmuls, get_default_device

    mesh = make_mesh(devices=devices, backend=backend)
    dev = get_default_device()
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    if dev.type == 'cuda':
        full_precision_matmuls()
    else:  # the CPU rehearsal: each twin call counted as the launch it is on the card
        import cpu_rehearsal
        cpu_rehearsal.counted(taylor_mlp)
    out = {'rank': mesh.get_local_rank(), 'world': mesh.size(), 'device': str(dev),
           'imports JAX': any(m in sys.modules for m in ('jax', 'neurodiffeq_tpu'))}
    if epochs:
        gen = torch.Generator(device=dev)
        gen.set_state(rng_state)
        solver = flagship_solver(mesh=mesh, generator=gen)
        solver.nets[0].load_state_dict(init)
        F.reset_taylor_fallback_count()
        taylor_mlp.reset_launches()
        solver.fit(1, tqdm_file=None)
        out['first'] = (solver.metrics_history['train_loss'][0],
                        [p.grad.detach().cpu().numpy() for p in solver._parameters()])
        main = max(epochs - 1 - SHARD_COLL_EPOCHS, 0)
        sync()
        t0 = time.perf_counter()
        solver.fit(main, tqdm_file=None)
        sync()
        out['rate'] = main / (time.perf_counter() - t0) if main else float('nan')
        spent = [0.0, 0]
        coll = epochs - 1 - main
        restore = [timed_collective(name, sync, spent) for name in ('all_reduce', 'broadcast')]
        try:
            solver.fit(coll, tqdm_file=None)
        finally:
            for undo in restore:
                undo()
        out['collectives'] = (spent[0] / max(coll, 1) * 1e3, spent[1] / max(coll, 1))
        out['launches'], out['fallbacks'] = dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count()
        out['history'] = list(solver.metrics_history['train_loss'])
        xs, ys = np.meshgrid(np.linspace(0, 1, 101), np.linspace(0, 1, 101))
        exact = np.sin(np.pi * xs) * np.sinh(np.pi * (1 - ys)) / np.sinh(np.pi)
        out['error'] = float(np.abs(solver.get_solution()(xs, ys, to_numpy=True) - exact).max())
    if hd is not None:
        points, params = hd
        hd_solver = highdim_solver(100, 'stde', mesh=mesh)
        hd_solver.nets[0].load_state_dict(params)
        pts = torch.as_tensor(points, device=dev)
        share, _ = hd_solver._loss_and_metrics([pts[:, i:i + 1] for i in range(100)])
        hd_solver._backward(share)
        loss = float(hd_solver._reduce_grads(share))
        shard = RowShard(mesh, pts.shape[0])
        probes = O._stde_probes(pts[shard.lo:shard.hi], range(100), HD_N_EST, 0, 2,
                                (shard.hi - shard.lo, HD_N_EST, 100), shard)
        out['hd'] = (loss, [p.grad.detach().cpu().numpy() for p in hd_solver._parameters()], shard.lo, shard.hi,
                     probes.cpu().numpy())
    if model is not None:
        out['model'] = model_rank(backend, devices, (init, rng_state, model[0]), model[1:4], sync, model[4])
    if polish is not None:
        out['5t'] = polish_rank(backend, devices, init, rng_state, sync, *polish)
    return out


def one_nccl_rank(init, rng_state):
    """Phase 5r's world of one: this process as the only rank of an NCCL
    process group (a file rendezvous), running ``shard_rank`` for one epoch;
    a spawned rank would spend most of its time starting. The group is
    destroyed after, and the default device is the card again."""
    import datetime
    import shutil
    import tempfile
    import torch.distributed as dist
    from neurodiffeq_tpu_torch.utils import _set_rank_device

    tmp = tempfile.mkdtemp(prefix='chip_smoke_nccl_')
    dist.init_process_group('nccl', init_method=Path(tmp, 'rendezvous').as_uri(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        return shard_rank('nccl', None, init, rng_state, 1, None)
    finally:
        dist.destroy_process_group()
        _set_rank_device(None)
        shutil.rmtree(tmp, ignore_errors=True)


def run_sharded(F, taylor_mlp, card='the CPU', chosen=('5r', '5s', '5t'), burgers=None):
    """Phases 5r, 5s and 5t in one spawn of ranks. 5r, the data-parallel slice:
    the flagship (5a's config, FCNN 2-512-1 tanh on 32 x 32 points) on a
    mesh over the points: 2 ranks on one card over gloo, or one rank per
    card over NCCL (2 or 4) where there are more; on the CPU (the
    rehearsal) 2 gloo ranks. From one initialization and one generator
    state the first epoch's loss and every gradient must equal the
    unsharded run's to ``SHARD_GRAD_TOL``, each rank must launch
    ``taylor_mlp_1h`` 5 times per epoch (its block of each of 5 batches)
    with no fallback, the histories of all ranks must be equal, the loss
    must fall over ``SHARD_EPOCHS`` and the error against the analytic
    solution stay below ``SHARD_LIMIT``; 5m's d = 100 batch gives every rank
    its rows of the unsharded probes bit for bit and the unsharded loss and
    gradients; one NCCL rank must equal the unsharded first epoch bitwise.
    5s, the model axis (:func:`run_model_axis`), over the same ranks, and
    5t, the optimizers that read across their parameters on it
    (:func:`run_polish`: Burgers' L-BFGS polish from 5k's solver
    ``burgers``, where 5k ran, and Adafactor and Muon on the flagship).
    Returns ``{phase: launches summed over the ranks}``."""
    import tempfile
    from neurodiffeq_tpu_torch import operators as O
    from neurodiffeq_tpu_torch.parallel import launch
    from neurodiffeq_tpu_torch.utils import get_default_device, set_seed

    dev = get_default_device()
    cards = torch.cuda.device_count() if dev.type == 'cuda' else 0
    if dev.type == 'cpu':
        backend, world, devices = 'gloo', SHARD_RANKS, 'cpu'
    elif cards >= 2:
        backend, world, devices = 'nccl', min(cards, 4) // 2 * 2, None
    else:
        backend, world, devices = 'gloo', SHARD_RANKS, 'cuda:0'
    sync = torch.cuda.synchronize if dev.type == 'cuda' else (lambda: None)
    points_axis, model_axis, polish_axis = '5r' in chosen, '5s' in chosen, '5t' in chosen
    hd = model = polish = None
    tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_5s_')
    if model_axis:  # first: the seed set last is the STDE probes' (utils.seed_value), the ranks' SHARD_SEED
        set_seed(4)  # 5e's
        cav_ref, cav_step = cavity_solver('primitive', CAV_ANNEAL)
        model = (SHARD_EPOCHS, {k: v.detach().cpu().clone() for k, v in cav_ref.nets[0].state_dict().items()},
                 cav_ref.rng.get_state(), MODEL_CAV_EPOCHS, str(Path(tmp.name, 'cavity.pt')))
    if polish_axis:
        before = save_burgers(burgers, str(Path(tmp.name, 'burgers.pt')))
    set_seed(SHARD_SEED)
    ref = flagship_solver()
    init = {k: v.detach().cpu().clone() for k, v in ref.nets[0].state_dict().items()}
    rng_state = ref.rng.get_state()
    if polish_axis:
        polish = (str(Path(tmp.name, 'burgers.pt')), flagship_weight_grads(init, rng_state), POLISH_EPOCHS)
    if points_axis:
        hd_ref = highdim_solver(100, 'stde')
        hd_init = {k: v.detach().cpu().clone() for k, v in hd_ref.nets[0].state_dict().items()}
        points = torch.rand(HD_POINTS, 100, generator=torch.Generator().manual_seed(SHARD_SEED), dtype=F32)
        hd = (points.numpy(), hd_init)
    t0 = time.perf_counter()
    # the mesh's ranks alone on the card: the rates they report are theirs
    outs = launch(shard_rank, world, backend=backend, device_type=dev.type, timeout=SHARD_TIMEOUT,
                  args=(backend, devices, init, rng_state, SHARD_EPOCHS if points_axis else 0, hd, model, polish),
                  num_threads=SHARD_CPU_THREADS if dev.type == 'cpu' else None)
    launch_s = time.perf_counter() - t0
    # the unsharded runs from the same states
    ref.fit(1, tqdm_file=None)
    first = (ref.metrics_history['train_loss'][0], [p.grad.detach().cpu().numpy() for p in ref._parameters()])
    checks = {f'{world} ranks over {backend}': [o['world'] for o in outs] == [world] * world,
              'no rank imported JAX': not any(o['imports JAX'] for o in outs)}
    totals = {}
    if model_axis:
        cav_ref.fit(1, callbacks=[cav_step], tqdm_file=None)
        cav_first = (cav_ref.metrics_history['train_loss'][0],
                     [p.grad.detach().cpu().numpy() for p in cav_ref._parameters()])
        whole = {'flagship': sum(p.numel() for p in ref._parameters()),
                 'cavity': sum(p.numel() for p in cav_ref._parameters())}
        loaded = load_cavity(model[4])
        totals['5s'] = run_model_axis(taylor_mlp, card, [o['model'] for o in outs], first, cav_first, backend, world,
                                      launch_s, checks, whole, loaded)
    if polish_axis:
        totals['5t'] = run_polish(taylor_mlp, card, [o['5t'] for o in outs], backend, world, launch_s, checks,
                                  (polish, (init, rng_state)), before, sync)
    tmp.cleanup()
    if not points_axis:
        return totals
    sync()
    t0 = time.perf_counter()
    ref.fit(SHARD_RATE_EPOCHS, tqdm_file=None)
    sync()
    ref_rate = SHARD_RATE_EPOCHS / (time.perf_counter() - t0)
    one = one_nccl_rank(init, rng_state) if dev.type == 'cuda' else None
    pts = points.to(dev)
    share, _ = hd_ref._loss_and_metrics([pts[:, i:i + 1] for i in range(100)])
    hd_ref._backward(share)
    hd_first = (share.item(), [p.grad.detach().cpu().numpy() for p in hd_ref._parameters()])
    probes = O._stde_probes(pts, range(100), HD_N_EST, 0, 2, (HD_POINTS, HD_N_EST, 100)).cpu().numpy()

    first_err = max([rel(o['first'][0], first[0]) for o in outs]
                    + [rel(g, h) for o in outs for g, h in zip(o['first'][1], first[1])])
    hd_err = max([rel(o['hd'][0], hd_first[0]) for o in outs]
                 + [rel(g, h) for o in outs for g, h in zip(o['hd'][1], hd_first[1])])
    per_epoch = [o['launches']['taylor_mlp_1h'] / SHARD_EPOCHS for o in outs]
    hist = outs[0]['history']
    early, late = float(np.mean(hist[:10])), float(np.mean(hist[-10:]))
    total = {k: sum(o['launches'][k] for o in outs) for k in taylor_mlp.LAUNCHES}
    checks.update({
        f'first-epoch loss and gradients within {SHARD_GRAD_TOL} of unsharded': first_err < SHARD_GRAD_TOL,
        'taylor_mlp_1h 5 per epoch per rank': all(o['launches']['taylor_mlp_1h'] == 5 * SHARD_EPOCHS
                                                 and o['launches']['taylor_mlp'] == 0 for o in outs),
        'no Taylor fallback': all(o['fallbacks'] == 0 for o in outs),
        'every rank the same history': all(o['history'] == hist for o in outs),
        'loss fell': late < early,
        f'max error < {SHARD_LIMIT}': all(np.isfinite(o['error']) and o['error'] < SHARD_LIMIT for o in outs),
        'd = 100 probes bit for bit': all(np.array_equal(o['hd'][4], probes[o['hd'][2]:o['hd'][3]]) for o in outs),
        f'd = 100 loss and gradients within {SHARD_GRAD_TOL}': hd_err < SHARD_GRAD_TOL,
    })
    note = ''
    if one is not None:
        checks['one NCCL rank bitwise unsharded'] = (one['first'][0] == first[0] and all(
            np.array_equal(g, h) for g, h in zip(one['first'][1], first[1])))
        checks['one NCCL rank: taylor_mlp_1h 5 launches'] = one['launches']['taylor_mlp_1h'] == 5
        total = {k: total[k] + one['launches'][k] for k in total}
        note = f"; one NCCL rank: first-epoch loss {one['first'][0]!r} against {first[0]!r}"
    rates = ', '.join(f"rank {o['rank']} {o['rate']:.2f} epochs/s, collectives {o['collectives'][0]:.3f} ms per "
                      f"epoch in {o['collectives'][1]:.0f} calls" for o in outs)
    scope = "one card's numbers, not a scaling claim" if dev.type == 'cuda' else 'a CPU rehearsal, no device time'
    phase('5r rates', f"{card}: flagship 2-512-1 N = {GRID[0] * GRID[1]} per batch over {world} {backend} ranks "
                      f"({devices or 'one card each'}; each rank's compute and collectives on its own device): "
                      f"{rates}; unsharded {ref_rate:.2f} epochs/s in one process ({scope})")
    report('5r sharded', f"{world} ranks over {backend} in {launch_s:.1f} s (with 5s where it runs): launches per "
                         f"epoch per rank {' '.join(f'{r:.2f}' for r in per_epoch)} (taylor_mlp_1h), fallbacks "
                         f"{[o['fallbacks'] for o in outs]}, first epoch's loss and gradients against unsharded "
                         f"{first_err:.2e} (relative), d = 100 stde batch {hd_err:.2e}; {SHARD_EPOCHS} epochs: train "
                         f"loss mean {early:.3e} (first 10) -> {late:.3e} (last 10), max |u - exact| on 101x101 "
                         f"{outs[0]['error']:.4e}{note}", checks, "sharded flagship check failed")
    totals['5r'] = total
    return totals


def rel(a, b):
    """max |a - b| / max |b| of two arrays (or numbers), in float64."""
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()
                 / max(np.abs(np.asarray(b, np.float64)).max(), 1e-300))


def load_cavity(path):
    """The cavity that 5s's ranks saved at ``path``, loaded in this process
    without a mesh through a ``SolverConfig`` (the card's machine has no
    dill): its ``get_solution()`` on the ranks' grid."""
    from neurodiffeq_tpu_torch.solvers import Solver2D
    from neurodiffeq_tpu_torch.solvers_utils import SolverConfig

    fresh, _ = cavity_solver('primitive', CAV_ANNEAL)
    loaded = Solver2D.load(path, config=SolverConfig(
        pde_system=fresh.diff_eqs, conditions=fresh.conditions, nets=fresh.nets,
        train_generator=fresh.generator['train'], valid_generator=fresh.generator['valid']))
    xs, ys = np.meshgrid(np.linspace(0, 1, 33), np.linspace(0, 1, 33))
    return loaded.mesh is None, loaded.get_solution()(xs, ys, to_numpy=True)


def run_model_axis(taylor_mlp, card, outs, first, cav_first, backend, world, launch_s, checks, whole, loaded):
    """Phase 5s's checks on the ranks' ``model_rank`` results ``outs``: on
    the ``(world // 2, 2)`` mesh the flagship's and the cavity's first
    epochs within ``SHARD_GRAD_TOL`` of the unsharded runs' (``first``,
    ``cav_first``; each rank's block of each gradient against the same
    block of the unsharded one), each rank's stored parameters, gradients
    and Adam moments at ``MODEL_PER_RANK`` elements (``whole``: the nets'
    own), no points-axis collective on a ``(1, m)`` mesh, the rehearsal's
    launches per epoch and rank with no fallback, every rank the same
    histories, falling losses, the flagship's error below ``SHARD_LIMIT``,
    the cavity's walls exact as 5e holds them, and the cavity saved on the
    mesh and ``loaded`` here without one (``load_cavity``) with the mesh
    run's gathered solution bit for bit. Returns the launches summed over
    the ranks."""
    flag, cav, checks = [o['flagship'] for o in outs], [o['cavity'] for o in outs], dict(checks)

    def block(h, spec):  # a rank's block of the unsharded array h
        return h if spec is None else np.take(h, np.arange(spec[1], spec[2]), axis=spec[0])

    def first_err(runs, want):
        return max([rel(r['first'][0], want[0]) for r in runs]
                   + [rel(g, block(h, spec)) for r in runs for g, h, spec in zip(r['first'][1], want[1], r['first'][2])])

    def launches(runs, epochs, one_hidden, streams):  # one backward an epoch: the train batch's
        return all(r['launches'] == {'taylor_mlp_1h': one_hidden * epochs, 'taylor_mlp': 0,
                                     'taylor_mlp_streams': streams * epochs, 'taylor_mlp_1h_bwd': epochs}
                   for r in runs)

    def fell(hist, k):
        return float(np.mean(hist[-k:])) < float(np.mean(hist[:k]))

    flag_err, cav_err = first_err(flag, first), first_err(cav, cav_first)
    walls = [max(w) for w in zip(*[r['walls'] for r in cav])]
    unsharded, loaded_solution = loaded
    points_calls = [r['points_calls'] for r in flag + cav]
    checks.update({
        f"stored parameters, gradients and Adam moments {MODEL_PER_RANK['flagship']} and "
        f"{MODEL_PER_RANK['cavity']} elements per rank (nets {whole['flagship']} and {whole['cavity']})": all(
            r['counts'] == [MODEL_PER_RANK[name]] * 4 for name, runs in (('flagship', flag), ('cavity', cav))
            for r in runs),
        'no points-axis collective on a (1, m) mesh': world > MODEL_AXIS or all(c == 0 for c in points_calls),
        'the cavity saved on the mesh loads without one, get_solution() bit for bit': unsharded and all(
            np.array_equal(a, b) for r in cav for a, b in zip(r['solution'], loaded_solution, strict=True)),
        f"a ({world // MODEL_AXIS}, {MODEL_AXIS}) mesh": sorted(o['index'] for o in outs) == sorted(
            (('points', 'model'), p, q) for p in range(world // MODEL_AXIS) for q in range(MODEL_AXIS)),
        f'flagship first epoch within {SHARD_GRAD_TOL} of unsharded': flag_err < SHARD_GRAD_TOL,
        'flagship: taylor_mlp_1h 5 and taylor_mlp_1h_bwd 1 per epoch per rank': launches(flag, SHARD_EPOCHS, 5, 0),
        f'cavity first epoch within {SHARD_GRAD_TOL} of unsharded': cav_err < SHARD_GRAD_TOL,
        'cavity: 1 taylor_mlp_1h, 2 taylor_mlp_streams and 1 taylor_mlp_1h_bwd per epoch per rank':
            launches(cav, MODEL_CAV_EPOCHS, 1, 2),
        'no Taylor fallback': all(r['fallbacks'] == 0 for r in flag + cav),
        'every rank the same histories': all(r['history'] == flag[0]['history'] for r in flag)
        and all(r['history'] == cav[0]['history'] for r in cav),
        'losses fell': fell(flag[0]['history'], 10) and fell(cav[0]['history'], 5),
        f'flagship max error < {SHARD_LIMIT}': all(np.isfinite(r['error']) and r['error'] < SHARD_LIMIT for r in flag),
        **wall_checks(*walls),
    })
    hist, chist = flag[0]['history'], cav[0]['history']
    rates = ', '.join(name + ' ' + ' '.join(f"{r['rate']:.2f}" for r in runs) for name, runs in (('flagship', flag),
                                                                                             ('cavity', cav)))
    coll = '; '.join(name + ' ' + ' '.join(f"{r['model_ms'][0]:.3f}" for r in runs) + f" ms in "
                     f"{runs[0]['model_ms'][1]:.0f} calls" for name, runs in (('flagship', flag), ('cavity', cav)))
    report('5s model axis', f"{card}: {world} {backend} ranks, mesh ({world // MODEL_AXIS}, {MODEL_AXIS}), in "
                            f"{launch_s:.1f} s (with 5r where it runs): first epoch's loss and gradients against "
                            f"unsharded: flagship 2-512-1 {flag_err:.2e}, cavity 2-(128x5)-3 {cav_err:.2e} "
                            f"(relative); launches per rank {flag[0]['launches']} in {SHARD_EPOCHS} flagship epochs, "
                            f"{cav[0]['launches']} in {MODEL_CAV_EPOCHS} cavity epochs; fallbacks "
                            f"{[r['fallbacks'] for r in flag + cav]}; train loss mean {np.mean(hist[:10]):.3e} (first "
                            f"10) -> {np.mean(hist[-10:]):.3e} (last 10), flagship max |u - exact| on 101x101 "
                            f"{flag[0]['error']:.4e}; cavity {np.mean(chist[:5]):.4e} (first 5) -> "
                            f"{np.mean(chist[-5:]):.4e} (last 5), walls {walls[0]:.2e}, lid {walls[1]:.2e}, p "
                            f"{walls[2]:.2e}; epochs/s, each rank: {rates}; the model group's all_reduce per "
                            f"epoch, each rank (synchronized): {coll}; "
                            f"other all_reduce calls per epoch (gradients and records over the points axis), each "
                            f"rank: {' '.join(f'{c:.0f}' for c in points_calls)}; elements per rank (parameters, "
                            f"gradients, exp_avg, exp_avg_sq): flagship {flag[0]['counts']} of {whole['flagship']}, "
                            f"cavity {cav[0]['counts']} of {whole['cavity']}; the cavity saved on the mesh and loaded "
                            f"without one", checks, "model-axis check failed")
    return {k: sum(r['launches'][k] for r in flag + cav) for k in taylor_mlp.LAUNCHES}


def state_elements(optimizer):
    """The elements of the tensors in ``optimizer``'s state (L-BFGS's
    vectors and history, Adafactor's factors and variances, Muon's
    momentum), step counts and scalars aside."""
    def count(v):
        if isinstance(v, (list, tuple)):
            return sum(count(x) for x in v)
        return v.numel() if torch.is_tensor(v) and v.ndim else 0

    return sum(count(v) for st in optimizer.state.values() for k, v in st.items() if k != 'gram')


def full_params(solver):
    """Every parameter at full size (gathered on every rank under a model axis)."""
    return [v.detach().cpu().numpy().copy() for sd in solver.get_internals('params') for v in sd.values()]


def load_burgers(path, mesh=None):
    """The Burgers solver saved at ``path`` (5k's, or an untrained one),
    loaded through a ``SolverConfig`` (the card's machine has no dill),
    onto ``mesh`` or none."""
    from neurodiffeq_tpu_torch.solvers import Solver2D
    from neurodiffeq_tpu_torch.solvers_utils import SolverConfig

    fresh = burgers_solver()
    return Solver2D.load(path, mesh=mesh, config=SolverConfig(
        pde_system=fresh.diff_eqs, conditions=fresh.conditions, nets=fresh.nets,
        train_generator=fresh.generator['train'], valid_generator=fresh.generator['valid']))


def polish_run(solver, sync, epochs, group=None):
    """Phase 5t (a) on ``solver`` (on a mesh, whose model group is
    ``group``): ``examples/burgers.py``'s ``polish_lbfgs``, ``set_generator``
    with the frozen draw and ``set_optimizer`` with ``torch.optim.LBFGS``,
    ``fit(1)`` ``epochs`` times: the first epoch's train loss and
    gathered parameters; per epoch the closure calls, L-BFGS iterations and
    the optimizer's own ``all_reduce`` calls; the rate over the epochs
    between the first and the last; over the last, the model group's
    ``all_reduce`` seconds (synchronized), all and the optimizer's own; the
    launches and fallbacks of the polish, the train losses, the elements of
    the L-BFGS state and parameters on this rank, and ``get_solution()`` on
    Burgers' grid."""
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator
    from neurodiffeq_tpu_torch.ops import taylor_mlp

    solver.set_generator(PredefinedGenerator(*polish_draw()))
    solver.set_optimizer(torch.optim.LBFGS(solver._parameters(), lr=1.0, max_iter=POLISH_ITERS,
                                           history_size=POLISH_HISTORY, line_search_fn='strong_wolfe'))
    opt, counts, own, timing = solver.optimizer, {'closures': 0, 'reductions': 0}, [0.0], [False]
    passes, reduce = solver._loss_and_metrics, getattr(opt, '_reduce', None)

    def counted(cols):
        counts['closures'] += torch.is_grad_enabled()  # validation batches run without a graph
        return passes(cols)

    def counted_reduce(flat):
        counts['reductions'] += 1
        if not timing[0]:
            return reduce(flat)
        sync()
        t1 = time.perf_counter()
        out = reduce(flat)
        sync()
        own[0] += time.perf_counter() - t1
        return out

    solver._loss_and_metrics = counted
    if group is not None:
        opt._reduce = counted_reduce
    per_epoch, start = [], len(solver.metrics_history['train_loss'])

    def epoch():
        before, n_iter = dict(counts), opt.state[opt._params[0]].get('n_iter', 0)
        solver.fit(1, tqdm_file=None)
        per_epoch.append({**{k: counts[k] - before[k] for k in counts},
                          'iterations': opt.state[opt._params[0]]['n_iter'] - n_iter})

    F.reset_taylor_fallback_count()
    taylor_mlp.reset_launches()
    epoch()
    first = (solver.metrics_history['train_loss'][-1], full_params(solver))
    sync()
    t0 = time.perf_counter()
    for _ in range(epochs - 2):
        epoch()
    sync()
    rate = (epochs - 2) / (time.perf_counter() - t0)
    spent, timing[0] = [0.0, 0], True
    restore = timed_collective('all_reduce', sync, spent, group) if group is not None else (lambda: None)
    try:
        epoch()
    finally:
        restore()
        timing[0] = False
    del solver._loss_and_metrics
    launches, fallbacks = dict(taylor_mlp.LAUNCHES), F.taylor_fallback_count()
    last = per_epoch[-1]['closures']
    return {'first': first, 'epochs': per_epoch, 'rate': rate, 'launches': launches, 'fallbacks': fallbacks,
            'model_ms': (spent[0] / last * 1e3, own[0] / last * 1e3, spent[1] / last),
            'history': list(solver.metrics_history['train_loss'][start:]),
            'elements': (state_elements(opt), sum(p.numel() for p in solver._parameters())),
            'solution': burgers_solution(solver)}


def optim_runs(mesh, init, rng_state, grads):
    """Phase 5t (b) on ``mesh`` (or none): the flagship from ``init`` and the
    generator state ``rng_state``, ``OPT_EPOCHS`` epochs with
    ``torch.optim.Adafactor`` and with ``torch.optim.Muon`` over the 2-D
    weights: the gathered parameters after each epoch and the optimizer
    state's elements on this rank; and one Muon step from the full-size
    gradients ``grads`` (this rank's block of each): the gathered
    parameters."""
    from neurodiffeq_tpu_torch.parallel.sharding import stored_blocks
    from neurodiffeq_tpu_torch.utils import get_default_device

    def flagship():
        gen = torch.Generator(device=get_default_device())
        gen.set_state(rng_state)
        solver = flagship_solver(mesh=mesh, generator=gen)
        solver.load_params([init])
        return solver

    makers = {'Adafactor': lambda params: torch.optim.Adafactor(params, lr=OPT_LR),
              'Muon': lambda params: torch.optim.Muon([p for p in params if p.ndim == 2], lr=OPT_LR)}
    out = {}
    for name, make in makers.items():
        solver = flagship()
        solver.set_optimizer(make(solver._parameters()))
        params = []
        for _ in range(OPT_EPOCHS):
            solver.fit(1, tqdm_file=None)
            params.append(full_params(solver))
        out[name] = (params, state_elements(solver.optimizer))
    solver = flagship()
    solver.set_optimizer(makers['Muon'](solver._parameters()))
    blocks = stored_blocks(solver._unique_nets)
    for p, g in zip([p for p in solver._parameters() if p.ndim == 2], grads, strict=True):
        g = torch.as_tensor(g, device=p.device)
        p.grad = blocks[p].right_inverse(g) if p in blocks else g
    solver.optimizer.step()
    out['Muon step'] = full_params(solver)
    return out


def polish_rank(backend, devices, init, rng_state, sync, path, grads, epochs):
    """Phase 5t in one rank: on ``make_mesh(model_axis_size=MODEL_AXIS)``
    over the ranks, Burgers' polish from the solver saved at ``path``
    (:func:`polish_run`) and the flagship's Adafactor and Muon runs
    (:func:`optim_runs`); ``epochs`` polish epochs."""
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes

    mesh = make_mesh(devices=devices, backend=backend, model_axis_size=MODEL_AXIS)
    out = {'polish': polish_run(load_burgers(path, mesh), sync, epochs, mesh_axes(mesh).model.get_group())}
    out.update(optim_runs(mesh, init, rng_state, grads))
    return out


def save_burgers(burgers, path):
    """5t's start, saved at ``path``: 5k's solver ``burgers``, or where 5k did
    not run the Burgers net at ``POLISH_SEED``. Returns 5k's mean error on
    Burgers' grid (None without 5k)."""
    from neurodiffeq_tpu_torch.utils import set_seed

    if burgers is None:
        set_seed(POLISH_SEED)
        burgers_solver().save(path)
        return None
    burgers.save(path)
    return float(np.abs(burgers_solution(burgers) - burgers_reference()[2]).mean())


def flagship_weight_grads(init, rng_state):
    """The unsharded flagship's first-epoch gradients of its 2-D weights from
    ``init`` and the generator state ``rng_state`` (5t's Muon step)."""
    from neurodiffeq_tpu_torch.utils import get_default_device

    gen = torch.Generator(device=get_default_device())
    gen.set_state(rng_state)
    ref = flagship_solver(generator=gen)
    ref.load_params([init])
    loss, _ = ref._loss_and_metrics(ref._generate_batch('train'))
    ref._backward(loss)
    return [p.grad.detach().cpu().numpy() for p in ref._parameters() if p.ndim == 2]


def run_polish(taylor_mlp, card, outs, backend, world, launch_s, checks, inputs, before, sync):
    """Phase 5t's checks on the ranks' :func:`polish_rank` results ``outs``
    against the same runs unsharded here (from ``inputs``, what the ranks
    started from): (a) the first polish epoch's loss and parameters within
    ``SHARD_GRAD_TOL`` of unsharded, its closure calls equal on every rank
    and to unsharded, the rest of the epochs' equal on every rank, the
    optimizer's model-group reductions per closure call and iteration, the
    loss on the frozen draw falling, every rank the same history,
    ``POLISH_PASS`` launches per pass on each rank and one ``taylor_mlp``
    unsharded, no fallback, and (after 5k, ``before`` its mean error) the
    mean error against Cole-Hopf below before and below
    ``POLISH_MEAN_LIMIT``; (b) Adafactor within ``SHARD_GRAD_TOL`` after each
    epoch, Muon's step from one gradient within ``MUON_STEP_TOL`` and its
    epochs within ``MUON_EPOCH_TOL``, the optimizer state per rank
    ``OPT_PER_RANK``. Returns the launches summed over the ranks."""
    (path, grads, _), (init, rng_state) = inputs
    plain = polish_run(load_burgers(path), sync, POLISH_EPOCHS)
    plain_optim = optim_runs(None, init, rng_state, grads)
    polish, checks = [o['polish'] for o in outs], dict(checks)
    _, _, exact = burgers_reference()
    after = [float(np.abs(r['solution'] - exact).mean()) for r in polish]
    passes = [sum(e['closures'] for e in r['epochs']) + 4 * POLISH_EPOCHS for r in polish]
    plain_passes = sum(e['closures'] for e in plain['epochs']) + 4 * POLISH_EPOCHS
    first_err = max([rel(r['first'][0], plain['first'][0]) for r in polish]
                    + [rel(a, b) for r in polish for a, b in zip(r['first'][1], plain['first'][1], strict=True)])
    hist = polish[0]['history']
    checks.update({
        f'first polish epoch loss and parameters within {SHARD_GRAD_TOL} of unsharded': first_err < SHARD_GRAD_TOL,
        'closure calls per epoch equal on every rank': all(
            [e['closures'] for e in r['epochs']] == [e['closures'] for e in polish[0]['epochs']] for r in polish),
        'first epoch closure calls equal to unsharded': polish[0]['epochs'][0]['closures'] == plain['epochs'][0]['closures'],
        'optimizer all_reduces: 1 per closure call and 2 per iteration (1 fewer in the first)': all(
            e['reductions'] == e['closures'] + 2 * e['iterations'] - (i == 0)
            for r in polish for i, e in enumerate(r['epochs'])),
        'loss on the frozen draw fell': hist[-1] < hist[0] and plain['history'][-1] < plain['history'][0],
        'every rank the same history': all(r['history'] == hist for r in polish),
        f'{POLISH_PASS} per pass and one taylor_mlp_1h_bwd per closure call on each rank': all(
            r['launches'] == {**{k: v * n for k, v in POLISH_PASS.items()},
                              'taylor_mlp_1h_bwd': sum(e['closures'] for e in r['epochs'])}
            for r, n in zip(polish, passes)),
        'unsharded: taylor_mlp once per pass': plain['launches'] == {'taylor_mlp_1h': 0, 'taylor_mlp': plain_passes,
                                                                      'taylor_mlp_streams': 0, 'taylor_mlp_1h_bwd': 0},
        'no Taylor fallback': all(r['fallbacks'] == 0 for r in polish + [plain]),
    })
    if before is not None:
        checks.update({
            'mean error below after Adam': all(a < before for a in after),
            f'mean error < {POLISH_MEAN_LIMIT}': all(np.isfinite(a) and a < POLISH_MEAN_LIMIT for a in after)})
    each = lambda key, i, f='.3f': ' '.join(format(r[key][i] if i is not None else r[key], f) for r in polish)
    before_msg = f'before {before:.5f}, ' if before is not None else ''
    report('5t polish', f"{card}: Burgers 2-(20x8)-1 from {'5k' if before is not None else 'an untrained net'}, "
                        f"L-BFGS (strong Wolfe, max_iter {POLISH_ITERS}, history {POLISH_HISTORY}) for {POLISH_EPOCHS} "
                        f"epochs on {POLISH_POINTS} frozen points over {world} {backend} ranks, mesh "
                        f"({world // MODEL_AXIS}, {MODEL_AXIS}), in {launch_s:.1f} s with 5r and 5s: first epoch "
                        f"against unsharded {first_err:.2e} (relative); closure calls per epoch "
                        f"{[e['closures'] for e in polish[0]['epochs']]} (unsharded "
                        f"{[e['closures'] for e in plain['epochs']]}), iterations "
                        f"{[e['iterations'] for e in polish[0]['epochs']]}; train loss {hist[0]:.4e} -> {hist[-1]:.4e} "
                        f"(unsharded {plain['history'][0]:.4e} -> {plain['history'][-1]:.4e}); mean error against "
                        f"Cole-Hopf on 201 x 101 {before_msg}after {' '.join(f'{a:.5f}' for a in after)} (unsharded "
                        f"{float(np.abs(plain['solution'] - exact).mean()):.5f}); launches per rank "
                        f"{polish[0]['launches']} in {passes[0]} passes; L-BFGS history elements per rank "
                        f"{each('elements', 0, 'd')} over {polish[0]['elements'][1]} parameters (unsharded "
                        f"{plain['elements'][0]} over {plain['elements'][1]}); the model group's all_reduce per "
                        f"closure call, each rank (synchronized, last epoch): {each('model_ms', 0)} ms in "
                        f"{polish[0]['model_ms'][2]:.1f} calls, of which the optimizer's {each('model_ms', 1)} ms; "
                        f"epochs/s, each rank: {each('rate', None)} (unsharded {plain['rate']:.3f})",
           checks, "Burgers polish check failed")

    optim = {name: [o[name] for o in outs] for name in ('Adafactor', 'Muon', 'Muon step')}
    errs = {name: [max(rel(a, b) for a, b in zip(params, want, strict=True))  # per rank and epoch, over the leaves
                   for r in optim[name] for params, want in zip(r[0], plain_optim[name][0], strict=True)]
            for name in ('Adafactor', 'Muon')}
    step_err = max(rel(a, b) for r in optim['Muon step'] for a, b in zip(r, plain_optim['Muon step'], strict=True))
    elements = {name: [r[1] for r in optim[name]] for name in ('Adafactor', 'Muon')}
    checks = {
        f'Adafactor within {SHARD_GRAD_TOL} of unsharded after each epoch': max(errs['Adafactor']) < SHARD_GRAD_TOL,
        f"Muon's step from the unsharded gradient within {MUON_STEP_TOL}": step_err < MUON_STEP_TOL,
        f'Muon within {MUON_EPOCH_TOL} of unsharded after each epoch': max(errs['Muon']) < MUON_EPOCH_TOL,
        f'optimizer state per rank {OPT_PER_RANK}': all(
            all(n == OPT_PER_RANK[name][0] for n in elements[name]) and plain_optim[name][1] == OPT_PER_RANK[name][1]
            for name in elements),
    }
    report('5t optimizers', f"{card}: the flagship 2-512-1 on the same mesh, {OPT_EPOCHS} epochs each at lr "
                            f"{OPT_LR}: Adafactor against unsharded after each epoch "
                            f"{' '.join(f'{e:.2e}' for e in errs['Adafactor'])}, Muon (the 2-D weights) "
                            f"{' '.join(f'{e:.2e}' for e in errs['Muon'])}, Muon's step from the unsharded gradient "
                            f"{step_err:.2e} (relative); optimizer state elements per rank: Adafactor "
                            f"{elements['Adafactor']} of {plain_optim['Adafactor'][1]}, Muon {elements['Muon']} of "
                            f"{plain_optim['Muon'][1]}", checks, "model-axis optimizer check failed")
    return {k: sum(o['polish']['launches'][k] for o in outs) for k in taylor_mlp.LAUNCHES}


def main():
    args = sys.argv[1:]
    chosen = set(args[1].split(',')) if len(args) == 2 and args[0] == '--phases' else set()
    if args and (not chosen or not chosen <= set(PHASES + EXTRA_PHASES)):
        raise SystemExit(f"usage: python3 chip_smoke.py [--phases {','.join(PHASES + EXTRA_PHASES)}]; got {args}")
    chosen = chosen or set(PHASES)
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
    from neurodiffeq_tpu_torch.utils import full_precision_matmuls

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

    # ---- 3. kernels against the twin; SIREN against the plain engine; a wide input; mixed partials
    if '3' in chosen:
        errors = check_kernels(fcnn_taylor, fcnn_taylor_reference)
        stream_errors = check_streams(taylor_mlp)
        check_siren()
        check_wide_inputs(F, taylor_mlp)
        check_mixed()
    if '3c' in chosen:
        check_high_order()
    if '3d' in chosen:
        check_highdim(F, taylor_mlp)
    if '3e' in chosen:
        check_ops(F, taylor_mlp, card)
    # ---- 4. gradient
    if '4' in chosen:
        check_gradient(fcnn_taylor_reference)
    # ---- 5. the paths: the flagship (the main path), Solver2D's defaults,
    # Lotka-Volterra, spherical Poisson, the cavities, GenericSolver in 3-D,
    # the bundle, heat (Dirichlet, Neumann) and Burgers; the rates of 5d-5f
    # and 5h-5k are their own fits' windows
    paths, timed = {}, {}
    if '5a' in chosen:
        paths['5a'] = run_flagship(F, taylor_mlp)
    if '5b' in chosen:
        paths['5b'] = run_default_solver2d(F, taylor_mlp)
    if '5c' in chosen:
        paths['5c'], paths['5c h1'] = run_lv(F, taylor_mlp)
    labels = {'5d': 'spherical Poisson (train + 4 validation batches of 512 points)',
              '5e': f'primitive cavity (one train batch of {CAV_POINTS} points, no validation)',
              '5f': f'psi-omega cavity (one train batch of {CAV_POINTS} points, no validation)',
              '5h': 'solution bundle (train + 4 validation batches of 32 x 32 points)',
              '5i': 'heat, Dirichlet (train + 4 validation batches of 32 x 32 points)',
              '5j': 'heat, Neumann, compose path (train + 4 validation batches of 32 x 32 points)',
              '5k': 'Burgers, adaptive (scoring 8 x 2048, train 2048, 4 validation batches of 32 x 32)',
              '5l': f'Poisson d = 10, exact laplacian (one train batch of {HD_POINTS} points)',
              '5m': f'Poisson d = 100, stde_laplacian, compose path (one train batch of {HD_POINTS} points)',
              '5n': f'clamped plate d = {PLATE_DIM}, exact biharmonic (one train batch of {PLATE_POINTS} points)',
              '5o': 'stiff oscillator (train + 4 validation batches of 32 points, 2 nets; the rate with 3 callbacks)'}
    runs = {'5d': run_sph, '5e': run_cavity, '5f': run_psi, '5g': run_generic_3d, '5h': run_bundle,
            '5i': run_heat, '5j': run_heat_neumann, '5k': run_burgers, '5l': run_poisson10, '5m': run_poisson100,
            '5n': run_plate, '5o': run_oscillator, '5p': run_temporal, '5q': run_legacy}
    for name, run in runs.items():
        if name in chosen:
            out = run(F, taylor_mlp)
            if name in ('5p', '5q'):  # several problems each: their launches summed, each timed
                paths[name], more = out
                timed.update(more)
                continue
            if name == '5i':
                out, paths['5i h1'] = out[:4], out[4]
            paths[name] = out if name == '5g' else out[0]
            if name in labels:
                timed[labels[name]] = out
    if chosen & {'5r', '5s', '5t'}:  # one spawn of ranks for all three; 5t polishes 5k's solver where 5k ran
        paths.update(run_sharded(F, taylor_mlp, card, chosen & {'5r', '5s', '5t'},
                                 burgers=timed[labels['5k']][1] if '5k' in chosen else None))

    # ---- 6. timing
    if '6' in chosen:
        times = time_shapes(card, taylor_mlp)
        bwd_times = time_backward_kernel(card, taylor_mlp)
        stream_times = time_streams(card, taylor_mlp)
        time_end_to_end(card, taylor_mlp)
        time_epochs(card, 'Lotka-Volterra (train + 4 validation batches, 2 nets)', lv_solver())
        for dims in ((2,) + CAV_HIDDEN + (3,), (2,) + CAV_HIDDEN + (2,)):
            time_backward(card, dims, CAV_POINTS)
        for label, (_, solver, step_schedule, rates) in timed.items():
            time_epochs(card, label, solver, [step_schedule] if step_schedule else [], rates)
    if '6b' in chosen:  # 5m's epoch in the design before this slice's batching (3.5-13 s per epoch)
        time_epochs(card, 'Poisson d = 100, per-coordinate fields and one Hessian-vector product per probe',
                    naive_highdim_solver(), own=(1, 1, 1), profiled=1)
    if chosen != set(PHASES):
        phase('7 result', f"phases {sorted(chosen)} only: launches per path {paths}; no result line")
        return

    # ---- 7. result: launches summed over the paths of phase 5
    phase('7 result', f"launches per path: {paths}")
    record = {'kernels': []}
    recorded = [(name, times[key], errors[key]) for name, key in RECORD_SHAPES.items()]
    recorded.append(('taylor_mlp_streams', stream_times[STREAM_SHAPES[0]], stream_errors[(STREAM_SHAPES[0], F32)]))
    recorded.append(('taylor_mlp_1h_bwd', bwd_times[BWD_RECORD][:4], bwd_times[BWD_RECORD][4]))
    for name, (k_us, t_us, b_ms, b_by), err in recorded:
        record['kernels'].append({
            'name': name, 'route': 'cuda', 'replaces': BWD_REPLACES if name == 'taylor_mlp_1h_bwd' else REPLACES,
            'source': STREAMS_SOURCE if name == 'taylor_mlp_streams' else KERNEL_SOURCE,
            'launches': sum(p.get(name, 0) for p in paths.values()), 'max_abs_err': err, 'ms': k_us / 1e3,
            'plain_ms': t_us / 1e3, 'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None})
    print(card)
    print(json.dumps(record))
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
