"""The rank side of ``tests/test_torch_parallel.py``.

``neurodiffeq_tpu_torch.parallel.launch`` spawns the ranks and pickles the
function it runs by name, so every rank imports this module. It imports
neither JAX nor the JAX package: a rank runs the port alone. The solvers
are built here (``build``) so that the test process builds the same ones
unsharded. Everything is float64 on the CPU.
"""
import os
import sys

import numpy as np
import torch

F64 = torch.float64


def _nets(kind, n_in=1, n_out=1):
    from neurodiffeq_tpu_torch.networks import FCNN, SIREN, FourierFCNN

    if kind == 'siren':
        return SIREN(n_input_units=n_in, n_output_units=n_out, hidden_units=(16, 16), w0=5.0, dtype=F64)
    if kind == 'fourier':
        return FourierFCNN(n_input_units=n_in, n_output_units=n_out, n_features=8, sigma=1.0, hidden_units=(16,),
                           dtype=F64)
    return FCNN(n_input_units=n_in, n_output_units=n_out, hidden_units=kind, dtype=F64)


def extra_loss(form):
    """An ``additional_loss`` override: ``'mean'`` 0.1 mean(u^2), or
    ``'global'`` 0.1 max |u| over the batch, a term the blocks cannot sum;
    ``'undeclared'``, the max with no ``shard_form``. Under a mesh a
    ``'global'`` term receives the gathered batch as plain tensors."""
    def additional_loss(self, residual, funcs, coords):
        u = funcs[0] if torch.is_tensor(funcs[0]) else funcs[0].value
        return 0.1 * (u ** 2).mean() if form == 'mean' else 0.1 * u.abs().max()

    if form != 'undeclared':
        additional_loss.shard_form = form
    return additional_loss


def build(mesh=None, problem='first', n=64, loss='l2', net=(16, 16), residual_weights=None, method='equally-spaced',
          n_batches_train=1, n_batches_valid=0, optimizer=None, seed=7, adaptive=None, oversample=4, metric=False,
          extra=None):
    """A port solver of ``problem`` on ``mesh`` (None: unsharded), seeded
    by ``seed``, float64 on the CPU. The problems are
    ``tests/test_parallel.py``'s: 'first' du/dt + u = 0 and 'second' its
    second-order variant (IVP(0, 1) on [0, 2]), 'weighted' two scaled
    copies of 'first' on [0, 1], 'energy' the Deep Ritz density of -u'' =
    pi^2 sin(pi t) with zero ends, 'oscillator' u' = v, v' = -25 u (two
    nets), 'stde_laplacian' and 'stde_biharmonic' in d = 3 and 'halton' a
    d = 2 Poisson problem on scrambled Halton points (``GenericSolver``),
    and 'flagship' the 2-D Laplace problem on an 8 x 8 grid. ``metric``
    adds max |u| over the batch, a metric that needs the whole batch;
    ``extra``, an ``additional_loss`` of that form (:func:`extra_loss`)."""
    from neurodiffeq_tpu_torch import conditions as C, diff, fields as F
    from neurodiffeq_tpu_torch import generators as G, solvers as S
    from neurodiffeq_tpu_torch.losses import causal
    from neurodiffeq_tpu_torch.operators import laplacian, stde_biharmonic, stde_laplacian
    from neurodiffeq_tpu_torch.utils import set_seed

    set_seed(seed)
    loss_fn = causal(epsilon=2.0, n_bins=4) if loss == 'causal' else loss
    common = dict(loss_fn=loss_fn, residual_weights=residual_weights, n_batches_train=n_batches_train,
                  n_batches_valid=n_batches_valid, dtype=F64, mesh=mesh,
                  metrics={'umax': lambda u, *coords: u.abs().max()} if metric else None)
    if problem in ('stde_laplacian', 'stde_biharmonic', 'halton'):
        d = 2 if problem == 'halton' else 3
        if problem == 'stde_laplacian':
            eqs = lambda u, *xs: [stde_laplacian(u, *xs, n_est=4) + sum(F.sin(np.pi * x) for x in xs)]  # noqa: E731
        elif problem == 'stde_biharmonic':
            eqs = lambda u, *xs: [stde_biharmonic(u, *xs, n_est=2)  # noqa: E731
                                  - sum(F.sin(np.pi * x) for x in xs) * np.pi ** 4 / d]
        else:
            eqs = lambda u, *xs: [laplacian(u, *xs) + sum(F.sin(np.pi * x) for x in xs)]  # noqa: E731
        train = G.GeneratorHypercube(n, dim=d, method='halton' if problem == 'halton' else 'uniform', dtype=F64)
        return S.GenericSolver(diff_eqs=eqs, conditions=[C.DirichletBoxND(d, power=2 if 'bih' in problem else 1)],
                               nets=[_nets(net, d)], train_generator=train,
                               valid_generator=G.GeneratorHypercube(n, dim=d, dtype=F64), **common)
    if problem == 'flagship':
        cond = C.DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                                y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x), y_max=1.0,
                                y_max_val=lambda x: 0 * x)
        return S.Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)], conditions=[cond],
                          nets=[_nets((16,), 2)],
                          train_generator=G.Generator2D((8, 8), (0, 0), (1, 1), method=method, dtype=F64),
                          valid_generator=G.Generator2D((8, 8), (0, 0), (1, 1), method='equally-spaced', dtype=F64),
                          **common)
    t1 = 1.0 if problem in ('weighted', 'energy') else 2.0
    nets = [_nets(net), _nets(net)] if problem == 'oscillator' else [_nets(net)]
    if optimizer == 'lbfgs':
        common['optimizer'] = torch.optim.LBFGS([p for m in nets for p in m.parameters()], lr=0.5, max_iter=4)
    conditions = [C.IVP(0.0, 1.0)]
    if problem == 'first':
        eqs = lambda u, t: [diff(u, t) + u]  # noqa: E731
    elif problem == 'second':
        eqs = lambda u, t: [diff(u, t, 2) + diff(u, t) + u]  # noqa: E731
    elif problem == 'weighted':
        eqs = lambda u, t: [diff(u, t) + u, 3.0 * (diff(u, t) + u)]  # noqa: E731
    elif problem == 'energy':
        eqs = lambda u, t: [0.5 * diff(u, t) ** 2 - (np.pi ** 2) * F.sin(np.pi * t) * u]  # noqa: E731
        conditions = [C.DirichletBVP(t_0=0.0, u_0=0.0, t_1=1.0, u_1=0.0)]
    elif problem == 'oscillator':
        eqs = lambda u, v, t: [diff(u, t) - v, diff(v, t) + 25.0 * u]  # noqa: E731
        conditions = [C.IVP(0.0, 1.0), C.IVP(0.0, 0.0)]
    else:
        raise ValueError(problem)
    train = G.Generator1D(n, 0.0, t1, method=method, dtype=F64)
    if adaptive is not None:
        train = G.ResidualAdaptiveGenerator(train, oversample=oversample, strategy=adaptive)
    solver_class = S.Solver1D
    if extra is not None:
        solver_class = type('ExtraLossSolver1D', (S.Solver1D,), {'additional_loss': extra_loss(extra)})
    return solver_class(ode_system=eqs, conditions=conditions, nets=nets, train_generator=train,
                        valid_generator=G.Generator1D(n, 0.0, t1, method='equally-spaced', dtype=F64), **common)


def grads(solver):
    """Every trained parameter's gradient, in ``solver._parameters()`` order."""
    return [p.grad.detach().numpy().copy() for p in solver._parameters()]


def params(solver):
    return [p.detach().numpy().copy() for p in solver._parameters()]


def loss_and_grads(solver, cols):
    """The global loss and gradients at ``cols`` (numpy columns): the share
    and its gradients of this rank, summed over the ranks as one optimizer
    step sums them (without a mesh, the plain loss)."""
    solver.optimizer.zero_grad(set_to_none=True)
    loss, _ = solver._loss_and_metrics([torch.tensor(c) for c in cols])
    solver._backward(loss)
    if solver.mesh is not None:
        loss = solver._reduce_grads(loss)
    return float(loss.detach()), grads(solver)


# ---------------------------------------------------------------- the cases
# each takes the mesh (None: the unsharded run in the test process) and its
# spec, and returns numpy data


def case_mesh(mesh):
    from neurodiffeq_tpu_torch.utils import get_default_device
    return {'names': tuple(mesh.mesh_dim_names), 'size': mesh.size(), 'rank': mesh.get_local_rank(),
            'device': str(get_default_device())}


def case_loss_grads(mesh, spec, jax_params, cols):
    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    return loss_and_grads(solver, cols)


def case_probes(mesh, spec, cols):
    """The probes of this rank's rows (the unsharded run's, all rows) and
    the loss and gradients at ``cols``."""
    from neurodiffeq_tpu_torch import operators as O
    from neurodiffeq_tpu_torch.parallel.sharding import RowShard

    solver = build(mesh, **spec)
    pts = torch.tensor(np.concatenate(cols, axis=1))
    shard = RowShard(mesh, pts.shape[0]) if mesh is not None else None
    lo, hi = (shard.lo, shard.hi) if shard is not None else (0, pts.shape[0])
    lap = O._stde_probes(pts[lo:hi], range(3), 4, 0, 2, (hi - lo, 4, 3), shard).numpy()
    bih = O._stde_probes(pts[lo:hi], range(3), 2, 0, 4, (hi - lo, 2, 2, 3), shard).numpy()
    return (lo, hi, lap, bih), loss_and_grads(solver, cols)


def case_fit(mesh, spec, epochs, load=None):
    """``fit(epochs)``: the histories, the parameters and each epoch's train
    batch (the adaptive pick); ``load``, JAX parameters to start from."""
    solver = build(mesh, **spec)
    if load is not None:
        solver.load_jax_params(load)
    batches = []
    solver.fit(epochs, callbacks=[lambda s: batches.append([c.numpy().copy() for c in s.batch['train']])],
               tqdm_file=None)
    return solver.metrics_history, params(solver), batches


class FileWriter:
    """A TensorBoard-style writer (``add_scalar``) that appends a line per
    scalar to ``path``."""

    def __init__(self, path):
        self.path = path

    def add_scalar(self, tag, scalar_value, global_step):
        with open(self.path, 'a') as f:
            f.write(f'{tag} {global_step} {scalar_value!r}\n')


def case_weights(mesh, spec, epochs, workdir):
    """``AutoResidualWeightCallback`` on every epoch, a 'state_dict'
    checkpoint every 2 epochs and ``SimpleTensorboardCallback``, each rank
    writing into a directory of its own under ``workdir``: the weights, and
    the files each rank wrote."""
    from neurodiffeq_tpu_torch import callbacks as cb

    here = os.path.join(workdir, 'plain' if mesh is None else f'rank{mesh.get_local_rank()}')
    os.makedirs(here)
    solver = build(mesh, **spec)
    weights = cb.AutoResidualWeightCallback(rate=0.5, freeze_tol=0.0)
    ckpt = cb.CheckpointCallback(os.path.join(here, 'ckpt'), format='state_dict').conditioned_on(cb.PeriodLocal(2))
    scalars = cb.SimpleTensorboardCallback(writer=FileWriter(os.path.join(here, 'scalars.txt')))
    solver.fit(epochs, callbacks=[weights, ckpt, scalars], tqdm_file=None)
    written = sorted(os.path.relpath(os.path.join(d, f), here) for d, _, files in os.walk(here) for f in files)
    return weights.weight_history, solver.residual_weights, written


def case_save(mesh, spec, epochs, path, load_path):
    """Train and save under the mesh (rank 0 writes); and load onto the
    mesh a solver saved without one."""
    from neurodiffeq_tpu_torch.solvers import Solver1D

    solver = build(mesh, **spec)
    solver.fit(epochs, tqdm_file=None)
    solver.save(path)
    loaded = Solver1D.load(load_path, mesh=mesh, device='cpu')
    return params(solver), solver.metrics_history, params(loaded), loaded.metrics_history, loaded.mesh is mesh


def case_undeclared(mesh, what):
    """A loss (``what='loss'``) or an ``additional_loss`` (``'extra'``) with
    no ``shard_form``: the message it raises under the mesh."""
    if what == 'loss':
        solver = build(mesh, loss=lambda residual, funcs, coords: (residual.value ** 2).mean())
    else:
        solver = build(mesh, extra='undeclared')
    try:
        solver._loss_and_metrics([torch.linspace(0.0, 2.0, 64, dtype=F64).reshape(-1, 1)])
    except ValueError as e:
        return str(e)
    return None


CASES = {'mesh': case_mesh, 'undeclared': case_undeclared, 'loss_grads': case_loss_grads, 'probes': case_probes,
         'fit': case_fit, 'weights': case_weights, 'save': case_save}


def run_cases(cases):
    """Run ``cases`` (``{key: (case name, kwargs)}``) in order on the mesh
    of this rank's process group; returns ``{key: result}`` and, under
    ``'imports'``, the JAX modules this process imported (none)."""
    from neurodiffeq_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    out = {key: CASES[name](mesh, **kwargs) for key, (name, kwargs) in cases.items()}
    out['imports'] = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neurodiffeq_tpu'))
    return out


def run_plain(cases):
    """The same cases without a mesh, in this process."""
    return {key: CASES[name](None, **kwargs) for key, (name, kwargs) in cases.items() if name != 'mesh'}


def hang(rank_that_waits):
    """A rank that never joins the collective the others wait in."""
    import time
    import torch.distributed as dist

    if dist.get_rank() == rank_that_waits:
        time.sleep(600)
    dist.all_reduce(torch.zeros(1))


def fail_on(rank_that_fails):
    import torch.distributed as dist

    if dist.get_rank() == rank_that_fails:
        raise ValueError(f'rank {rank_that_fails} fails on purpose')
    dist.all_reduce(torch.zeros(1))
    return dist.get_rank()


def cuda_case(backend, devices, epochs):
    """On the card: the flagship at full width (FCNN 2-512-1, 32 x 32) in
    float32 on ``make_mesh(devices=devices, backend=backend)``, seeded
    alike on every rank: the first ``epochs`` epochs' losses and the
    gradients of the last."""
    from neurodiffeq_tpu_torch import conditions as C, diff, fields as F
    from neurodiffeq_tpu_torch import generators as G, solvers as S
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.utils import set_seed

    mesh = make_mesh(devices=devices, backend=backend) if backend else None
    set_seed(0)
    f32 = torch.float32
    cond = C.DirichletBVP2D(x_min=0.0, x_min_val=lambda y: 0 * y, x_max=1.0, x_max_val=lambda y: 0 * y,
                            y_min=0.0, y_min_val=lambda x: F.sin(np.pi * x), y_max=1.0, y_max_val=lambda x: 0 * x)
    solver = S.Solver2D(pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)], conditions=[cond],
                        nets=[FCNN(2, 1, hidden_units=(512,), dtype=f32)],
                        train_generator=G.Generator2D((32, 32), (0, 0), (1, 1), method='equally-spaced-noisy',
                                                      dtype=f32),
                        valid_generator=G.Generator2D((32, 32), (0, 0), (1, 1), method='equally-spaced', dtype=f32),
                        dtype=f32, mesh=mesh)
    solver.fit(epochs, tqdm_file=None)
    return solver.metrics_history['train_loss'], [p.grad.cpu().numpy() for p in solver._parameters()]
