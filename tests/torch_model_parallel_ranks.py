"""The rank side of ``tests/test_torch_model_parallel.py``: the port on a
``(points, model)`` mesh.

``neurodiffeq_tpu_torch.parallel.launch`` spawns the ranks and pickles the
function it runs by name, so every rank imports this module. It imports
neither JAX nor the JAX package. The solvers are built here (``build``) so
that the test process builds the same ones unsharded. Everything is
float64 on the CPU.
"""
import sys

import numpy as np
import torch

import torch_parallel_ranks as R

F64 = torch.float64


def build(mesh=None, problem='second', hidden=(32, 32), n=32, n_batches_train=1, method='equally-spaced',
          loss='l2', seed=7):
    """A port solver of ``problem`` on ``mesh`` (None: unsharded), float64
    on the CPU: 'second' the second-order ODE of ``tests/test_parallel.py``
    (``torch_parallel_ranks.build``) on an FCNN 1-``hidden``-1; 'flagship'
    the 2-D Laplace problem of ``__graft_entry__._flagship_solver`` on an
    FCNN 2-``hidden``-1 and a 4 x 4 grid; 'cavity' the primitive (u, v, p)
    lid-driven cavity (``chip_smoke.cavity_problem``) with one FCNN
    2-``hidden``-3 shared by its three conditions, on ``n`` points."""
    import chip_smoke as cs
    from neurodiffeq_tpu_torch import generators as G, solvers as S
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.utils import set_seed

    if problem == 'second':
        return R.build(mesh, problem='second', n=n, net=hidden, n_batches_train=n_batches_train, method=method,
                       loss=loss, seed=seed)
    set_seed(seed)
    common = dict(n_batches_train=n_batches_train, n_batches_valid=0, dtype=F64, mesh=mesh, loss_fn=loss)
    if problem == 'flagship':
        return cs.laplace_solver(nets=[FCNN(2, 1, hidden_units=hidden, dtype=F64)],
                                 train_generator=G.Generator2D((4, 4), (0, 0), (1, 1), method=method, dtype=F64),
                                 valid_generator=G.Generator2D((4, 4), (0, 0), (1, 1), dtype=F64), **common)
    conds, equations, _ = cs.cavity_problem('primitive')
    net = FCNN(2, 3, hidden_units=hidden, dtype=F64)
    gen = G.Generator2D((4, n // 4), (0, 0), (1, 1), method=method, dtype=F64)
    return S.Solver2D(pde_system=equations, conditions=conds, xy_min=(0, 0), xy_max=(1, 1), nets=[net] * 3,
                      train_generator=gen, valid_generator=gen, **common)


def case_layout(mesh, hidden):
    """``megatron_param_shardings`` of an FCNN 2-``hidden``-1 and this
    rank's blocks of its split leaves."""
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.parallel import megatron_param_shardings
    from neurodiffeq_tpu_torch.parallel.sharding import model_grad_slices

    net = FCNN(2, 1, hidden_units=hidden, dtype=F64)
    names = {p: name for name, p in net.named_parameters()}
    return megatron_param_shardings(net, mesh), {names[p]: v for p, v in model_grad_slices([net], mesh).items()}


def case_loss_grads(mesh, spec, jax_params, cols):
    """The global loss and every gradient at ``cols`` from the JAX
    parameters, and the Taylor-MLP launches per kernel that the pass made
    (on the CPU, the twin calls ``cpu_rehearsal.counted`` counts)."""
    from neurodiffeq_tpu_torch.ops import taylor_mlp

    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    taylor_mlp.reset_launches()
    out = R.loss_and_grads(solver, cols)
    return out, dict(taylor_mlp.LAUNCHES)


def case_epoch(mesh, spec, jax_params):
    """One training epoch from the JAX parameters: the parameters after it
    and its train loss."""
    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    solver.run_train_epoch()
    return R.params(solver), solver.metrics_history['train_loss']


def case_fit(mesh, spec, epochs):
    solver = build(mesh, **spec)
    solver.fit(epochs, tqdm_file=None)
    return solver.metrics_history, R.params(solver)


CASES = {'layout': case_layout, 'loss_grads': case_loss_grads, 'epoch': case_epoch, 'fit': case_fit}


def run_cases(model_axis_size, cases, bad_model_axis_size=None):
    """Run ``cases`` (``{key: (case name, kwargs)}``) in order on
    ``make_mesh(model_axis_size=...)`` of this rank's process group;
    returns ``{key: result}``, this rank's ``(points, model)`` index under
    ``'index'``, the message of ``make_mesh(model_axis_size=
    bad_model_axis_size)`` under ``'bad'`` and the JAX modules this process
    imported (none) under ``'imports'``."""
    import cpu_rehearsal
    from neurodiffeq_tpu_torch.ops import taylor_mlp
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes

    cpu_rehearsal.counted(taylor_mlp)  # each fused twin call counted as the launch it is on the card
    bad = None if bad_model_axis_size is None else bad_model_axis(bad_model_axis_size)
    mesh = make_mesh(model_axis_size=model_axis_size)
    axes = mesh_axes(mesh)
    out = {key: CASES[name](mesh, **kwargs) for key, (name, kwargs) in cases.items()}
    out['index'] = (tuple(mesh.mesh_dim_names), axes.points.get_local_rank(), axes.model.get_local_rank())
    out['bad'] = bad
    out['imports'] = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'neurodiffeq_tpu'))
    return out


def run_plain(cases):
    """The same cases without a mesh, in this process."""
    return {key: CASES[name](None, **kwargs) for key, (name, kwargs) in cases.items() if name in ('epoch', 'fit')}


def bad_model_axis(model_axis_size):
    """The message of ``make_mesh(model_axis_size=...)`` where it does not
    divide the world, or None."""
    from neurodiffeq_tpu_torch.parallel import make_mesh
    try:
        make_mesh(model_axis_size=model_axis_size)
    except ValueError as e:
        return str(e)
    return None


def columns(n, d, seed):
    """``d`` columns of ``n`` points in [0, 1) from numpy's seeded stream."""
    pts = np.random.RandomState(seed).rand(n, d)
    return [pts[:, i:i + 1] for i in range(d)]


def cuda_case(model_axis_size):
    """On the card: the second-order ODE on an FCNN 1-(32, 32)-1 in float64
    at 32 fixed points, on ``make_mesh(model_axis_size=...)`` of this rank's
    process group (None: unsharded): the device, the mesh index, the loss,
    every gradient and the kernel launches of the pass."""
    from neurodiffeq_tpu_torch.ops import taylor_mlp
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes
    from neurodiffeq_tpu_torch.utils import get_default_device

    mesh = None if model_axis_size is None else make_mesh(model_axis_size=model_axis_size)
    solver = build(mesh)
    taylor_mlp.reset_launches()
    solver.optimizer.zero_grad(set_to_none=True)
    loss, _ = solver._loss_and_metrics([torch.tensor(2.0 * columns(32, 1, 3)[0], device=solver.device)])
    solver._backward(loss)
    if mesh is not None:
        loss = solver._reduce_grads(loss)
    axes = None if mesh is None else mesh_axes(mesh)
    index = None if mesh is None else (axes.points.get_local_rank(), axes.model.get_local_rank())
    return (str(get_default_device()), index, float(loss.detach()), [p.grad.cpu().numpy() for p in solver._parameters()],
            dict(taylor_mlp.LAUNCHES))
