"""The rank side of ``tests/test_torch_model_parallel.py``: the port on a
``(points, model)`` mesh.

``neurodiffeq_tpu_torch.parallel.launch`` spawns the ranks and pickles the
function it runs by name, so every rank imports this module. It imports
neither JAX nor the JAX package. The solvers are built here (``build``) so
that the test process builds the same ones unsharded. Everything is
float64 on the CPU. A rank stores its blocks of the split leaves, so the
parameters and gradients that the cases return are gathered to full size
(:func:`full_params`, :func:`full_grads`), as a solution or a saved file
holds them.
"""
import os
import sys
import warnings

import numpy as np
import torch

import torch_parallel_ranks as R

F64 = torch.float64


def build(mesh=None, problem='second', hidden=(32, 32), n=32, n_batches_train=1, method='equally-spaced',
          loss='l2', seed=7, kind='fcnn'):
    """A port solver of ``problem`` on ``mesh`` (None: unsharded), float64
    on the CPU: 'second' the second-order ODE of ``tests/test_parallel.py``
    (``torch_parallel_ranks.build``) on an FCNN 1-``hidden``-1; 'flagship'
    the 2-D Laplace problem of ``__graft_entry__._flagship_solver`` on an
    FCNN 2-``hidden``-1 (a SIREN with ``kind='siren'``) and a 4 x 4 grid;
    'cavity' the primitive (u, v, p)
    lid-driven cavity (``chip_smoke.cavity_problem``) with one FCNN
    2-``hidden``-3 shared by its three conditions, on ``n`` points."""
    import chip_smoke as cs
    from neurodiffeq_tpu_torch import generators as G, solvers as S
    from neurodiffeq_tpu_torch.networks import FCNN, SIREN
    from neurodiffeq_tpu_torch.utils import set_seed

    if problem == 'second':
        return R.build(mesh, problem='second', n=n, net=hidden, n_batches_train=n_batches_train, method=method,
                       loss=loss, seed=seed)
    set_seed(seed)
    common = dict(n_batches_train=n_batches_train, n_batches_valid=0, dtype=F64, mesh=mesh, loss_fn=loss)
    if problem == 'flagship':
        net = (SIREN(2, 1, hidden_units=hidden, w0=5.0, dtype=F64) if kind == 'siren'
               else FCNN(2, 1, hidden_units=hidden, dtype=F64))
        return cs.laplace_solver(nets=[net],
                                 train_generator=G.Generator2D((4, 4), (0, 0), (1, 1), method=method, dtype=F64),
                                 valid_generator=G.Generator2D((4, 4), (0, 0), (1, 1), dtype=F64), **common)
    conds, equations, _ = cs.cavity_problem('primitive')
    net = FCNN(2, 3, hidden_units=hidden, dtype=F64)
    gen = G.Generator2D((4, n // 4), (0, 0), (1, 1), method=method, dtype=F64)
    return S.Solver2D(pde_system=equations, conditions=conds, xy_min=(0, 0), xy_max=(1, 1), nets=[net] * 3,
                      train_generator=gen, valid_generator=gen, **common)


def _unique(nets):
    return list({id(n): n for n in nets}.values())


def full_params(solver):
    """Every parameter at full size (the blocks of a model axis gathered),
    in the order of an unsharded solver's ``_parameters()``."""
    return [p.detach().cpu().numpy().copy() for net in _unique(solver._nets_for(best=False)) for p in net.parameters()]


def full_grads(solver):
    """Every gradient at full size, gathered as :func:`full_params`."""
    from neurodiffeq_tpu_torch.parallel.sharding import full_state

    out = []
    for net, plain in zip(solver._unique_nets, _unique(solver._nets_for(best=False))):
        grads = full_state(net, {k: p.grad for k, p in net.named_parameters()})
        out += [grads[k].detach().cpu().numpy().copy() for k, _ in plain.named_parameters()]
    return out


def counting_collectives(solver):
    """Record every ``all_reduce`` that ``solver._reduce_grads`` (the
    gradient step's sum) makes, as ``(group size, elements)``; returns the
    list it fills."""
    import torch.distributed as dist

    calls, reduce = [], solver._reduce_grads

    def counted(*args, **kwargs):
        original = dist.all_reduce

        def all_reduce(tensor, group=None, **kw):
            calls.append((dist.get_world_size(group), tensor.numel()))
            return original(tensor, group=group, **kw)

        dist.all_reduce = all_reduce
        try:
            return reduce(*args, **kwargs)
        finally:
            dist.all_reduce = original

    solver._reduce_grads = counted
    return calls


def case_layout(mesh, hidden):
    """``megatron_param_shardings`` of an FCNN 2-``hidden``-1 and this
    rank's blocks of its split leaves."""
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.parallel import megatron_param_shardings
    from neurodiffeq_tpu_torch.parallel.sharding import model_blocks

    net = FCNN(2, 1, hidden_units=hidden, dtype=F64)
    names = {id(m): name for name, m in net.named_modules()}
    return megatron_param_shardings(net, mesh), {f'{names[id(lin)]}.{leaf}': v
                                                for (lin, leaf), v in model_blocks([net], mesh).items()}


def case_store(mesh, kind, hidden, jax_params):
    """The flagship problem on ``kind`` 2-``hidden``-1 from the JAX
    parameters: what this rank stores of each leaf (full name -> array)
    before training, and after one training epoch the shapes of each stored
    leaf, its gradient, its Adam moments and its entry of ``best_params``,
    and the element count of each."""
    def plain(key):
        return key.replace('parametrizations.', '').replace('.original', '')

    solver = build(mesh, 'flagship', hidden, kind=kind)
    solver.load_jax_params(jax_params)
    params = {plain(k): p for k, p in solver._unique_nets[0].named_parameters()}
    stored = {name: p.detach().numpy().copy() for name, p in params.items()}
    solver.run_train_epoch()
    state, best = solver.optimizer.state, {plain(k): v for k, v in solver.best_params[0].items()}
    shapes = {name: (tuple(p.shape), tuple(p.grad.shape), tuple(state[p]['exp_avg'].shape),
                     tuple(state[p]['exp_avg_sq'].shape), tuple(best[name].shape)) for name, p in params.items()}
    counts = [sum(t.numel() for t in tensors) for tensors in zip(*[
        (p, p.grad, state[p]['exp_avg'], state[p]['exp_avg_sq']) for p in params.values()])]
    return stored, shapes, counts


def loss_and_grads(solver, cols):
    """``torch_parallel_ranks.loss_and_grads`` with the gradients gathered,
    and the gradient step's collectives."""
    calls = counting_collectives(solver)
    solver.optimizer.zero_grad(set_to_none=True)
    loss, _ = solver._loss_and_metrics([torch.tensor(c) for c in cols])
    solver._backward(loss)
    if solver.mesh is not None:
        loss = solver._reduce_grads(loss)
    return float(loss.detach()), full_grads(solver), calls


def case_loss_grads(mesh, spec, jax_params, cols):
    """The global loss and every gradient at ``cols`` from the JAX
    parameters (and the gradient step's collectives), and the Taylor-MLP
    launches per kernel that the pass made (on the CPU, the twin calls
    ``cpu_rehearsal.counted`` counts)."""
    from neurodiffeq_tpu_torch.ops import taylor_mlp

    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    taylor_mlp.reset_launches()
    loss, grads, calls = loss_and_grads(solver, cols)
    return (loss, grads), dict(taylor_mlp.LAUNCHES), calls


def case_epoch(mesh, spec, jax_params):
    """One training epoch from the JAX parameters: the parameters after it,
    its train loss, the gradient step's collectives and the elements this
    rank's trained parameters hold."""
    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    calls = counting_collectives(solver)
    solver.run_train_epoch()
    return full_params(solver), solver.metrics_history['train_loss'], calls, sum(
        p.numel() for p in solver._parameters())


def case_fit(mesh, spec, epochs, points):
    """``fit(epochs)``: the histories and parameters, and what the solver
    hands out, at full size: ``get_solution()`` at ``points``, ``best_nets``'
    parameters, ``get_internals``' ``params`` and ``best_params`` and the
    exported solution's values."""
    from neurodiffeq_tpu_torch.solvers import load_exported_solution

    solver = build(mesh, **spec)
    solver.fit(epochs, tqdm_file=None)
    solution = solver.get_solution()
    internals = solver.get_internals(['params', 'best_params'], return_type='dict')
    served = load_exported_solution(solution.export(1))(points.reshape(-1, 1))[0]
    handed = {'solution': solution(points, to_numpy=True),
              'best_nets': [p.numpy().copy() for net in _unique(solver.best_nets) for p in net.parameters()],
              'internals': {k: [{n: t.detach().numpy().copy() for n, t in s.items()} for s in v]
                            for k, v in internals.items()},
              'export': served.numpy().reshape(points.shape)}
    return solver.metrics_history, full_params(solver), handed


def case_resume(mesh, spec, epochs, workdir, plain_path):
    """``fit(epochs)`` and ``save`` on the mesh (into ``workdir``); then
    that file and ``plain_path`` (saved without a mesh after the same
    epochs) each loaded onto the mesh and trained ``epochs`` more: their
    histories and parameters."""
    from neurodiffeq_tpu_torch.solvers import Solver1D

    solver = build(mesh, **spec)
    solver.fit(epochs, tqdm_file=None)
    solver.save(os.path.join(workdir, 'mesh.pt'))
    out = {}
    for name, path in (('mesh', os.path.join(workdir, 'mesh.pt')), ('plain', plain_path)):
        loaded = Solver1D.load(path, mesh=mesh, device='cpu')
        loaded.fit(epochs, tqdm_file=None)
        out[name] = (loaded.metrics_history, full_params(loaded))
    return out


def case_callbacks(mesh, epochs, workdir):
    """The oscillator (two FCNN 1-(16, 16)-1) with
    ``AutoResidualWeightCallback`` on every epoch, and a ``MonitorCallback``
    and 'state_dict' and 'internals' checkpoints every 2 epochs, each rank
    writing into a directory of its own under ``workdir``: the weights, and
    the files each rank wrote."""
    from neurodiffeq_tpu_torch import callbacks as cb, monitors

    here = os.path.join(workdir, 'plain' if mesh is None else f'rank{mesh.get_rank()}')
    os.makedirs(here)
    solver = R.build(mesh, problem='oscillator', net=(16, 16))
    weights = cb.AutoResidualWeightCallback(rate=0.5, freeze_tol=0.0)
    every2 = [cb.MonitorCallback(monitors.Monitor1D(0.0, 2.0, check_every=1), fig_dir=os.path.join(here, 'figs')),
              cb.CheckpointCallback(os.path.join(here, 'ckpt'), format='state_dict'),
              cb.CheckpointCallback(os.path.join(here, 'internals'), format='internals')]
    solver.fit(epochs, callbacks=[weights] + [c.conditioned_on(cb.PeriodLocal(2)) for c in every2], tqdm_file=None)
    written = sorted(os.path.relpath(os.path.join(d, f), here) for d, _, files in os.walk(here) for f in files)
    return weights.weight_history, solver.residual_weights, written


def case_lbfgs(mesh, spec):
    """``set_optimizer`` with ``torch.optim.LBFGS`` and with Adafactor on a
    solver of ``spec``: the messages of the ``ValueError``s (None where it
    is accepted); and the ``all_reduce`` calls that ``get_internals`` makes
    for ``'params'`` and for ``'global_epoch'``, with the number of stored
    blocks (each one gather)."""
    import torch.distributed as dist
    from neurodiffeq_tpu_torch.parallel.sharding import stored_blocks

    solver = build(mesh, **spec)
    messages = []
    for make in (torch.optim.LBFGS, getattr(torch.optim, 'Adafactor', None)):
        try:
            with warnings.catch_warnings():  # L-BFGS with no validation batches warns
                warnings.simplefilter('ignore', RuntimeWarning)
                if make is not None:
                    solver.set_optimizer(make(solver._parameters()))
            messages.append(None)
        except ValueError as e:
            messages.append(str(e))
    calls, original = [], dist.all_reduce

    def all_reduce(tensor, group=None, **kw):
        calls[-1] += 1
        return original(tensor, group=group, **kw)

    dist.all_reduce = all_reduce
    try:
        for name in ('params', 'global_epoch'):
            calls.append(0)
            solver.get_internals(name)
    finally:
        dist.all_reduce = original
    return messages, calls, len(stored_blocks(solver._unique_nets))


CASES = {'layout': case_layout, 'store': case_store, 'loss_grads': case_loss_grads, 'epoch': case_epoch,
         'fit': case_fit, 'resume': case_resume, 'callbacks': case_callbacks, 'lbfgs': case_lbfgs}


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
    return {key: CASES[name](None, **kwargs) for key, (name, kwargs) in cases.items()
            if name in ('epoch', 'fit', 'callbacks', 'lbfgs')}


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
    return str(get_default_device()), index, float(loss.detach()), full_grads(solver), dict(taylor_mlp.LAUNCHES)


def cuda_store_case(model_axis_size, workdir):
    """On the card: the second-order ODE on an FCNN 1-(32, 32)-1 in float64
    on ``make_mesh(model_axis_size=...)`` (None: unsharded), ``fit(2)``:
    the shapes of what this rank stores, the gathered parameters and
    ``get_solution()`` at 16 points; and, on a mesh, ``save`` (into
    ``workdir``), ``load`` onto the mesh and one more epoch of the solver
    and of the loaded one: their gathered parameters, and the file's
    path."""
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.solvers import Solver1D

    mesh = None if model_axis_size is None else make_mesh(model_axis_size=model_axis_size)
    solver = build(mesh, method='equally-spaced-noisy')
    solver.fit(2, tqdm_file=None)
    out = {'shapes': [tuple(p.shape) for p in solver._parameters()], 'params': full_params(solver),
           'solution': solver.get_solution()(np.linspace(0.0, 2.0, 16), to_numpy=True)}
    if mesh is not None:
        path = os.path.join(workdir, 'mesh.pt')
        solver.save(path)
        loaded = Solver1D.load(path, config=solver_config(), mesh=mesh)
        for s in (solver, loaded):
            s.fit(1, tqdm_file=None)
        out['resumed'] = [full_params(s) for s in (solver, loaded)]
        out['path'] = path
    return out


def solver_config():
    """What ``load`` needs where dill is missing (the GPU machine): the
    callables of :func:`cuda_store_case`'s solver."""
    from neurodiffeq_tpu_torch.solvers_utils import SolverConfig

    fresh = build(method='equally-spaced-noisy')
    return SolverConfig(ode_system=fresh.diff_eqs, conditions=fresh.conditions, nets=fresh.nets,
                        train_generator=fresh.generator['train'], valid_generator=fresh.generator['valid'])
