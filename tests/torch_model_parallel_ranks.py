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
import contextlib
import os
import sys
import warnings

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

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


def case_loss_grads(mesh, spec, jax_params, cols, kernels=True):
    """The global loss and every gradient at ``cols`` from the JAX
    parameters (and the gradient step's collectives), and the Taylor-MLP
    launches per kernel that the pass made (on the CPU, the twin calls
    ``cpu_rehearsal.counted`` counts); with ``kernels=False`` under
    ``disable_pallas()``, the switch turned back on after."""
    from neurodiffeq_tpu_torch.ops import disable_pallas, enable_pallas, taylor_mlp

    solver = build(mesh, **spec)
    solver.load_jax_params(jax_params)
    taylor_mlp.reset_launches()
    if not kernels:
        disable_pallas()
    try:
        loss, grads, calls = loss_and_grads(solver, cols)
    finally:
        enable_pallas()
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


class SubclassedLBFGS(torch.optim.LBFGS):
    """A subclass of ``torch.optim.LBFGS``: its step may be its own, so the
    model axis refuses it."""


def case_lbfgs(mesh, spec):
    """``set_optimizer`` with ``torch.optim.LBFGS``, Adafactor, Muon (over the
    2-D weights) and a subclass of L-BFGS on a solver of ``spec``: the
    messages of the ``ValueError``s (None where it is accepted); and the
    ``all_reduce`` calls that ``get_internals`` makes for ``'params'`` and
    for ``'global_epoch'``, with the number of stored blocks (each one
    gather)."""
    import torch.distributed as dist
    from neurodiffeq_tpu_torch.parallel.sharding import stored_blocks

    solver = build(mesh, **spec)
    messages = []
    for make in (torch.optim.LBFGS, torch.optim.Adafactor,
                 lambda params: torch.optim.Muon([p for p in params if p.ndim == 2]), SubclassedLBFGS):
        try:
            with warnings.catch_warnings():  # L-BFGS with no validation batches warns
                warnings.simplefilter('ignore', RuntimeWarning)
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


# the optimizers that read across their parameters: name -> (torch.optim class, its arguments); Muon takes the
# 2-D weights alone. History 5 fills and shifts within 3 epochs of 5 iterations; history 50 does not.
OPTIMIZERS = {
    'lbfgs': ('LBFGS', dict(lr=0.5, max_iter=5, history_size=5)),
    'lbfgs:h50': ('LBFGS', dict(lr=0.5, max_iter=5, history_size=50)),
    'wolfe': ('LBFGS', dict(lr=1.0, max_iter=5, history_size=5, line_search_fn='strong_wolfe')),
    'wolfe:h50': ('LBFGS', dict(lr=1.0, max_iter=5, history_size=50, line_search_fn='strong_wolfe')),
    'adafactor': ('Adafactor', dict(lr=1e-2)),
    'muon': ('Muon', dict(lr=1e-2)),
}
# Burgers' polish: torch.optim.LBFGS with the strong-Wolfe line search, as chip_smoke.py's 5t
POLISH = dict(lr=1.0, max_iter=4, history_size=10, line_search_fn='strong_wolfe')


def make_optimizer(name, params):
    kind, kwargs = OPTIMIZERS[name]
    return getattr(torch.optim, kind)([p for p in params if kind != 'Muon' or p.ndim == 2], **kwargs)


class _Allocations(TorchDispatchMode):
    """Counts into ``counts['allocated']`` the elements of every tensor that
    an operation makes in storage of its own (not a view, not in place),
    except while ``inside[0]``."""

    def __init__(self, counts, inside):
        super().__init__()
        self.counts, self.inside = counts, inside

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.inside[0]:
            seen = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs)) if torch.is_tensor(t)}
            self.counts['allocated'] += sum(t.numel() for t in tree_leaves(out)
                                            if torch.is_tensor(t) and t.untyped_storage().data_ptr() not in seen)
        return out


@contextlib.contextmanager
def counting_steps(solver, mesh):
    """Within the block: ``{'closures': closure calls, 'reductions': the
    model group's all_reduce calls outside the closure's passes (the
    optimizer's own), 'allocated': the elements of the tensors made outside
    them}``. A closure call is one training loss evaluation (the solvers
    here have no validation batches)."""
    import torch.distributed as dist
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes

    counts, inside = {'closures': 0, 'reductions': 0, 'allocated': 0}, [False]
    model = None if mesh is None else mesh_axes(mesh).model.get_group()
    original, passes = dist.all_reduce, (solver._loss_and_metrics, solver._backward)

    def all_reduce(tensor, group=None, **kw):
        counts['reductions'] += model is not None and group is model and not inside[0]
        return original(tensor, group=group, **kw)

    def inner(fn, closure):
        def run(*args, **kwargs):
            counts['closures'] += closure
            inside[0] = True
            try:
                return fn(*args, **kwargs)
            finally:
                inside[0] = False
        return run

    dist.all_reduce = all_reduce
    solver._loss_and_metrics, solver._backward = inner(passes[0], 1), inner(passes[1], 0)
    try:
        with _Allocations(counts, inside):
            yield counts
    finally:
        dist.all_reduce = original
        del solver._loss_and_metrics, solver._backward


def plain_state(sd):
    """An optimizer ``state_dict``'s state as numpy float64 arrays (numbers
    and tensors alike), None kept."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        if v is None:
            return None
        return (v.detach().cpu().double().numpy() if torch.is_tensor(v) else np.asarray(v, np.float64)).copy()

    return {i: {k: conv(v) for k, v in st.items()} for i, st in sd['state'].items()}


def case_optim(mesh, name, spec, epochs, workdir, plain_path=None):
    """``OPTIMIZERS[name]`` on a solver of ``spec``, ``fit(1)`` ``epochs``
    times: after each epoch the gathered parameters, the closure calls, the
    optimizer's model-group reductions and (L-BFGS) its iterations and
    function evaluations; the elements of the optimizer state on this rank;
    then ``save`` (into ``workdir``, as ``name.pt``) and one epoch more: the
    parameters. On a mesh, the file ``plain_path`` (saved without one after
    the same epochs) loaded onto it: its optimizer state gathered to full
    size, and its parameters after one epoch more."""
    import chip_smoke as cs
    from neurodiffeq_tpu_torch.parallel.optim import full_optimizer_state
    from neurodiffeq_tpu_torch.solvers import Solver1D

    solver = build(mesh, **spec)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        solver.set_optimizer(make_optimizer(name, solver._parameters()))
    out = {'params': [], 'counts': []}
    lbfgs = OPTIMIZERS[name][0] == 'LBFGS'
    for _ in range(epochs):
        before = dict(solver.optimizer.state[solver.optimizer._params[0]]) if lbfgs else {}
        with counting_steps(solver, mesh) as counts:
            solver.fit(1, tqdm_file=None)
        if lbfgs:
            after = solver.optimizer.state[solver.optimizer._params[0]]
            counts.update(iterations=after['n_iter'] - before.get('n_iter', 0),
                          evaluations=after['func_evals'] - before.get('func_evals', 0))
        out['params'].append(full_params(solver))
        out['counts'].append(counts)
    out['history'] = list(solver.metrics_history['train_loss'])
    out['elements'] = (cs.state_elements(solver.optimizer), sum(p.numel() for p in solver._parameters()))
    solver.save(os.path.join(workdir, f'{name}.pt'))
    solver.fit(1, tqdm_file=None)
    out['went_on'] = full_params(solver)
    if mesh is not None:
        loaded = Solver1D.load(plain_path, mesh=mesh, device='cpu')
        out['loaded_state'] = plain_state(full_optimizer_state(loaded.optimizer, loaded._unique_nets))
        loaded.fit(1, tqdm_file=None)
        out['resumed'] = full_params(loaded)
    return out


def case_muon_step(mesh, spec, grads, steps):
    """``OPTIMIZERS['muon']`` over the 2-D weights of a solver of ``spec``,
    ``steps`` steps each from the full-size gradients ``grads`` (this
    rank's block of each): the gathered parameters."""
    from neurodiffeq_tpu_torch.parallel.sharding import stored_blocks

    solver = build(mesh, **spec)
    solver.set_optimizer(make_optimizer('muon', solver._parameters()))
    blocks = stored_blocks(solver._unique_nets)
    weights = [p for p in solver._parameters() if p.ndim == 2]
    for _ in range(steps):
        for p, g in zip(weights, grads, strict=True):
            g = torch.tensor(g)
            p.grad = g if p not in blocks else blocks[p].right_inverse(g)
        solver.optimizer.step()
    return full_params(solver)


def case_schedule(mesh, spec, epochs):
    """Adafactor made before ``set_optimizer`` with a ``StepLR`` (halving
    each epoch) and a step post-hook on it, ``fit(1)`` and the scheduler's
    step ``epochs`` times: the gathered parameters, the hook's calls and
    the learning rate after."""
    solver = build(mesh, **spec)
    opt = torch.optim.Adafactor(solver._parameters(), lr=1e-2)
    schedule, fired = torch.optim.lr_scheduler.StepLR(opt, 1, gamma=0.5), []
    opt.register_step_post_hook(lambda *args: fired.append(1))
    solver.set_optimizer(opt)
    for _ in range(epochs):
        solver.fit(1, tqdm_file=None)
        schedule.step()
    return full_params(solver), len(fired), opt.param_groups[0]['lr'], solver.optimizer is opt


def burgers(mesh, hidden):
    """``chip_smoke.burgers_problem`` on an FCNN 2-``hidden``-1, float64 on
    the CPU, with 16 x 16 uniform candidates and 4 x 4 validation points."""
    import chip_smoke as cs
    from neurodiffeq_tpu_torch.generators import Generator1D, Generator2D
    from neurodiffeq_tpu_torch.networks import FCNN
    from neurodiffeq_tpu_torch.solvers import Solver2D

    pde_system, conditions = cs.burgers_problem()
    base = Generator1D(16, -1.0, 1.0, method='uniform', dtype=F64) * Generator1D(16, 0.0, 1.0, method='uniform',
                                                                                   dtype=F64)
    return Solver2D(pde_system=pde_system, conditions=conditions, xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0),
                    nets=[FCNN(n_input_units=2, hidden_units=hidden, dtype=F64)], train_generator=base,
                    valid_generator=Generator2D((4, 4), xy_min=(-1.0, 0.0), xy_max=(1.0, 1.0),
                                                method='equally-spaced', dtype=F64), dtype=F64, mesh=mesh)


def case_polish(mesh, hidden, jax_params, n, via, epochs):
    """Burgers' L-BFGS polish (``examples/burgers.py``'s ``polish_lbfgs``)
    from the JAX parameters of an FCNN 2-``hidden``-1: ``set_generator``
    with a ``PredefinedGenerator`` of the frozen draw of ``n`` points, and
    L-BFGS (``POLISH``) set by ``set_optimizer`` or, after an Adam epoch,
    by the ``SetOptimizer`` callback (``via``); ``fit(1)`` ``epochs``
    times. Returns the first closure's global loss and gathered gradients
    (on a mesh, through ``set_optimizer``), the gathered parameters after
    each epoch, the closure calls of each and the history."""
    import chip_smoke as cs
    from neurodiffeq_tpu_torch.callbacks import SetOptimizer
    from neurodiffeq_tpu_torch.generators import PredefinedGenerator

    solver = burgers(mesh, hidden)
    solver.load_jax_params(jax_params)
    solver.set_generator(PredefinedGenerator(*cs.polish_draw(n), dtype=F64))
    first, reduce = [], solver._reduce_grads

    def reduce_grads(loss=None):
        out = reduce(loss)
        if loss is not None and not first:
            first.append((float(out), full_grads(solver)))
        return out

    solver._reduce_grads = reduce_grads
    callbacks = []
    if via == 'set_optimizer':
        solver.set_optimizer(torch.optim.LBFGS(solver._parameters(), **POLISH))
    else:
        callbacks = [SetOptimizer(torch.optim.LBFGS, optimizer_kwargs=POLISH)]
    params, closures = [], []
    for _ in range(epochs):
        calls, inner = [0], solver._loss_and_metrics

        def counted(cols):
            calls[0] += torch.is_grad_enabled()  # the validation batches run without a graph
            return inner(cols)

        solver._loss_and_metrics = counted
        solver.fit(1, callbacks=callbacks, tqdm_file=None)
        del solver._loss_and_metrics
        params.append(full_params(solver))
        closures.append(calls[0])
    return (first[0] if first and via == 'set_optimizer' else None), params, closures, solver.metrics_history


CASES = {'layout': case_layout, 'store': case_store, 'loss_grads': case_loss_grads, 'epoch': case_epoch,
         'fit': case_fit, 'resume': case_resume, 'callbacks': case_callbacks, 'lbfgs': case_lbfgs,
         'optim': case_optim, 'muon_step': case_muon_step, 'polish': case_polish, 'schedule': case_schedule}


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
            if name in ('epoch', 'fit', 'callbacks', 'lbfgs', 'muon_step', 'polish', 'schedule')}


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


def cuda_disabled_case(model_axis_size):
    """On the card, under ``disable_pallas()``: :func:`cuda_case`'s pass on
    ``make_mesh(model_axis_size=...)`` (None: unsharded) raises, for the
    card launches the kernels or raises. The mesh index, the error's
    message (None if nothing raised) and the kernel launches; the switch is
    turned back on after."""
    from neurodiffeq_tpu_torch.ops import disable_pallas, enable_pallas, taylor_mlp
    from neurodiffeq_tpu_torch.parallel import make_mesh
    from neurodiffeq_tpu_torch.parallel.sharding import mesh_axes

    mesh = None if model_axis_size is None else make_mesh(model_axis_size=model_axis_size)
    solver = build(mesh)
    taylor_mlp.reset_launches()
    message = None
    disable_pallas()
    try:
        solver._loss_and_metrics([torch.tensor(2.0 * columns(32, 1, 3)[0], device=solver.device)])
    except RuntimeError as e:
        message = str(e)
    finally:
        enable_pallas()
    axes = None if mesh is None else mesh_axes(mesh)
    index = None if mesh is None else (axes.points.get_local_rank(), axes.model.get_local_rank())
    return index, message, dict(taylor_mlp.LAUNCHES)


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


def cuda_lbfgs_case(model_axis_size):
    """On the card: the second-order ODE on an FCNN 1-(32, 32)-1 in float64
    on ``make_mesh(model_axis_size=...)`` (None: unsharded), one epoch of
    ``torch.optim.LBFGS`` with the strong-Wolfe line search: the gathered
    parameters and the closure calls."""
    from neurodiffeq_tpu_torch.parallel import make_mesh

    mesh = None if model_axis_size is None else make_mesh(model_axis_size=model_axis_size)
    solver = build(mesh, method='equally-spaced-noisy')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', RuntimeWarning)
        solver.set_optimizer(make_optimizer('wolfe', solver._parameters()))
    with counting_steps(solver, mesh) as counts:
        solver.fit(1, tqdm_file=None)
    return full_params(solver), counts['closures']
