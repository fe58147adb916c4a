r"""Solver persistence: save, load and resume, and the remote hub client
(counterpart of ``neurodiffeq_tpu/solvers_utils.py``).

A saved solver is one ``torch.save`` archive of two parts:

- the **tensor part**, plain data that ``torch.load(..., weights_only=True)``
  reads: the state dict of each distinct net (a net shared by several
  conditions is saved once), the best parameters, ``optimizer.state_dict()``
  with the place of each of its parameters among the solver's, the state of
  the sampling ``torch.Generator``, the histories, the lowest loss, the
  global epoch, the constructor arguments and ``diff_equation_details``;
- the **callables** (equations, conditions, the nets as modules, the
  generators, the loss and the metrics), as one dill blob, as in the JAX
  package, when ``dill`` imports. The optimizer's class goes by its module
  and name in the tensor part. Without dill the
  archive holds the tensor part alone, and :meth:`PretrainedSolver.load`
  takes the callables from a :class:`SolverConfig`.

A solver on a ``'model'`` mesh axis saves what an unsharded one saves:
every rank gathers the blocks of its split leaves and of their optimizer
state, and rank 0 writes. Loading places the blocks of whatever mesh the
new solver has, so a file loads with or without one.

``dill``, ``requests`` and the hub are imported at first use. The hub is
controlled by the environment variables ``NEURODIFF_API_URL`` and
``NEURODIFF_API_KEY``, as in the JAX package.
"""
import ast
import decimal
import inspect
import io
import json
import os
import random
import types

import numpy as np
import torch

FORMAT = 'neurodiffeq_tpu_torch.solver/1'


def _dill():
    """The ``dill`` module, or None where it is not installed."""
    try:
        import dill
    except ImportError:
        return None
    return dill


def _dill_load_protected(fileobj):
    """``dill.load`` with live-module state protection.

    dill serializes a MODULE OBJECT by value when it sits in a closure cell,
    e.g. a user's ``diff_eqs`` defined inside a function body after a local
    ``from neurodiffeq_tpu_torch import fields as F``. Unpickling such a blob
    imports the real module and ``__dict__.update``s it with the pickled
    copies, rebinding every live global (the engine's rule tables, the
    eval-mode flag, the field-aware math functions) to stale duplicates
    from save time.

    Guard: snapshot every imported module's ``__dict__`` and, after the
    load, restore any entry whose identity the load changed. The loaded
    solver keeps working (its closure cells reference the module object,
    not the stale values), and the process keeps its real module state.
    Keys the load adds to a module are left alone.
    """
    import sys
    dill = _dill()
    snapshot = {name: dict(m.__dict__) for name, m in list(sys.modules.items()) if m is not None}
    try:
        return dill.load(fileobj)
    finally:
        for name, saved in snapshot.items():
            mod = sys.modules.get(name)
            if mod is None:
                continue
            live = mod.__dict__
            for k, v in saved.items():
                if k in live and live[k] is not v:
                    live[k] = v


DEFAULT_API_URL = "https://dev.neurodiff.io/v1/" if os.getenv("DEV") else "https://api.neurodiff.io/v1/"
DEV = bool(os.environ.get("DEV"))
NEURODIFF_API_URL = os.getenv("NEURODIFF_API_URL", DEFAULT_API_URL)


def _get_api_url():
    return os.getenv("NEURODIFF_API_URL", DEFAULT_API_URL)


def _get_api_key():
    return os.getenv("NEURODIFF_API_KEY")


def is_solution_name(name):
    """True if ``name`` names a hub solution rather than a local path
    (anything not starting with ``./``)."""
    return not name.startswith('./')


def process_response(response):
    """Decode an HTTP response from the hub."""
    return response.json()


def create_cache_dir():
    """Create (if needed) and return the ``~/.neurodiff`` download cache."""
    cache_dir = os.path.join(os.path.expanduser('~'), '.neurodiff')
    os.makedirs(cache_dir, exist_ok=True)
    return cache_dir


def get_parameters(lambda_function):
    """Names and values a user equation captured: its closure cells if any,
    else the globals it references; callables and modules are left out, so
    that the result is plain data."""
    def is_param(value):
        return not (callable(value) or isinstance(value, types.ModuleType))

    parameters = {}
    try:
        closures = lambda_function.__closure__
        if closures is not None:
            for name, cell in zip(lambda_function.__code__.co_freevars, closures):
                if is_param(cell.cell_contents):
                    parameters[name] = cell.cell_contents
        else:
            gbs = lambda_function.__globals__
            for name in lambda_function.__code__.co_names:
                if name in gbs and is_param(gbs[name]):
                    parameters[name] = gbs[name]
    except Exception:
        pass
    return parameters


def get_conditions(conditions):
    """Per-condition metadata dicts: the instance attributes plus
    ``condition_type``, with captured functions as their source."""
    condition_list = []
    for condition in conditions:
        cond_dict = dict(condition.__dict__)
        cond_dict["condition_type"] = type(condition).__name__
        for key, value in cond_dict.items():
            if isinstance(value, types.FunctionType):
                source = get_source(value)
                if source:
                    cond_dict[key] = source
        condition_list.append(cond_dict)
    return condition_list


def get_generator(generator):
    """The plain-data attributes of the train generator (a nested generator
    as its repr); a ``SamplerGenerator`` is unwrapped."""
    try:
        gen = generator['train']
    except (KeyError, TypeError):
        return {}
    gen = getattr(gen, 'generator', gen) if type(gen).__name__ == 'SamplerGenerator' else gen
    out = {}
    for k, v in vars(gen).items():
        if callable(v) or k in ('examples', 'grid_x', 'grid_y'):
            continue
        try:
            json.dumps(v, cls=JsonEncoder)
            out[k] = v
        except TypeError:
            out[k] = repr(v)
    return out


class JsonEncoder(json.JSONEncoder):
    """JSON encoder for numpy scalars and arrays and torch tensors."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, decimal.Decimal):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if torch.is_tensor(obj):
            return obj.detach().cpu().tolist()
        return super().default(obj)


def get_loss(loss):
    """A loss as plain data: a registry name as it is, a callable as its source."""
    return loss if isinstance(loss, str) else get_source(loss)


def get_source(obj):
    """The source of a (lambda) function: the lambda alone where the line
    holds one, else the whole definition; None where there is no source."""
    try:
        source = inspect.getsource(obj).strip()
        try:
            tree = ast.parse(source)
            for node in ast.walk(tree):
                if isinstance(node, ast.Lambda):
                    return ast.get_source_segment(source, node)
        except SyntaxError:
            pass
        return source
    except (OSError, TypeError):
        return None


def get_networks(solver):
    """Per-net architecture: ``[{"layers": [{"layer", "in_features",
    "out_features", "bias"}, {"layer": <activation>}, ...]}]``."""
    networks = []
    for net in solver.nets:
        layers = []
        if hasattr(net, 'hidden_units') and hasattr(net, 'n_input_units'):
            dims = (net.n_input_units,) + tuple(net.hidden_units) + (net.n_output_units,)
            actvs = list(getattr(net, 'actvs', []))
            for i in range(len(dims) - 1):
                layers.append({'layer': 'Linear', 'in_features': int(dims[i]), 'out_features': int(dims[i + 1]),
                               'bias': True})
                if i < len(dims) - 2:
                    name = type(actvs[i]).__name__ if i < len(actvs) else 'Tanh'
                    layers.append({'layer': name})
        else:
            layers.append({'layer': type(net).__name__})
        networks.append({'layers': layers})
    return networks


def get_sample_solution(solver):
    """Sampled solution curves for the hub: ``[xs, us]`` lists, ``[]`` when
    sampling fails, None for solver types without a sampler. The draws
    (a bundle's parameter values, a 2-D solver's points) come from their
    own seeded generators, never from the solver's sampling stream, so
    saving a solver does not change how it resumes."""
    names = [c.__name__ for c in type(solver).__mro__]
    best = solver.best_params is not None
    try:
        if 'BundleSolver1D' in names:
            t0, t1 = float(solver.r_min[0]), float(solver.r_max[0])
            t = np.linspace(t0, t1, max(10 * int(t1 - t0), 10))
            draw = random.Random(0)
            values = [np.full_like(t, draw.random() * (float(solver.r_max[i]) - float(solver.r_min[i]))
                                   + float(solver.r_min[i]))
                      for i in range(1, len(solver.r_min))]
            us = solver.get_solution(best=best)(t, *values, to_numpy=True)
            us = us if isinstance(us, (list, tuple)) else [us]
            return [t.tolist(), [np.asarray(u).tolist() for u in us]]
        if 'Solver1D' in names:
            t = np.linspace(solver.t_min, solver.t_max, max(10 * int(solver.t_max - solver.t_min), 10))
            us = solver.get_solution(best=best)(t, to_numpy=True)
            us = us if isinstance(us, (list, tuple)) else [us]
            return [t.tolist(), [np.asarray(u).tolist() for u in us]]
        if 'Solver2D' in names:
            gen = solver.generator['train']
            cols = gen.sample(torch.Generator(device=gen.device).manual_seed(0))
            xs = [c.detach().cpu().numpy().reshape(-1) for c in cols[:2]]
            us = solver.get_solution(best=best)(xs[0], xs[1], to_numpy=True)
            us = us[0] if isinstance(us, (list, tuple)) else us
            return [[x.tolist() for x in xs], np.asarray(us).tolist()]
    except Exception:
        return []
    return None


def get_sample_solution1D(solver):
    """Sample solution curves of a ``Solver1D`` (:func:`get_sample_solution`)."""
    return get_sample_solution(solver)


def get_sample_solution2D(solver):
    """Sample solution surface of a ``Solver2D`` (:func:`get_sample_solution`)."""
    return get_sample_solution(solver)


def get_sample_solutionBundle1D(solver):
    """Sample solution curves of a ``BundleSolver1D`` at a drawn bundle point
    (:func:`get_sample_solution`)."""
    return get_sample_solution(solver)


def _user_diff_eqs(solver):
    return getattr(solver, '_ode_system', solver.diff_eqs)


def _diff_equation_details(solver):
    """The introspected metadata block that the hub shows."""
    return {
        "equation": get_source(_user_diff_eqs(solver)),
        "conditions": [type(c).__name__ for c in solver.conditions],
        "generator": {k: repr(g) for k, g in solver.generator.items()},
        "sample_solution": get_sample_solution(solver),
        "sample_loss": list(solver.metrics_history.get('valid_loss', [])),
        "loss_fn": get_loss(solver.loss_fn),
        "networks": get_networks(solver),
        "optimizer": {"name": type(solver.optimizer).__name__},
    }


def _plain(obj):
    """``obj`` with numpy scalars and arrays made Python numbers and lists,
    so that ``torch.load(..., weights_only=True)`` reads it."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


class SolverConfig:
    """What :meth:`PretrainedSolver.load` takes in place of the saved value;
    an attribute left None keeps the saved one. Without dill in the saved
    file, it must give every callable the solver needs."""

    def __init__(self, conditions=None, ode_system=None, pde_system=None, nets=None,
                 train_generator=None, valid_generator=None, optimizer=None,
                 metrics=None, loss_fn=None, n_batches_train=None, n_batches_valid=None):
        self.conditions = conditions
        self.ode_system = ode_system
        self.pde_system = pde_system
        self.nets = nets
        self.train_generator = train_generator
        self.valid_generator = valid_generator
        self.optimizer = optimizer
        self.metrics = metrics
        self.loss_fn = loss_fn
        self.n_batches_train = n_batches_train
        self.n_batches_valid = n_batches_valid


def _optimizer_state(solver):
    """The optimizer as plain data: its class's module and name, its
    ``state_dict`` (the state of each stored block of a model axis gathered
    to full size, on every rank) and, per parameter group, the place of each
    parameter among the solver's ``_parameters()`` (the order the restored
    state maps to)."""
    from .parallel.optim import full_optimizer_state, plain_class

    position = {id(p): i for i, p in enumerate(solver._parameters())}
    opt = solver.optimizer
    kind = plain_class(opt)  # a model axis's L-BFGS, Adafactor or Muon keeps torch.optim's state
    return {'module': kind.__module__, 'type': kind.__qualname__,
            'state_dict': full_optimizer_state(opt, solver._unique_nets),
            'param_index': [[position.get(id(p), -1) for p in group['params']] for group in opt.param_groups]}


def _state(solver):
    """The tensor part of a saved solver (see the module docstring)."""
    from .losses import _losses

    unique = solver._unique_nets
    loss_name = next((k for k, f in _losses.items() if f is solver.loss_fn), None)
    return {
        'format': FORMAT,
        'type_name': type(solver).__name__,
        'parent_type_name': type(solver).__mro__[1].__name__,
        'net_index': [next(i for i, u in enumerate(unique) if u is n) for n in solver.nets],
        'nets': solver._full_states(),
        'best_params': None if solver.best_params is None else solver._full_states(solver.best_params),
        'optimizer': _optimizer_state(solver),
        'rng': {'device_type': solver.rng.device.type, 'state': solver.rng.get_state()},
        'n_batches': dict(solver.n_batches),
        'metric_names': list(solver.metrics_fn),
        'metrics_history': {k: [float(x) for x in v] for k, v in solver.metrics_history.items()},
        'lowest_loss': None if solver.lowest_loss is None else float(solver.lowest_loss),
        'global_epoch': solver.global_epoch,
        'loss_name': loss_name,
        'solver_kwargs': _plain(solver._constructor_kwargs()),
        'diff_equation_details': _plain(_diff_equation_details(solver)),
    }


def _callables(solver):
    """The callables of a solver for dill. The nets are full-size copies on
    the CPU, so that a file saved on the card, or on a mesh, loads anywhere;
    one deepcopy of the list keeps a shared net shared, and the live nets are
    not touched."""
    from .parallel.sharding import plain_copies
    nets = plain_copies(solver.nets, solver._full_states())
    for net in {id(n): n for n in nets}.values():
        net.to('cpu')
    return {
        'diff_eqs': _user_diff_eqs(solver),
        'conditions': solver.conditions,
        'nets': nets,
        'generator': dict(solver.generator),
        'loss_fn': solver.loss_fn,
        'metrics_fn': solver.metrics_fn,
    }


def _optimizer_class(opt):
    """The saved optimizer's class, imported by its module and name (None
    where it does not import, e.g. a class defined in a script)."""
    import importlib
    try:
        obj = importlib.import_module(opt['module'])
        for part in opt['type'].split('.'):
            obj = getattr(obj, part)
    except (ImportError, AttributeError):
        return None
    return obj


def _cpu_steps(optimizer):
    """Put each scalar ``step`` back on the CPU, where a freshly made
    optimizer keeps it (``map_location`` moved it to the solver's device),
    unless its group is capturable or fused."""
    for group in optimizer.param_groups:
        if group.get('capturable') or group.get('fused'):
            continue
        for p in group['params']:
            st = optimizer.state.get(p, {})
            if torch.is_tensor(st.get('step')) and st['step'].ndim == 0:
                st['step'] = st['step'].cpu()


def _fits(value, param, n_flat):
    """Whether the optimizer state ``value`` (of ``param``, in a group of
    ``n_flat`` elements) fits: a number, a moment of the parameter's shape,
    Adafactor's row or column factor of it, L-BFGS's flat vector over the
    group, or a list of these."""
    if isinstance(value, (list, tuple)):
        return all(_fits(v, param, n_flat) for v in value)
    if not torch.is_tensor(value) or value.ndim == 0:
        return True
    shape, own = tuple(value.shape), tuple(param.shape)
    factors = {own[:-1] + (1,), own[:-2] + (1,) + own[-1:]} if len(own) > 1 else set()
    return shape == own or shape in factors or shape == (n_flat,)


def _restore_optimizer(solver, opt, optimizer_class):
    """Rebuild the saved optimizer over ``solver``'s parameters and load its
    state, each group's parameters in the saved places (some of the
    solver's parameters, each at most once: Muon takes the weights alone);
    under a ``'model'`` axis the full-size state of a split leaf becomes
    this rank's part of it
    (:func:`~neurodiffeq_tpu_torch.parallel.optim.placed_optimizer_state`).
    Where the state has other shapes it starts afresh over the same
    parameters; one that held a tensor the solver does not own starts
    afresh over all of them, with the saved hyperparameters, as the JAX
    package re-initializes an optimizer state of another structure."""
    from .parallel.optim import placed_optimizer_state

    params = solver._parameters()
    sd = opt['state_dict']
    hyper = [{k: v for k, v in g.items() if k != 'params'} for g in sd['param_groups']]
    index = opt['param_index']
    flat = [i for idx in index for i in idx]
    fits = owned = all(0 <= i < len(params) for i in flat) and len(set(flat)) == len(flat)
    if fits:
        by_id = {pid: p for idx, g in zip(index, sd['param_groups']) for pid, p in zip(g['params'], idx)}
        sd = placed_optimizer_state(sd, {pid: params[i] for pid, i in by_id.items()}, solver._unique_nets,
                                    optimizer_class)
        n_flat = {pid: sum(params[i].numel() for i in idx) for idx, g in zip(index, sd['param_groups'])
                  for pid in g['params']}
        fits = all(_fits(v, params[by_id[pid]], n_flat[pid]) for pid, st in sd['state'].items() for v in st.values())
    if owned:
        optimizer = optimizer_class([{**h, 'params': [params[i] for i in idx]} for h, idx in zip(hyper, index)])
        if fits:
            optimizer.load_state_dict(sd)
            _cpu_steps(optimizer)
    else:
        optimizer = optimizer_class([{**hyper[0], 'params': params}])
    solver.set_optimizer(optimizer, reset_state=False)


def _restore(solver, state):
    """Load the tensor part into ``solver``: the nets' parameters, the best
    parameters (each rank's blocks of them under a ``'model'`` axis), the
    sampling generator's state (where the devices match) and the histories.
    The optimizer goes through :func:`_restore_optimizer`."""
    from .parallel.sharding import placed_state

    unique = solver._unique_nets
    if len(state['nets']) != len(unique):
        raise ValueError(f"the saved solver has {len(state['nets'])} distinct nets, this one {len(unique)}")
    solver.load_params(state['nets'])
    if state['best_params'] is not None:
        solver.best_params = [{k: v.to(solver.device) for k, v in placed_state(net, p).items()}
                              for net, p in zip(unique, state['best_params'])]
    rng = state['rng']
    if rng['device_type'] == solver.rng.device.type:
        solver.rng.set_state(rng['state'].cpu())
    solver.metrics_history = {k: list(v) for k, v in state['metrics_history'].items()}
    solver.lowest_loss = state['lowest_loss']


def _read(blob, device):
    """(tensor part, dill blob or None) of a saved solver's bytes."""
    saved = torch.load(io.BytesIO(blob), weights_only=True, map_location=device)
    if not isinstance(saved, dict) or saved.get('state', {}).get('format') != FORMAT:
        raise ValueError("not a solver saved by neurodiffeq_tpu_torch")
    return saved['state'], saved['callables']


class PretrainedSolver:
    """Mixin giving solvers ``save`` and ``load`` (mixed into ``BaseSolver``)."""

    def _constructor_kwargs(self):
        """The constructor arguments to rebuild this solver with."""
        kwargs = {}
        for name in ('t_min', 't_max', 'xy_min', 'xy_max', 'r_min', 'r_max', 'n_input_units', 'eq_param_index',
                     'residual_weights', 'eval_mode'):
            if getattr(self, name, None) is not None:
                kwargs[name] = getattr(self, name)
        kwargs['dtype'] = self.dtype
        return kwargs

    def _serialize(self):
        """The saved solver's bytes: ``torch.save`` of the tensor part and,
        when dill imports, the dill blob of the callables."""
        dill = _dill()
        callables = None
        if dill is not None:
            buf = io.BytesIO()
            dill.dump(_callables(self), buf)
            callables = buf.getvalue()
        out = io.BytesIO()
        torch.save({'state': _state(self), 'callables': callables}, out)
        return out.getvalue()

    def save(self, path=None, name=None, save_to_hub=False, **kwargs):
        """Save this solver to ``path`` and/or upload it to the hub.

        :param path: local file to write.
        :param name: solution name for the hub.
        :param save_to_hub: POST the saved bytes to the configured hub
            (``kwargs`` may give a ``description``).

        Under a mesh rank 0 writes (every rank holds the same state; under
        a ``'model'`` axis every rank gathers its blocks first, so every
        rank calls ``save``), and every rank returns once the file is
        written. The file holds no mesh and full-size tensors, as an
        unsharded solver's: it loads with or without one (``load(...,
        mesh=...)``).
        """
        if path is None and not save_to_hub:
            raise ValueError("Either `path` must be given or `save_to_hub` must be True")
        mesh = getattr(self, 'mesh', None)
        writes = mesh is None or mesh.get_rank() == 0
        if writes or self._reads_collective:
            blob = self._serialize()
        if writes:
            if path is not None:
                with open(path, 'wb') as f:
                    f.write(blob)
            if save_to_hub:
                self._upload_to_hub(blob, name=name, **kwargs)
        if mesh is not None:  # a barrier: no rank reads the file before it is written
            from .parallel.sharding import all_reduce_, world_group
            all_reduce_(torch.zeros(1, device=self.device), world_group(mesh))
        return path

    def _upload_to_hub(self, blob, name=None, description=""):
        try:
            import requests
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("`requests` is required for hub upload") from e
        api_key = _get_api_key()
        if not api_key:
            raise RuntimeError("Set NEURODIFF_API_KEY to upload solutions to the hub")
        resp = requests.post(_get_api_url() + "solutions/upload", headers={"api-key": api_key},
                             files={"file": (name or "solver", io.BytesIO(blob))},
                             data={"name": name or "solver", "description": description})
        resp.raise_for_status()
        return resp

    @classmethod
    def _download_from_hub(cls, name):
        try:
            import requests
        except ImportError as e:  # pragma: no cover
            raise RuntimeError("`requests` is required for hub download") from e
        headers = {"api-key": _get_api_key()} if _get_api_key() else {}
        resp = requests.get(_get_api_url() + f"solutions/download/{name}", headers=headers)
        resp.raise_for_status()
        return resp.content

    @classmethod
    def load(cls, path=None, name=None, config=None, **kwargs):
        """Load a saved solver from ``path`` (or from the hub by ``name``)
        into a new solver of the saved class, on ``kwargs['device']`` (the
        port's default device if not given), with ``config``'s overrides.
        The optimizer's state is restored unless ``config`` gives an
        optimizer.

        :param path: local file.
        :param name: hub solution name (downloaded if ``path`` is None).
        :param config: a :class:`SolverConfig`. Where the file holds no
            callables (saved without dill) or dill is not installed here, it
            must give them; a ``RuntimeError`` names each missing one.
        :param kwargs: more constructor arguments (``device``, ``mesh``, ...).
            With a ``mesh`` every rank loads the same state.
        """
        from . import solvers as _solvers
        from .utils import resolve

        if path is None and name is None:
            raise ValueError("Either `path` or `name` must be provided")
        if path is not None:
            with open(path, 'rb') as f:
                blob = f.read()
        else:
            blob = cls._download_from_hub(name)
        device, _ = resolve(kwargs.get('device'))
        state, callables_blob = _read(blob, device)
        saved = {}
        if callables_blob is not None and _dill() is not None:
            saved = _dill_load_protected(io.BytesIO(callables_blob))
        config = config or SolverConfig()
        solver_cls = getattr(_solvers, state['type_name'])

        generators = saved.get('generator', {})
        loss_fn = config.loss_fn or saved.get('loss_fn') or state['loss_name']
        metrics = config.metrics or saved.get('metrics_fn')
        optimizer_class = None
        if config.optimizer is None:
            optimizer_class = _optimizer_class(state['optimizer'])
        found = {
            'diff_eqs (ode_system or pde_system)': config.ode_system or config.pde_system or saved.get('diff_eqs'),
            'conditions': config.conditions or saved.get('conditions'),
            'nets': config.nets or saved.get('nets'),
            'train_generator': config.train_generator or generators.get('train'),
            'valid_generator': config.valid_generator or generators.get('valid'),
            'loss_fn': loss_fn,
            'metrics': metrics if state['metric_names'] else {},
            'optimizer': config.optimizer or optimizer_class,
        }
        missing = [k for k, v in found.items() if v is None]
        if missing:
            if callables_blob is None:
                why = "the file holds no callables (it was saved without dill)"
            else:
                why = "dill is not installed" if not saved else "they were not saved (an optimizer class not importable)"
            raise RuntimeError(f"cannot rebuild the solver: {why}; pass {', '.join(missing)} in a SolverConfig")

        init_sig = inspect.signature(solver_cls.__init__)
        ctor_kwargs = {k: v for k, v in state['solver_kwargs'].items()
                       if k in init_sig.parameters and k != 'n_input_units'}
        ctor_kwargs.update(kwargs)
        eq_kw = next((k for k in ('ode_system', 'pde_system') if k in init_sig.parameters), 'diff_eqs')
        solver = solver_cls(
            **{eq_kw: found['diff_eqs (ode_system or pde_system)']},
            conditions=found['conditions'],
            nets=found['nets'],
            train_generator=found['train_generator'],
            valid_generator=found['valid_generator'],
            optimizer=config.optimizer,
            loss_fn=loss_fn,
            metrics=metrics,
            n_batches_train=config.n_batches_train or state['n_batches']['train'],
            n_batches_valid=(config.n_batches_valid if config.n_batches_valid is not None
                             else state['n_batches']['valid']),
            **ctor_kwargs,
        )
        _restore(solver, state)
        if config.optimizer is None:
            _restore_optimizer(solver, state['optimizer'], optimizer_class)
        return solver


def get_file(path_or_name):
    """Open a local saved solver."""
    return open(path_or_name, 'rb')
