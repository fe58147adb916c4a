"""The benchmark of ``neurodiffeq_tpu_torch``, driven by data.

``BENCHMARK.json`` names the cells; everything else is found by name:

- ``configs/<config>.json``: the configuration's sizes, as run. An FCNN's
  are ``n_input_units``, ``hidden_units`` and ``n_output_units``; any other
  net declares its ``leaves``, an ordered list of ``{"name", "shape",
  "init", "trainable"}`` (:func:`make_params`), and names its forward count
  by ``net`` (``cost.config_forward_cost``; ``"fcnn"`` if absent);
- ``configs/<config>.py``: ``build(cfg, layers, train_generator, rng, device,
  dtype)`` -> ``{'solver', 'net', 'callbacks'}``, the port's solver holding
  the harness's weights: an FCNN's ``[(W, b), ...]``, or ``{name: leaf}`` in
  the declared order. ``net.parameters()`` has to hold the trainable leaves
  in that order (:func:`check_leaves`); frozen leaves go to the program as
  it takes them (a buffer) and are never compared;
- ``reference/<config>.py``: ``residuals(cfg, layers, x, y)``, the plain
  reference of the equations, and optionally ``unpack(cfg, params)``, which
  turns the flat list of leaves into what ``residuals`` takes
  (``reference/plain.py::as_layers``, the FCNN's pairs, if absent;
  ``reference/plain.py`` does the rest);
- ``traffic/<mix>.json``: a training feed or a closed loop of requests
  (``traffic.py``);
- ``metrics/<metric>.py``: ``MOVES`` and ``read(slice)`` of a per-layer
  metric, ``None`` where it finds nothing to read;
- ``kernels.d/<kernel>.txt``: patterns of the forward kernels' names;
- ``laws/<class>.<method>.py``: ``COLUMNS`` and ``check(node, cols)``, the
  law by which a training mix's batches are judged (``compare.py``);
- ``limits/<workload>.json``: the limit of each number compared.

The evaluation path (``run_eval``, ``check_eval``, the ``eval`` mixes and
readers) has no cell in ``BENCHMARK.json`` yet: its one user is the
evaluation cells that PERF.md's Open questions (row 0) hold back until
``get_residuals`` frees its memo; remove it if that row is closed otherwise.

A run builds the cell from ``--seed`` (weights and points made on the
device), warms it up, measures for ``--seconds`` and then checks what the
timed path produced against the plain reference in float64.
"""
import gc
import importlib.util
import json
import math
import random
import re
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import compare, cost, devtrace, stats, traffic

HERE = Path(__file__).resolve().parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'neurodiffeq_tpu')


def forbidden_modules(names=None):
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    JAX or the JAX package, compared whole."""
    tops = {name.split('.')[0] for name in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def load_module(path):
    """The Python file ``path`` as a module of its own."""
    name = 'portbench_' + re.sub(r'\W', '_', str(Path(path).with_suffix('')))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path):
    return json.loads(Path(path).read_text())


def discover(root=HERE):
    """The names the harness finds under ``root``, by kind."""
    root = Path(root)
    names = lambda sub, pattern: sorted(p.name[:-len(pattern) + 1] for p in (root / sub).glob(pattern))
    return {'configs': names('configs', '*.json'), 'traffic': names('traffic', '*.json'),
            'metrics': names('metrics', '*.py'), 'kernels': names('kernels.d', '*.txt'),
            'limits': names('limits', '*.json')}


def kernel_patterns(root=HERE):
    """Every pattern of ``kernels.d/``, compiled."""
    pats = []
    for path in sorted(Path(root, 'kernels.d').glob('*.txt')):
        pats += [re.compile(line.strip()) for line in path.read_text().splitlines()
                 if line.strip() and not line.lstrip().startswith('#')]
    return pats


@dataclass
class Cell:
    """One workload with everything it names, loaded."""
    name: str
    entry: dict
    bench: dict
    cfg: dict
    traffic: dict
    builder: object
    problem: object
    root: Path

    @classmethod
    def load(cls, workload, root=HERE, bench=None):
        root = Path(root)
        bench = bench if bench is not None else load_json(root.parent / 'BENCHMARK.json')
        entries = {w['name']: w for w in bench['workloads']}
        if workload not in entries:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has {sorted(entries)}")
        entry = entries[workload]
        config = entry['config']
        return cls(workload, entry, bench, load_json(root / 'configs' / f'{config}.json'),
                   traffic.load(root, entry['traffic']), load_module(root / 'configs' / f'{config}.py'),
                   load_module(root / 'reference' / f'{config}.py'), root)

    def _applies(self, metric, moves_present):
        if 'workloads' in metric:
            return self.name in metric['workloads']
        return moves_present(metric)

    def end_to_end(self):
        return [m for m in self.bench['end_to_end'] if self._applies(m, lambda m: True)]

    def per_layer(self):
        mine = {m['name'] for m in self.end_to_end()}
        return [m for m in self.bench['per_layer'] if self._applies(m, lambda m: m['moves'] in mine)]

    def limits(self):
        path = self.root / 'limits' / f'{self.name}.json'
        return load_json(path) if path.exists() else None

    @property
    def dims(self):
        """An FCNN's widths (a configuration without ``leaves``)."""
        return [self.cfg['n_input_units'], *self.cfg['hidden_units'], self.cfg['n_output_units']]

    @property
    def leaves(self):
        """The configuration's leaves in order: ``cfg['leaves']``, or an
        FCNN's ``(W (n_out, n_in), b)`` pairs, every one trainable and drawn
        as ``nn.Linear`` draws it, U(-1/sqrt(n_in), 1/sqrt(n_in))."""
        if 'leaves' in self.cfg:
            return self.cfg['leaves']
        dims = self.dims
        return [{'name': f'layers.{i}.{k}', 'shape': shape, 'init': {'kind': 'uniform', 'fan_in': n}, 'trainable': True}
                for i, (o, n) in enumerate(zip(dims[1:], dims[:-1])) for k, shape in (('W', [o, n]), ('b', [o]))]

    @property
    def trainable(self):
        """The indices of the trainable leaves."""
        return [i for i, leaf in enumerate(self.leaves) if leaf['trainable']]

    @property
    def dtype(self):
        return {'float32': torch.float32, 'float64': torch.float64}[self.cfg['dtype']]


INITS = ('uniform', 'normal', 'const')


def make_params(cell, seed, device, dtype):
    """The flat list of the configuration's leaves (:attr:`Cell.leaves`),
    made from ``seed`` on ``device`` by one generator: one call for all the
    uniform leaves and one for all the normal ones, each split among them in
    the listed order. ``init`` is ``{"kind": "uniform", "bound": b}`` or
    ``{"kind": "uniform", "fan_in": k}`` (U(-b, b), b = 1/sqrt(k) as
    ``nn.Linear`` draws), ``{"kind": "normal", "mean": mu, "std": sigma}``,
    or ``{"kind": "const", "value": c}``, which draws nothing. A normal leaf
    may add ``"over_exp": "<leaf>"`` (and ``"axis"``, 0 if absent): it is
    then its draw divided by exp of that 1-D leaf along ``axis``, so that a
    weight-factorised layer W = diag(exp(s)) V starts from the drawn W, as
    ``jaxpi``'s ``Dense`` with ``weight_fact`` draws its V and s."""
    specs = cell.leaves
    kinds = [leaf['init']['kind'] for leaf in specs]
    unknown = sorted(set(kinds) - set(INITS))
    if unknown:
        raise ValueError(f"unknown init {unknown} in {cell.cfg['name']!r}; known: {INITS}")
    sizes = [math.prod(leaf['shape']) for leaf in specs]
    g = torch.Generator(device=device)
    g.manual_seed(traffic.derive(seed, 'weights'))
    draws = {}
    for kind, draw in (('uniform', torch.rand), ('normal', torch.randn)):
        parts = [n for n, k in zip(sizes, kinds) if k == kind]
        if parts:
            draws[kind] = iter(draw(sum(parts), generator=g, device=device, dtype=dtype).split(parts))
    params = []
    for leaf, kind in zip(specs, kinds):
        init, shape = leaf['init'], tuple(leaf['shape'])
        if kind == 'uniform':
            bound = init['bound'] if 'bound' in init else 1.0 / math.sqrt(init['fan_in'])
            t = (next(draws[kind]) * 2 - 1) * bound
        elif kind == 'normal':
            t = next(draws[kind]) * init['std'] + init['mean']
        else:
            t = torch.full(shape, float(init['value']), device=device, dtype=dtype)
        params.append(t.view(shape))
    index = {leaf['name']: i for i, leaf in enumerate(specs)}
    for i, leaf in enumerate(specs):
        over = leaf['init'].get('over_exp')
        if over is None:
            continue
        if over not in index or len(specs[index[over]]['shape']) != 1 or 'over_exp' in specs[index[over]]['init']:
            raise ValueError(f"{leaf['name']!r} is divided by exp of {over!r}, which is no drawn 1-D leaf")
        axis = leaf['init'].get('axis', 0)
        shape = [1] * len(leaf['shape'])
        shape[axis] = -1
        params[i] = params[i] / params[index[over]].exp().view(shape)
    return params


def build_weights(cell, params):
    """What ``build`` takes of ``params``: an FCNN's ``[(W, b), ...]``, or
    ``{name: leaf}`` in the declared order."""
    if 'leaves' not in cell.cfg:
        return list(zip(params[0::2], params[1::2]))
    return {leaf['name']: p for leaf, p in zip(cell.leaves, params)}


def check_leaves(cell, net, params):
    """That ``net.parameters()`` holds the trainable leaves of ``params``,
    in count, order, shape and value; a ``ValueError`` names the first
    mismatch. The comparison reads only what the program was handed, so a
    leaf left out, added or put in another's place cannot pass."""
    want = [(cell.leaves[i]['name'], params[i]) for i in cell.trainable]
    got = list(net.named_parameters())
    for k, ((name, leaf), (held, p)) in enumerate(zip(want, got)):
        if tuple(p.shape) != tuple(leaf.shape):
            raise ValueError(f"{cell.name}: the net's parameter {k} ({held}) has shape {tuple(p.shape)}, "
                             f"the trainable leaf {name!r} {tuple(leaf.shape)}")
        if not torch.equal(p.detach(), leaf):
            raise ValueError(f"{cell.name}: the net's parameter {k} ({held}) does not hold the trainable leaf {name!r}")
    if len(got) != len(want):
        first = (f"has no parameter for the trainable leaf {want[len(got)][0]!r}" if len(got) < len(want)
                 else f"has a parameter {got[len(want)][0]} beyond the trainable leaves")
        raise ValueError(f"{cell.name}: the net {first} ({len(got)} parameters, {len(want)} trainable leaves)")


def note(t_start, msg):
    """A time-stamped line on standard error: how long each stage took."""
    print(f"portbench: +{time.perf_counter() - t_start:.2f} s {msg}", file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


class Window:
    """The measured window's clock, one ``tick`` per step; opens and closes
    the traced slice at the steps the traffic names, and counts the
    interpreter's garbage collections inside the window."""

    def __init__(self, device, seconds, spec, trace):
        self.device, self.seconds = device, seconds
        self.slice = (spec['trace_start'], spec['trace_start'] + spec['trace_steps']) if trace else None
        self.profiler = devtrace.Profiler() if trace else None
        self.steps, self.times = 0, []
        self.collections = [[0, 0.0] for _ in range(3)]  # per generation: count, seconds
        self._gc_start = None

    def _on_gc(self, phase, info):
        if phase == 'start':
            self._gc_start = time.perf_counter()
        elif self._gc_start is not None:
            c = self.collections[info['generation']]
            c[0] += 1
            c[1] += time.perf_counter() - self._gc_start

    def open(self):
        sync(self.device)
        gc.callbacks.append(self._on_gc)
        self.t0 = self.last = time.perf_counter()
        self._maybe_trace()

    def close(self, t_start, samples):
        """Stop counting; a line on standard error of how the window's step
        times (or ``samples``) spread and what the collector took."""
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)
        med = stats.percentile(samples, 50)
        slow = [t for t in samples if t > 2 * med]
        note(t_start, f"window: {self.steps} steps in {self.window_s:.3f} s; median {1e3 * med:.3f} ms, "
                      f"p95 {1e3 * stats.percentile(samples, 95):.3f} ms, max {1e3 * max(samples):.3f} ms, "
                      f"{len(slow)} over twice the median ({sum(slow):.3f} s); gc collections by generation "
                      + ', '.join(f"{n} ({1e3 * s:.1f} ms)" for n, s in self.collections))

    def tick(self):
        """After a step whose result the host has read back. Returns whether
        the window has closed."""
        t = time.perf_counter()
        self.times.append(t - self.last)
        self.steps += 1
        self.last = t
        self._maybe_trace()
        tracing = self.slice is not None and self.steps < self.slice[1]
        return t - self.t0 >= self.seconds and not tracing

    def _maybe_trace(self):
        if self.slice is None:
            return
        if self.steps == self.slice[0]:
            sync(self.device)
            self.profiler.start()
        elif self.steps == self.slice[1]:
            sync(self.device)
            self.profiler.stop()

    @property
    def window_s(self):
        return self.last - self.t0


class TrainRecorder:
    """A callback over the first steps of ``fit``: each step's batch, and
    the optimizer's first moments after step 1 and the parameters after the
    last."""

    def __init__(self, net, steps):
        self.params, self.steps = list(net.parameters()), steps
        self.batches, self.moments, self.final = [], [None] * len(self.params), None

    def __call__(self, solver):
        self.batches.append([c.detach().clone() for c in solver.batch['train']])
        k = len(self.batches)
        if k == 1:
            state = solver.optimizer.state
            self.moments = [state[p]['exp_avg'].detach().clone() if 'exp_avg' in state.get(p, {}) else None
                            for p in self.params]
        if k == self.steps:
            self.final = [p.detach().clone() for p in self.params]


def run_train(cell, seed, seconds, trace, device, t_start):
    spec, cfg, dtype = cell.traffic, cell.cfg, cell.dtype
    params = make_params(cell, seed, device, dtype)
    note(t_start, 'weights made on the device')
    rng = torch.Generator(device=device)
    rng.manual_seed(traffic.derive(seed, 'feed'))
    gen = traffic.collocation_generator(spec, device, dtype)
    built = cell.builder.build(cfg, build_weights(cell, params), gen, rng, device, dtype)
    solver, net, callbacks = built['solver'], built['net'], list(built['callbacks'])
    check_leaves(cell, net, params)
    note(t_start, 'solver built')
    recorder = TrainRecorder(net, spec['check_steps'])
    solver.fit(spec['check_steps'], callbacks=callbacks + [recorder], tqdm_file=None)
    note(t_start, f"{spec['check_steps']} checked steps")
    solver.fit(spec['warmup_steps'], callbacks=callbacks, tqdm_file=None)
    sync(device)
    setup_s = time.perf_counter() - t_start
    note(t_start, f"{spec['warmup_steps']} warm-up steps: set-up done")

    window = Window(device, seconds, spec, trace)

    def tick(s):
        if window.tick():
            s._stop_training = True

    window.open()
    solver.fit(2 ** 62, callbacks=callbacks + [tick], tqdm_file=None)
    sync(device)
    window.close(t_start, window.times)
    losses = solver.metrics_history['train_loss'][-window.steps:]
    run = {'window': window, 'attempted': window.steps,
           'failed': sum(1 for x in losses if not math.isfinite(x)), 'points_per_step': gen.size,
           'e2e': {'train_points_per_s': stats.rate(window.steps * gen.size, window.window_s),
                   'epoch_ms_p95': 1e3 * stats.percentile(window.times, 95), 'setup_s': setup_s}}
    run['memory_peak_bytes'] = memory_peak(device)
    b1 = cfg['optimizer']['betas'][0]
    run['evidence'] = {
        'p0': params, 'batches': recorder.batches, 'rows': gen.size,
        'program': (solver.metrics_history['train_loss'][:spec['check_steps']],
                    [None if m is None else m.double() / (1 - b1) for m in recorder.moments], recorder.final)}
    del solver, net, built, callbacks, tick, recorder
    return run


def check_train(cell, ev):
    ref = compare.reference_train(cell, ev['p0'], ev['batches'])
    return compare.train_readings(cell, ev['p0'], ev['batches'], ev['rows'], ev['program'], ref)


def run_eval(cell, seed, seconds, trace, device, t_start):
    spec, cfg, dtype = cell.traffic, cell.cfg, cell.dtype
    params = make_params(cell, seed, device, dtype)
    note(t_start, 'weights made on the device')
    rng = torch.Generator(device=device)
    rng.manual_seed(traffic.derive(seed, 'feed'))
    built = cell.builder.build(cfg, build_weights(cell, params), None, rng, device, dtype)
    solver = built['solver']
    check_leaves(cell, built['net'], params)

    def request(index):
        pts = request_points(cell, seed, index, device)
        sync(device)
        t0 = time.perf_counter()
        out = solver.get_residuals(*pts, best=False)
        sync(device)
        return out, time.perf_counter() - t0

    note(t_start, 'solver built')
    for i in range(spec['warmup_requests']):
        request(-1 - i)
    setup_s = time.perf_counter() - t_start
    note(t_start, f"{spec['warmup_requests']} warm-up requests: set-up done")

    window = Window(device, seconds, spec, trace)
    kept, pick, latencies, closed, index = {}, random.Random(traffic.derive(seed, 'check')), [], False, 0
    k = spec['check_requests']
    window.open()
    while not closed:
        out, latency = request(index)
        latencies.append(latency)
        closed = window.tick()
        # a uniform sample of k - 1 requests of the window, drawn from the seed, and the last
        slot = index if index < k - 1 else pick.randrange(index + 1)
        if slot < k - 1:
            kept[slot] = (index, out)
        last = (index, out)
        index += 1
    window.close(t_start, latencies)
    answers = dict(kept.values())
    answers[last[0]] = last[1]
    n = spec['points_per_request']
    run = {'window': window, 'attempted': window.steps, 'failed': 0, 'points_per_step': n,
           'e2e': {'eval_points_per_s': stats.rate(window.steps * n, window.window_s),
                   'eval_ms_p95': 1e3 * stats.percentile(latencies, 95), 'setup_s': setup_s}}
    run['memory_peak_bytes'] = memory_peak(device)
    run['evidence'] = {'seed': seed, 'params': params, 'answers': answers}
    del solver, built, out, last, kept
    return run


def check_eval(cell, ev):
    refs = {i: compare.reference_eval(cell, ev['params'], request_points(cell, ev['seed'], i, ev['params'][0].device))
            for i in ev['answers']}
    return compare.eval_readings(cell, ev['answers'], refs)


def request_points(cell, seed, index, device):
    return traffic.request_points(cell.traffic, cell.cfg['domain'], seed, index, device, cell.dtype)


def memory_peak(device):
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == 'cuda' else 0


def traced_slice(cell, run):
    """The per-layer metrics, the device's busy seconds and the breakdown of
    the traced slice."""
    lo, hi, kernels, backward_s, host_ops = devtrace.reduce_events(run['window'].profiler.events())
    spec = cell.traffic
    esize = torch.finfo(cell.dtype).bits // 8
    sl = devtrace.Slice(steps=spec['trace_steps'], lo=lo, hi=hi, kernels=kernels, backward_s=backward_s,
                        forward_bound_s=cost.config_bound_seconds(cell.cfg, run['points_per_step'], esize),
                        forward_patterns=kernel_patterns(cell.root), host_ops=host_ops)
    metrics = {}
    for m in cell.per_layer():
        reader = load_module(cell.root / 'metrics' / f"{m['name']}.py")
        if reader.MOVES != m['moves']:
            raise ValueError(f"metrics/{m['name']}.py moves {reader.MOVES!r}, BENCHMARK.json says {m['moves']!r}")
        value = reader.read(sl)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}
    return metrics, sl.busy_s(), sl.window_s, sl.breakdown()


RUNNERS = {'train': run_train, 'eval': run_eval}
CHECKS = {'train': check_train, 'eval': check_eval}


def run(workload, seed, seconds, trace, device='cuda', t_start=None, root=HERE, cell=None):
    """One run of ``workload``: the result line's object, its ``checks``
    last. ``cell`` replaces what ``workload`` names (the tests' small cells)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cell or Cell.load(workload, root)
    device = torch.device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', torch.cuda.current_device() if device.index is None else device.index)
        torch.cuda.reset_peak_memory_stats(device)
    r = RUNNERS[cell.traffic['kind']](cell, seed, seconds, trace, device, t_start)
    dev = {'platform': 'gpu' if device.type == 'cuda' else device.type,
           'kind': torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu',
           'count': cell.entry.get('chips', 1), 'memory_peak_bytes': r['memory_peak_bytes']}
    result = {'correct': False, 'attempted': r['attempted'], 'failed': r['failed']}
    if trace:
        metrics, busy_s, window_s, breakdown = traced_slice(cell, r)
        dev.update(busy_s=busy_s, window_s=window_s)
    else:
        missing = [m['name'] for m in cell.end_to_end() if m['name'] not in r['e2e']]
        if missing:
            raise ValueError(f"{cell.name} cannot report {missing}")
        metrics = {m['name']: {'value': r['e2e'][m['name']], 'unit': m['unit']} for m in cell.end_to_end()}
        breakdown = None
    del r['window']  # and the profiler's events with it
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    note(t_start, f"window closed after {r['attempted']} steps{' and the trace read' if trace else ''}")
    readings = CHECKS[cell.traffic['kind']](cell, r['evidence'])
    note(t_start, 'checked against the reference')
    correct, checks = compare.judge(readings, cell.limits())
    result.update(correct=bool(correct and r['failed'] == 0), metrics=metrics, device=dev)
    if breakdown is not None:
        result['breakdown'] = breakdown
    result['checks'] = checks
    return result
