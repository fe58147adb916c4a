"""The one general generator of traffic, read from ``traffic/<mix>.json``.

A training mix names the port's collocation generator as data::

    {"kind": "train",
     "generator": {"product": [{"class": "Generator1D", "size": 131072, "method": "uniform"},
                               {"class": "Generator1D", "size": 131072, "method": "uniform"}]},
     "warmup_steps": 5, "trace_start": 20, "trace_steps": 10}

``{"class": name, ...}`` is that class of ``neurodiffeq_tpu_torch.generators``
built with the other keys; ``{"product": [...]}`` is their ``*`` (one batch
takes a column from each). One batch a step is drawn from the solver's own
generator, which the harness seeds; ``laws/`` holds the law that each leaf's
points are judged by.

An evaluation mix is a closed loop of one client::

    {"kind": "eval", "points_per_request": 1048576, "sampler": "uniform",
     "warmup_requests": 2, "trace_start": 20, "trace_steps": 10, "check_requests": 3}

Each request is ``points_per_request`` fresh points drawn uniformly from the
configuration's domain by a generator seeded from the run's seed and the
request's index, so any request's points can be drawn again.
"""
import hashlib
import json
from functools import reduce
from pathlib import Path

import torch

KINDS = ('train', 'eval')


def load(root, name):
    spec = json.loads((Path(root) / 'traffic' / f'{name}.json').read_text())
    if spec.get('kind') not in KINDS:
        raise ValueError(f"traffic {name!r}: kind must be one of {KINDS}")
    return spec


def derive(seed, *parts):
    """A 63-bit seed from the run's seed and ``parts``."""
    h = hashlib.sha256(repr((int(seed),) + parts).encode()).digest()
    return int.from_bytes(h[:8], 'little') >> 1


def collocation_generator(spec, device, dtype):
    """The port's generator that ``spec['generator']`` describes."""
    from neurodiffeq_tpu_torch import generators

    def build(node):
        if 'product' in node:
            return reduce(lambda a, b: a * b, [build(n) for n in node['product']])
        kwargs = {k: (tuple(v) if isinstance(v, list) else v) for k, v in node.items() if k != 'class'}
        return getattr(generators, node['class'])(device=device, dtype=dtype, **kwargs)

    return build(spec['generator'])


def request_points(spec, domain, seed, index, device, dtype):
    """The ``(d, n)`` points of request ``index``: uniform in the box
    ``domain = [(lo, hi), ...]``."""
    if spec.get('sampler', 'uniform') != 'uniform':
        raise ValueError(f"unknown sampler {spec['sampler']!r}")
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 'request', index))
    n = spec['points_per_request']
    u = torch.rand((len(domain), n), generator=g, device=device, dtype=dtype)
    for row, (lo, hi) in zip(u, domain):
        row.mul_(hi - lo).add_(lo)
    return u
