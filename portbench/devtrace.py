"""The traced slice of a run: ``torch.profiler`` over a fixed number of
steps of the measured window, reduced in memory to plain numbers that the
per-layer readers take.

Times are seconds on the profiler's clock. The slice is the span of a
``portbench.slice`` range that the harness opens right after the profiler
starts and closes before it stops, at step boundaries where the host has
just read the device back.
"""
import bisect
from collections import defaultdict
from dataclasses import dataclass, field

from . import stats

SLICE_RANGE = 'portbench.slice'
BACKWARD_PREFIX = 'autograd::engine::evaluate_function'
NO_OP = 'host: python between torch ops'
TOP = 10


@dataclass
class Slice:
    """What a reader sees of the traced steps."""
    steps: int  # epochs or requests in the slice
    lo: float  # the slice on the profiler's clock, seconds
    hi: float
    kernels: list  # (name, start, end): every device operation
    backward_s: float  # device seconds of the kernels launched under the autograd engine
    forward_bound_s: float  # the frozen least time of one forward at the cell's shape
    forward_patterns: list  # compiled patterns of kernels.d/
    host_ops: list = field(default_factory=list)  # (name, start, end): outermost host ops

    @property
    def window_s(self):
        return self.hi - self.lo

    def busy_s(self):
        return stats.busy([(s, e) for _, s, e in self.kernels], self.lo, self.hi)

    def kernel_seconds(self, patterns):
        """Device seconds in the slice of the operations whose names match
        any of ``patterns``."""
        return sum(min(e, self.hi) - max(s, self.lo) for name, s, e in self.kernels
                   if e > self.lo and s < self.hi and any(p.search(name) for p in patterns))

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        stretches by the host op running at their middle, each summed by name."""
        by_op = defaultdict(float)
        for name, s, e in self.kernels:
            if e > self.lo and s < self.hi:
                by_op[name[:160]] += min(e, self.hi) - max(s, self.lo)
        starts = [s for _, s, _ in self.host_ops]
        by_host = defaultdict(float)
        for g0, g1 in stats.gaps([(s, e) for _, s, e in self.kernels], self.lo, self.hi):
            by_host[_host_op_at(self.host_ops, starts, (g0 + g1) / 2)] += g1 - g0
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {'device_ops': top(by_op), 'idle_gaps': top(by_host)}


def _host_op_at(ops, starts, t):
    """The name of the latest-starting op in ``ops`` (sorted by start) that
    covers ``t``."""
    i = bisect.bisect_right(starts, t)
    for name, s, e in reversed(ops[max(0, i - 16):i]):
        if e >= t:
            return name
    return NO_OP


def _on_device(e):
    return getattr(e.device_type, 'name', str(e.device_type)).upper().endswith('CUDA')


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def reduce_events(events):
    """``(lo, hi, kernels, backward_s, host_ops)`` from ``torch.profiler``'s
    function events (anything with ``name``, ``device_type``,
    ``time_range.start``/``end`` in microseconds, ``cpu_parent`` and
    ``device_time_total``)."""
    us = 1e-6
    kernels, host_ops, backward_us, lo, hi = [], [], 0.0, None, None
    for e in events:
        if _on_device(e):  # a kernel, copy or fill; not a range annotated on the device's timeline
            if not getattr(e, 'is_user_annotation', False) and e.name != SLICE_RANGE:
                kernels.append((e.name, e.time_range.start * us, e.time_range.end * us))
            continue
        if e.name == SLICE_RANGE:
            lo, hi = e.time_range.start * us, e.time_range.end * us
            continue
        parents = list(_ancestors(e))
        if e.name.startswith(BACKWARD_PREFIX) and not any(p.name.startswith(BACKWARD_PREFIX) for p in parents):
            backward_us += e.device_time_total
        if not parents or (len(parents) == 1 and parents[0].name == SLICE_RANGE):
            host_ops.append((e.name, e.time_range.start * us, e.time_range.end * us))
    if lo is None:
        raise RuntimeError(f"the trace holds no {SLICE_RANGE!r} range")
    host_ops.sort(key=lambda op: op[1])
    return lo, hi, kernels, backward_us * us, host_ops


class Profiler:
    """Starts and stops ``torch.profiler`` around the slice, from the
    harness's step boundaries."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._range = None

    def start(self):
        from torch.autograd.profiler import record_function
        self._prof.start()
        self._range = record_function(SLICE_RANGE)
        self._range.__enter__()

    def stop(self):
        self._range.__exit__(None, None, None)
        self._prof.stop()

    def events(self):
        return self._prof.events()
