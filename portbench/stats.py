"""The arithmetic that turns samples and intervals into metrics."""
import math


def percentile(samples, q):
    """The ``q``-th percentile (0-100) of every sample, by linear
    interpolation between the closest ranks (numpy's default)."""
    if not samples:
        raise ValueError("no samples")
    xs = sorted(samples)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units, seconds):
    """Units of work per second over the whole window, stalls included."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return units / seconds


def merged(intervals):
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def clipped(intervals, lo, hi):
    """The parts of ``intervals`` inside ``[lo, hi]``."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def busy(intervals, lo, hi):
    """Length of the union of ``intervals`` inside ``[lo, hi]``."""
    return sum(e - s for s, e in merged(clipped(intervals, lo, hi)))


def gaps(intervals, lo, hi):
    """The idle ``(start, end)`` stretches of ``[lo, hi]`` outside every
    interval, longest first."""
    out, t = [], lo
    for s, e in merged(clipped(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return sorted(out, key=lambda g: g[0] - g[1])


def ks_uniform(u):
    """sqrt(N) times the Kolmogorov-Smirnov distance between the ``N``
    values ``u`` (a tensor) and the uniform law on [0, 1]: under that law it
    follows Kolmogorov's distribution (above 1.95 once in a thousand)."""
    import torch

    u = u.double().reshape(-1).sort().values.clamp(0, 1)
    n = u.numel()
    k = torch.arange(1, n + 1, dtype=u.dtype, device=u.device)
    d = torch.maximum(k / n - u, u - (k - 1) / n).max()
    return float(d) * math.sqrt(n)


def ks_on_grid(values, cdf, grid):
    """sqrt(N) times the largest gap between the empirical distribution of
    the ``N`` values and ``cdf`` (a function of a tensor), read at the
    points ``grid``: a lower bound of the Kolmogorov-Smirnov statistic that
    comes within the law's rise between neighbouring grid points."""
    import torch

    v = values.double().reshape(-1).sort().values
    emp = torch.searchsorted(v, grid, right=True).double() / v.numel()
    return float((emp - cdf(grid)).abs().max()) * math.sqrt(v.numel())
