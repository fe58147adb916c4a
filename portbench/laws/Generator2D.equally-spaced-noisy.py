"""The law of ``Generator2D(grid, xy_min, xy_max, method='equally-spaced-noisy')``:
one point at each node of the grid of ``grid[i]`` equally spaced values on
[xy_min[i], xy_max[i]] per axis, moved on each axis by fresh Gaussian noise
of standard deviation ``xy_noise_std[i]``, by default a quarter of
(xy_max[i] - xy_min[i]) / grid[i] (neurodiffeq's default)."""
import math

import torch

from portbench import stats

COLUMNS = 2
REACH = 10  # standard deviations of noise past which no point lies (odds under 1e-22 a point)
GRID = 4001  # points at which each distribution is read


def _axis(node, i):
    a, b, n = node['xy_min'][i], node['xy_max'][i], node['grid'][i]
    std = node.get('xy_noise_std')
    return a, b, n, (std[i] if std else (b - a) / n / 4)


def _offset_cdf(d, nodes, sigma):
    """P(x - (the node nearest x) <= d) for x = a node drawn evenly plus
    N(0, sigma^2), the edge nodes' wide cells included."""
    n, h = nodes.numel(), float(nodes[1] - nodes[0])
    phi = lambda x: torch.special.ndtr(x / sigma)
    reach = math.ceil(REACH * sigma / h) + 1
    i = torch.arange(n, device=d.device)[:, None]
    j = i + torch.arange(-reach, reach + 1, device=d.device)[None, :]
    ok = (j >= 0) & (j < n)
    j = j.clamp(0, n - 1)
    lo = torch.where(j == 0, torch.full_like(nodes[j], -math.inf), nodes[j] - h / 2)
    hi = torch.where(j == n - 1, torch.full_like(nodes[j], math.inf), nodes[j] + h / 2)
    out = []
    for part in d.split(256):
        top = torch.minimum(hi[None], nodes[j][None] + part[:, None, None])
        p = (phi(top - nodes[i][None]) - phi(lo[None] - nodes[i][None])).clamp_min(0) * ok[None]
        out.append(p.sum((1, 2)) / n)
    return torch.cat(out)


def check(node, cols):
    """Points farther than REACH standard deviations outside the box, and
    the largest sqrt(N) times Kolmogorov-Smirnov distance of each axis's
    values from the law's, and of each point's offset from its nearest node
    from the law's: no noise, a noise of the wrong size, or a part of the
    grid left out reads far above the sound draw's."""
    outside, law = 0, 0.0
    for i, c in enumerate(cols):
        a, b, n, sigma = _axis(node, i)
        c = c.double().reshape(-1)
        outside += int(((c < a - REACH * sigma) | (c > b + REACH * sigma)).sum())
        nodes = torch.linspace(a, b, n, dtype=torch.float64, device=c.device)
        span = torch.linspace(a - REACH * sigma, b + REACH * sigma, GRID, dtype=torch.float64, device=c.device)
        law = max(law, stats.ks_on_grid(c, lambda x: torch.special.ndtr((x[:, None] - nodes) / sigma).mean(1), span))
        h = (b - a) / (n - 1)
        near = nodes[((c - a) / h).round().clamp(0, n - 1).long()]
        reach = h / 2 + REACH * sigma
        offsets = torch.linspace(-reach, reach, GRID, dtype=torch.float64, device=c.device)
        law = max(law, stats.ks_on_grid(c - near, lambda d: _offset_cdf(d, nodes, sigma), offsets))
    return {'outside': outside, 'law': law}
