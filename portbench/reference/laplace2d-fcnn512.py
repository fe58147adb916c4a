"""Plain reference of ``laplace2d-fcnn512``: Laplace's equation on the unit
square under ``DirichletBVP2D``'s reparameterisation (Lagaris et al. 1998;
neurodiffeq's ``DirichletBVP2D``), u = A(x, y) + x~(1 - x~) y~(1 - y~) N(x, y),
with u = sin(pi x) on y = y0 and 0 on the other three sides."""
import math

import torch

from portbench.reference.plain import d, mlp


def boundary(cfg):
    """The four sides' values f0(y), f1(y) (x = x0, x1) and g0(x), g1(x)."""
    zero = lambda t: 0 * t
    return zero, zero, lambda x: torch.sin(math.pi * x), zero


def residuals(cfg, layers, x, y):
    (x0, x1), (y0, y1) = cfg['domain']
    f0, f1, g0, g1 = boundary(cfg)
    xt, yt = (x - x0) / (x1 - x0), (y - y0) / (y1 - y0)
    xa, xb = x * 0 + x0, x * 0 + x1
    A = ((1 - xt) * f0(y) + xt * f1(y)
         + (1 - yt) * (g0(x) - ((1 - xt) * g0(xa) + xt * g0(xb)))
         + yt * (g1(x) - ((1 - xt) * g1(xa) + xt * g1(xb))))
    u = A + xt * (1 - xt) * yt * (1 - yt) * mlp(layers, torch.cat([x, y], 1), cfg['activation'])
    return [d(d(u, x), x) + d(d(u, y), y)]
