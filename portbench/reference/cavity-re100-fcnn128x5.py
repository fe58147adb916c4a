"""Plain reference of ``cavity-re100-fcnn128x5``: steady incompressible
Navier-Stokes in (u, v, p) on the unit square at Re 100, with the lid
u = (1 - e^{-a x})(1 - e^{a (x - 1)}) on y = 1, walls at rest and the
pressure pinned at the origin, all three imposed on the columns of one net:
u = x(1-x)y(1-y) N_u + y lid(x), v = x(1-x)y(1-y) N_v,
p = (1 - e^{-x})(1 - e^{-y}) N_p."""
import torch

from portbench.reference.plain import d, mlp


def residuals(cfg, layers, x, y):
    a, nu = cfg['lid_sharpness'], 1.0 / cfg['Re']
    out = mlp(layers, torch.cat([x, y], 1), cfg['activation'])
    bump = x * (1 - x) * y * (1 - y)
    lid = (1 - torch.exp(-a * x)) * (1 - torch.exp(a * (x - 1)))
    u = bump * out[:, 0:1] + y * lid
    v = bump * out[:, 1:2]
    p = (1 - torch.exp(-x)) * (1 - torch.exp(-y)) * out[:, 2:3]
    ux, uy, vx, vy = d(u, x), d(u, y), d(v, x), d(v, y)
    lap_u = d(ux, x) + d(uy, y)
    lap_v = d(vx, x) + d(vy, y)
    return [u * ux + v * uy + d(p, x) - nu * lap_u,
            u * vx + v * vy + d(p, y) - nu * lap_v,
            ux + vy]
