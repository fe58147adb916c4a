"""``laplace2d-fcnn512`` through the port: the flagship 2-D Laplace
Dirichlet problem on ``Solver2D`` with an FCNN 2-512-1 and Adam
(neurodiffeq's README example; ``__graft_entry__._flagship_solver``)."""
import math

from portbench import port


def build(cfg, layers, train_generator, rng, device, dtype):
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import DirichletBVP2D
    from neurodiffeq_tpu_torch.fields import diff
    from neurodiffeq_tpu_torch.generators import Generator2D
    from neurodiffeq_tpu_torch.solvers import Solver2D

    (x0, x1), (y0, y1) = cfg['domain']
    cond = DirichletBVP2D(x_min=x0, x_min_val=lambda y: 0 * y, x_max=x1, x_max_val=lambda y: 0 * y,
                          y_min=y0, y_min_val=lambda x: F.sin(math.pi * x), y_max=y1, y_max_val=lambda x: 0 * x)
    net = port.fcnn(cfg, layers, device, dtype)
    grid = tuple(cfg['published']['train_grid'])
    solver = Solver2D(
        pde_system=lambda u, x, y: [diff(u, x, 2) + diff(u, y, 2)], conditions=[cond],
        xy_min=(x0, y0), xy_max=(x1, y1), nets=[net],
        train_generator=train_generator or Generator2D(grid, (x0, y0), (x1, y1), method='equally-spaced-noisy',
                                                       device=device, dtype=dtype),
        valid_generator=Generator2D(grid, (x0, y0), (x1, y1), method='equally-spaced', device=device, dtype=dtype),
        optimizer=port.optimizer(cfg, net.parameters()), n_batches_valid=cfg['n_batches_valid'],
        device=device, dtype=dtype, generator=rng)
    return {'solver': solver, 'net': net, 'callbacks': port.schedule_callbacks(cfg, solver.optimizer)}
