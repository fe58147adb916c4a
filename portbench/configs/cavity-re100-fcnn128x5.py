"""``cavity-re100-fcnn128x5`` through the port: the primitive (u, v, p)
lid-driven cavity at Re 100 on ``Solver2D``, one FCNN 2-(128x5)-3 shared by
three hard conditions, Adam under the cosine anneal as a ``LambdaLR``
stepped once per epoch (``examples/lid_driven_cavity.py::build_deep``, as
``chip_smoke.py::cavity_problem`` and ``cavity_solver`` port it)."""
import warnings

from portbench import port


def build(cfg, layers, train_generator, rng, device, dtype):
    from neurodiffeq_tpu_torch import fields as F
    from neurodiffeq_tpu_torch.conditions import BaseCondition
    from neurodiffeq_tpu_torch.fields import diff
    from neurodiffeq_tpu_torch.generators import Generator1D, Generator2D
    from neurodiffeq_tpu_torch.solvers import Solver2D

    a, nu = cfg['lid_sharpness'], 1.0 / cfg['Re']

    def u_lid(x):
        return (1 - F.exp(-a * x)) * (1 - F.exp(a * (x - 1)))

    class HardCavityU(BaseCondition):
        def parameterize(self, out, x, y):
            return x * (1 - x) * y * (1 - y) * out + y * u_lid(x)

    class HardCavityV(BaseCondition):
        def parameterize(self, out, x, y):
            return x * (1 - x) * y * (1 - y) * out

    class HardCavityP(BaseCondition):
        def parameterize(self, out, x, y):
            return (1 - F.exp(-x)) * (1 - F.exp(-y)) * out

    def equations(u, v, p, x, y):
        return [u * diff(u, x) + v * diff(u, y) + diff(p, x) - nu * (diff(u, x, 2) + diff(u, y, 2)),
                u * diff(v, x) + v * diff(v, y) + diff(p, y) - nu * (diff(v, x, 2) + diff(v, y, 2)),
                diff(u, x) + diff(v, y)]

    conds = [HardCavityU(), HardCavityV(), HardCavityP()]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)
        for i, c in enumerate(conds):
            c.set_impose_on(i)
    net = port.fcnn(cfg, layers, device, dtype)
    (x0, x1), (y0, y1) = cfg['domain']
    n = cfg['published']['train_points']
    solver = Solver2D(
        pde_system=equations, conditions=conds, xy_min=(x0, y0), xy_max=(x1, y1), nets=[net] * len(conds),
        train_generator=train_generator or (Generator1D(n, x0, x1, method='uniform', device=device, dtype=dtype)
                                            * Generator1D(n, y0, y1, method='uniform', device=device, dtype=dtype)),
        valid_generator=Generator2D((32, 32), (x0, y0), (x1, y1), method='equally-spaced', device=device,
                                    dtype=dtype),
        optimizer=port.optimizer(cfg, net.parameters()), n_batches_valid=cfg['n_batches_valid'],
        device=device, dtype=dtype, generator=rng)
    return {'solver': solver, 'net': net, 'callbacks': port.schedule_callbacks(cfg, solver.optimizer)}
