"""Host milliseconds per epoch in ``solver.forward`` and ``solver.residual``:
the host's cost of building the Taylor-mode loss, the kernels' launches
among it."""
from portbench import spans

MOVES = 'train_points_per_s'


def read(s):
    t = spans.seconds(s, {'solver.forward', 'solver.residual'})
    return None if t is None else 1e3 * t / s.steps
