"""Host milliseconds per epoch in ``solver.backward``: the main thread's
time in the backward's dispatch. Its device time is
``backward_ms_per_epoch.train``'s."""
from portbench import spans

MOVES = 'train_points_per_s'


def read(s):
    t = spans.seconds(s, {'solver.backward'})
    return None if t is None else 1e3 * t / s.steps
