"""The host's own milliseconds per epoch: the traced slice less the time
the main thread spent in ``solver.readback``, the epoch's one wait for the
device, per epoch. Where it nears the epoch's time, the host paces."""
from portbench import spans

MOVES = 'train_points_per_s'


def read(s):
    wait = spans.seconds(s, {'solver.readback'})
    return None if wait is None else 1e3 * (s.window_s - wait) / s.steps
