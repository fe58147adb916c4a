"""The share of the traced slice in which no operation ran on the device:
1 - (union of the device operations' intervals) / (the slice's length)."""
MOVES = 'eval_points_per_s'


def read(s):
    return 100.0 * (1.0 - s.busy_s() / s.window_s) if s.kernels else None
