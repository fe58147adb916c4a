"""The forward kernels' share of their roofline: the frozen least time of
one Taylor-mode forward of the net at the cell's shape (cost.py), over the
device time per epoch of the kernels that kernels.d/ names."""
MOVES = 'train_points_per_s'


def read(s):
    t = s.kernel_seconds(s.forward_patterns) / s.steps
    return 100.0 * s.forward_bound_s / t if t > 0 else None
