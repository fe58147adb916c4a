"""The whole training step's share of the chip's float32-accurate peak:
three times the frozen least time of one forward (forward and backward, by
the usual convention) per epoch, over the slice's seconds per epoch."""
MOVES = 'train_points_per_s'


def read(s):
    return 100.0 * 3.0 * s.forward_bound_s * s.steps / s.window_s
