"""The whole request's share of the chip's float32-accurate peak: the
frozen least time of one forward per request, over the slice's seconds
per request."""
MOVES = 'eval_points_per_s'


def read(s):
    return 100.0 * s.forward_bound_s * s.steps / s.window_s
