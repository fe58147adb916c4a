"""Device milliseconds per epoch of the kernels launched under PyTorch's
``autograd::engine::evaluate_function`` ranges (outermost ones only): the
backward, whatever the program names its parts."""
MOVES = 'train_points_per_s'


def read(s):
    return 1e3 * s.backward_s / s.steps if s.backward_s > 0 else None
