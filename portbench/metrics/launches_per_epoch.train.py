"""Device operations (kernels, copies, fills) launched per epoch in the
traced slice: the host's dispatch work, which sets the pace where the device
waits."""
MOVES = 'train_points_per_s'


def read(s):
    n = sum(1 for _, start, _ in s.kernels if s.lo <= start <= s.hi)
    return n / s.steps if n else None
