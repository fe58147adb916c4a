"""The law of ``Generator1D(size, t_min, t_max, method='uniform')``: each
point uniform on [t_min, t_max], drawn afresh every batch."""
from portbench import stats

COLUMNS = 1


def check(node, cols):
    """Points outside [t_min, t_max], and sqrt(N) times the Kolmogorov-Smirnov
    distance from the uniform law."""
    (t,) = cols
    a, b = node.get('t_min', 0.0), node.get('t_max', 1.0)
    return {'outside': int(((t < a) | (t > b)).sum()), 'law': stats.ks_uniform((t.double() - a) / (b - a))}
