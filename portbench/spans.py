"""The program's solver spans in a traced slice: the outermost host ranges
named ``solver.*`` (``neurodiffeq_tpu_torch/tracing.py`` lists them), which
the host-side readers of ``metrics/`` sum. A program without spans reads
nothing."""
PREFIX = 'solver.'


def seconds(s, names):
    """Seconds of the slice's outermost host ranges named in ``names``, each
    clipped to ``[s.lo, s.hi]``; None where the slice holds no solver span."""
    if not any(name.startswith(PREFIX) for name, _, _ in s.host_ops):
        return None
    return sum(min(end, s.hi) - max(start, s.lo) for name, start, end in s.host_ops
               if name in names and end > s.lo and start < s.hi)
