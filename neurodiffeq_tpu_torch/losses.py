r"""Loss registry (counterpart of ``neurodiffeq_tpu/losses.py``).

Each entry maps ``(residual, funcs, coords) -> scalar`` where ``residual``
is an ``(N, n_eq)`` :class:`~neurodiffeq_tpu_torch.fields.Field`. Only
``'l2'`` is ported so far; the rest of the registry waits for a later
slice (``ROADMAP.md``).
"""
from .fields import Field

__all__ = ['_losses']


def _value(r):
    return r.value if isinstance(r, Field) else r


def _l2_norm(residual, funcs, coords):
    return (_value(residual) ** 2).mean()


_losses = {
    'l2': _l2_norm,
}
