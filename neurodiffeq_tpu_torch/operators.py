r"""Vector calculus operators in cartesian coordinates (counterpart of the
cartesian part of ``neurodiffeq_tpu/operators.py``).

Every partial is read off the shared batched Taylor series of its field with
:func:`~neurodiffeq_tpu_torch.fields.diff`: one network forward serves all
of them. A field without a Taylor rule raises when it is evaluated, as
:mod:`~neurodiffeq_tpu_torch.fields` does (the per-sample compose fallback
is not ported). The spherical and cylindrical operators come with the
spherical slice (``ROADMAP.md`` §1 item 13).
"""
from .fields import Field, diff

__all__ = ['grad', 'div', 'curl', 'laplacian', 'vector_laplacian']


def _split_u_x(*us_xs):
    if len(us_xs) == 0 or len(us_xs) % 2 != 0:
        raise RuntimeError("Number of us and xs must be equal and positive")
    return us_xs[:len(us_xs) // 2], us_xs[len(us_xs) // 2:]


def grad(u, *xs):
    r"""All first partials of ``u`` w.r.t. the given coordinates.

    :param u: A scalar Field (N, 1).
    :param xs: Coordinate Fields.
    :return: List of Fields, the partial derivatives in order.
    """
    if not isinstance(u, Field):
        raise TypeError(f"grad expects a Field, got {type(u)}")
    for x in xs:
        if not isinstance(x, Field) or x.index is None:
            raise TypeError("grad expects coordinate Fields as independent variables")
    return [diff(u, x, shape_check=False) for x in xs]


def div(*us_xs):
    r"""Divergence of an n-dimensional vector field: sum_i d(u_i)/d(x_i).
    Input is ``(u_1, ..., u_n, x_1, ..., x_n)``."""
    us, xs = _split_u_x(*us_xs)
    total = diff(us[0], xs[0])
    for u, x in zip(us[1:], xs[1:]):
        total = total + diff(u, x)
    return total


def curl(u_x, u_y, u_z, x, y, z):
    r"""Curl of a 3-D cartesian vector field; returns the three components."""
    dxy, dxz = grad(u_x, y, z)
    dyx, dyz = grad(u_y, x, z)
    dzx, dzy = grad(u_z, x, y)
    return dzy - dyz, dxz - dzx, dyx - dxy


def laplacian(u, *xs):
    r"""Laplacian of a scalar field: the sum of its pure second partials."""
    total = diff(u, xs[0], 2)
    for x in xs[1:]:
        total = total + diff(u, x, 2)
    return total


def vector_laplacian(u_x, u_y, u_z, x, y, z):
    r"""Component-wise laplacian of a cartesian vector field."""
    return laplacian(u_x, x, y, z), laplacian(u_y, x, y, z), laplacian(u_z, x, y, z)
