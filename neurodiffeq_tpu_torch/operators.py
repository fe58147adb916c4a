r"""Vector calculus operators in cartesian, spherical and cylindrical
coordinates (counterpart of ``neurodiffeq_tpu/operators.py`` but its
high-dimensional and stochastic operators).

Every partial is read off the shared batched Taylor series of its field with
:func:`~neurodiffeq_tpu_torch.fields.diff`: one network forward serves all
of them. A field without a Taylor rule raises when it is evaluated, as
:mod:`~neurodiffeq_tpu_torch.fields` does (the per-sample compose fallback
is not ported).

The spherical operators use the expanded metric forms of the JAX package
(``u_rr + 2 u_r / r + ...`` rather than ``diff(r^2 u_r, r) / r^2``), so that
each second derivative is a pure partial of a raw field component. A
derivative of a derivative along another axis is a mixed partial, recovered
in batch by polarization (:func:`~neurodiffeq_tpu_torch.ops.taylor.partial_entry`),
so the composed identities (``div(*grad(u))``, ``curl(*grad(u)) = 0``, div
of a curl, curl of a curl) run in every coordinate system. Physics
convention: theta is the polar angle, phi the azimuth.
"""
from .fields import Field, atan2, cos, diff, sin, sqrt

__all__ = ['grad', 'div', 'curl', 'laplacian', 'vector_laplacian',
           'spherical_curl', 'spherical_grad', 'spherical_div', 'spherical_laplacian',
           'spherical_vector_laplacian', 'spherical_to_cartesian', 'cartesian_to_spherical',
           'cylindrical_grad', 'cylindrical_div', 'cylindrical_curl', 'cylindrical_laplacian',
           'cylindrical_vector_laplacian', 'cylindrical_to_cartesian', 'cartesian_to_cylindrical']


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


# ----------------------------------------------------------------- spherical

def spherical_curl(u_r, u_theta, u_phi, r, theta, phi):
    r"""Curl in spherical coordinates (r, theta, phi); returns its three components."""
    ur_dth, ur_dph = grad(u_r, theta, phi)
    uth_dr, uth_dph = grad(u_theta, r, phi)
    uph_dr, uph_dth = grad(u_phi, r, theta)
    csc_th = 1 / sin(theta)
    r_inv = 1 / r

    curl_r = r_inv * (uph_dth + (u_phi * cos(theta) - uth_dph) * csc_th)
    curl_th = r_inv * (csc_th * ur_dph - u_phi) - uph_dr
    curl_ph = uth_dr + r_inv * (u_theta - ur_dth)
    return curl_r, curl_th, curl_ph


def spherical_grad(u, r, theta, phi):
    r"""Gradient in spherical coordinates: (du/dr, du/dtheta / r, du/dphi / (r sin theta))."""
    u_dr, u_dth, u_dph = grad(u, r, theta, phi)
    r_inv = 1 / r
    return u_dr, u_dth * r_inv, u_dph * r_inv / sin(theta)


def spherical_div(u_r, u_theta, u_phi, r, theta, phi):
    r"""Divergence in spherical coordinates, in the expanded metric form:
    :math:`\partial_r u_r + 2u_r/r + (\partial_\theta u_\theta + \cot\theta\,u_\theta)/r
    + \partial_\phi u_\phi/(r\sin\theta)`."""
    cot_th = cos(theta) / sin(theta)
    return (diff(u_r, r) + 2 * u_r / r
            + (diff(u_theta, theta) + cot_th * u_theta) / r
            + diff(u_phi, phi) / (r * sin(theta)))


def _expanded_spherical_scalar_lap(u_dr, u_dth, u_dph, r, theta, phi,
                                   r_inv, r2_inv, cot_th, csc2_th):
    """The expanded laplacian given u's first partials:
    u_rr + 2 u_r / r + (u_thth + cot(th) u_th) / r^2 + u_phph / (r^2 sin^2 th).
    Every second derivative is a pure partial of u."""
    return (diff(u_dr, r) + 2 * u_dr * r_inv
            + (diff(u_dth, theta) + cot_th * u_dth) * r2_inv
            + diff(u_dph, phi) * (csc2_th * r2_inv))


def spherical_laplacian(u, r, theta, phi):
    r"""Scalar laplacian in spherical coordinates (expanded metric form)."""
    u_dr, u_dth, u_dph = grad(u, r, theta, phi)
    sin_th = sin(theta)
    r_inv = 1 / r
    return _expanded_spherical_scalar_lap(
        u_dr, u_dth, u_dph, r, theta, phi,
        r_inv, r_inv ** 2, cos(theta) / sin_th, 1 / sin_th ** 2)


def spherical_vector_laplacian(u_r, u_theta, u_phi, r, theta, phi):
    r"""Vector laplacian in spherical coordinates, with the metric coupling
    terms (expanded metric form)."""
    ur_dr, ur_dth, ur_dph = grad(u_r, r, theta, phi)
    uth_dr, uth_dth, uth_dph = grad(u_theta, r, theta, phi)
    uph_dr, uph_dth, uph_dph = grad(u_phi, r, theta, phi)
    sin_th, cos_th = sin(theta), cos(theta)
    sin2_th = sin_th ** 2
    r2 = r ** 2
    r_inv = 1 / r
    r2_inv = r_inv ** 2
    cot_th = cos_th / sin_th
    csc2_th = 1 / sin2_th

    scalar_lap_r = _expanded_spherical_scalar_lap(
        ur_dr, ur_dth, ur_dph, r, theta, phi, r_inv, r2_inv, cot_th, csc2_th)
    scalar_lap_th = _expanded_spherical_scalar_lap(
        uth_dr, uth_dth, uth_dph, r, theta, phi, r_inv, r2_inv, cot_th, csc2_th)
    scalar_lap_ph = _expanded_spherical_scalar_lap(
        uph_dr, uph_dth, uph_dph, r, theta, phi, r_inv, r2_inv, cot_th, csc2_th)

    vec_lap_r = scalar_lap_r - 2 * (u_r + uth_dth + (cos_th * u_theta + uph_dph) / sin_th) / r2
    vec_lap_th = scalar_lap_th + (2 * ur_dth - (u_theta + 2 * cos_th * uph_dph) / sin2_th) / r2
    vec_lap_ph = scalar_lap_ph + ((2 * cos_th * uth_dph - u_phi) / sin_th + 2 * ur_dph) / (r2 * sin_th)
    return vec_lap_r, vec_lap_th, vec_lap_ph


def spherical_to_cartesian(r, theta, phi):
    r"""Spherical (r, theta, phi) to cartesian (x, y, z); Field-aware."""
    rho = r * sin(theta)
    return rho * cos(phi), rho * sin(phi), r * cos(theta)


def cartesian_to_spherical(x, y, z):
    r"""Cartesian (x, y, z) to spherical (r, theta, phi); Field-aware."""
    rho2 = x ** 2 + y ** 2
    return sqrt(rho2 + z ** 2), atan2(sqrt(rho2), z), atan2(y, x)


# --------------------------------------------------------------- cylindrical

def cylindrical_grad(u, rho, phi, z):
    r"""Gradient in cylindrical coordinates (rho, phi, z)."""
    u_drho, u_dphi, u_dz = grad(u, rho, phi, z)
    return u_drho, u_dphi / rho, u_dz


def cylindrical_div(u_rho, u_phi, u_z, rho, phi, z):
    r"""Divergence in cylindrical coordinates."""
    return diff(u_rho, rho) + (u_rho + diff(u_phi, phi)) / rho + diff(u_z, z)


def cylindrical_curl(u_rho, u_phi, u_z, rho, phi, z):
    r"""Curl in cylindrical coordinates; returns its three components."""
    urho_dphi, urho_dz = grad(u_rho, phi, z)
    uphi_drho, uphi_dz = grad(u_phi, rho, z)
    uz_drho, uz_dphi = grad(u_z, rho, phi)
    return (
        uz_dphi / rho - uphi_dz,
        urho_dz - uz_drho,
        uphi_drho + (u_phi - urho_dphi) / rho,
    )


def cylindrical_laplacian(u, rho, phi, z):
    r"""Scalar laplacian in cylindrical coordinates."""
    u_drho, u_dphi, u_dz = grad(u, rho, phi, z)
    return diff(u_drho, rho) + u_drho / rho + diff(u_dphi, phi) / rho ** 2 + diff(u_dz, z)


def cylindrical_vector_laplacian(u_rho, u_phi, u_z, rho, phi, z):
    r"""Vector laplacian in cylindrical coordinates."""
    rho2 = rho ** 2
    urho_drho, urho_dphi, urho_dz = grad(u_rho, rho, phi, z)
    uphi_drho, uphi_dphi, uphi_dz = grad(u_phi, rho, phi, z)
    uz_drho, uz_dphi, uz_dz = grad(u_z, rho, phi, z)

    scalar_lap_rho = diff(urho_drho, rho) + urho_drho / rho + diff(urho_dphi, phi) / rho2 + diff(urho_dz, z)
    scalar_lap_phi = diff(uphi_drho, rho) + uphi_drho / rho + diff(uphi_dphi, phi) / rho2 + diff(uphi_dz, z)
    scalar_lap_z = diff(uz_drho, rho) + uz_drho / rho + diff(uz_dphi, phi) / rho2 + diff(uz_dz, z)

    return (
        scalar_lap_rho - (u_rho + 2 * uphi_dphi) / rho2,
        scalar_lap_phi + (2 * urho_dphi - u_phi) / rho2,
        scalar_lap_z,
    )


def cylindrical_to_cartesian(rho, phi, z):
    r"""Cylindrical (rho, phi, z) to cartesian (x, y, z); Field-aware."""
    return rho * cos(phi), rho * sin(phi), z


def cartesian_to_cylindrical(x, y, z):
    r"""Cartesian (x, y, z) to cylindrical (rho, phi, z); Field-aware."""
    return sqrt(x ** 2 + y ** 2), atan2(y, x), z
