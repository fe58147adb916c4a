r"""Vector calculus operators in cartesian, spherical and cylindrical
coordinates, and the high-dimensional ones (counterpart of
``neurodiffeq_tpu/operators.py``).

Every partial is read off the shared batched Taylor series of its field with
:func:`~neurodiffeq_tpu_torch.fields.diff`: one network forward serves all
of them. A field without a Taylor rule composes instead (repeated
``torch.autograd.grad`` on its batched function,
:func:`~neurodiffeq_tpu_torch.fields._nested_grad`), counting one fallback.

The spherical operators use the expanded metric forms of the JAX package
(``u_rr + 2 u_r / r + ...`` rather than ``diff(r^2 u_r, r) / r^2``), so that
each second derivative is a pure partial of a raw field component. A
derivative of a derivative along another axis is a mixed partial, recovered
in batch by polarization (:func:`~neurodiffeq_tpu_torch.ops.taylor.partial_entry`),
so the composed identities (``div(*grad(u))``, ``curl(*grad(u)) = 0``, div
of a curl, curl of a curl) run in every coordinate system. Physics
convention: theta is the polar angle, phi the azimuth.

The biharmonic and the stochastic estimators of the Laplacian and the
biharmonic (:func:`stde_laplacian`, :func:`stde_biharmonic`) are fields
without a Taylor rule, as in the JAX package: an axis-direction series is
the O(d) cost the estimators avoid. Each is one compose fallback: the rows
of its points, replicated once per probe (or basis pair), go through one
chain of directional derivatives, each a reverse-mode gradient.
"""
import zlib

import numpy as np
import torch

from .fields import Field, _call, atan2, cos, diff, sin, sqrt

__all__ = ['grad', 'div', 'curl', 'laplacian', 'vector_laplacian', 'stde_laplacian', 'biharmonic', 'stde_biharmonic',
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


def _check_operands(name, u, xs):
    if not isinstance(u, Field):
        raise TypeError(f"{name} expects a Field, got {type(u)}")
    for x in xs:
        if not isinstance(x, Field) or x.index is None:
            raise TypeError(f"{name} expects coordinate Fields as independent variables")
    if not xs:
        raise TypeError(f"{name} needs at least one coordinate")


def _directional_field(u, xs, vs, ws, weights):
    r"""The field :math:`\sum_j c_j D^k u[v_j, v_j, (w_j, w_j)]` of a scalar
    field ``u``: per row, a weighted sum over J directions of its second
    (``ws`` None) or fourth directional derivative.

    ``vs`` and ``ws`` are ``(N|1, J, len(xs))``: direction j of row r over
    the coordinates ``xs`` (the other coordinates' components are 0);
    ``weights`` is ``(J,)``. The rows are replicated J times (row
    ``j * N + r`` carries direction j of row r), and each level of the
    chain is one reverse-mode gradient of the ``J * N`` rows' sum,
    contracted with their directions: every row depends on its own point
    only, so that is the per-row directional derivative. It has no Taylor
    rule, so it is one compose fallback."""
    if u.width != 1:
        raise TypeError(f"expected a scalar field of one column, got {u.width} columns")
    idx = [x.index for x in xs]
    n_coords = u.coords.n_dims
    # the directions' coordinates in the gradient: all of them (the common case), a run, or a list
    pick = (slice(None) if idx == list(range(n_coords)) else
            slice(idx[0], idx[-1] + 1) if idx == list(range(idx[0], idx[-1] + 1)) else idx)
    levels = [vs, vs] if ws is None else [vs, vs, ws, ws]
    n_dirs = vs.shape[1]

    def fn(p):
        n = p.shape[0]
        rows = [lv.expand(n, -1, -1).transpose(0, 1).reshape(n_dirs * n, len(idx)) for lv in levels]
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            z = p.repeat(n_dirs, 1)
            if not z.requires_grad:
                z.requires_grad_()
            out = _call(u, z).reshape(-1)
            for k, r in enumerate(rows):
                if not out.requires_grad:  # constant in the points
                    out = torch.zeros_like(out)
                    break
                (g,) = torch.autograd.grad(out.sum(), z, create_graph=keep or k < len(rows) - 1)
                out = (g[:, pick] * r).sum(dim=1)
        total = (weights[:, None] * out.reshape(n_dirs, n)).sum(dim=0)[:, None]
        return total if keep else total.detach()

    return Field(u.coords, 1, fn)


def biharmonic(u, *xs):
    r"""The exact biharmonic :math:`\Delta^2 u = \sum_{i,j} \partial^4 u /
    \partial x_i^2 \partial x_j^2` (the plate operator), as
    :math:`\sum_{i \le j} w_{ij} D^4 u[e_i, e_i, e_j, e_j]` with
    :math:`w_{ii} = 1`, :math:`w_{i<j} = 2`: one chain of four directional
    derivatives over the rows replicated for the :math:`d(d+1)/2` basis
    pairs (:func:`_directional_field`), so its cost grows like
    :math:`d^2`; past d ~ 10 use :func:`stde_biharmonic`. Pair it with
    :class:`~neurodiffeq_tpu_torch.conditions.DirichletBoxND` ``(power=2)``
    for a clamped plate.

    :param u: A scalar Field (N, 1).
    :param xs: Coordinate Fields to sum over (all of them for the full biharmonic).
    :return: A scalar Field, exact.
    """
    _check_operands('biharmonic', u, xs)
    ii, jj = np.triu_indices(len(xs))
    p = u.coords.points
    eye = torch.eye(len(xs), dtype=p.dtype, device=p.device)
    weights = torch.tensor(np.where(ii == jj, 1.0, 2.0), dtype=p.dtype, device=p.device)
    return _directional_field(u, xs, eye[ii][None], eye[jj][None], weights)


# odd multipliers below 2**31: a product with a 32-bit value fits in int64
_MIX = (0x21f0aaad, 0x735a2d97)
_MASK32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (two multiply-xorshift rounds) of the int64
    tensor (or int) ``x`` in [0, 2**32), without overflow: the same bits on
    the CPU and on the card."""
    x = x ^ (x >> 16)
    x = (x * _MIX[0]) & _MASK32
    x = x ^ (x >> 15)
    x = (x * _MIX[1]) & _MASK32
    return x ^ (x >> 15)


def _stde_probes(points, indices, n_est, salt, tag, shape, shard=None):
    r"""Rademacher probes of ``shape`` (rows first), a pure function of the
    seed value (:func:`~neurodiffeq_tpu_torch.utils.seed_value`), the
    coordinate indices, ``n_est``, ``salt``, the estimator's ``tag`` and the
    bits of the points (as float32, summed modulo 2**32), the determinism
    contract of the JAX package (whose threefry streams torch cannot
    reproduce). Everything after the static key is integer arithmetic on
    the points' device: no value is read back to the host, and the CPU and
    the card give the same probes. Where ``points`` are one rank's block of
    a global batch (``shard``), the bits are summed over every rank and the
    elements numbered from the block's first row: each rank draws its rows
    of the unsharded run's probes, bit for bit."""
    from .utils import seed_value

    stable = np.asarray(list(indices) + [n_est, salt, tag], dtype=np.int64)
    folded = zlib.crc32(stable.tobytes()) & 0x7FFFFFFF
    static = _mix32(_mix32(int(seed_value()) & _MASK32) ^ folded)
    bits = points.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _MASK32
    total = bits.sum() if shard is None else shard.all_reduce(bits.sum())
    key = _mix32((total & _MASK32) ^ static)
    start = 0 if shard is None else shard.lo * int(np.prod(shape[1:]))
    element = torch.arange(start, start + int(np.prod(shape)), device=points.device)
    h = _mix32((_mix32(element ^ key) + static) & _MASK32)
    return (1 - 2 * (h >> 31)).to(points.dtype).reshape(shape)


def stde_laplacian(u, *xs, n_est=16, salt=0):
    r"""Unbiased stochastic estimator of the Laplacian for high-dimensional
    problems, the Stochastic Taylor Derivative Estimator (Shi et al. 2024,
    arXiv:2412.00088; Hutchinson trace estimation):

    .. math:: \widehat{\nabla^2 u} = \tfrac1J\sum_{j=1}^{J} v_j^T H v_j,
        \qquad v_j \in \{\pm 1\}^d \text{ (Rademacher)},

    unbiased since :math:`E[v v^T] = I`, at a cost in ``n_est`` = J and not
    in d. The probes are drawn per row from a hash of the points
    (:func:`_stde_probes`), so every fresh batch gets fresh probes: pair it
    with a stochastic generator. **Determinism contract:** the probes are a
    pure function of the seed (:func:`~neurodiffeq_tpu_torch.utils.set_seed`),
    the coordinate indices, ``n_est``, ``salt`` and the points; pass
    distinct ``salt`` values to decorrelate otherwise identical calls.

    It has no Taylor rule (as in the JAX package, a deliberate fallback): the
    J probes' second directional derivatives run as one chain over the
    rows replicated J times.

    :param u: A scalar Field (N, 1).
    :param xs: Coordinate Fields to sum second derivatives over.
    :param n_est: number of probe directions J, defaults to 16.
    :param salt: integer folded into the probe key, defaults to 0.
    :return: A scalar Field estimating :math:`\sum_i \partial^2 u/\partial x_i^2`.
    """
    _check_operands('stde_laplacian', u, xs)
    pts = u.coords.points
    probes = _stde_probes(pts, [x.index for x in xs], n_est, salt, 2, (pts.shape[0], n_est, len(xs)),
                          u.coords.shard)
    return _stde_laplacian_with(u, xs, probes)


def _stde_laplacian_with(u, xs, probes):
    """:func:`stde_laplacian` with given ``(N, n_est, len(xs))`` probes."""
    n_est = probes.shape[1]
    return _directional_field(u, xs, probes, None, torch.full((n_est,), 1.0 / n_est, dtype=probes.dtype,
                                                               device=probes.device))


def stde_biharmonic(u, *xs, n_est=16, salt=0):
    r"""Unbiased stochastic estimator of the biharmonic
    :math:`\Delta^2 u = \sum_{i,j} \partial^4 u / \partial x_i^2 \partial x_j^2`:

    .. math:: \widehat{\Delta^2 u} = \tfrac1J \sum_{j=1}^{J}
        D^4 u[v_j, v_j, w_j, w_j], \qquad v_j, w_j \in \{\pm 1\}^d
        \text{ independent}.

    Independence makes it unbiased (one probe used four times is not:
    :math:`E[D^4u[v,v,v,v]] = 3\Delta^2 u - 2\sum_i u_{iiii}`), and it is
    exact on additively separable functions such as :math:`\sum_i c_i
    x_i^4`. The probes follow :func:`stde_laplacian`'s determinism contract
    with their own tag, so a Laplacian estimate on the same points draws
    others. It has no Taylor rule: one fallback, the J pairs' fourth
    directional derivatives as one chain over the replicated rows. Pair it
    with :class:`~neurodiffeq_tpu_torch.conditions.DirichletBoxND`
    ``(power=2)`` for a clamped plate.

    :param u: A scalar Field (N, 1).
    :param xs: Coordinate Fields to sum over.
    :param n_est: number of probe pairs J, defaults to 16.
    :param salt: integer folded into the probe key, defaults to 0.
    :return: A scalar Field estimating the biharmonic.
    """
    _check_operands('stde_biharmonic', u, xs)
    pts = u.coords.points
    probes = _stde_probes(pts, [x.index for x in xs], n_est, salt, 4, (pts.shape[0], n_est, 2, len(xs)),
                          u.coords.shard)
    return _stde_biharmonic_with(u, xs, probes)


def _stde_biharmonic_with(u, xs, probes):
    """:func:`stde_biharmonic` with given ``(N, n_est, 2, len(xs))`` probe pairs."""
    n_est = probes.shape[1]
    return _directional_field(u, xs, probes[:, :, 0], probes[:, :, 1],
                              torch.full((n_est,), 1.0 / n_est, dtype=probes.dtype, device=probes.device))


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
