r"""Function bases: Legendre polynomials, Fourier series, real spherical
harmonics, and basis-space Laplacians (counterpart of
``neurodiffeq_tpu/function_basis.py``).

Every basis is Field-aware: called with coordinate Fields it returns an
``(N, K)`` Field usable inside residuals; called with tensors it returns a
tensor. The real spherical harmonics :math:`Y_{lm}(\theta, \phi)` (theta
the polar angle) come from closed-form associated Legendre functions, so
any ``max_degree`` works, with the JAX package's normalisation, which
leaves out the factor :math:`1/\sqrt{\pi}`.
"""
from math import comb, factorial

import numpy as np
import torch
from scipy.special import legendre

from ._version_utils import warn_deprecate_class
from .fields import Field, cat, diff
from .fields import cos as fcos, sin as fsin


def _y_name(l, m):
    """Name of a module-level harmonic: Y2_0, Y2n1, Y2p1, ..."""
    return f'Y{l}_0' if m == 0 else f'Y{l}{"n" if m < 0 else "p"}{abs(m)}'


__all__ = [
    'LegendrePolynomial', 'LegendreBasis', 'CustomBasis', 'ZonalSphericalHarmonics',
    'ZonalSphericalHarmonicsLaplacian', 'RealFourierSeries', 'FourierLaplacian',
    'RealSphericalHarmonics', 'HarmonicsLaplacian',
    'FunctionBasis', 'BasisOperator',
    'ZeroOrderSphericalHarmonics', 'ZeroOrderSphericalHarmonicsLaplacian',
] + [_y_name(l, m) for l in range(5) for m in range(-l, l + 1)]


class FunctionBasis:
    """Base class of the function bases: callables mapping coordinate
    Field(s) to an (N, K) basis Field."""


class BasisOperator:
    """Base class of the basis-space operators (the basis-space Laplacians)."""


class LegendrePolynomial:
    """The Legendre polynomial of degree ``degree``, evaluated Horner-style
    from scipy's coefficients."""

    def __init__(self, degree):
        self.degree = degree
        self.coefficients = [float(c) for c in legendre(degree).coefficients]

    def __call__(self, x):
        if self.degree == 0:
            return x * 0 + 1
        if self.degree == 1:
            return x * 1
        result = self.coefficients[0]
        for c in self.coefficients[1:]:
            result = result * x + c
        return result


class CustomBasis(FunctionBasis):
    """Column-concatenation of arbitrary callables."""

    def __init__(self, fns):
        self.fns = fns

    def __call__(self, *xs):
        outs = [fn(*xs) for fn in self.fns]
        if any(isinstance(o, Field) for o in outs):
            return cat(outs)
        return torch.cat([torch.atleast_2d(o) for o in outs], dim=1)


class LegendreBasis(FunctionBasis):
    """Legendre polynomials of degrees 0..max_degree as a basis."""

    def __init__(self, max_degree):
        self.basis_module = CustomBasis([LegendrePolynomial(d) for d in range(max_degree + 1)])

    def __call__(self, x):
        return self.basis_module(x)


class ZonalSphericalHarmonics(FunctionBasis):
    r"""Zonal harmonics (order m = 0): :math:`\sqrt{(2l+1)/(4\pi)}\,P_l(\cos\theta)`.

    :param max_degree: highest degree l (inclusive); degrees 0..max_degree.
    :param degrees: an explicit list of degrees (instead of max_degree).
    """

    def __init__(self, max_degree=None, degrees=None):
        if max_degree is None and degrees is None:
            raise ValueError("Either `max_degree` or `degrees` must be specified")
        if max_degree is not None and degrees is not None:
            raise ValueError("Only one of `max_degree` and `degrees` can be specified")
        if degrees is None:
            degrees = list(range(max_degree + 1))
        self.degrees = degrees
        coefficients = [np.sqrt((2 * l + 1) / (4 * np.pi)) for l in self.degrees]
        polynomials = [LegendrePolynomial(d) for d in self.degrees]
        self.basis_module = CustomBasis([(lambda theta, c=c, fn=fn: fn(fcos(theta)) * c)
                                         for c, fn in zip(coefficients, polynomials)])

    @property
    def max_degree(self):
        return max(self.degrees)

    def __call__(self, theta, phi):
        return self.basis_module(theta)


def _radial_second_derivatives(base_coeffs, r):
    r""":math:`\partial_r^2 (R_j r) / r` for every column j of the coefficients."""
    coeffs_times_r = base_coeffs * r
    return cat([diff(coeffs_times_r[:, j:j + 1], r, order=2)
                for j in range(base_coeffs.shape[1])]) / r


class ZonalSphericalHarmonicsLaplacian(BasisOperator):
    r"""Basis-space laplacian for zonal harmonics: the angular part is the
    closed form :math:`-l(l+1)R/r^2` and the radial part
    :math:`\partial_r^2 (R\,r)/r`."""

    def __init__(self, max_degree=None, degrees=None):
        self.harmonics_fn = ZonalSphericalHarmonics(max_degree=max_degree, degrees=degrees)
        self.laplacian_coefficients = np.asarray([-l * (l + 1) for l in self.harmonics_fn.degrees],
                                                 dtype=np.float64)

    def __call__(self, base_coeffs, r, theta, phi):
        angular_components = self.laplacian_coefficients * base_coeffs / r ** 2
        products = (_radial_second_derivatives(base_coeffs, r) + angular_components) * self.harmonics_fn(theta, phi)
        return products.sum(axis=1, keepdims=True)


ZeroOrderSphericalHarmonics = warn_deprecate_class(ZonalSphericalHarmonics)
ZeroOrderSphericalHarmonicsLaplacian = warn_deprecate_class(ZonalSphericalHarmonicsLaplacian)


class RealFourierSeries(FunctionBasis):
    r"""Real Fourier series on an angle:
    ``[1/(2 sqrt(pi)), cos(phi)/sqrt(pi), sin(phi)/sqrt(pi), cos(2 phi)/sqrt(pi), ...]``.

    :param max_degree: highest degree of the series; defaults to 12.
    """

    def __init__(self, max_degree=12):
        self.max_degree = max_degree
        fns = [lambda phi: phi * 0 + 0.5 / np.sqrt(np.pi)]
        for deg in range(1, self.max_degree + 1):
            fns.append(lambda phi, deg=deg: fcos(deg * phi) / np.sqrt(np.pi))
            fns.append(lambda phi, deg=deg: fsin(deg * phi) / np.sqrt(np.pi))
        self.basis_module = CustomBasis(fns)

    def __call__(self, phi):
        """:param phi: angles, an (N, 1) Field or tensor.
        :return: the basis at each angle, (N, 2 max_degree + 1)."""
        return self.basis_module(phi)


class FourierLaplacian(BasisOperator):
    r"""The polar-coordinate laplacian of :math:`\sum_i R_i(r)F_i(\phi)`,
    :math:`F_i` a Fourier component: per-column radial derivatives plus the
    closed-form angular coefficients :math:`-\mathrm{deg}_i^2`."""

    def __init__(self, max_degree=12):
        self.harmonics_fn = RealFourierSeries(max_degree=max_degree)
        self.laplacian_coefficients = np.asarray(
            [0] + [-deg ** 2 for deg in range(1, max_degree + 1) for _ in range(2)], dtype=np.float64)

    def __call__(self, base_coeffs, r, phi):
        """:param base_coeffs: the coefficients R_i(r), an (N, K) Field.
        :param r, phi: polar coordinate Fields, (N, 1) each.
        :return: the laplacian at (r, phi), an (N, 1) Field."""
        radial_components = cat([
            diff(base_coeffs[:, j:j + 1], r) / r + diff(base_coeffs[:, j:j + 1], r, order=2)
            for j in range(base_coeffs.shape[1])])
        angular_components = self.laplacian_coefficients * base_coeffs / r ** 2
        products = (radial_components + angular_components) * self.harmonics_fn(phi)
        return products.sum(axis=1, keepdims=True)


def _gen_binom(alpha, k):
    """The generalised binomial coefficient C(alpha, k) for real alpha."""
    out = 1.0
    for i in range(k):
        out *= (alpha - i) / (k - i)
    return out


def _assoc_legendre_fn(l, m):
    r"""The associated Legendre function :math:`P_l^m(\cos\theta)` (with
    the Condon-Shortley phase) as a function of ``cos_t`` and ``sin_t``:
    :math:`(-1)^m 2^l \sin^m\theta \sum_{k=m}^{l} \frac{k!}{(k-m)!}
    \cos^{k-m}\theta \binom{l}{k} \binom{(l+k-1)/2}{l}`."""

    def P(cos_t, sin_t):
        total = 0.
        for k in range(m, l + 1):
            c = (factorial(k) / factorial(k - m)) * comb(l, k) * _gen_binom((l + k - 1) / 2.0, l)
            total = total + c * cos_t ** (k - m)
        return ((-1) ** m * 2 ** l) * (sin_t ** m) * total

    return P


class RealSphericalHarmonics(FunctionBasis):
    r"""Real spherical harmonics :math:`Y_{lm}(\theta, \phi)` of degrees
    0..max_degree, in columns ordered (l=0, m=0), (l=1, m=-1..1),
    (l=2, m=-2..2), ...

    :param max_degree: highest degree l.
    """

    def __init__(self, max_degree=4):
        self.max_degree = max_degree
        self.basis_module = CustomBasis([self._make_fn(l, m)
                                         for l in range(max_degree + 1) for m in range(-l, l + 1)])

    @staticmethod
    def _make_fn(l, m):
        am = abs(m)
        # the real-form normalisation without the factor 1/sqrt(pi); the
        # (-1)^m below cancels the Condon-Shortley phase of P_l^m
        norm = np.sqrt((2 * l + 1) / 4 * factorial(l - am) / factorial(l + am))
        if m != 0:
            norm *= np.sqrt(2.0)
        P = _assoc_legendre_fn(l, am)

        if m < 0:
            def fn(theta, phi):
                return ((-1) ** am) * norm * P(fcos(theta), fsin(theta)) * fsin(am * phi)
        elif m == 0:
            def fn(theta, phi):
                return norm * P(fcos(theta), fsin(theta)) + 0 * phi
        else:
            def fn(theta, phi):
                return ((-1) ** am) * norm * P(fcos(theta), fsin(theta)) * fcos(am * phi)
        return fn

    def __call__(self, theta, phi):
        """:param theta: polar angles, an (N, 1) Field or tensor.
        :param phi: azimuthal angles, an (N, 1) Field or tensor.
        :return: the basis, (N, (max_degree + 1)^2)."""
        return self.basis_module(theta, phi)


# the module-level harmonics Y0_0 ... Y4p4, from the same closed forms
for _l in range(5):
    for _m in range(-_l, _l + 1):
        globals()[_y_name(_l, _m)] = RealSphericalHarmonics._make_fn(_l, _m)
del _l, _m


class HarmonicsLaplacian(BasisOperator):
    r"""Basis-space spherical laplacian for real spherical harmonics: with
    :math:`u = \sum_{l,m} R_{l,m}(r) Y_{l,m}(\theta,\phi)`, the angular part
    contributes :math:`-l(l+1)R/r^2` and the radial part
    :math:`\partial_r^2(R\,r)/r`, which avoids the :math:`1/\sin\theta`
    singularity."""

    def __init__(self, max_degree=4):
        self.harmonics_fn = RealSphericalHarmonics(max_degree=max_degree)
        self.laplacian_coefficients = np.asarray(
            [-l * (l + 1) for l in range(max_degree + 1) for _ in range(-l, l + 1)], dtype=np.float64)

    def __call__(self, base_coeffs, r, theta, phi):
        angular_components = self.laplacian_coefficients * base_coeffs / r ** 2
        products = (_radial_second_derivatives(base_coeffs, r) + angular_components) * self.harmonics_fn(theta, phi)
        return products.sum(axis=1, keepdims=True)
