r"""Boundary-condition reparameterizations (counterpart of
``neurodiffeq_tpu/conditions.py``).

A condition transforms the *function*: ``enforce(net, *coords)`` composes
the network and the reparameterizing formula into one
:class:`~neurodiffeq_tpu_torch.fields.Field`, so every derivative of the
constrained solution flows through the condition exactly.
"""
import warnings

import numpy as np
import torch

from ._version_utils import deprecated_alias
from .fields import Field, abs as fabs, cat, exp, network_field, pin, tanh
from .utils import resolve

__all__ = ['BaseCondition', 'IrregularBoundaryCondition', 'EnsembleCondition', 'NoCondition', 'IVP',
           'BundleIVP', 'DirichletBVP', 'BundleDirichletBVP', 'DirichletBVP2D', 'DirichletBoxND', 'IBVP1D',
           'DoubleEndedBVP1D', 'DirichletBVPSpherical',
           'InfDirichletBVPSpherical', 'DirichletBVPSphericalBasis', 'InfDirichletBVPSphericalBasis']


def _ann_field(net, coordinates, ith_unit=None):
    """The raw network-output Field ``net(*coordinates)``; the network
    consumes exactly the passed coordinate components, in order."""
    for c in coordinates:
        if c.index is None:
            raise TypeError("enforce expects raw coordinate Fields")
    return network_field(net, coordinates, ith_unit=ith_unit)


def _const_field(value, like_field):
    """A Field of constant value on ``like_field``'s points (differentiable:
    every derivative is zero)."""
    def fn(p):
        return torch.as_tensor(value, dtype=p.dtype, device=p.device)

    def trule(ctx):
        from .ops.taylor import constant_series
        return constant_series(value, ctx, ctx.points.shape[0])

    return Field(like_field.coords, 1, fn, trule=trule)


class BaseCondition:
    r"""Base class for conditions: a condition re-parameterizes the output(s)
    of a network so that they satisfy initial/boundary conditions exactly.

    - *(re-)parameterize* is said of network outputs;
    - *enforce* is said of networks themselves.
    """

    def __init__(self):
        self.ith_unit = None

    def parameterize(self, output_tensor, *input_tensors):
        r"""Re-parameterize output(s) of a network (all arguments are Fields)."""
        raise ValueError(f"Abstract {self.__class__.__name__} cannot be parameterized")  # pragma: no cover

    def enforce(self, net, *coordinates):
        r"""Enforce this condition on a network.

        :param net: The network module.
        :param coordinates: Coordinate Fields, inputs of the network.
        :return: The re-parameterized output Field.
        """
        return self.parameterize(_ann_field(net, coordinates, ith_unit=self.ith_unit), *coordinates)

    def set_impose_on(self, ith_unit):
        r"""**[DEPRECATED]** Track which output unit of a shared multi-output
        network is being parameterized."""
        warnings.warn(f"`{self.__class__.__name__}.set_impose_on` is deprecated and will be "
                      f"removed in the future", DeprecationWarning)
        self.ith_unit = ith_unit


class _BundleConditionMixin:
    """Mixin for bundle conditions whose parameters (t_0, u_0, ...) may be
    sampled coordinates of the bundle.

    :param bundle_param_lookup: maps a parameter name to its index into the
        ``theta`` coordinates that follow ``t`` in ``parameterize``.
    :param allowed_params: legal names for ``bundle_param_lookup`` keys.
    """

    def __init__(self, bundle_param_lookup=None, allowed_params=None):
        self.bundle_param_lookup = bundle_param_lookup or {}
        if isinstance(allowed_params, str):
            allowed_params = set(allowed_params)
        if allowed_params:
            illegal_params = set(self.bundle_param_lookup) - set(allowed_params)
            if illegal_params:
                raise ValueError(
                    f"The following parameter(s) are not allowed in `bundle_parameters_lookup`: "
                    f"{illegal_params}.\nSupported parameter name(s) are: {allowed_params}.")

    def _get_parameter(self, param_name, thetas):
        if param_name in self.bundle_param_lookup:
            return thetas[self.bundle_param_lookup[param_name]]
        return getattr(self, param_name)


class IrregularBoundaryCondition(BaseCondition):
    """Base for conditions on irregular domains; adds an ``in_domain`` mask
    hook for monitors."""

    def in_domain(self, *coordinates):
        """Boolean array: whether each (numpy) point lies within the domain."""
        return np.ones_like(coordinates[0], dtype=bool)


class EnsembleCondition(BaseCondition):
    r"""Enforces sub-conditions on individual output units of a multi-output
    network.

    :param sub_conditions: Condition(s) to be ensemble'd.
    :param force: Whether to force ensembl'ing even when ``.enforce`` is
        overridden in a sub-condition.
    """

    def __init__(self, *sub_conditions, force=False):
        super().__init__()
        for i, c in enumerate(sub_conditions):
            if c.__class__.enforce != BaseCondition.enforce:
                msg = (f"{c.__class__.__name__} (index={i})'s overrides BaseCondition's "
                       f"`.enforce` method. Ensembl'ing is likely not going to work.")
                if force:
                    warnings.warn(msg)
                else:
                    raise ValueError(msg + "\nTry with `force=True` if you know what you are doing.")
        self.conditions = sub_conditions

    def parameterize(self, output_tensor, *input_tensors):
        r"""Re-parameterize each column individually with its sub-condition and
        concatenate the results."""
        if output_tensor.shape[1] != len(self.conditions):
            raise ValueError(f"number of output units ({output_tensor.shape[1]}) "
                             f"differs from number of conditions ({len(self.conditions)})")
        return cat([con.parameterize(output_tensor[:, i:i + 1], *input_tensors)
                    for i, con in enumerate(self.conditions)])


class NoCondition(BaseCondition):
    r"""A polymorphic condition performing no re-parameterization."""

    def parameterize(self, output_tensor, *input_tensors):
        return output_tensor


class IVP(BaseCondition):
    r"""An initial value problem:

    - Dirichlet: :math:`u(t_0)=u_0`, enforced as
      :math:`u(t) = u_0 + (1 - e^{-(t-t_0)})\,\mathrm{ANN}(t)`;
    - Neumann: :math:`u'(t_0)=u_0'`, enforced as
      :math:`u(t) = u_0 + (t-t_0)u_0' + (1 - e^{-(t-t_0)})^2\,\mathrm{ANN}(t)`.

    :param t_0: The initial time.
    :param u_0: The initial value of u.
    :param u_0_prime: The initial derivative of u w.r.t. t, defaults to None.
    """

    @deprecated_alias(x_0='u_0', x_0_prime='u_0_prime')
    def __init__(self, t_0, u_0=None, u_0_prime=None):
        super().__init__()
        self.t_0, self.u_0, self.u_0_prime = t_0, u_0, u_0_prime

    def parameterize(self, output_tensor, t):
        if self.u_0_prime is None:
            return self.u_0 + (1 - exp(-t + self.t_0)) * output_tensor
        return (self.u_0 + (t - self.t_0) * self.u_0_prime
                + ((1 - exp(-t + self.t_0)) ** 2) * output_tensor)


class BundleIVP(BaseCondition, _BundleConditionMixin):
    r"""An IVP over a bundle of parameters: any of t_0, u_0 and u_0' may be
    a sampled theta coordinate. With a sampled t_0 the factor
    :math:`1 - e^{-(t - t_0)}` becomes :math:`t - t_0`, polynomial, so that
    the constraint stays exact for every sampled t_0.

    :param t_0: The initial time (unless sampled).
    :param u_0: The initial value of u (unless sampled).
    :param u_0_prime: The initial derivative of u, defaults to None.
    :param bundle_param_lookup: maps 't_0', 'u_0' or 'u_0_prime' to the
        index of its theta coordinate.
    """

    @deprecated_alias(x_0='u_0', x_0_prime='u_0_prime', bundle_conditions='bundle_param_lookup')
    def __init__(self, t_0=None, u_0=None, u_0_prime=None, bundle_param_lookup=None):
        BaseCondition.__init__(self)
        _BundleConditionMixin.__init__(self, bundle_param_lookup=bundle_param_lookup,
                                       allowed_params=['t_0', 'u_0', 'u_0_prime'])
        self.t_0, self.u_0, self.u_0_prime = t_0, u_0, u_0_prime

    def parameterize(self, output_tensor, t, *theta):
        t_0 = self._get_parameter('t_0', theta)
        u_0 = self._get_parameter('u_0', theta)
        u_0_prime = self._get_parameter('u_0_prime', theta)
        if 't_0' in self.bundle_param_lookup:
            if u_0_prime is None:
                return u_0 + (t - t_0) * output_tensor
            return u_0 + (t - t_0) * u_0_prime + ((t - t_0) ** 2) * output_tensor
        if u_0_prime is None:
            return u_0 + (1 - exp(-t + t_0)) * output_tensor
        return u_0 + (t - t_0) * u_0_prime + ((1 - exp(-t + t_0)) ** 2) * output_tensor


class DirichletBVP(BaseCondition):
    r"""A double-ended Dirichlet boundary condition :math:`u(t_0)=u_0`,
    :math:`u(t_1)=u_1`, enforced as
    :math:`u(t)=(1-\tilde t)u_0+\tilde t u_1+(1-e^{(1-\tilde t)\tilde t})\mathrm{ANN}(t)`
    with :math:`\tilde t = (t - t_0)/(t_1 - t_0)`."""

    @deprecated_alias(x_0='u_0', x_1='u_1')
    def __init__(self, t_0, u_0, t_1, u_1):
        super().__init__()
        self.t_0, self.u_0, self.t_1, self.u_1 = t_0, u_0, t_1, u_1

    def parameterize(self, output_tensor, t):
        t_tilde = (t - self.t_0) / (self.t_1 - self.t_0)
        return (self.u_0 * (1 - t_tilde) + self.u_1 * t_tilde
                + (1 - exp((1 - t_tilde) * t_tilde)) * output_tensor)


class BundleDirichletBVP(BaseCondition, _BundleConditionMixin):
    r"""A double-ended Dirichlet BVP whose t_0, u_0, t_1 and u_1 may be
    sampled theta coordinates:
    :math:`u(t)=(1-\tilde t)u_0+\tilde t u_1+(1-e^{(1-\tilde t)\tilde t})\mathrm{ANN}(t)`.

    :param bundle_param_lookup: maps 't_0', 'u_0', 't_1' or 'u_1' to the
        index of its theta coordinate.
    """

    @deprecated_alias(bundle_conditions='bundle_param_lookup')
    def __init__(self, t_0, u_0, t_1, u_1, bundle_param_lookup=None):
        BaseCondition.__init__(self)
        _BundleConditionMixin.__init__(self, bundle_param_lookup=bundle_param_lookup,
                                       allowed_params=['t_0', 'u_0', 't_1', 'u_1'])
        self.t_0, self.u_0, self.t_1, self.u_1 = t_0, u_0, t_1, u_1

    def parameterize(self, output_tensor, t, *theta):
        u_0 = self._get_parameter('u_0', theta)
        u_1 = self._get_parameter('u_1', theta)
        t_0 = self._get_parameter('t_0', theta)
        t_1 = self._get_parameter('t_1', theta)
        t_tilde = (t - t_0) / (t_1 - t_0)
        return u_0 * (1 - t_tilde) + u_1 * t_tilde + (1 - exp((1 - t_tilde) * t_tilde)) * output_tensor


class DirichletBVP2D(BaseCondition):
    r"""A Dirichlet condition on all four sides of
    :math:`[x_0, x_1] \times [y_0, y_1]`: an additive boundary interpolant
    ``A(x, y)`` plus
    :math:`\tilde x(1-\tilde x)\tilde y(1-\tilde y)\,\mathrm{ANN}(x,y)`.

    :param x_min, x_max, y_min, y_max: domain bounds.
    :param x_min_val, x_max_val: callables f0(y), f1(y) (written with the
        Field-aware math of :mod:`neurodiffeq_tpu_torch.fields`).
    :param y_min_val, y_max_val: callables g0(x), g1(x).
    """

    def __init__(self, x_min, x_min_val, x_max, x_max_val, y_min, y_min_val, y_max, y_max_val):
        super().__init__()
        self.x0, self.f0 = x_min, x_min_val
        self.x1, self.f1 = x_max, x_max_val
        self.y0, self.g0 = y_min, y_min_val
        self.y1, self.g1 = y_max, y_max_val

    def parameterize(self, output_tensor, x, y):
        x_tilde = (x - self.x0) / (self.x1 - self.x0)
        y_tilde = (y - self.y0) / (self.y1 - self.y0)
        # constant-valued inputs for corner evaluations (`x * 0 + c` keeps
        # the differentiable type)
        x0 = x * 0 + self.x0
        x1 = x * 0 + self.x1
        Axy = ((1 - x_tilde) * self.f0(y) + x_tilde * self.f1(y)
               + (1 - y_tilde) * (self.g0(x) - ((1 - x_tilde) * self.g0(x0) + x_tilde * self.g0(x1)))
               + y_tilde * (self.g1(x) - ((1 - x_tilde) * self.g1(x0) + x_tilde * self.g1(x1))))
        return Axy + x_tilde * (1 - x_tilde) * y_tilde * (1 - y_tilde) * output_tensor


def _tree_prod(cols):
    """The product over the columns of an ``(N, m)`` tensor as ``(N, 1)``,
    padded with ones to a power of two and multiplied in pairs: ceil(log2 m)
    multiplications deep, each pair split off by one ``unbind``, so that
    every derivative of it, to any order, is one of products (no division: a
    factor of 0 is fine) over a few operations whatever m."""
    n, m = cols.shape
    width = 1 << (m - 1).bit_length()
    if width > m:
        cols = torch.cat([cols, cols.new_ones(n, width - m)], dim=1)
    while cols.shape[1] > 1:
        a, b = cols.reshape(n, -1, 2).unbind(-1)
        cols = a * b
    return cols


def _leave_one_out(cols):
    """Per column, the product of all the other columns, from exclusive
    prefix and suffix cumulative products (a factor of 0 is fine)."""
    one = torch.ones_like(cols[:, :1])
    pre = torch.cumprod(torch.cat([one, cols[:, :-1]], dim=1), dim=1)
    suf = torch.flip(torch.cumprod(torch.flip(torch.cat([cols[:, 1:], one], dim=1), [1]), dim=1), [1])
    return pre * suf


class DirichletBoxND(BaseCondition):
    r"""An exact Dirichlet condition on a ``dim``-dimensional box
    :math:`[a_1, b_1] \times \dots \times [a_d, b_d]`:

    .. math:: u(x) = g(x) + \phi(x)^{\text{power}}\,\mathrm{ANN}(x),

    where ``g`` is a smooth extension of the boundary data over the closed
    box and :math:`\phi` vanishes (to first order) on every face. The masks
    are built from the normalized per-face factors
    :math:`\phi_i = 4(x_i - a_i)(b_i - x_i)/(b_i - a_i)^2 \in [0, 1]`:

    - ``'product'``: :math:`\phi = \prod_i \phi_i`, best conditioned at low
      d, but its interior magnitude decays like :math:`e^{-0.61 d}`;
      construction raises past ``dim=16``;
    - ``'sat'``: :math:`\phi = \prod_i (1 - (1 - \phi_i)^k)`, ``k = dim``
      by default, whose interior magnitude does not decay with d: the mask
      that trains strong-form residuals at d >> 10;
    - ``'adf'``: the R-function approximate distance
      :math:`\phi = d / \sum_i 1/(\phi_i + \epsilon)`, :math:`\epsilon =
      \sqrt{\text{tiny}}` of the points' dtype (1 at the centre). Its
      second derivatives grow near edges: use it with a variational loss.

    ``mask='auto'`` (the default) picks ``'product'`` for ``dim`` <= 10
    and ``'sat'`` above. With ``power=2`` (the clamped condition of
    fourth-order problems) both ``u = g`` and ``du/dn = dg/dn`` hold on the
    boundary by construction.

    The mask of the coordinate fields is one field over their stacked
    columns (:meth:`mask_field`), whatever d: a handful of tensor
    operations evaluate it, and its Taylor rule gives the axis derivatives
    from the per-coordinate factors and their leave-one-out products.

    :param dim: number of coordinates d.
    :param boundary_fn: the extension ``g``, a callable of the d coordinate
        Fields (written with the math of :mod:`neurodiffeq_tpu_torch.fields`),
        or None for homogeneous data.
    :param r_min: scalar or length-d lower bounds. Defaults to 0.
    :param r_max: scalar or length-d upper bounds. Defaults to 1.
    :param mask: ``'auto'``, ``'product'``, ``'sat'`` or ``'adf'``.
    :param k: saturation order of ``'sat'``; defaults to ``dim``.
    :param power: vanishing order of the mask's factor in ``u``: 1
        (Dirichlet, the default) or 2 (clamped).
    """

    def __init__(self, dim, boundary_fn=None, r_min=0.0, r_max=1.0, mask='auto', k=None, power=1):
        super().__init__()
        if dim < 1:
            raise ValueError(f"dim must be >= 1, got {dim}")
        if int(power) != power or power < 1:
            raise ValueError(
                f"power must be a positive integer (1 = Dirichlet, 2 = "
                f"clamped), got {power!r}")
        if mask == 'auto':
            mask = 'product' if dim <= 10 else 'sat'
        if mask not in ('adf', 'product', 'sat'):
            raise ValueError(
                f"mask must be 'auto', 'product', 'sat' or 'adf', got {mask!r}")
        if mask == 'product' and dim > 16:
            raise ValueError(
                f"mask='product' underflows/un-trains past d~10-15 (typical "
                f"interior magnitude e^(-0.61*{dim}) here); use mask='sat'")
        if k is not None and (mask != 'sat' or k < 1):
            raise ValueError("k is the saturation order of mask='sat' (k >= 1)")
        self.k = int(k) if k is not None else dim
        r_min = tuple(float(v) for v in np.atleast_1d(r_min)) if np.ndim(r_min) else (float(r_min),) * dim
        r_max = tuple(float(v) for v in np.atleast_1d(r_max)) if np.ndim(r_max) else (float(r_max),) * dim
        if len(r_min) != dim or len(r_max) != dim:
            raise ValueError(
                f"r_min/r_max must be scalars or length-{dim}: "
                f"got {len(r_min)}/{len(r_max)}")
        if any(hi <= lo for lo, hi in zip(r_min, r_max)):
            raise ValueError(f"Illegal box [{r_min}, {r_max}]")
        if boundary_fn is not None and not callable(boundary_fn):
            raise TypeError("boundary_fn must be a callable of the coordinate "
                            "Fields (or None for homogeneous data)")
        self.dim = dim
        self.boundary_fn = boundary_fn
        self.r_min, self.r_max = r_min, r_max
        self.mask = mask
        self.power = int(power)

    def _bounds(self, n, like):
        """The first ``n`` bounds as ``(a, b, (b - a)^2)`` rows of ``like``'s dtype and device."""
        a, b = self.r_min[:n], self.r_max[:n]
        return tuple(torch.tensor(v, dtype=like.dtype, device=like.device)
                     for v in (a, b, [(hi - lo) ** 2 for lo, hi in zip(a, b)]))

    def _mask_values(self, X):
        """The mask at the ``(N, m)`` stacked coordinates ``X``, as ``(N, 1)``."""
        a, b, l2 = self._bounds(X.shape[1], X)
        phis = 4.0 * (X - a) * (b - X) / l2
        if self.mask == 'product':
            return _tree_prod(phis)
        if self.mask == 'sat':
            return _tree_prod(1.0 - (1.0 - phis) ** self.k)
        eps = float(np.sqrt(torch.finfo(X.dtype).tiny))
        return float(self.dim) / (1.0 / (phis + eps)).sum(dim=1, keepdim=True)

    def _mask_series(self, X, K):
        """``(value (N, 1), [k-th derivatives along each column's own axis,
        (m, N, 1)] for k = 1..K)`` of the mask at the stacked coordinates."""
        from .ops.taylor import TSeries, _chain_unary, _power_derivs, _reciprocal_derivs
        a, b, l2 = self._bounds(X.shape[1], X)
        zero = torch.zeros_like(X)
        # each factor phi_i(x_i) and its derivatives along x_i, as a one-direction series
        p0 = 4.0 * (X - a) * (b - X) / l2
        fac = TSeries(p0, [d[None] for d in [4.0 * (a + b - 2 * X) / l2, zero - 8.0 / l2] + [zero] * (K - 2)][:K])
        if self.mask == 'sat':
            q0 = 1.0 - p0
            qk = _chain_unary(TSeries(q0, [-d for d in fac.derivs]), K, q0 ** self.k, _power_derivs(q0, self.k, K))
            fac = TSeries(1.0 - qk.c0, [-d for d in qk.derivs])
        if self.mask in ('product', 'sat'):
            loo = _leave_one_out(fac.c0)
            return _tree_prod(fac.c0), [(d[0] * loo).t()[:, :, None] for d in fac.derivs]
        eps = float(np.sqrt(torch.finfo(X.dtype).tiny))
        x0 = p0 + eps
        inv = _chain_unary(TSeries(x0, fac.derivs), K, 1.0 / x0, _reciprocal_derivs(x0, 1.0 / x0, K))
        s = TSeries(inv.c0.sum(dim=1, keepdim=True), [d[0].t()[:, :, None] for d in inv.derivs])
        phi = float(self.dim) / s.c0
        out = _chain_unary(s, K, phi, _reciprocal_derivs(s.c0, phi, K))
        return out.c0, out.derivs

    def _mask_expression(self, *xs):
        """The mask as the composition of per-coordinate operations (the JAX
        package's form): for arguments other than the raw coordinate fields
        of one batch, and for the polarization contexts of mixed partials."""
        phis = [4.0 * (x - a) * (b - x) / (b - a) ** 2 for x, a, b in zip(xs, self.r_min, self.r_max)]
        if self.mask == 'product':
            phi = phis[0]
            for p in phis[1:]:
                phi = phi * p
            return phi
        if self.mask == 'sat':
            phi = 1.0 - (1.0 - phis[0]) ** self.k
            for p in phis[1:]:
                phi = phi * (1.0 - (1.0 - p) ** self.k)
            return phi
        like = next((x for x in xs if torch.is_tensor(x)), None)
        dtype = xs[0].coords.points.dtype if isinstance(xs[0], Field) else (
            like.dtype if like is not None else resolve()[1])
        eps = float(np.sqrt(torch.finfo(dtype).tiny))
        s = 1.0 / (phis[0] + eps)
        for p in phis[1:]:
            s = s + 1.0 / (p + eps)
        return float(self.dim) / s

    def mask_field(self, *xs):
        r"""The mask :math:`\phi` of the given coordinates, exposed so that
        its exact vanishing factor can be reused (to manufacture solutions
        with known boundary gaps, say). Of raw coordinate fields of one
        batch it is one field over their stacked columns, with its own
        Taylor rule; of anything else, the composition of per-coordinate
        operations."""
        if not xs or not all(isinstance(x, Field) and x.index is not None and x.coords is xs[0].coords
                             for x in xs):
            return self._mask_expression(*xs)
        cs, idxs = xs[0].coords, [x.index for x in xs]
        cols = slice(idxs[0], idxs[-1] + 1) if idxs == list(range(idxs[0], idxs[-1] + 1)) else idxs
        expression = []

        def fn(p):
            return self._mask_values(p[:, cols])

        def trule(ctx):
            from .ops.taylor import TSeries, teval
            if not ctx.is_axes:
                if not expression:
                    expression.append(self._mask_expression(*xs))
                return teval(expression[0], ctx)
            c0, derivs = self._mask_series(ctx.points[:, cols], ctx.order)
            if idxs != list(range(ctx.n_dirs)):
                full = []
                for dk in derivs:
                    z = dk.new_zeros((ctx.n_dirs,) + dk.shape[1:])
                    z[idxs] = dk
                    full.append(z)
                derivs = full
            return TSeries(c0, derivs)

        return Field(cs, 1, fn, trule=trule)

    def parameterize(self, output_tensor, *xs):
        if len(xs) != self.dim:
            raise ValueError(f"expected {self.dim} coordinates, got {len(xs)}")
        phi = self.mask_field(*xs)
        if self.power > 1:
            phi = phi ** self.power
        u = phi * output_tensor
        if self.boundary_fn is not None:
            u = self.boundary_fn(*xs) + u
        return u


def _check_two_ends(x_min_val, x_min_prime, x_max_val, x_max_prime):
    """Exactly two conditions, at most one per end (the reference's test,
    truthiness included)."""
    n_conditions = sum(c is not None for c in [x_min_val, x_min_prime, x_max_val, x_max_prime])
    if n_conditions != 2 or (x_min_val and x_min_prime) or (x_max_val and x_max_prime):
        raise NotImplementedError('Sorry, this boundary condition is not implemented.')


def _anchors(u, x, at):
    """The raw output and its x-derivative pinned at each end in ``at``:
    ``pin(u, x.index, c, k)`` is constant in x, like the reference's
    independent anchor tensors."""
    return [f for c in at for f in (pin(u, x.index, c), pin(u, x.index, c, derivative_order=1))]


class IBVP1D(BaseCondition):
    r"""An initial and boundary condition on :math:`x \in [x_0, x_1]`, time
    starting at :math:`t_0`: :math:`u(x, t_0) = u_0(x)`, and a Dirichlet or
    a Neumann condition at each of :math:`x_0` and :math:`x_1`.

    Exactly two of ``x_min_val``, ``x_min_prime``, ``x_max_val`` and
    ``x_max_prime`` must be given (callables of t), at most one per end;
    ``t_min_val`` is a callable of x. A Neumann end evaluates the network
    and its x-derivative at the anchor with :func:`~neurodiffeq_tpu_torch.fields.pin`,
    which has no Taylor rule: those variants compose (two fallbacks per
    heat residual, as in the JAX package).
    """

    def __init__(self, x_min, x_max, t_min, t_min_val,
                 x_min_val=None, x_min_prime=None,
                 x_max_val=None, x_max_prime=None):
        super().__init__()
        _check_two_ends(x_min_val, x_min_prime, x_max_val, x_max_prime)
        self.x_min, self.x_min_val, self.x_min_prime = x_min, x_min_val, x_min_prime
        self.x_max, self.x_max_val, self.x_max_prime = x_max, x_max_val, x_max_prime
        self.t_min, self.t_min_val = t_min, t_min_val

    def enforce(self, net, x, t):
        uxt = _ann_field(net, (x, t), ith_unit=self.ith_unit)
        if self.x_min_val and self.x_max_val:
            return self.parameterize(uxt, x, t)
        if self.x_min_val and self.x_max_prime:
            return self.parameterize(uxt, x, t, *_anchors(uxt, x, [self.x_max]))
        if self.x_min_prime and self.x_max_val:
            return self.parameterize(uxt, x, t, *_anchors(uxt, x, [self.x_min]))
        if self.x_min_prime and self.x_max_prime:
            return self.parameterize(uxt, x, t, *_anchors(uxt, x, [self.x_min, self.x_max]))
        raise NotImplementedError('Sorry, this boundary condition is not implemented.')

    def parameterize(self, u, x, t, *additional_tensors):
        t0 = _const_field(self.t_min, t)
        x_tilde = (x - self.x_min) / (self.x_max - self.x_min)
        t_tilde = t - self.t_min
        if self.x_min_val and self.x_max_val:
            return self._parameterize_dd(u, x, t, x_tilde, t_tilde, t0)
        if self.x_min_val and self.x_max_prime:
            return self._parameterize_dn(u, x, t, x_tilde, t_tilde, t0, *additional_tensors)
        if self.x_min_prime and self.x_max_val:
            return self._parameterize_nd(u, x, t, x_tilde, t_tilde, t0, *additional_tensors)
        if self.x_min_prime and self.x_max_prime:
            return self._parameterize_nn(u, x, t, x_tilde, t_tilde, t0, *additional_tensors)
        raise NotImplementedError('Sorry, this boundary condition is not implemented.')

    def _parameterize_dd(self, uxt, x, t, x_tilde, t_tilde, t0):
        Axt = (self.t_min_val(x)
               + x_tilde * (self.x_max_val(t) - self.x_max_val(t0))
               + (1 - x_tilde) * (self.x_min_val(t) - self.x_min_val(t0)))
        return Axt + x_tilde * (1 - x_tilde) * (1 - exp(-t_tilde)) * uxt

    def _parameterize_dn(self, uxt, x, t, x_tilde, t_tilde, t0, ux1t, dux1t):
        Axt = ((self.x_min_val(t) - self.x_min_val(t0)) + self.t_min_val(x)
               + x_tilde * (self.x_max - self.x_min) * (self.x_max_prime(t) - self.x_max_prime(t0)))
        return Axt + x_tilde * (1 - exp(-t_tilde)) * (uxt - (self.x_max - self.x_min) * dux1t - ux1t)

    def _parameterize_nd(self, uxt, x, t, x_tilde, t_tilde, t0, ux0t, dux0t):
        Axt = ((self.x_max_val(t) - self.x_max_val(t0)) + self.t_min_val(x)
               + (x_tilde - 1) * (self.x_max - self.x_min) * (self.x_min_prime(t) - self.x_min_prime(t0)))
        return Axt + (1 - x_tilde) * (1 - exp(-t_tilde)) * (uxt + (self.x_max - self.x_min) * dux0t - ux0t)

    def _parameterize_nn(self, uxt, x, t, x_tilde, t_tilde, t0, ux0t, dux0t, ux1t, dux1t):
        Axt = (self.t_min_val(x)
               - 0.5 * (1 - x_tilde) ** 2 * (self.x_max - self.x_min) * (
                   self.x_min_prime(t) - self.x_min_prime(t0))
               + 0.5 * x_tilde ** 2 * (self.x_max - self.x_min) * (
                   self.x_max_prime(t) - self.x_max_prime(t0)))
        return Axt + (1 - exp(-t_tilde)) * (
            uxt
            - x_tilde * (self.x_max - self.x_min) * dux0t
            + 0.5 * x_tilde ** 2 * (self.x_max - self.x_min) * (dux0t - dux1t)
        )


class DoubleEndedBVP1D(BaseCondition):
    r"""Boundary conditions on a space-only range :math:`x \in [x_0, x_1]`:
    a Dirichlet or a Neumann condition at each end, given as numbers.
    Neumann ends pin anchors as :class:`IBVP1D` does, and compose.
    """

    def __init__(self, x_min, x_max,
                 x_min_val=None, x_min_prime=None,
                 x_max_val=None, x_max_prime=None):
        super().__init__()
        _check_two_ends(x_min_val, x_min_prime, x_max_val, x_max_prime)
        self.x_min, self.x_min_val, self.x_min_prime = x_min, x_min_val, x_min_prime
        self.x_max, self.x_max_val, self.x_max_prime = x_max, x_max_val, x_max_prime

    def enforce(self, net, x):
        ux = _ann_field(net, (x,), ith_unit=self.ith_unit)
        if self.x_min_val is not None and self.x_max_val is not None:
            return self.parameterize(ux, x)
        if self.x_min_val is not None and self.x_max_prime is not None:
            return self.parameterize(ux, x, *_anchors(ux, x, [self.x_max]))
        if self.x_min_prime is not None and self.x_max_val is not None:
            return self.parameterize(ux, x, *_anchors(ux, x, [self.x_min]))
        if self.x_min_prime is not None and self.x_max_prime is not None:
            return self.parameterize(ux, x, *_anchors(ux, x, [self.x_min, self.x_max]))
        raise NotImplementedError('Sorry, this boundary condition is not implemented.')

    def parameterize(self, u, x, *additional_tensors):
        x_tilde = (x - self.x_min) / (self.x_max - self.x_min)
        if self.x_min_val is not None and self.x_max_val is not None:
            return self._parameterize_dd(u, x, x_tilde)
        if self.x_min_val is not None and self.x_max_prime is not None:
            return self._parameterize_dn(u, x, x_tilde, *additional_tensors)
        if self.x_min_prime is not None and self.x_max_val is not None:
            return self._parameterize_nd(u, x, x_tilde, *additional_tensors)
        if self.x_min_prime is not None and self.x_max_prime is not None:
            return self._parameterize_nn(u, x, x_tilde, *additional_tensors)
        raise NotImplementedError('Sorry, this boundary condition is not implemented.')

    def _parameterize_dd(self, ux, x, x_tilde):
        Ax = self.x_min_val * (1 - x_tilde) + self.x_max_val * x_tilde
        return Ax + x_tilde * (1 - x_tilde) * ux

    def _parameterize_dn(self, ux, x, x_tilde, ux1, dux1):
        Ax = (1 - x_tilde) * self.x_min_val + 0.5 * x_tilde ** 2 * self.x_max_prime * (self.x_max - self.x_min)
        return Ax + x_tilde * (ux - ux1 + self.x_min_val - dux1 * (self.x_max - self.x_min))

    def _parameterize_nd(self, ux, x, x_tilde, ux0, dux0):
        Ax = x_tilde * self.x_max_val - 0.5 * (1 - x_tilde) ** 2 * self.x_min_prime * (self.x_max - self.x_min)
        return Ax + (1 - x_tilde) * (ux - ux0 + self.x_max_val + dux0 * (self.x_max - self.x_min))

    def _parameterize_nn(self, ux, x, x_tilde, ux0, dux0, ux1, dux1):
        Ax = (-0.5 * (1 - x_tilde) ** 2 * (self.x_max - self.x_min) * self.x_min_prime
              + 0.5 * x_tilde ** 2 * (self.x_max - self.x_min) * self.x_max_prime)
        return (Ax
                + 0.5 * x_tilde ** 2 * (ux - ux1 - 0.5 * dux1 * (self.x_max - self.x_min))
                + 0.5 * (1 - x_tilde) ** 2 * (ux - ux0 + 0.5 * dux0 * (self.x_max - self.x_min)))


class DirichletBVPSpherical(BaseCondition):
    r"""Dirichlet conditions on an interior and, optionally, an exterior
    sphere: :math:`u(r_0,\theta,\phi)=f(\theta,\phi)` and
    :math:`u(r_1,\theta,\phi)=g(\theta,\phi)`.

    - one-ended: :math:`u = f + (1 - e^{-|r - r_0|})\,\mathrm{ANN}`;
    - two-ended: :math:`u = (1-\tilde r) f + \tilde r g + (1 - e^{(1-\tilde r)\tilde r})\,\mathrm{ANN}`,
      with :math:`\tilde r = (r - r_0)/(r_1 - r_0)`.

    :param f, g: callables of the (theta, phi) Fields (written with the
        Field-aware math of :mod:`neurodiffeq_tpu_torch.fields`).
    """

    def __init__(self, r_0, f, r_1=None, g=None):
        super().__init__()
        if (r_1 is None) ^ (g is None):
            raise ValueError(f'r_1 and g must be both/neither set to None; got r_1={r_1}, g={g}')
        self.r_0, self.r_1 = r_0, r_1
        self.f, self.g = f, g

    def parameterize(self, output_tensor, r, theta, phi):
        if self.r_1 is None:
            return (1 - exp(-fabs(r - self.r_0))) * output_tensor + self.f(theta, phi)
        r_tilde = (r - self.r_0) / (self.r_1 - self.r_0)
        return (self.f(theta, phi) * (1 - r_tilde)
                + self.g(theta, phi) * r_tilde
                + (1. - exp((1 - r_tilde) * r_tilde)) * output_tensor)


class InfDirichletBVPSpherical(BaseCondition):
    r"""Like :class:`DirichletBVPSpherical` with the exterior sphere at
    infinity: :math:`u = f e^{-k(r-r_0)} + g \tanh(r-r_0) + e^{-k(r-r_0)}\tanh(r-r_0)\,\mathrm{ANN}`.

    :param order: the smallest k such that u decays like :math:`e^{-kr}`.
    """

    def __init__(self, r_0, f, g, order=1):
        super().__init__()
        self.r_0, self.f, self.g, self.order = r_0, f, g, order

    def parameterize(self, output_tensor, r, theta, phi):
        dr = r - self.r_0
        return (self.f(theta, phi) * exp(-self.order * dr)
                + self.g(theta, phi) * tanh(dr)
                + exp(-self.order * dr) * tanh(dr) * output_tensor)


def _coefficients(values, device, dtype):
    """Harmonic coefficients as a (1, K) row on the resolved device (None
    stays None). A row broadcasts over the points even when K equals their
    number, where a (K,) vector would be taken as one value per point."""
    if values is None:
        return None
    device, dtype = resolve(device, dtype)
    values = values if torch.is_tensor(values) else np.asarray(values)
    return torch.as_tensor(values, dtype=dtype, device=device).reshape(1, -1)


class DirichletBVPSphericalBasis(BaseCondition):
    r"""A Dirichlet condition on the vector of harmonic coefficients
    :math:`\mathbf{R}(r)` of a radial network:
    :math:`\mathbf{R}(r_0)=\mathbf{R}_0` and, optionally,
    :math:`\mathbf{R}(r_1)=\mathbf{R}_1`.

    :param device: device of the coefficients (the port's default if None).
    :param dtype: dtype of the coefficients (the port's default if None).
    """

    def __init__(self, r_0, R_0, r_1=None, R_1=None, max_degree=None, device=None, dtype=None):
        super().__init__()
        if max_degree is not None:
            warnings.warn("`max_degree` is deprecated and ignored", FutureWarning)
        if (r_1 is None) ^ (R_1 is None):
            raise ValueError(f'r_1 and R_1 must be both/neither set to None; got r_1={r_1}, R_1={R_1}')
        self.r_0, self.r_1 = r_0, r_1
        self.R_0 = _coefficients(R_0, device, dtype)
        self.R_1 = _coefficients(R_1, device, dtype)

    def parameterize(self, output_tensor, r):
        if self.r_1 is None:
            return (1 - exp(-r + self.r_0)) * output_tensor + self.R_0
        r_tilde = (r - self.r_0) / (self.r_1 - self.r_0)
        return (self.R_0 * (1 - r_tilde) + self.R_1 * r_tilde
                + (1. - exp((1 - r_tilde) * r_tilde)) * output_tensor)


class InfDirichletBVPSphericalBasis(BaseCondition):
    r"""Like :class:`DirichletBVPSphericalBasis` with the exterior boundary
    at infinity, where the coefficients tend to :math:`\mathbf{R}_\infty`.

    :param device: device of the coefficients (the port's default if None).
    :param dtype: dtype of the coefficients (the port's default if None).
    """

    def __init__(self, r_0, R_0, R_inf, order=1, max_degree=None, device=None, dtype=None):
        super().__init__()
        if max_degree is not None:
            warnings.warn("`max_degree` is deprecated and ignored", FutureWarning)
        self.r_0, self.order = r_0, order
        self.R_0 = _coefficients(R_0, device, dtype)
        self.R_inf = _coefficients(R_inf, device, dtype)

    def parameterize(self, output_tensor, r):
        dr = r - self.r_0
        return (self.R_0 * exp(-self.order * dr)
                + self.R_inf * tanh(dr)
                + exp(-self.order * dr) * tanh(dr) * output_tensor)
