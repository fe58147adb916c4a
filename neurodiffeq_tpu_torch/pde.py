r"""Legacy functional API (v1) for 2-D PDEs and the irregular-domain
boundary toolkit (counterpart of ``neurodiffeq_tpu/pde.py``).

``solve2D``/``solve2D_system`` are deprecated wrappers around
:class:`~neurodiffeq_tpu_torch.solvers.Solver2D`; ``make_animation``
animates a 1-D time-dependent solution (matplotlib, imported at first use).
MacFall's length-factor thin-plate-spline method gives exact boundary
conditions on an arbitrary 2-D domain (``Point``,
``DirichletControlPoint``, ``NeumannControlPoint``,
``CustomBoundaryCondition``, the interpolators).

A spline is fitted by one float64 numpy solve over all its output columns,
the same system as the JAX package's, so the fits agree bit for bit. Its
evaluation on Fields is one torch formula per spline inside
:func:`~neurodiffeq_tpu_torch.fields.composite`: one Taylor rule for the
whole spline, so boundary enforcement stays differentiable to any order
(the Neumann term differentiates the enforced network, and a second-order
residual then needs the network at order 3, which goes layer by layer, as
on the TPU). The spline's weights are cast to the points' device and dtype
once per (device, dtype).
"""
import warnings

import numpy as np
import torch

from .networks import FCNN, Tanh  # noqa: F401 (re-exported for parity)
from .fields import diff
from . import fields as F
from .generators import Generator2D, PredefinedGenerator
from ._version_utils import warn_deprecate_class
from .conditions import IrregularBoundaryCondition, _ann_field
from .conditions import NoCondition, DirichletBVP2D, IBVP1D  # noqa: F401 (re-exported for parity)
from .monitors import Monitor2D  # noqa: F401 (re-exported for parity)
from .ode import _run_legacy, _shared_nets
from .solvers import Solution2D
from .solvers import Solver2D

ExampleGenerator2D = warn_deprecate_class(Generator2D)
PredefinedExampleGenerator2D = warn_deprecate_class(PredefinedGenerator)
Solution = warn_deprecate_class(Solution2D)


def solve2D(
        pde,
        condition,
        xy_min=None,
        xy_max=None,
        net=None,
        train_generator=None,
        valid_generator=None,
        optimizer=None,
        criterion=None,
        n_batches_train=1,
        n_batches_valid=4,
        additional_loss_term=None,
        metrics=None,
        max_epochs=1000,
        monitor=None,
        return_internal=False,
        return_best=False,
        batch_size=None,
        shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve a 2-input PDE
    (use :class:`~neurodiffeq_tpu_torch.solvers.Solver2D` instead).

    :return: ``(solution, metrics_history[, internals])``.
    """
    return solve2D_system(
        pde_system=lambda u, x, y: [pde(u, x, y)],
        conditions=[condition],
        xy_min=xy_min,
        xy_max=xy_max,
        nets=None if not net else [net],
        train_generator=train_generator,
        valid_generator=valid_generator,
        optimizer=optimizer,
        criterion=criterion,
        n_batches_train=n_batches_train,
        n_batches_valid=n_batches_valid,
        additional_loss_term=additional_loss_term,
        metrics=metrics,
        max_epochs=max_epochs,
        monitor=monitor,
        return_internal=return_internal,
        return_best=return_best,
        batch_size=batch_size,
        shuffle=shuffle,
    )


def solve2D_system(
        pde_system,
        conditions,
        xy_min=None,
        xy_max=None,
        single_net=None,
        nets=None,
        train_generator=None,
        valid_generator=None,
        optimizer=None,
        criterion=None,
        n_batches_train=1,
        n_batches_valid=4,
        additional_loss_term=None,
        metrics=None,
        max_epochs=1000,
        monitor=None,
        return_internal=False,
        return_best=False,
        batch_size=None,
        shuffle=None,
):
    r"""**[DEPRECATED]** Train a neural network to solve a system of 2-input PDEs
    (use :class:`~neurodiffeq_tpu_torch.solvers.Solver2D` instead).

    :return: ``(solution, metrics_history[, internals])``.
    """
    warnings.warn(
        "The `solve2D_system` function is deprecated, use a `neurodiffeq_tpu_torch.solvers.Solver2D` instance instead",
        FutureWarning,
    )
    return _run_legacy(
        Solver2D, additional_loss_term, max_epochs, monitor, return_internal, return_best,
        pde_system=pde_system,
        conditions=conditions,
        xy_min=xy_min,
        xy_max=xy_max,
        nets=_shared_nets(single_net, nets, conditions, 2),
        train_generator=train_generator,
        valid_generator=valid_generator,
        optimizer=optimizer,
        loss_fn=criterion,
        n_batches_train=n_batches_train,
        n_batches_valid=n_batches_valid,
        metrics=metrics,
        batch_size=batch_size,
        shuffle=shuffle,
    )


def make_animation(solution, xs, ts):
    r"""Create an animation of a 1-D time-dependent solution
    (reference ``pde.py:341-375``).

    :param solution: Solution function returned by ``solve2D``.
    :param xs: locations to evaluate the solution.
    :param ts: time points to evaluate the solution.
    :rtype: ``matplotlib.animation.FuncAnimation``
    """
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    xx, tt = np.meshgrid(xs, ts)
    frames = solution(xx, tt, to_numpy=True)

    fig, ax = plt.subplots()
    line, = ax.plot([], [], lw=2)

    lo, hi = frames.min(), frames.max()
    pad = (hi - lo) * 0.1
    ax.set_ylim(lo - pad, hi + pad)
    ax.set_xlim(xs.min(), xs.max())

    def draw(frame):
        line.set_data(xs, frame)
        return (line,)

    return animation.FuncAnimation(
        fig, draw, iter(frames), blit=True, interval=50, repeat=False,
    )


# ======================= arbitrary boundary conditions =======================

# values below ROUND_TO_ZERO are considered zero
ROUND_TO_ZERO = 1e-7
K = 5.0
ALPHA = 5.0


class Point:
    r"""A 2-D point.

    :param loc: location as ``(x, y)``.
    """

    def __init__(self, loc):
        self.loc = tuple(map(float, loc))
        self.dim = len(self.loc)

    def __repr__(self):
        return f'Point({self.loc})'


class DirichletControlPoint(Point):
    r"""A 2-D point on the Dirichlet boundary.

    :param loc: location as ``(x, y)``.
    :param val: expected value of u at this location.
    """

    def __init__(self, loc, val):
        super().__init__(loc)
        self.val = float(val)

    def __repr__(self):
        return f'DirichletControlPoint({self.loc}, val={self.val})'


class NeumannControlPoint(Point):
    r"""A 2-D point on the Neumann boundary (normal-derivative constraint).

    :param loc: location as ``(x, y)``.
    :param val: expected normal derivative of u at this location.
    :param normal_vector: outward normal at this location (normalized here).
    """

    def __init__(self, loc, val, normal_vector):
        super().__init__(loc)
        self.val = float(val)
        norm = float(np.linalg.norm(normal_vector))
        self.normal_vector = tuple(float(c) / norm for c in normal_vector)

    def __repr__(self):
        return (f'NeumannControlPoint({self.loc}, val={self.val}, '
                f'normal_vector={self.normal_vector})')


def _locs(points):
    """(M, d) float64 array of point locations."""
    return np.asarray([p.loc for p in points], dtype=np.float64)


class _ThinPlateSpline:
    r"""Array-backed thin-plate spline with K output columns.

    .. math:: u_k(p) = \sum_i W_{ik}\,\phi(q_i(p)) + A_{0k} + p \cdot A_{1:,k}

    with :math:`\phi(q) = q \log q` and :math:`q_i(p) = |p - c_i|^2 + s^2`.
    The fit is one float64 construction (broadcast pairwise distances) and
    one multi-right-hand-side ``np.linalg.solve`` under the polynomial
    orthogonality constraints :math:`\sum_i W_{ik} = 0`,
    :math:`\sum_i W_{ik} c_i = 0`: the JAX package's own system, solved the
    same way.
    """

    def __init__(self, centers, targets, stiffness=0.01):
        centers = np.asarray(centers, dtype=np.float64)             # (M, d)
        targets = np.asarray(targets, dtype=np.float64)             # (M,) or (M, K)
        if targets.ndim == 1:
            targets = targets[:, None]
        m, d = centers.shape

        q = ((centers[:, None, :] - centers[None, :, :]) ** 2).sum(-1) + stiffness ** 2
        poly = np.concatenate([np.ones((m, 1)), centers], axis=1)   # (M, d+1)
        lhs = np.zeros((m + d + 1, m + d + 1))
        lhs[:m, :m] = q * np.log(q)
        lhs[:m, m:] = poly
        lhs[m:, :m] = poly.T
        rhs = np.zeros((m + d + 1, targets.shape[1]))
        rhs[:m] = targets

        solution = np.linalg.solve(lhs, rhs)
        self.centers = centers
        self.stiffness = stiffness
        self.kernel_weights = solution[:m]                          # (M, K)
        self.affine = solution[m:]                                  # (d+1, K)
        self.n_outputs = targets.shape[1]
        self._tensors = {}  # (device, dtype) -> (centers, kernel weights, affine)

    def _on(self, like):
        """The centers, kernel weights and affine part as tensors of
        ``like``'s dtype on its device, made once per (device, dtype). Ones
        made while ``torch.export`` traces are stand-ins of that trace and
        are not kept."""
        key = (like.device, like.dtype)
        hit = self._tensors.get(key)
        if hit is None:
            hit = tuple(torch.as_tensor(a, dtype=like.dtype, device=like.device)
                        for a in (self.centers, self.kernel_weights, self.affine))
            if not torch.compiler.is_compiling():
                self._tensors[key] = hit
        return hit

    def formula(self, pts):
        """Torch evaluation, ``pts (N, d) -> (N, K)``. All K columns share
        the ``(N, M)`` RBF basis: a multi-component spline costs one distance
        matrix, not K."""
        centers, weights, affine = self._on(pts)
        q = ((pts[:, None, :] - centers) ** 2).sum(-1) + self.stiffness ** 2
        return (q * torch.log(q)) @ weights + affine[0] + pts @ affine[1:]

    def eval_np(self, dimensions):
        """Numpy evaluation for monitor masks: same-shaped coordinate arrays
        in, ``shape + (K,)`` out."""
        dims = [np.asarray(d, dtype=np.float64) for d in dimensions]
        pts = np.stack([d.reshape(-1) for d in dims], axis=-1)
        q = ((pts[:, None, :] - self.centers) ** 2).sum(-1) + self.stiffness ** 2
        out = (q * np.log(q)) @ self.kernel_weights + self.affine[0] + pts @ self.affine[1:]
        return out.reshape(dims[0].shape + (self.n_outputs,))


def _stack_samples(vals):
    """The (N, 1) coordinate values of a composite's operands as (N, d) points."""
    return torch.cat(torch.broadcast_tensors(*vals), dim=1)


class CustomBoundaryCondition(IrregularBoundaryCondition):
    r"""A boundary condition on an irregularly-shaped 2-D domain, implementing
    MacFall's length-factor thin-plate-spline method
    (reference ``pde.py:442-596``): the enforced solution is
    ``A_D + A_M + L_D * ANN`` where A_D interpolates Dirichlet values, L_D is a
    length factor vanishing on the boundary (built by TPS-mapping the boundary
    onto a circle), and A_M handles Neumann terms.

    :param center_point: a point roughly at the domain center (used to sort
        control points clockwise).
    :param dirichlet_control_points: points on the Dirichlet boundary.
    :param neumann_control_points: points on the Neumann boundary (optional).
    """

    def __init__(self, center_point, dirichlet_control_points, neumann_control_points=None):
        super().__init__()

        dirichlet = self._clean_control_points(dirichlet_control_points, center_point)
        self.dirichlet_control_points = dirichlet
        # A_D / L_D in MacFall's paper: the Dirichlet surface and its length factor
        self.a_d_interp = InterpolatorCreator.fit_surface(dirichlet)
        self.l_d_interp = InterpolatorCreator.fit_length_factor(dirichlet)

        self.neumann_control_points = None
        self.g_interp = None
        self.l_m_interp = None
        self.n_hat_interp = None
        if neumann_control_points is not None and len(neumann_control_points) > 0:
            neumann = self._clean_control_points(neumann_control_points, center_point)
            self.neumann_control_points = neumann
            self.g_interp = InterpolatorCreator.fit_surface(neumann)
            self.l_m_interp = InterpolatorCreator.fit_length_factor(neumann)
            self.n_hat_interp = InterpolatorCreator.fit_normal_vector(neumann)

    def a_d(self, *dimensions):
        return self.a_d_interp.interpolate(dimensions)

    def l_d(self, *dimensions):
        return self.l_d_interp.interpolate(dimensions)

    def g(self, *dimensions):
        return self.g_interp.interpolate(dimensions)

    def l_m(self, *dimensions):
        return self.l_m_interp.interpolate(dimensions)

    def f(self, net, *dimensions):
        # F(x) in MacFall's paper: L_D * ANN
        ann = _ann_field(net, dimensions, ith_unit=self.ith_unit)
        return self.l_d(*dimensions) * ann

    def n_hat(self, *dimensions):
        return self.n_hat_interp.interpolate(dimensions)

    def a_m(self, net, *dimensions):
        """A_M(x) in MacFall's paper (the Neumann correction term)."""
        if self.neumann_control_points is None:
            return 0.0

        n_hat = self.n_hat(*dimensions)

        def d_normal(field):
            """Directional derivative of ``field`` along the interpolated normal."""
            total = 0.0
            for nk, coord in zip(n_hat, dimensions):
                total = total + nk * diff(field, coord)
            return total

        l_d_val = self.l_d(*dimensions)
        l_m_val = self.l_m(*dimensions)
        numer = (self.g(*dimensions)
                 - d_normal(self.a_d(*dimensions))
                 - d_normal(self.f(net, *dimensions)))
        denom = l_d_val * d_normal(l_m_val) + K * (1 - F.exp(-ALPHA * l_m_val))
        return l_d_val * l_m_val * numer / denom

    def in_domain(self, *dimensions):
        """Mask for monitors: positive length factor(s) == inside the domain."""
        ld = self.l_d_interp.interpolate_np(dimensions)
        if self.neumann_control_points is None:
            return ld > 0.0
        lm = self.l_m_interp.interpolate_np(dimensions)
        return (ld > 0.0) & (lm > 0.0)

    def enforce(self, net, *dimensions):
        # equation [10] in MacFall's paper
        return self.a_d(*dimensions) + self.a_m(net, *dimensions) + self.f(net, *dimensions)

    @staticmethod
    def _clean_control_points(control_points, center_point):
        """Sort control points clockwise around ``center_point`` — starting
        from the +x direction, matching the circular-target parameterization
        in :meth:`InterpolatorCreator.fit_length_factor` — and drop adjacent
        near-duplicates.

        Offsets within ``ROUND_TO_ZERO`` of an axis are snapped onto it before
        taking the angle, so points nominally on the +x axis sort first
        instead of straddling the 0/2pi seam.
        """
        deltas = _locs(control_points) - center_point.loc
        deltas[np.abs(deltas) < ROUND_TO_ZERO] = 0.0
        clockwise_angle = (-np.arctan2(deltas[:, 1], deltas[:, 0])) % (2.0 * np.pi)
        ordered = [control_points[i] for i in np.argsort(clockwise_angle, kind='stable')]

        kept = [ordered[0]]
        for cp in ordered[1:]:
            if not np.allclose(cp.loc, kept[-1].loc, rtol=0.0, atol=ROUND_TO_ZERO):
                kept.append(cp)
        return kept


class InterpolatorCreator:
    """Factory fitting thin-plate-spline interpolators, each one
    :class:`_ThinPlateSpline` solve over all its columns."""

    @staticmethod
    def fit_surface(dirichlet_or_neumann_control_points):
        points = dirichlet_or_neumann_control_points
        spline = _ThinPlateSpline(_locs(points), [p.val for p in points])
        return SurfaceInterpolator(spline, points)

    @staticmethod
    def fit_length_factor(control_points, radius=0.5):
        # Map the (clockwise-sorted) boundary onto equally-spaced clockwise
        # targets on a circle of the given radius.
        theta = -2.0 * np.pi * np.arange(len(control_points)) / len(control_points)
        targets = radius * np.stack([np.cos(theta), np.sin(theta)], axis=1)
        spline = _ThinPlateSpline(_locs(control_points), targets)
        return LengthFactorInterpolator(spline, control_points, radius)

    @staticmethod
    def fit_normal_vector(neumann_control_points):
        targets = np.asarray([p.normal_vector for p in neumann_control_points])
        spline = _ThinPlateSpline(_locs(neumann_control_points), targets)
        return NormalVectorInterpolator(spline, neumann_control_points)


class Interpolator:
    """Thin-plate-spline evaluation; Field-aware (``interpolate``) for the
    differentiated training path, numpy (``interpolate_np``) for monitor
    masks. The Field path evaluates the whole M-point basis as one torch
    formula inside ``composite`` (one Taylor rule per spline)."""

    def __init__(self, spline, control_points):
        self.spline = spline
        self.control_points = control_points

    def interpolate(self, dimensions):
        if not any(isinstance(d, F.Field) for d in dimensions):
            return self.interpolate_np(dimensions)
        return self._interpolate_fields(dimensions)

    def _interpolate_fields(self, dimensions):
        raise NotImplementedError  # pragma: no cover

    def interpolate_np(self, dimensions):
        raise NotImplementedError  # pragma: no cover


class SurfaceInterpolator(Interpolator):
    """Interpolates (x, y) -> A_D(x, y)."""

    def _interpolate_fields(self, dimensions):
        def surface(*vals):
            return self.spline.formula(_stack_samples(vals))[:, :1]

        return F.composite(surface, *dimensions)

    def interpolate_np(self, dimensions):
        return self.spline.eval_np(dimensions)[..., 0]


class LengthFactorInterpolator(Interpolator):
    """Interpolates (x, y) -> L_D(x, y) = radius^2 - |TPS-mapped point|^2.

    Both mapped components come out of one shared RBF basis inside one
    composite formula: one Taylor rule for the whole length factor."""

    def __init__(self, spline, control_points, radius):
        super().__init__(spline, control_points)
        self.radius = radius

    def _interpolate_fields(self, dimensions):
        def length_factor(*vals):
            mapped = self.spline.formula(_stack_samples(vals))
            return self.radius ** 2 - (mapped ** 2).sum(dim=1, keepdim=True)

        return F.composite(length_factor, *dimensions)

    def interpolate_np(self, dimensions):
        mapped = self.spline.eval_np(dimensions)
        return self.radius ** 2 - (mapped ** 2).sum(axis=-1)


class NormalVectorInterpolator(Interpolator):
    """Interpolates (x, y) -> n_hat(x, y) on the Neumann boundary."""

    def _interpolate_fields(self, dimensions):
        def component(j):
            def n_hat_j(*vals):
                return self.spline.formula(_stack_samples(vals))[:, j:j + 1]

            return F.composite(n_hat_j, *dimensions)

        return tuple(component(j) for j in range(self.spline.n_outputs))

    def interpolate_np(self, dimensions):
        mapped = self.spline.eval_np(dimensions)
        return tuple(mapped[..., j] for j in range(self.spline.n_outputs))
