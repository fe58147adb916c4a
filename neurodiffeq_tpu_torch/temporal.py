r"""The alternate "temporal" subsystem: penalty-based boundary conditions
(counterpart of ``neurodiffeq_tpu/temporal.py``).

An approximator owns one network (an ``nn.Module``). Boundary conditions
are *soft*: squared-residual penalty terms in the loss. Initial conditions
are enforced exactly by an ``exp(-t)`` blend of the network output. The
samplers are infinite python generators that draw from numpy's global
stream (``np.random.rand``, ``np.random.permutation``) in the JAX package's
order, so that one ``np.random.seed`` gives both packages the same points;
they yield tensors on the port's default device in its default dtype.

The training routines take a ``torch.optim.Optimizer`` over
``approximator.parameters()`` where the JAX package takes an optax
transformation: one optimizer step per mini-batch, and each epoch's train
loss recomputed on the whole epoch's points after the steps, as in the JAX
package. Every network pass of a loss is one Taylor-mode forward per
collocation set (one kernel launch on the card, at order 1-2), shared by
every column and derivative; order-0 reads (boundary penalties on ``u``,
``__call__``, metrics) run the plain forward.

Conventions follow the reference: ``u`` before ``x``, ``x`` before ``t``;
``xx``/``tt`` are paired (cartesian-product) coordinates while ``x``/``t``
are the underlying axes. matplotlib is imported when the first monitor is
made.
"""
from abc import ABC, abstractmethod

import numpy as np
import torch

from . import fields as F
from .utils import resolve

__all__ = [
    'Approximator',
    'SingleNetworkApproximator1DSpatialTemporal', 'SingleNetworkApproximator2DSpatial',
    'SingleNetworkApproximator2DSpatialSystem', 'SingleNetworkApproximator2DSpatialTemporal',
    'FirstOrderInitialCondition', 'SecondOrderInitialCondition', 'BoundaryCondition',
    'generator_1dspatial', 'generator_2dspatial_segment', 'generator_2dspatial_rectangle',
    'generator_temporal',
    'MonitorMinimal', 'Monitor1DSpatialTemporal', 'Monitor2DSpatialTemporal', 'Monitor2DSpatial',
    '_solve_1dspatial_temporal', '_solve_2dspatial_temporal', '_solve_2dspatial',
]


def _cartesian_prod_dims(x, t):
    """Return the cartesian product of x and t as two paired 1-D tensors."""
    x, t = torch.as_tensor(x), torch.as_tensor(t)
    return x.repeat_interleave(t.shape[0]), t.repeat(x.shape[0])


def _np(a):
    """A tensor (on any device) or array-like as a numpy array."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


class Approximator(ABC):
    r"""Base class of approximators: knows its parameters and how to compute
    the loss and metrics (reference ``temporal.py:25-44``)."""

    @abstractmethod
    def __call__(self):
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def parameters(self):
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def calculate_loss(self):
        raise NotImplementedError  # pragma: no cover

    @abstractmethod
    def calculate_metrics(self):
        raise NotImplementedError  # pragma: no cover


class _SingleNetworkApproximatorBase(Approximator):
    """Shared plumbing: owns the network and builds coordinate Fields on its
    device and in its dtype."""

    def __init__(self, single_network, pde, boundary_conditions, boundary_strictness):
        self.single_network = single_network
        self.pde = pde
        self.boundary_conditions = boundary_conditions
        self.boundary_strictness = boundary_strictness

    def parameters(self):
        """The network's parameters, for a ``torch.optim.Optimizer``."""
        return self.single_network.parameters()

    def load_jax_params(self, params):
        """Copy the JAX package's parameters of the network into it."""
        self.single_network.load_jax_params(params)
        return self

    def _coords(self, *arrays):
        p = next(iter(self.single_network.parameters()), None)
        device, dtype = (p.device, p.dtype) if p is not None else resolve()
        return F.coordinates(*arrays, dtype=dtype, device=device)

    def _ann(self, coords):
        return F.network_field(self.single_network, coords)

    def _solution(self, coords):
        """The solution Field(s) on ``coords``: one Field, or a tuple of them."""
        raise NotImplementedError  # pragma: no cover

    def _values(self, *arrays):
        """The solution at paired coordinates, as flattened numpy arrays."""
        with torch.no_grad():
            coords = self._coords(*arrays)
            u = self._solution(coords)
            out = tuple(_np(f.value).flatten() for f in (u if isinstance(u, tuple) else (u,)))
            coords[0].coords.release()
        return out if isinstance(u, tuple) else out[0]

    def _mse(self, coord_arrays, form):
        """Mean squared ``form`` (the PDE or a boundary form) of the solution
        over the paired coordinates; sums over the equations of a system."""
        coords = self._coords(*coord_arrays)
        u = self._solution(coords)
        res = form(*(u if isinstance(u, tuple) else (u,)), *coords)
        mse = sum((r.value ** 2).mean() for r in (res if isinstance(res, (list, tuple)) else [res]))
        coords[0].coords.release()
        return mse

    def _loss(self, *args):
        """The loss of the network's current parameters: ``(*coord_arrays,
        boundary_samples)``, the equation's mean squared residual plus
        ``boundary_strictness`` times the boundary penalties."""
        *coord_arrays, boundary_samples = args
        boundary_mse = 0.0
        for bc, samples in zip(self.boundary_conditions, boundary_samples):
            boundary_mse = boundary_mse + self._mse(samples, bc.form)
        return self._mse(coord_arrays, self.pde) + self.boundary_strictness * boundary_mse

    def _metrics(self, arrays, metrics):
        """Each metric of the solution's numpy values at the paired
        coordinates ``arrays`` (numpy too); no evaluation without metrics."""
        if not metrics:
            return {}
        uu = self(*arrays)
        uu = uu if isinstance(uu, tuple) else (uu,)
        arrays = [_np(a) for a in arrays]
        return {name: fn(*uu, *arrays) for name, fn in metrics.items()}


class SingleNetworkApproximator1DSpatialTemporal(_SingleNetworkApproximatorBase):
    r"""Approximates the solution of a 1-D time-dependent problem
    (reference ``temporal.py:46-104``): the initial condition is enforced by
    the transform :math:`u = e^{-t} u_0(x) + (1 - e^{-t})\,\mathrm{ANN}(x, t)`;
    boundary conditions are penalty terms.

    :param single_network: network with 2 inputs (x, t) and 1 output.
    :param pde: maps ``(u, x, t)`` to the residual F(u, x, t).
    :param initial_condition: a :class:`FirstOrderInitialCondition` whose
        ``u0`` is written with Field-aware math.
    :param boundary_conditions: list of :class:`BoundaryCondition`.
    :param boundary_strictness: penalty weight, defaults to 1.
    """

    def __init__(self, single_network, pde, initial_condition, boundary_conditions, boundary_strictness=1.):
        super().__init__(single_network, pde, boundary_conditions, boundary_strictness)
        self.initial_condition = initial_condition

    def _solution(self, coords):
        xf, tf = coords
        return F.exp(-tf) * self.initial_condition.u0(xf) + (1 - F.exp(-tf)) * self._ann(coords)

    def __call__(self, xx, tt):
        return self._values(xx, tt)

    def _boundary_samples(self, t):
        return tuple(_cartesian_prod_dims(next(bc.points_generator), t) for bc in self.boundary_conditions)

    def calculate_loss(self, xx, tt, x, t):
        return self._loss(xx, tt, self._boundary_samples(t))

    def calculate_metrics(self, xx, tt, x, t, metrics):
        return self._metrics((xx, tt), metrics)


class SingleNetworkApproximator2DSpatial(_SingleNetworkApproximatorBase):
    r"""Approximates the solution of a 2-D steady-state problem with penalty
    boundary conditions (reference ``temporal.py:107-158``)."""

    def __init__(self, single_network, pde, boundary_conditions, boundary_strictness=1.):
        super().__init__(single_network, pde, boundary_conditions, boundary_strictness)

    def _solution(self, coords):
        return self._ann(coords)

    def __call__(self, xx, yy):
        return self._values(xx, yy)

    def _boundary_samples(self):
        return tuple(next(bc.points_generator) for bc in self.boundary_conditions)

    def calculate_loss(self, xx, yy):
        return self._loss(xx, yy, self._boundary_samples())

    def calculate_metrics(self, xx, yy, metrics):
        return self._metrics((xx, yy), metrics)


class SingleNetworkApproximator2DSpatialSystem(SingleNetworkApproximator2DSpatial):
    r"""Approximates a system of 2-D steady-state equations with one
    multi-output network (reference ``temporal.py:161-222``). The functions
    are the network's columns, sliced from one network Field: one network
    pass per collocation set serves them all."""

    def _solution(self, coords):
        ann = self._ann(coords)
        return tuple(ann[:, i:i + 1] for i in range(ann.shape[1]))


class SingleNetworkApproximator2DSpatialTemporal(_SingleNetworkApproximatorBase):
    r"""Approximates a 2-D time-dependent problem; first- or second-order
    initial conditions enforced by ``exp(-t)``-blends
    (reference ``temporal.py:225-296``)."""

    def __init__(self, single_network, pde, initial_condition, boundary_conditions, boundary_strictness=1.):
        super().__init__(single_network, pde, boundary_conditions, boundary_strictness)
        self.u0 = initial_condition.u0
        self.u0dot = getattr(initial_condition, 'u0dot', None)

    def _solution(self, coords):
        xf, yf, tf = coords
        ann = self._ann(coords)
        decay = 1 - F.exp(-tf)
        if self.u0dot is None:
            return F.exp(-tf) * self.u0(xf, yf) + decay * ann
        return (1 - decay ** 2) * self.u0(xf, yf) + decay * self.u0dot(xf, yf) + decay ** 2 * ann

    def __call__(self, xx, yy, tt):
        return self._values(xx, yy, tt)

    def _boundary_samples(self, t):
        samples = []
        for bc in self.boundary_conditions:
            x, y = next(bc.points_generator)
            bxx, btt = _cartesian_prod_dims(x, t)
            byy, _ = _cartesian_prod_dims(y, t)
            samples.append((bxx, byy, btt))
        return tuple(samples)

    def calculate_loss(self, xx, yy, tt, x, y, t):
        return self._loss(xx, yy, tt, self._boundary_samples(t))

    def calculate_metrics(self, xx, yy, tt, x, y, t, metrics):
        return self._metrics((xx, yy, tt), metrics)


class FirstOrderInitialCondition:
    r"""A first-order initial condition: ``u0`` maps spatial coordinate
    Field(s) to :math:`u|_{t=0}` (reference ``temporal.py:299-314``)."""

    def __init__(self, u0):
        self.u0 = u0


class SecondOrderInitialCondition:
    r"""A second-order initial condition: ``u0`` and ``u0dot`` map spatial
    coordinate Field(s) to the initial value and initial time-derivative
    (reference ``temporal.py:317-343``)."""

    def __init__(self, u0, u0dot):
        self.u0 = u0
        self.u0dot = u0dot


class BoundaryCondition:
    r"""A penalty boundary condition: ``form`` has the same signature as the
    PDE and should vanish on the boundary; ``points_generator`` yields boundary
    points (reference ``temporal.py:346-371``)."""

    def __init__(self, form, points_generator):
        self.form = form
        self.points_generator = points_generator


# ------------------------------------------------------------- samplers

def _tensor(a):
    device, dtype = resolve()
    return torch.as_tensor(a, dtype=dtype, device=device)


def _generator_1d(size, lo, hi, random):
    """Bin centers of ``size`` equal bins of [lo, hi], plus uniform in-bin
    noise (``np.random.rand``) if ``random``."""
    seg_len = (hi - lo) / size
    center = np.linspace(lo + seg_len * 0.5, hi - seg_len * 0.5, size)
    noise_lo = -seg_len * 0.5
    while True:
        if random:
            yield _tensor(center + (seg_len * np.random.rand(size) + noise_lo))
        else:
            yield _tensor(center)


def generator_1dspatial(size, x_min, x_max, random=True):
    r"""Infinite generator of 1-D spatial points in [x_min, x_max]
    (reference ``temporal.py:374-403``): bin centers plus uniform in-bin noise."""
    return _generator_1d(size, x_min, x_max, random)


def generator_2dspatial_segment(size, start, end, random=True):
    r"""Infinite generator of 2-D points on a line segment
    (reference ``temporal.py:406-441``)."""
    x1, y1 = start
    x2, y2 = end
    step = 1. / size
    center = np.linspace(0. + 0.5 * step, 1. - 0.5 * step, size)
    noise_lo = -step * 0.5
    while True:
        pos = center + (step * np.random.rand(size) + noise_lo) if random else center
        yield _tensor(x1 + (x2 - x1) * pos), _tensor(y1 + (y2 - y1) * pos)


def generator_2dspatial_rectangle(size, x_min, x_max, y_min, y_max, random=True):
    r"""Infinite generator of 2-D points in a rectangle: cartesian product of
    two 1-D generators (reference ``temporal.py:444-472``)."""
    x_size, y_size = size
    x_generator = generator_1dspatial(x_size, x_min, x_max, random)
    y_generator = generator_1dspatial(y_size, y_min, y_max, random)
    while True:
        x = next(x_generator)
        y = next(y_generator)
        yield _cartesian_prod_dims(x, y)


def generator_temporal(size, t_min, t_max, random=True):
    r"""Infinite generator of 1-D temporal points in [t_min, t_max]
    (reference ``temporal.py:475-504``)."""
    return _generator_1d(size, t_min, t_max, random)


# ------------------------------------------------------------- monitors

def _plt():
    import matplotlib
    import matplotlib.pyplot as plt
    return matplotlib, plt


def _np_cartesian(x, t):
    x, t = np.asarray(x), np.asarray(t)
    return np.repeat(x, len(t)), np.tile(t, len(x))


def _plot_loss_metrics(ax_loss, ax_metrics, history):
    ax_loss.clear()
    ax_loss.plot(history['train_loss'], label='training loss')
    ax_loss.plot(history['valid_loss'], label='validation loss')
    ax_loss.set_title('loss during training')
    ax_loss.set_ylabel('loss')
    ax_loss.set_xlabel('epochs')
    ax_loss.set_yscale('log')
    ax_loss.legend()

    ax_metrics.clear()
    for metric_name, metric_values in history.items():
        if metric_name in ('train_loss', 'valid_loss'):
            continue
        ax_metrics.plot(metric_values, label=metric_name)
    ax_metrics.set_title('metrics during training')
    ax_metrics.set_ylabel('metrics')
    ax_metrics.set_xlabel('epochs')
    ax_metrics.set_yscale('log')
    if len(history) > 2:
        ax_metrics.legend()


def _create_contour(ax, xx, yy, uu):
    import matplotlib.tri as tri
    contour = ax.tricontourf(tri.Triangulation(xx, yy), uu, cmap='coolwarm')
    ax.set_xlabel('x')
    ax.set_ylabel('y')
    ax.set_aspect('equal', adjustable='box')
    return contour


class _TemporalMonitor:
    """Shared plumbing of the monitors: matplotlib imported here, and the
    canvas drawn (and, with a GUI backend, shown) after each check."""

    def __init__(self, check_every):
        matplotlib, self._plt = _plt()
        self.using_non_gui_backend = matplotlib.get_backend().lower() == 'agg'
        self.check_every = check_every

    def _draw(self, fig):
        fig.canvas.draw()
        if not self.using_non_gui_backend:  # pragma: no cover
            self._plt.pause(0.05)


class MonitorMinimal(_TemporalMonitor):
    r"""Shows only the loss and custom metrics (reference ``temporal.py:507-544``)."""

    def __init__(self, check_every):
        super().__init__(check_every)
        self.fig = self._plt.figure(figsize=(20, 8))
        self.ax1 = self.fig.add_subplot(121)
        self.ax2 = self.fig.add_subplot(122)

    def check(self, approximator, history):
        _plot_loss_metrics(self.ax1, self.ax2, history)
        self._draw(self.fig)


class Monitor1DSpatialTemporal(_TemporalMonitor):
    r"""Monitor for 1-D time-dependent problems (reference ``temporal.py:547-602``)."""

    def __init__(self, check_on_x, check_on_t, check_every):
        super().__init__(check_every)
        self.xx_array, self.tt_array = _np_cartesian(check_on_x, check_on_t)
        self.x_array = np.asarray(check_on_x)
        self.t_array = np.asarray(check_on_t)
        self.t_color = np.linspace(0, 1, len(self.t_array))

        self.fig = self._plt.figure(figsize=(30, 8))
        self.ax1 = self.fig.add_subplot(131)
        self.ax2 = self.fig.add_subplot(132)
        self.ax3 = self.fig.add_subplot(133)

    def check(self, approximator, history):
        import matplotlib.cm as cm
        uu_array = approximator(self.xx_array, self.tt_array)

        self.ax1.clear()
        for i, (t, c) in enumerate(zip(self.t_array, self.t_color)):
            u_t = uu_array[i::len(self.t_array)]
            self.ax1.plot(self.x_array, u_t, color=cm.viridis(c), label=f't = {float(t):.2E}')
        self.ax1.legend()
        self.ax1.set_title('approximation')

        _plot_loss_metrics(self.ax2, self.ax3, history)
        self._draw(self.fig)


class Monitor2DSpatialTemporal(_TemporalMonitor):
    r"""Monitor for 2-D time-dependent problems (reference ``temporal.py:605-684``)."""

    def __init__(self, check_on_x, check_on_y, check_on_t, check_every):
        super().__init__(check_every)
        self.xx_array, self.yy_array = _np_cartesian(check_on_x, check_on_y)
        self.tt_arrays = [np.ones(len(self.xx_array)) * float(t) for t in np.asarray(check_on_t)]
        self.t_array = np.asarray(check_on_t)
        self.fig = None
        self.axs = []
        self.cbs = []

    def check(self, approximator, history):
        if not self.fig:
            n_axs = len(self.t_array) + 2
            n_row, n_col = (n_axs + 1) // 2, 2
            self.fig = self._plt.figure(figsize=(20, 8 * n_row))
            for i in range(n_axs):
                self.axs.append(self.fig.add_subplot(n_row, n_col, i + 1))
            self.cbs = [None] * (n_axs - 2)

        for i, ax in enumerate(self.axs[:-2]):
            ax.clear()
            uu_array = approximator(self.xx_array, self.yy_array, self.tt_arrays[i])
            cs = _create_contour(ax, self.xx_array, self.yy_array, uu_array)
            if self.cbs[i] is None:
                self.cbs[i] = self.fig.colorbar(cs, format='%.0e', ax=ax)
            else:
                self.cbs[i].mappable.set_clim(vmin=uu_array.min(), vmax=uu_array.max())
            ax.set_title(f'approximation t = {self.t_array[i]:.2E}')

        _plot_loss_metrics(self.axs[-2], self.axs[-1], history)
        self._draw(self.fig)


class Monitor2DSpatial(_TemporalMonitor):
    r"""Monitor for 2-D steady-state problems (reference ``temporal.py:687-753``)."""

    def __init__(self, check_on_x, check_on_y, check_every):
        super().__init__(check_every)
        self.xx_array, self.yy_array = _np_cartesian(check_on_x, check_on_y)

        self.fig = self._plt.figure(figsize=(30, 8))
        self.ax1 = self.fig.add_subplot(131)
        self.cb1 = None
        self.ax2 = self.fig.add_subplot(132)
        self.ax3 = self.fig.add_subplot(133)

    def check(self, approximator, history):
        self.ax1.clear()
        uu_array = approximator(self.xx_array, self.yy_array)
        cs = _create_contour(self.ax1, self.xx_array, self.yy_array, uu_array)
        if self.cb1 is None:
            self.cb1 = self.fig.colorbar(cs, format='%.0e', ax=self.ax1)
        else:
            self.cb1.mappable.set_clim(vmin=uu_array.min(), vmax=uu_array.max())
        self.ax1.set_title('approximation')

        _plot_loss_metrics(self.ax2, self.ax3, history)
        self._draw(self.fig)


# ------------------------------------------------------- training routines

def _minibatch_train(approximator, optimizer, coord_arrays, boundary_samples, shuffle, batch_size):
    """Reference mini-batch loop (``temporal.py:934-958``): one optimizer
    step per slice of the cartesian-product points, the slices drawn by
    ``np.random.permutation`` if ``shuffle``."""
    n = len(coord_arrays[0])
    idx = torch.as_tensor(np.random.permutation(n) if shuffle else np.arange(n), device=coord_arrays[0].device)
    for batch_start in range(0, n, batch_size):
        batch_idx = idx[batch_start:batch_start + batch_size]
        optimizer.zero_grad(set_to_none=True)
        approximator._loss(*(a[batch_idx] for a in coord_arrays), boundary_samples).backward()
        optimizer.step()


def _epoch_result(loss, metrics):
    """``(float loss, {name: float metric})``: one host read of the loss per
    routine, as in the JAX package."""
    return float(loss), {k: float(v) for k, v in metrics.items()}


def _train_1dspatial_temporal(train_generator_spatial, train_generator_temporal,
                              approximator, optimizer, metrics, shuffle, batch_size):
    x = next(train_generator_spatial)
    t = next(train_generator_temporal)
    xx, tt = _cartesian_prod_dims(x, t)
    boundary_samples = approximator._boundary_samples(t)
    _minibatch_train(approximator, optimizer, (xx, tt), boundary_samples, shuffle, batch_size)
    with torch.no_grad():
        loss = approximator._loss(xx, tt, boundary_samples)
    return _epoch_result(loss, approximator.calculate_metrics(xx, tt, x, t, metrics))


def _train_2dspatial(train_generator_spatial, train_generator_temporal,
                     approximator, optimizer, metrics, shuffle, batch_size):
    xx, yy = next(train_generator_spatial)
    boundary_samples = approximator._boundary_samples()
    _minibatch_train(approximator, optimizer, (xx, yy), boundary_samples, shuffle, batch_size)
    with torch.no_grad():
        loss = approximator._loss(xx, yy, boundary_samples)
    return _epoch_result(loss, approximator.calculate_metrics(xx, yy, metrics))


def _valid_2dspatial(valid_generator_spatial, valid_generator_temporal, approximator, metrics):
    xx, yy = next(valid_generator_spatial)
    with torch.no_grad():
        loss = approximator.calculate_loss(xx, yy)
    return _epoch_result(loss, approximator.calculate_metrics(xx, yy, metrics))


def _train_2dspatial_temporal(train_generator_spatial, train_generator_temporal,
                              approximator, optimizer, metrics, shuffle, batch_size):
    x, y = next(train_generator_spatial)
    t = next(train_generator_temporal)
    xx, tt = _cartesian_prod_dims(x, t)
    yy, _ = _cartesian_prod_dims(y, t)
    boundary_samples = approximator._boundary_samples(t)
    _minibatch_train(approximator, optimizer, (xx, yy, tt), boundary_samples, shuffle, batch_size)
    with torch.no_grad():
        loss = approximator._loss(xx, yy, tt, boundary_samples)
    return _epoch_result(loss, approximator.calculate_metrics(xx, yy, tt, x, y, t, metrics))


def _valid_1dspatial_temporal(valid_generator_spatial, valid_generator_temporal, approximator, metrics):
    x = next(valid_generator_spatial)
    t = next(valid_generator_temporal)
    xx, tt = _cartesian_prod_dims(x, t)
    with torch.no_grad():
        loss = approximator.calculate_loss(xx, tt, x, t)
    return _epoch_result(loss, approximator.calculate_metrics(xx, tt, x, t, metrics))


def _valid_2dspatial_temporal(valid_generator_spatial, valid_generator_temporal, approximator, metrics):
    x, y = next(valid_generator_spatial)
    t = next(valid_generator_temporal)
    xx, tt = _cartesian_prod_dims(x, t)
    yy, _ = _cartesian_prod_dims(y, t)
    with torch.no_grad():
        loss = approximator.calculate_loss(xx, yy, tt, x, y, t)
    return _epoch_result(loss, approximator.calculate_metrics(xx, yy, tt, x, y, t, metrics))


def _solve_1dspatial_temporal(
        train_generator_spatial, train_generator_temporal, valid_generator_spatial, valid_generator_temporal,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor
):
    r"""Solve a 1-D time-dependent problem (reference ``temporal.py:756-803``).

    :param optimizer: a ``torch.optim.Optimizer`` over ``approximator.parameters()``.
    :return: ``(approximator, history)``.
    """
    return _solve_spatial_temporal(
        train_generator_spatial, train_generator_temporal, valid_generator_spatial, valid_generator_temporal,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor,
        train_routine=_train_1dspatial_temporal, valid_routine=_valid_1dspatial_temporal
    )


def _solve_2dspatial_temporal(
        train_generator_spatial, train_generator_temporal, valid_generator_spatial, valid_generator_temporal,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor
):
    r"""Solve a 2-D time-dependent problem (reference ``temporal.py:806-854``).

    :param optimizer: a ``torch.optim.Optimizer`` over ``approximator.parameters()``.
    :return: ``(approximator, history)``.
    """
    return _solve_spatial_temporal(
        train_generator_spatial, train_generator_temporal, valid_generator_spatial, valid_generator_temporal,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor,
        train_routine=_train_2dspatial_temporal, valid_routine=_valid_2dspatial_temporal
    )


def _solve_2dspatial(
        train_generator_spatial, valid_generator_spatial,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor
):
    r"""Solve a 2-D steady-state problem (reference ``temporal.py:856-898``).

    :param optimizer: a ``torch.optim.Optimizer`` over ``approximator.parameters()``.
    :return: ``(approximator, history)``.
    """
    return _solve_spatial_temporal(
        train_generator_spatial, None, valid_generator_spatial, None,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor,
        train_routine=_train_2dspatial, valid_routine=_valid_2dspatial
    )


def _solve_spatial_temporal(
        train_generator_spatial, train_generator_temporal, valid_generator_spatial, valid_generator_temporal,
        approximator, optimizer, batch_size, max_epochs, shuffle, metrics, monitor,
        train_routine, valid_routine
):
    history = {'train_loss': [], 'valid_loss': []}
    for metric_name in metrics:
        history['train_' + metric_name] = []
        history['valid_' + metric_name] = []

    for epoch in range(max_epochs):
        train_epoch_loss, train_epoch_metrics = train_routine(
            train_generator_spatial, train_generator_temporal, approximator, optimizer, metrics, shuffle, batch_size
        )
        history['train_loss'].append(train_epoch_loss)
        for metric_name, metric_value in train_epoch_metrics.items():
            history['train_' + metric_name].append(metric_value)

        valid_epoch_loss, valid_epoch_metrics = valid_routine(
            valid_generator_spatial, valid_generator_temporal, approximator, metrics
        )
        history['valid_loss'].append(valid_epoch_loss)
        for metric_name, metric_value in valid_epoch_metrics.items():
            history['valid_' + metric_name].append(metric_value)

        if monitor and epoch % monitor.check_every == 0:
            monitor.check(approximator, history)

    return approximator, history
