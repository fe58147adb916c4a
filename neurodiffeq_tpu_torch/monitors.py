r"""Monitors: live matplotlib plots of solutions, losses and metrics
(counterpart of ``neurodiffeq_tpu/monitors.py``).

``BaseMonitor`` with ``to_callback()``, ``Monitor1D``, ``Monitor2D`` (with
the irregular-domain mask), ``MonitorSpherical``,
``MonitorSphericalHarmonics``, ``MetricsMonitor`` and
``StreamPlotMonitor2D``. A monitor evaluates the conditions enforced on the
nets at fixed plotting points under ``torch.no_grad()``, on the nets'
device, and plots the values as numpy arrays. matplotlib is imported when
the first monitor is made, never when this module is imported. The JAX
package caches one compiled evaluation per net, condition and shape to cut
its dispatches over the TPU transport; eager PyTorch has nothing to cache.
"""
import math
import warnings
from abc import ABC, abstractmethod

import numpy as np
import torch

from ._version_utils import deprecated_alias

__all__ = [
    'BaseMonitor', 'Monitor1D', 'Monitor2D', 'MonitorSpherical',
    'MonitorSphericalHarmonics', 'MetricsMonitor', 'StreamPlotMonitor2D',
]


def _plt():
    import matplotlib.pyplot as plt
    return plt


def _updatable_contour_plot_available():
    import matplotlib
    major, minor, *_ = matplotlib.__version__.split('.')
    return (int(major), int(minor)) >= (3, 3)


def _placement(net):
    """(device, dtype) of a net's parameters (the port's defaults for a net
    without any)."""
    from .utils import resolve
    p = next(iter(net.parameters()), None)
    return (p.device, p.dtype) if p is not None else resolve()


def _coordinates(net, *arrays):
    from .fields import coordinates
    device, dtype = _placement(net)
    return coordinates(*arrays, dtype=dtype, device=device)


def _enforce_np(net, cond, *arrays):
    """A condition enforced on a net at fixed plotting coordinates, as a
    numpy (N, m) array."""
    with torch.no_grad():
        coords = _coordinates(net, *arrays)
        value = cond.enforce(net, *coords).value
        coords[0].coords.release()
    return value.cpu().numpy()


class BaseMonitor(ABC):
    r"""A tool for checking the status of the neural network during training.

    A monitor keeps a matplotlib Figure and redraws it whenever its
    ``check()`` method is called (usually through ``monitor.to_callback()``).
    """

    def __init__(self, check_every=None):
        import matplotlib
        self.check_every = check_every or 100
        self.fig = ...
        self.using_non_gui_backend = (matplotlib.get_backend().lower() == 'agg')
        if matplotlib.get_backend() == 'module://ipykernel.pylab.backend_inline':
            warnings.warn("You seem to be using jupyter notebook with '%matplotlib inline' which can lead to monitor "
                          "plots not updating. Consider using '%matplotlib notebook' or '%matplotlib widget' instead.",
                          UserWarning)

    @abstractmethod
    def check(self, nets, conditions, history, params=None, solver=None):
        """Redraw. ``params`` is accepted for the JAX package's signature; the
        port's nets carry their parameters."""

    def to_callback(self, fig_dir=None, format=None, logger=None):
        r"""A callback that redraws every ``check_every`` epochs and on the
        last local epoch."""
        from .callbacks import MonitorCallback, OnLastLocal, PeriodLocal
        action_cb = MonitorCallback(self, fig_dir=fig_dir, format=format, logger=logger)
        condition_cb = OnLastLocal(logger=logger)
        if self.check_every:
            condition_cb = condition_cb | PeriodLocal(self.check_every, logger=logger)
        return condition_cb.set_action_callback(action_cb)

    def _pause(self):
        # on a non-GUI backend (Agg) a render shows nothing until the figure
        # is saved, and savefig renders anyway
        if not self.using_non_gui_backend:
            self.fig.canvas.draw()
            _plt().pause(0.05)

    @staticmethod
    def _plot_history(ax, history, losses=True, title=None):
        # the Line2D artists are kept across fires and given new data
        state = getattr(ax, '_ndq_history_lines', None)
        if state is not None and any(line.axes is not ax for line in state.values()):
            state = None  # an ax.clear() detached them: rebuild
        if state is None:
            state = {}
            ax._ndq_history_lines = state
            ax.set_title(title or ('loss during training' if losses else 'metrics during training'))
            ax.set_ylabel('loss' if losses else 'metrics')
            ax.set_xlabel('epochs')
            ax.set_yscale('log')
        new_labels = False
        for name, values in history.items():
            if (name in ('train_loss', 'valid_loss')) != losses:
                continue
            label = {'train_loss': 'training loss', 'valid_loss': 'validation loss'}.get(name, name)
            line = state.get(name)
            if line is None:
                (line,) = ax.plot([], [], label=label)
                state[name] = line
                new_labels = True
            line.set_data(np.arange(len(values)), np.asarray(values, dtype=float))
        # series the current history no longer has (the monitor reused on
        # another solver) are removed
        stale = [name for name in state if (name in ('train_loss', 'valid_loss')) == losses and name not in history]
        for name in stale:
            state.pop(name).remove()
        if stale or (new_labels and (losses or len(history) > 2)):
            ax.legend()
        ax.relim()
        ax.autoscale_view()


class Monitor1D(BaseMonitor):
    """Monitors ODE solutions: solution curves, loss history, metric history.

    :param t_min: lower bound of the monitored time domain.
    :param t_max: upper bound of the monitored time domain.
    :param check_every: epochs between checks; defaults to 100.
    """

    def __init__(self, t_min, t_max, check_every=None):
        super().__init__(check_every=check_every)
        self.fig = _plt().figure(figsize=(30, 8))
        self.ax1 = self.fig.add_subplot(131)
        self.ax2 = self.fig.add_subplot(132)
        self.ax3 = self.fig.add_subplot(133)
        self.ts_plt = np.linspace(t_min, t_max, 100)

    def check(self, nets, conditions, history, params=None, solver=None):
        us = [_enforce_np(net, cond, self.ts_plt) for net, cond in zip(nets, conditions)]
        self.ax1.clear()
        for i, u in enumerate(us):
            self.ax1.plot(self.ts_plt, u[:, 0], label=f'variable {i}')
        self.ax1.legend()
        self.ax1.set_title('solutions')
        self._plot_history(self.ax2, history, losses=True)
        self._plot_history(self.ax3, history, losses=False)
        self._pause()


class Monitor2D(BaseMonitor):
    r"""Monitors 2-D PDE solutions as heatmaps or as curves grouped by t,
    masking cells outside an irregular domain.

    :param xy_min: lower bounds (x_0, y_0).
    :param xy_max: upper bounds (x_1, y_1).
    :param valid_generator: generator sampled once (with a generator seeded
        0) for the plotting points; defaults to a 32 x 32 grid.
    :param solution_style: 'heatmap' or 'curves'.
    """

    def __init__(self, xy_min, xy_max, check_every=None, valid_generator=None, solution_style='heatmap',
                 equal_aspect=True, ax_width=5.0, ax_height=4.0, n_col=2, levels=20):
        super().__init__(check_every=check_every)
        if solution_style not in ['heatmap', 'curves']:
            raise ValueError(f"Unsupported 'solution_style' = {solution_style}")
        self.solution_style = solution_style
        self.fig = None
        self.ax_width = ax_width
        self.ax_height = ax_height
        self.n_col = n_col
        self.equal_aspect = equal_aspect
        self.axs = []
        self.cbs = []
        if valid_generator is None:
            # a structured grid: heatmaps draw one pcolormesh
            gx = np.linspace(xy_min[0], xy_max[0], 32)
            gy = np.linspace(xy_min[1], xy_max[1], 32)
            X, Y = np.meshgrid(gx, gy)
            self._mesh_xy = (X, Y)
            self.xs_plot = X.flatten()
            self.ys_plot = Y.flatten()
        else:
            self._mesh_xy = None
            xs, ys = valid_generator.sample(torch.Generator(device=valid_generator.device).manual_seed(0))
            self.xs_plot = xs.detach().cpu().numpy().flatten()
            self.ys_plot = ys.detach().cpu().numpy().flatten()
        self.levels = levels

    def _create_contour(self, ax, xs, ys, zs, condition):
        import matplotlib.tri as tri
        from .conditions import IrregularBoundaryCondition
        triang = tri.Triangulation(xs, ys)
        cx = xs[triang.triangles].mean(axis=1)
        cy = ys[triang.triangles].mean(axis=1)
        if isinstance(condition, IrregularBoundaryCondition):
            triang.set_mask(~np.asarray(condition.in_domain(cx, cy)).flatten())
        contour = ax.tricontourf(triang, zs, cmap='coolwarm', levels=self.levels)
        ax.set_xlabel('x')
        ax.set_ylabel('y')
        if self.equal_aspect:
            ax.set_aspect('equal', adjustable='box')
        return contour

    def check(self, nets, conditions, history, params=None, solver=None):
        from .conditions import IrregularBoundaryCondition
        if not self.fig:
            n_func = len(conditions)
            n_col = self.n_col
            n_row_sols = math.ceil(n_func / n_col)
            n_row = n_row_sols + 2
            self.fig = _plt().figure(figsize=(self.ax_width * n_col, self.ax_height * n_row))
            self.fig.tight_layout()
            for i in range(n_func):
                self.axs.append(self.fig.add_subplot(n_row, n_col, i + 1))
                self.cbs.append(None)
            self.axs.append(self.fig.add_subplot(n_row, 1, n_row_sols + 1))
            self.axs.append(self.fig.add_subplot(n_row, 1, n_row_sols + 2))

        us = [_enforce_np(net, cond, self.xs_plot, self.ys_plot) for net, cond in zip(nets, conditions)]
        for i, (ax, u, con) in enumerate(zip(self.axs[:-2], us, conditions)):
            ax.clear()
            u = u.flatten()
            if self.solution_style == 'heatmap':
                if self._mesh_xy is not None and not isinstance(con, IrregularBoundaryCondition):
                    X, Y = self._mesh_xy
                    cs = ax.pcolormesh(X, Y, u.reshape(X.shape), cmap='coolwarm', shading='gouraud')
                    ax.set_xlabel('x')
                    ax.set_ylabel('y')
                    if self.equal_aspect:
                        ax.set_aspect('equal', adjustable='box')
                else:
                    cs = self._create_contour(ax, self.xs_plot, self.ys_plot, u, con)
                if self.cbs[i] is None:
                    self.cbs[i] = self.fig.colorbar(cs, format='%.0e', ax=ax)
                else:
                    # re-point the colorbar: a new one per fire costs a layout pass
                    self.cbs[i].update_normal(cs)
                ax.set_title(f'u[{i}](x, y)')
            else:
                # u-x curves grouped by t (= the y coordinate)
                for t_val in np.unique(np.round(self.ys_plot, 6))[::max(1, len(np.unique(self.ys_plot)) // 8)]:
                    m = np.isclose(self.ys_plot, t_val)
                    order = np.argsort(self.xs_plot[m])
                    ax.plot(self.xs_plot[m][order], u[m][order], label=f't={t_val:.2f}')
                ax.legend(fontsize=6)
                ax.set_title(f'u[{i}](x) across different t')

        self._plot_history(self.axs[-2], history, losses=True)
        self._plot_history(self.axs[-1], history, losses=False)
        self._pause()


class MonitorSpherical(BaseMonitor):
    r"""Monitors spherical PDE solutions: u-r curves grouped by phi and by
    theta, a theta-phi contour averaged across r, and the histories.

    :param r_min: interior radius.
    :param r_max: exterior radius.
    :param shape: (n_r, n_theta, n_phi) plotting grid; defaults (10, 10, 10).
    :param r_scale: 'linear' or 'log' spacing of the r grid.
    """

    def __init__(self, r_min, r_max, check_every=None, var_names=None, shape=(10, 10, 10), r_scale='linear',
                 theta_min=0.0, theta_max=math.pi, phi_min=0.0, phi_max=math.pi * 2):
        from .generators import Generator3D
        super().__init__(check_every=check_every)
        self.contour_plot_available = _updatable_contour_plot_available()
        self.fig = None
        self.axs = []
        self.ax_metrics = None
        self.ax_loss = None
        self.cbs = []
        self.names = var_names
        self.shape = shape

        lo, hi = (np.log(r_min), np.log(r_max)) if r_scale == 'log' else (r_min, r_max)
        gen = Generator3D(grid=shape, xyz_min=(lo, theta_min, phi_min), xyz_max=(hi, theta_max, phi_max),
                          method='equally-spaced', device='cpu', dtype=torch.float64)
        rs, thetas, phis = (c.numpy() for c in gen.sample(torch.Generator().manual_seed(0)))
        if r_scale == 'log':
            rs = np.exp(rs)
        self.r_label = rs.reshape(-1)
        self.theta_label = thetas.reshape(-1)
        self.phi_label = phis.reshape(-1)
        self.n_vars = None

    @staticmethod
    def _longitude_formatter(value, count):
        value = int(round(value / math.pi * 180)) - 180
        marker = '' if value == 0 or abs(value) == 180 else ('E' if value > 0 else 'W')
        return f'{abs(value)}°{marker}'

    @staticmethod
    def _latitude_formatter(value, count):
        value = int(round(value / math.pi * 180)) - 90
        marker = '' if value == 0 else ('N' if value > 0 else 'S')
        return f'{abs(value)}°{marker}'

    def _compute_us(self, nets, conditions):
        return [_enforce_np(net, cond, self.r_label, self.theta_label, self.phi_label)
                for net, cond in zip(nets, conditions)]

    @deprecated_alias(loss_history='history')
    def check(self, nets, conditions, history, params=None, solver=None, analytic_mse_history=None):
        r"""Draw (3n + 2) plots: per function, u-r curves grouped by phi and by
        theta and a theta-phi contour; then the loss and metric histories."""
        for key in ['train', 'valid']:
            if key in history:
                warnings.warn(f'`{key}` is deprecated, use `{key}_loss` instead', FutureWarning)
                history[key + '_loss'] = history.pop(key)
        if ('train_loss' not in history) or ('valid_loss' not in history):
            raise ValueError("Either 'train_loss' or 'valid_loss' not present in `history`.")
        if analytic_mse_history is not None:
            warnings.warn("`analytic_mse_history` is deprecated. Include 'train_analytic_mse' and "
                          "'valid_analytic_mse' in ``history`` instead.", FutureWarning)
            history['train_analytic_mse'] = analytic_mse_history['train']
            history['valid_analytic_mse'] = analytic_mse_history['valid']

        n_vars = len(nets) if self.n_vars is None else self.n_vars
        n_row = (n_vars + 2) if len(history) > 2 else (n_vars + 1)
        n_col = 3
        if not self.fig:
            self.fig = _plt().figure(figsize=(24, 6 * n_row))
            self.fig.tight_layout()
            self.axs = self.fig.subplots(nrows=n_row, ncols=n_col, gridspec_kw={'width_ratios': [1, 1, 2]})
            if n_row == 1:
                self.axs = np.array([self.axs])
            for row in self.axs[n_vars:]:
                for ax in row:
                    ax.remove()
            self.cbs = [None] * n_vars
            if len(history) > 2:
                self.ax_loss = self.fig.add_subplot(n_row, 1, n_row - 1)
                self.ax_metrics = self.fig.add_subplot(n_row, 1, n_row)
            else:
                self.ax_loss = self.fig.add_subplot(n_row, 1, n_row)

        us = self._compute_us(nets, conditions)
        for i, u in enumerate(us):
            try:
                var_name = self.names[i]
            except (TypeError, IndexError):
                var_name = f"u[{i}]"
            u_across_r = u.reshape(*self.shape).mean(0)
            self._update_r_plot_grouped_by(var_name, self.axs[i][0], u, self.phi_label, '$\\phi$')
            self._update_r_plot_grouped_by(var_name, self.axs[i][1], u, self.theta_label, '$\\theta$')
            self._update_contourf(var_name, self.axs[i][2], u_across_r, colorbar_index=i)

        self._plot_history(self.ax_loss, history, losses=True, title='Loss (Mean Squared Residual)')
        if len(history) > 2:
            self._plot_history(self.ax_metrics, history, losses=False, title='Other metrics')
        self.customization()
        self._pause()

    def customization(self):
        """Override to apply custom tweaks after each redraw."""

    def _update_r_plot_grouped_by(self, var_name, ax, u, group_label, group_name):
        ax.clear()
        for g in np.unique(np.round(group_label, 8)):
            m = np.isclose(group_label, g)
            rs = self.r_label[m]
            order = np.argsort(rs)
            ax.plot(rs[order], u.flatten()[m][order], alpha=0.5)
        ax.set_xlabel('$r$')
        ax.set_title(f'{var_name}($r$) grouped by {group_name}')
        ax.set_ylabel(var_name)

    def _update_contourf(self, var_name, ax, u, colorbar_index):
        plt = _plt()
        ax.clear()
        ax.set_xlabel('$\\phi$')
        ax.set_ylabel('$\\theta$')
        ax.set_title(f'{var_name} averaged across $r$')
        if self.contour_plot_available:
            theta = self.theta_label.reshape(*self.shape)[0, :, 0]
            phi = self.phi_label.reshape(*self.shape)[0, 0, :]
            cax = ax.contourf(phi, theta, u, cmap='magma', levels=max(self.shape[-2:]))
            ax.xaxis.set_major_locator(plt.MultipleLocator(math.pi / 6))
            ax.xaxis.set_minor_locator(plt.MultipleLocator(math.pi / 12))
            ax.xaxis.set_major_formatter(plt.FuncFormatter(self._longitude_formatter))
            ax.yaxis.set_major_locator(plt.MultipleLocator(math.pi / 6))
            ax.yaxis.set_minor_locator(plt.MultipleLocator(math.pi / 12))
            ax.yaxis.set_major_formatter(plt.FuncFormatter(self._latitude_formatter))
            ax.grid(which='major', linestyle='--', linewidth=0.5)
            ax.grid(which='minor', linestyle=':', linewidth=0.5)
        else:  # pragma: no cover - matplotlib before 3.3
            cax = ax.matshow(u, cmap='magma', interpolation='nearest')
        if self.cbs[colorbar_index] is None:
            self.cbs[colorbar_index] = self.fig.colorbar(cax, ax=ax)
        else:
            self.cbs[colorbar_index].update_normal(cax)

    def new(self):
        self.fig = None
        self.axs = []
        self.cbs = []
        self.ax_metrics = None
        self.ax_loss = None
        return self

    def set_variable_count(self, n):
        r"""Set the number of scalar fields to plot."""
        self.n_vars = n
        return self

    def unset_variable_count(self):
        r"""Infer the number of fields from ``nets`` again."""
        self.n_vars = None
        return self


class MonitorSphericalHarmonics(MonitorSpherical):
    r"""A :class:`MonitorSpherical` for radial networks that give harmonic
    coefficients, expanded before plotting.

    :param harmonics_fn: mapping from (theta, phi) to the basis functions.
    """

    def __init__(self, r_min, r_max, check_every=None, var_names=None, shape=(10, 10, 10), r_scale='linear',
                 harmonics_fn=None, theta_min=0.0, theta_max=math.pi, phi_min=0.0, phi_max=math.pi * 2,
                 max_degree=None):
        super().__init__(r_min, r_max, check_every=check_every, var_names=var_names, shape=shape, r_scale=r_scale,
                         theta_min=theta_min, theta_max=theta_max, phi_min=phi_min, phi_max=phi_max)
        if (harmonics_fn is None) and (max_degree is None):
            raise ValueError("harmonics_fn should be specified")
        if max_degree is not None:
            warnings.warn("`max_degree` is DEPRECATED; pass `harmonics_fn` instead, which takes precedence")
            from .function_basis import RealSphericalHarmonics
            self.harmonics_fn = RealSphericalHarmonics(max_degree=max_degree)
        if harmonics_fn is not None:
            self.harmonics_fn = harmonics_fn

    def _compute_us(self, nets, conditions):
        us = []
        with torch.no_grad():
            for net, cond in zip(nets, conditions):
                rf, thetaf, phif = _coordinates(net, self.r_label, self.theta_label, self.phi_label)
                products = cond.enforce(net, rf) * self.harmonics_fn(thetaf, phif)
                us.append(products.sum(axis=1, keepdims=True).value.cpu().numpy())
                rf.coords.release()
        return us

    @property
    def max_degree(self):
        try:
            return self.harmonics_fn.max_degree
        except AttributeError as e:
            warnings.warn(f"Error caught when accessing {self.__class__.__name__}, returning None:\n{e}")
            return None


class MetricsMonitor(BaseMonitor):
    r"""Plots the loss and metric histories only."""

    def __init__(self, check_every=None):
        super().__init__(check_every=check_every)
        self.fig = _plt().figure(figsize=(12, 6), dpi=125)
        self.ax1, self.ax2 = self.fig.subplots(1, 2)

    def check(self, nets, conditions, history, params=None, solver=None):
        self._plot_history(self.ax1, history, losses=True)
        self._plot_history(self.ax2, history, losses=False)
        self._pause()


class StreamPlotMonitor2D(BaseMonitor):
    r"""Streamlines of 2-D vector fields made of solution components (or of
    a scalar solution's gradient), with an optional domain mask.

    :param pairs: (ui, vi) index pairs for vector fields, or an int i for
        the gradient of u[i].
    :param mask_fn: optional (X, Y) -> bool array masking the domain.
    """

    def __init__(self, xy_min, xy_max, pairs, nx=32, ny=32, check_every=None, mask_fn=None,
                 ax_width=13.0, ax_height=10.0, n_col=2, stream_kwargs=None, equal_aspect=True, field_names=None):
        super().__init__(check_every=check_every)
        self.pairs = pairs
        self.field_names = field_names or [f'Field[{i}]' for i, _ in enumerate(pairs)]
        if len(self.field_names) != len(self.pairs):
            raise ValueError(f"Length of field_names ({len(self.field_names)}) != Length of pairs ({len(self.pairs)})")
        n_row = int(np.ceil(len(self.pairs) / n_col))
        self.nx, self.ny = nx, ny
        self.fig = _plt().figure(figsize=(n_col * ax_width, n_row * ax_height))
        self.axes = np.array(self.fig.subplots(n_row, n_col)).reshape(-1)
        self.cbs = [None] * len(pairs)
        _x = np.linspace(xy_min[0], xy_max[0], nx)
        _y = np.linspace(xy_min[1], xy_max[1], ny)
        self.xs_plot, self.ys_plot = np.meshgrid(_x, _y, indexing='ij')
        self.xlim = xy_min[0], xy_max[0]
        self.ylim = xy_min[1], xy_max[1]
        if mask_fn:
            self.mask = mask_fn(self.xs_plot, self.ys_plot)
            _pcolor_x, _pcolor_y = np.meshgrid(np.linspace(xy_min[0], xy_max[0], nx * 8),
                                               np.linspace(xy_min[1], xy_max[1], ny * 8))
            self._pcolor_args = (_pcolor_x, _pcolor_y, ~mask_fn(_pcolor_x, _pcolor_y))
        else:
            self.mask = None
            self._pcolor_args = ()
        self.stream_kwargs = dict(density=(self.nx / 30, self.ny / 30))
        self.stream_kwargs.update(stream_kwargs or {})
        self.equal_aspect = equal_aspect

    def _plot_streamlines(self, ax, us, vs, norms, cb_idx, is_grad=False):
        # the colorbar goes before ax.clear()
        if self.cbs[cb_idx] is not None:
            self.cbs[cb_idx].remove()
            self.cbs[cb_idx] = None
        ax.clear()
        if self.mask is not None:
            us, vs = us.copy(), vs.copy()
            us[~self.mask] = np.nan
            vs[~self.mask] = np.nan
            ax.pcolor(*self._pcolor_args, shading='auto', cmap='Purples')
        kwargs = dict(color=norms.transpose())
        kwargs.update(self.stream_kwargs)
        stream = ax.streamplot(self.xs_plot[:, 0], self.ys_plot[0, :], us.transpose(), vs.transpose(), **kwargs)
        self.cbs[cb_idx] = _plt().colorbar(stream.lines, ax=ax)
        if self.equal_aspect:
            ax.set_aspect('equal', adjustable='box')
        ax.set_xlim(*self.xlim)
        ax.set_ylim(*self.ylim)
        ax.set_title(f'Gradient of {self.field_names[cb_idx]}' if is_grad
                     else f'Stream Plot of {self.field_names[cb_idx]}')

    def _field_values(self, nets, conditions, pair):
        """(us, vs, is_grad) of one pair on the (nx, ny) grid."""
        from .operators import grad
        with torch.no_grad():
            net = nets[pair if isinstance(pair, int) else pair[0]]
            xf, yf = _coordinates(net, self.xs_plot.flatten(), self.ys_plot.flatten())
            if isinstance(pair, int):
                gx, gy = grad(conditions[pair].enforce(nets[pair], xf, yf), xf, yf)
                us, vs, is_grad = gx.value, gy.value, True
            else:
                ui, vi = pair
                us = conditions[ui].enforce(nets[ui], xf, yf).value
                vs = conditions[vi].enforce(nets[vi], xf, yf).value
                is_grad = False
            xf.coords.release()
        return (us.cpu().numpy().reshape(self.nx, self.ny), vs.cpu().numpy().reshape(self.nx, self.ny), is_grad)

    def check(self, nets, conditions, history, params=None, solver=None):
        for idx, pair in enumerate(self.pairs):
            us, vs, is_grad = self._field_values(nets, conditions, pair)
            norms = np.sqrt(us ** 2 + vs ** 2)
            self._plot_streamlines(ax=self.axes[idx], us=us, vs=vs, norms=norms, cb_idx=idx, is_grad=is_grad)
        self._pause()
