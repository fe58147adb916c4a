r"""Loss registry (counterpart of ``neurodiffeq_tpu/losses.py``).

Each entry maps ``(residual, funcs, coords) -> scalar`` where ``residual``
is an ``(N, n_eq)`` :class:`~neurodiffeq_tpu_torch.fields.Field` and
``coords`` are coordinate Fields. The H1 norms differentiate the residual
itself (:func:`~neurodiffeq_tpu_torch.operators.grad`), which is why
residuals stay Fields all the way to the loss. Over several coordinates
those gradients hold mixed partials, so H1 of a first-order residual takes
total order 2, and H1 of a second-order residual order 3.

Losses that are linear in the residual columns declare
``residual_power = 1``; solvers then scale equation k by ``w_k`` instead of
``sqrt(w_k)`` under ``residual_weights``.

Under a mesh (:mod:`~neurodiffeq_tpu_torch.parallel`) each rank holds one
block of the batch's rows, and a loss declares how it combines, as
``shard_form``:

- ``'mean'``: a mean over the points, so the sum over the ranks of each
  block's loss times its share of the rows is the global loss, exactly;
- ``'global'``: the loss needs the whole batch at once (``causal`` sorts it
  by time). The solver hands it the values of the global batch (tensors,
  gathered from every rank), and each rank's gradient flows through its
  own rows.

A loss that declares neither raises under a mesh.
"""
import torch

from .fields import Field

__all__ = ['_losses', 'causal', 'variational']


def _value(r):
    return r.value if isinstance(r, Field) else r


def _l1_norm(residual, funcs, coords):
    return _value(residual).abs().mean()


_l1_norm.residual_power = 1
_l1_norm.shard_form = 'mean'


def _l2_norm(residual, funcs, coords):
    return (_value(residual) ** 2).mean()


_l2_norm.shard_form = 'mean'


def _infinity_norm(residual, funcs, coords):
    return _value(residual).abs().amax(dim=1).mean()


# also degree-1: scaling column k by w_k weights it inside the per-point max
_infinity_norm.residual_power = 1
_infinity_norm.shard_form = 'mean'


def _residual_grads(residual, coords):
    """d(sum of residual columns)/d(coords): the torch ``grad_outputs=ones``
    semantics of the upstream reference."""
    from .operators import grad
    r_scalar = residual.sum(axis=1) if residual.shape[1] > 1 else residual
    return grad(r_scalar, *coords)


def _h1_norm(residual, funcs, coords):
    # the gradients first: they build the order-2 context whose memo then
    # serves the residual's value, so each net runs once
    g = [gi.value for gi in _residual_grads(residual, coords)]
    return (torch.cat([_value(residual)] + g, dim=1) ** 2).mean()


def _h1_semi_norm(residual, funcs, coords):
    g = _residual_grads(residual, coords)
    return (torch.cat([gi.value for gi in g], dim=1) ** 2).mean()


_h1_norm.shard_form = _h1_semi_norm.shard_form = 'mean'


def causal(epsilon=1.0, n_bins=32, t_index=-1):
    r"""Causal training loss for time-dependent problems (Wang, Sankaran &
    Perdikaris 2022, arXiv:2203.07404).

    Collocation points are sorted by the time coordinate, their squared
    residuals averaged into ``n_bins`` contiguous bins
    :math:`L_1, \dots, L_M`, and the loss is
    :math:`\frac{1}{M}\sum_i w_i L_i` with
    :math:`w_i = \exp(-\epsilon \sum_{j<i} L_j)`, the weights detached from
    the graph.

    :param epsilon: Causality strength, defaults to 1.0.
    :param n_bins: Number of time bins M (clipped to the batch size),
        defaults to 32.
    :param t_index: Which coordinate is time, defaults to -1 (the last one).
    """

    def loss(residual, funcs, coords):
        r2 = (_value(residual) ** 2).mean(dim=1)
        n = r2.shape[0]
        t = _value(coords[t_index]).reshape(-1)
        r2 = r2[torch.argsort(t, stable=True)]
        m = min(int(n_bins), n)
        bounds = [round(i * n / m) for i in range(m + 1)]
        L = torch.stack([r2[a:b].mean() for a, b in zip(bounds[:-1], bounds[1:])])
        cum = torch.cat([L.new_zeros(1), torch.cumsum(L, 0)[:-1]])
        w = torch.exp(-epsilon * cum).detach()
        return (w * L).mean()

    loss.shard_form = 'global'  # the sort by time spans the whole batch
    return loss


def variational(residual, funcs, coords):
    r"""Deep Ritz / variational loss (E & Yu 2018, arXiv:1710.00211): the
    equations return an energy density and this loss is its Monte-Carlo
    integral, the mean of the summed columns (not a squared norm). Linear in
    the density columns: ``residual_power = 1``."""
    v = _value(residual)
    return v.sum(dim=1).mean() if v.ndim > 1 else v.mean()


variational.residual_power = 1
variational.shard_form = 'mean'


_losses = {
    'variational': variational,
    'l1': _l1_norm,
    'l2': _l2_norm,
    'infinity': _infinity_norm,
    'h1': _h1_norm,
    'h1 semi': _h1_semi_norm,
}
