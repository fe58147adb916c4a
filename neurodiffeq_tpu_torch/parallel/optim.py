r"""Optimizers that read across their parameters, on the ``'model'`` axis.

On a ``(points, model)`` mesh each rank stores its blocks of the split
leaves (:func:`~neurodiffeq_tpu_torch.parallel.sharding.device_put_params`),
and its gradients and optimizer state follow them. An elementwise optimizer
(Adam, SGD) steps each element alone and runs on the blocks as it is. Three
``torch.optim`` optimizers read across their parameters, and
:func:`on_model_axis` makes each step on the rank's blocks exactly as it
steps on the full-size leaves without a mesh (the JAX package gets this
from XLA, which inserts the global reductions into optax's step):

- ``torch.optim.LBFGS``: dot products, norms, the strong-Wolfe line search
  and the stopping tests over the flat parameter vector;
- ``torch.optim.Adafactor``: each matrix's row and column factors, and the
  norms of each leaf and of its update;
- ``torch.optim.Muon``: the Newton-Schulz orthogonalization of each
  matrix's update.

Every global scalar is a sum over the model group, in which each block
counts on its own rank and each replicated leaf, which every model rank
holds alike, counts once, on model rank 0; a maximum is the largest of the
group's slots (each rank writes its own into its slot of a zero vector, and
the vector is summed). Every model rank then holds the same bits and takes
the same branches, and the replicated leaves stay equal on every rank.
The reductions of a step ride in a fixed number of ``all_reduce`` calls
(:meth:`_OnModelAxis._reduce`):

- L-BFGS: one per closure call (the directional derivative and the
  gradient's largest element), and two per iteration: the new row of the
  history's Gram scalars (S.Y, Y.Y, S.g, Y.g), and the direction's
  derivative and largest element. The two-loop recursion runs on the
  replicated scalars and each rank forms its part of the direction from
  its blocks (vector-free L-BFGS: Chen, Wang and Zhou, "Large-scale L-BFGS
  using MapReduce", NeurIPS 2014). It is an exact rewrite, so the steps are
  ``torch.optim.LBFGS``'s to round-off, and no count depends on
  ``history_size``. The history holds the rank's flat vector over its
  blocks and replicated leaves, 1/m of each split leaf, in two buffers of
  ``history_size`` rows that the products read in place, with no copy.
- Adafactor: two per step. A factor along the split dimension stays a
  block; the factor along the other dimension is a global mean.
- Muon: one per step, which gathers the Nesterov updates of all split
  matrices to full size; every rank orthogonalizes the full matrices and
  keeps its blocks. ``torch.optim.Muon`` takes only 2-D parameters, so a
  solver trains with Muon over the weights it is given, with a mesh or
  without.

Saved files hold ``torch.optim``'s own full-size state
(:func:`full_optimizer_state`), which :func:`placed_optimizer_state` places
on the ranks of any mesh, or none.
"""
import math
import weakref
from collections import namedtuple

import numpy as np
import torch

from .sharding import all_reduce_, stored_blocks

__all__ = ['on_model_axis', 'full_optimizer_state', 'placed_optimizer_state']

# a cut of a full-size tensor: the block [lo, hi) along dim of shape (a _Block, or a factor's)
Cut = namedtuple('Cut', 'dim lo hi shape')


def _scalar(x):
    return x.item() if torch.is_tensor(x) else x


def _cut(spec):
    return Cut(spec.dim, spec.lo, spec.hi, tuple(spec.shape))


class _OnModelAxis:
    """What the optimizers of this module share: this rank's model group and
    its stored blocks, and the one collective they issue."""

    plain = None  # the torch.optim class whose step this one takes

    def _attach(self, split, blocks):
        self._split, self._blocks = split, blocks

    def _reduce(self, flat):
        """``flat`` summed over the model group, in place: one ``all_reduce``."""
        return all_reduce_(flat, self._split.group)

    def _sum(self, parts):
        """Each tensor of ``parts`` summed over the model group, all in one
        ``all_reduce``."""
        flat = self._reduce(torch.cat([p.reshape(-1) for p in parts]))
        return [f.view_as(p) for f, p in zip(torch.split(flat, [p.numel() for p in parts]), parts)]

    def _slots(self, values):
        """A zero ``(m, len(values))`` matrix with ``values`` in this rank's
        row: summed, each column holds every rank's value."""
        rows = values[0].new_zeros(self._split.size, len(values))
        rows[self._split.rank] = torch.stack(values)
        return rows


def _gather(items, group):
    """The full-size tensors of ``items`` (tensor, Cut or None): each cut
    block written into a zero tensor of its full shape, all summed over
    ``group`` in one ``all_reduce``; an uncut tensor is returned as it is."""
    cut = [(t, c) for t, c in items if c is not None]
    if not cut:
        return [t for t, _ in items]
    sizes = [math.prod(c.shape) for _, c in cut]
    flat = cut[0][0].new_zeros(sum(sizes))
    fulls = iter([f.view(c.shape) for f, (_, c) in zip(torch.split(flat, sizes), cut)])
    out = []
    for t, c in items:
        if c is None:
            out.append(t)
            continue
        full = next(fulls)
        full.narrow(c.dim, c.lo, c.hi - c.lo).copy_(t)
        out.append(full)
    all_reduce_(flat, group)
    return out


# ------------------------------------------------------------------- L-BFGS
def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bounds=None):
    """``torch.optim.lbfgs._cubic_interpolate`` on float64 host scalars."""
    if bounds is not None:
        xmin_bound, xmax_bound = bounds
    else:
        xmin_bound, xmax_bound = (x1, x2) if x1 <= x2 else (x2, x1)
    with np.errstate(divide='ignore', invalid='ignore'):
        x1, f1, g1, x2, f2, g2 = map(np.float64, (x1, f1, g1, x2, f2, g2))
        d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
        d2_square = d1 ** 2 - g1 * g2
        if d2_square >= 0:
            d2 = np.sqrt(d2_square)
            if x1 <= x2:
                min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + 2 * d2))
            else:
                min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + 2 * d2))
            return min(max(min_pos, xmin_bound), xmax_bound)
    return (xmin_bound + xmax_bound) / 2.0


def _strong_wolfe(obj_func, x, t, d, f, g, gmax, gtd, d_norm, c1=1e-4, c2=0.9, tolerance_change=1e-9, max_ls=25):
    """``torch.optim.lbfgs._strong_wolfe`` with the reductions done by
    ``obj_func``: it returns the loss, the rank's flat gradient, the global
    directional derivative and the gradient's largest element, which ride
    with the gradient. ``d_norm`` is the direction's largest element."""
    f_new, g_new, gtd_new, gmax_new = obj_func(x, t, d)
    ls_func_evals = 1
    t_prev, f_prev, g_prev, gmax_prev, gtd_prev = 0, f, g, gmax, gtd
    done = False
    ls_iter = 0
    while ls_iter < max_ls:
        if f_new > (f + c1 * t * gtd) or (ls_iter > 1 and f_new >= f_prev):
            bracket, bracket_f = [t_prev, t], [f_prev, f_new]
            bracket_g, bracket_gmax, bracket_gtd = [g_prev, g_new], [gmax_prev, gmax_new], [gtd_prev, gtd_new]
            break
        if abs(gtd_new) <= -c2 * gtd:
            bracket, bracket_f, bracket_g, bracket_gmax = [t], [f_new], [g_new], [gmax_new]
            done = True
            break
        if gtd_new >= 0:
            bracket, bracket_f = [t_prev, t], [f_prev, f_new]
            bracket_g, bracket_gmax, bracket_gtd = [g_prev, g_new], [gmax_prev, gmax_new], [gtd_prev, gtd_new]
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        tmp = t
        t = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f_new, gtd_new, bounds=(min_step, max_step))
        t_prev, f_prev, g_prev, gmax_prev, gtd_prev = tmp, f_new, g_new, gmax_new, gtd_new
        f_new, g_new, gtd_new, gmax_new = obj_func(x, t, d)
        ls_func_evals += 1
        ls_iter += 1
    if ls_iter == max_ls:
        bracket, bracket_f, bracket_g, bracket_gmax = [0, t], [f, f_new], [g, g_new], [gmax, gmax_new]

    insuf_progress = False
    low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[-1] else (1, 0)
    while not done and ls_iter < max_ls:
        if abs(bracket[1] - bracket[0]) * d_norm < tolerance_change:
            break
        t = _cubic_interpolate(bracket[0], bracket_f[0], bracket_gtd[0], bracket[1], bracket_f[1], bracket_gtd[1])
        eps = 0.1 * (max(bracket) - min(bracket))
        if min(max(bracket) - t, t - min(bracket)) < eps:
            if insuf_progress or t >= max(bracket) or t <= min(bracket):
                t = max(bracket) - eps if abs(t - max(bracket)) < abs(t - min(bracket)) else min(bracket) + eps
                insuf_progress = False
            else:
                insuf_progress = True
        else:
            insuf_progress = False
        f_new, g_new, gtd_new, gmax_new = obj_func(x, t, d)
        ls_func_evals += 1
        ls_iter += 1
        if f_new > (f + c1 * t * gtd) or f_new >= bracket_f[low_pos]:
            bracket[high_pos], bracket_f[high_pos], bracket_g[high_pos] = t, f_new, g_new
            bracket_gmax[high_pos], bracket_gtd[high_pos] = gmax_new, gtd_new
            low_pos, high_pos = (0, 1) if bracket_f[0] <= bracket_f[1] else (1, 0)
        else:
            if abs(gtd_new) <= -c2 * gtd:
                done = True
            elif gtd_new * (bracket[high_pos] - bracket[low_pos]) >= 0:
                bracket[high_pos], bracket_f[high_pos], bracket_g[high_pos] = (
                    bracket[low_pos], bracket_f[low_pos], bracket_g[low_pos])
                bracket_gmax[high_pos], bracket_gtd[high_pos] = bracket_gmax[low_pos], bracket_gtd[low_pos]
            bracket[low_pos], bracket_f[low_pos], bracket_g[low_pos] = t, f_new, g_new
            bracket_gmax[low_pos], bracket_gtd[low_pos] = gmax_new, gtd_new
    return bracket_f[low_pos], bracket_g[low_pos], bracket_gmax[low_pos], bracket[low_pos], ls_func_evals


def _two_loop(sy, yy, sg, yg, ro, h_diag, al):
    """The L-BFGS two-loop recursion on the Gram scalars (``sy[i, j] =
    s_i.y_j``, ``yy[i, j] = y_i.y_j``, ``sg[i] = s_i.g``, ``yg[i] = y_i.g``):
    the coefficients ``(c_g, c_y, c_s)`` of the direction ``c_g g + sum_i
    c_y[i] y_i + c_s[i] s_i``, with ``al`` (the first loop's alphas) filled
    in, as ``torch.optim.LBFGS`` computes it on the vectors."""
    k = len(ro)
    c_y = np.zeros(k)  # q = -g + sum_j c_y[j] y_j
    for i in range(k - 1, -1, -1):
        al[i] = float((-sg[i] + sy[i] @ c_y) * ro[i])
        c_y[i] -= al[i]
    c_g, c_y, c_s = -h_diag, h_diag * c_y, np.zeros(k)  # r = H_diag q
    for i in range(k):
        be_i = (c_g * yg[i] + yy[i] @ c_y + sy[:, i] @ c_s) * ro[i]
        c_s[i] += al[i] - be_i
    return c_g, c_y, c_s


class LBFGS(_OnModelAxis, torch.optim.LBFGS):
    """``torch.optim.LBFGS`` on this rank's blocks (module docstring). The
    state keeps ``torch.optim.LBFGS``'s keys, its vectors this rank's flat
    vector over its blocks and replicated leaves, but for the history:
    ``'stps'`` and ``'dirs'``, ``(history_size, n)`` buffers made with the
    first pair and written in turn (``'order'``: their rows from the oldest
    pair to the newest), so that no step copies the history; and ``'gram'``,
    the history's ``S.Y`` and ``Y.Y`` (float64, on the host, oldest first)."""

    plain = torch.optim.LBFGS

    def _attach(self, split, blocks):
        super()._attach(split, blocks)
        self._numel_cache = None
        first = float(split.rank == 0)
        # the weight of each element in a global dot product: a replicated leaf counts once, on model rank 0
        self._weight = torch.cat([torch.full((p.numel(),), 1.0 if p in blocks else first, dtype=p.dtype,
                                             device=p.device) for p in self._params])
        self._cuts = [_cut(blocks[p]) if p in blocks else None for p in self._params]

    def _host(self, flat):
        return self._reduce(flat).double().cpu().numpy()

    def _evaluated(self, g, d=None, l1=False):
        """One ``all_reduce`` after a closure call: ``(g.d or None, max |g|,
        sum |g| or None)``, global."""
        parts = ([torch.dot(g * self._weight, d)] if d is not None else []) + \
                ([torch.dot(g.abs(), self._weight)] if l1 else [])
        slots = self._slots([g.abs().max()]).reshape(-1)
        out = self._host(torch.cat([torch.stack(parts), slots]) if parts else slots)
        gtd = out[0] if d is not None else None
        return gtd, out[len(parts):].max(), out[len(parts) - 1] if l1 else None

    def _direction(self, g, d):
        """One ``all_reduce``: ``(g.d, max |d|)``, global."""
        out = self._host(torch.cat([torch.dot(g * self._weight, d)[None], self._slots([d.abs().max()]).reshape(-1)]))
        return out[0], out[1:].max()

    def _ring(self, state):
        """``state``'s history as buffers: a state in ``torch.optim.LBFGS``'s
        form (a loaded file: the lists ``old_stps`` and ``old_dirs``) is
        moved into them. No collective."""
        if 'old_dirs' not in state:
            state.setdefault('order', [])
            return
        old_stps, old_dirs = state.pop('old_stps'), state.pop('old_dirs')
        state['order'] = list(range(len(old_dirs)))
        state.pop('gram', None)
        if old_dirs:
            S, Y = self._buffers(state, old_dirs[0], len(old_dirs))
            for i, (s, y) in enumerate(zip(old_stps, old_dirs)):
                S[i].copy_(s)
                Y[i].copy_(y)

    def _buffers(self, state, like, rows=0):
        """``state``'s ``(stps, dirs)`` buffers, made where there are none yet:
        ``history_size`` rows (``rows`` if more) shaped as ``like``."""
        if 'stps' not in state:
            rows = max(rows, self.param_groups[0]['history_size'])
            state['stps'], state['dirs'] = like.new_empty(rows, like.numel()), like.new_empty(rows, like.numel())
        return state['stps'], state['dirs']

    def _pairs(self, state, s, y, g):
        """One ``all_reduce``: the dot products of each pair of the history,
        oldest first (``S`` then ``Y``), and of ``s`` and ``y``, with ``s``,
        ``y`` and ``g``: a ``(2k + 2, 3)`` float64 array. Products of the
        buffers' rows, with no copy of them."""
        order, k = state['order'], len(state['order'])
        w = torch.stack([s, y, g]).mul_(self._weight)
        parts = [w @ s, w @ y]
        if k:
            parts = [state['stps'][:k] @ w.T, state['dirs'][:k] @ w.T] + parts
        out = self._host(torch.cat([p.reshape(-1) for p in parts])).reshape(-1, 3)
        return np.concatenate([out[:k][order], out[k:2 * k][order], out[2 * k:]]) if k else out

    def _gram(self, state):
        """The history's ``(S.Y, Y.Y)`` from ``state``, computed (one
        ``all_reduce``) where the state came without them (a loaded file)."""
        self._ring(state)
        order = state['order']
        gram = state.get('gram')
        if gram is None or gram.shape[-1] != len(order):
            if order:  # [., i, j]: the buffers' rows i and j, reordered oldest first
                k = len(order)
                S, Y = state['stps'][:k], state['dirs'][:k]
                by_row = self._host(torch.stack([torch.stack([S @ (y * self._weight), Y @ (y * self._weight)])
                                                 for y in Y], dim=-1))
                gram = torch.from_numpy(np.ascontiguousarray(by_row[:, order][:, :, order]))
            else:
                gram = torch.zeros(2, 0, 0, dtype=torch.float64)
            state['gram'] = gram
        return gram[0].numpy().copy(), gram[1].numpy().copy()

    @torch.no_grad()
    def step(self, closure):
        """One ``torch.optim.LBFGS.step`` (its control flow line by line),
        every reduction over the model group."""
        closure = torch.enable_grad()(closure)
        group = self.param_groups[0]
        lr = _scalar(group['lr'])
        max_iter, max_eval = group['max_iter'], group['max_eval']
        tolerance_grad, tolerance_change = group['tolerance_grad'], group['tolerance_change']
        line_search_fn, history_size = group['line_search_fn'], group['history_size']
        state = self.state[self._params[0]]
        state.setdefault('func_evals', 0)
        state.setdefault('n_iter', 0)
        sy, yy = self._gram(state)

        orig_loss = closure()
        loss = float(orig_loss)
        current_evals = 1
        state['func_evals'] += 1
        flat_grad = self._gather_flat_grad()
        _, gmax, l1 = self._evaluated(flat_grad, l1=state['n_iter'] == 0)
        opt_cond = gmax <= tolerance_grad
        if opt_cond:
            return orig_loss

        d, t = state.get('d'), state.get('t')
        order = state['order']
        ro = [float(r) for r in state.get('ro') or []]
        H_diag = float(state.get('H_diag', 1))
        prev_flat_grad, prev_loss = state.get('prev_flat_grad'), state.get('prev_loss')

        n_iter = 0
        while n_iter < max_iter:
            n_iter += 1
            state['n_iter'] += 1
            if state['n_iter'] == 1:
                d = flat_grad.neg()
                order[:], ro, H_diag = [], [], 1.0
                sy = yy = np.zeros((0, 0))
            else:
                y = flat_grad.sub(prev_flat_grad)
                s = d.mul(t)
                k = len(order)
                dots = self._pairs(state, s, y, flat_grad)
                sg, yg = dots[:k, 2], dots[k:2 * k, 2]
                ys = dots[2 * k, 1]
                if ys > 1e-10:
                    grow = np.zeros((2, k + 1, k + 1))
                    grow[0, :k, :k], grow[1, :k, :k] = sy, yy
                    grow[0, k, :k], grow[0, :k, k], grow[0, k, k] = dots[k:2 * k, 0], dots[:k, 1], ys
                    grow[1, k, :k] = grow[1, :k, k] = dots[k:2 * k, 1]
                    grow[1, k, k] = dots[2 * k + 1, 1]
                    sg, yg = np.append(sg, dots[2 * k, 2]), np.append(yg, dots[2 * k + 1, 2])
                    S, Y = self._buffers(state, s)
                    full = k == len(S)  # torch.optim.LBFGS appends, then drops the oldest past history_size
                    row = order.pop(0) if full else k
                    order.append(row)
                    S[row].copy_(s)
                    Y[row].copy_(y)
                    ro.append(float(1.0 / ys))
                    if full:
                        ro.pop(0)
                        grow, sg, yg = grow[:, 1:, 1:], sg[1:], yg[1:]
                    sy, yy = grow[0], grow[1]
                    H_diag = float(ys / dots[2 * k + 1, 1])
                if 'al' not in state:
                    state['al'] = [None] * history_size
                c_g, c_y, c_s = _two_loop(sy, yy, sg, yg, ro, H_diag, state['al'])
                d = flat_grad.mul(c_g)
                if order:  # d += S^T c_s + Y^T c_y over the buffers' rows, in their order
                    k, S, Y = len(order), state['stps'], state['dirs']
                    by_row = np.zeros((2, k))
                    by_row[0, order], by_row[1, order] = c_s, c_y
                    by_row = torch.as_tensor(by_row, dtype=d.dtype, device=d.device)
                    d.addmv_(S[:k].T, by_row[0]).addmv_(Y[:k].T, by_row[1])

            if prev_flat_grad is None:
                prev_flat_grad = flat_grad.clone(memory_format=torch.contiguous_format)
            else:
                prev_flat_grad.copy_(flat_grad)
            prev_loss = loss

            t = float(min(1.0, 1.0 / l1) * lr) if state['n_iter'] == 1 else lr
            gtd, d_norm = self._direction(flat_grad, d)
            if gtd > -tolerance_change:
                break

            ls_func_evals = 0
            if line_search_fn is not None:
                if line_search_fn != 'strong_wolfe':
                    raise RuntimeError("only 'strong_wolfe' is supported")
                x_init = self._clone_param()
                loss, flat_grad, gmax, t, ls_func_evals = _strong_wolfe(
                    lambda x, t, d: self._directional_evaluate(closure, x, t, d), x_init, t, d, loss, flat_grad,
                    gmax, gtd, d_norm, max_ls=max_eval - current_evals)
                t = float(t)
                self._add_grad(t, d)
                opt_cond = gmax <= tolerance_grad
            else:
                self._add_grad(t, d)
                if n_iter != max_iter:
                    with torch.enable_grad():
                        loss = float(closure())
                    flat_grad = self._gather_flat_grad()
                    _, gmax, _ = self._evaluated(flat_grad)
                    opt_cond = gmax <= tolerance_grad
                    ls_func_evals = 1

            current_evals += ls_func_evals
            state['func_evals'] += ls_func_evals
            if n_iter == max_iter:
                break
            if current_evals >= max_eval:
                break
            if opt_cond:
                break
            if d_norm * abs(t) <= tolerance_change:  # max |d t|
                break
            if abs(loss - prev_loss) < tolerance_change:
                break

        state.update(d=d, t=t, ro=ro, H_diag=H_diag, prev_flat_grad=prev_flat_grad, prev_loss=prev_loss,
                     gram=torch.from_numpy(np.stack([sy, yy]).reshape(2, len(ro), len(ro))))
        return orig_loss

    def _directional_evaluate(self, closure, x, t, d):
        self._add_grad(t, d)
        loss = float(closure())
        flat_grad = self._gather_flat_grad()
        gtd, gmax, _ = self._evaluated(flat_grad, d)
        self._set_param(x)
        return loss, flat_grad, gtd, gmax

    def _full_flat(self, vectors):
        """This rank's flat vectors at full size, in ``torch.optim.LBFGS``'s
        order (each leaf whole, flattened, in the parameters' order), in one
        ``all_reduce``: a replicated leaf is written by model rank 0 alone."""
        first = self._split.rank == 0
        sizes = [p.numel() for p in self._params]
        items = []
        for v in vectors:
            for p, piece, c in zip(self._params, torch.split(v, sizes), self._cuts):
                if c is not None:
                    items.append((piece.view(p.shape), c))
                else:
                    items.append((piece if first else torch.zeros_like(piece), Cut(0, 0, p.numel(), (p.numel(),))))
        fulls, n = _gather(items, self._split.group), len(sizes)
        return [torch.cat([f.reshape(-1) for f in fulls[i * n:(i + 1) * n]]) for i in range(len(vectors))]

    @torch.no_grad()
    def full_state_dict(self):
        """``state_dict()`` at full size in ``torch.optim.LBFGS``'s form: the
        history as the lists ``old_stps`` and ``old_dirs``, oldest first. Every
        rank of the model group calls it alike."""
        if self._params[0] in self.state:
            self._ring(self.state[self._params[0]])
        sd = self.state_dict()
        if 0 not in sd['state']:
            return sd
        st = sd['state'][0]
        state = {k: v for k, v in st.items() if k not in ('gram', 'order', 'stps', 'dirs')}
        if 'd' in state:
            order, k = st['order'], len(st['order'])
            history = [st['dirs'][i] for i in order] + [st['stps'][i] for i in order]
            full = self._full_flat([st['d'], st['prev_flat_grad']] + history)
            state.update(d=full[0], prev_flat_grad=full[1], old_dirs=full[2:2 + k], old_stps=full[2 + k:])
        return {**sd, 'state': {**sd['state'], 0: state}}


# ---------------------------------------------------------------- Adafactor
class Adafactor(_OnModelAxis, torch.optim.Adafactor):
    """``torch.optim.Adafactor`` on this rank's blocks (module docstring):
    its single-tensor step, the norms and the factors' means global."""

    plain = torch.optim.Adafactor

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work, parts = [], []
        for group in self.param_groups:
            lr, eps1 = _scalar(group['lr']), group['eps'][0]
            for p in group['params']:
                if p.grad is None:
                    continue
                if torch.is_complex(p):
                    raise RuntimeError("Adafactor does not support complex parameters")
                if p.grad.is_sparse:
                    raise RuntimeError("Adafactor does not support sparse gradients")
                grad = -p.grad if group['maximize'] else p.grad
                state = self.state[p]
                if len(state) == 0:
                    state['step'] = torch.tensor(0.0, dtype=torch.float64 if torch.get_default_dtype() == torch.float64
                                                 else torch.float32)
                    if grad.dim() > 1:
                        state['row_var'] = grad.new_zeros(grad.shape[:-1] + (1,))
                        state['col_var'] = grad.new_zeros(grad.shape[:-2] + (1,) + grad.shape[-1:])
                    else:
                        state['variance'] = torch.zeros_like(grad, memory_format=torch.preserve_format)
                if eps1 is None:
                    eps1 = torch.finfo(p.dtype).eps
                state['step'] += 1
                step = state['step'].item()
                one_minus_beta2 = step ** group['beta2_decay']
                rho = min(lr, 1 / step ** 0.5)
                spec = self._blocks.get(p)
                w = dict(group=group, p=p, grad=grad, state=state, spec=spec, eps1=eps1, b=one_minus_beta2, rho=rho)
                if grad.dim() > 1:
                    if spec is None or spec.dim != grad.dim() - 1:  # the rows are this rank's: each row's mean is
                        state['row_var'].lerp_(torch.norm(grad, dim=-1, keepdim=True).square_().div_(grad.size(-1)),
                                               one_minus_beta2)
                    if spec is None or spec.dim != grad.dim() - 2:
                        state['col_var'].lerp_(torch.norm(grad, dim=-2, keepdim=True).square_().div_(grad.size(-2)),
                                               one_minus_beta2)
                if spec is not None:  # this rank's parts of the leaf's global sums
                    w['at'] = len(parts)
                    parts.append(p.square().sum()[None])
                    if grad.dim() > 1 and spec.dim == grad.dim() - 1:  # the rows are split over the columns
                        parts.append(grad.square().sum(dim=-1, keepdim=True))
                    elif grad.dim() > 1:  # the columns over the rows; and the row factor's block
                        parts.append(grad.square().sum(dim=-2, keepdim=True))
                        parts.append(state['row_var'].sum(dim=-2, keepdim=True))
                work.append(w)
        sums = self._sum(parts) if parts else []
        updates = []
        for w in work:
            p, grad, state, spec, eps1 = w['p'], w['grad'], w['state'], w['spec'], w['eps1']
            if spec is None:
                norm, numel = p.norm(2).item(), p.numel()
            else:
                norm, numel = sums[w['at']].sqrt().item(), math.prod(spec.shape)
            w['alpha'] = max(w['group']['eps'][1], norm / numel ** 0.5) * w['rho']
            if w['group']['weight_decay'] != 0:
                p.mul_(1 - _scalar(w['group']['lr']) * w['group']['weight_decay'])
            if grad.dim() > 1:
                row_var, col_var = state['row_var'], state['col_var']
                if spec is not None and spec.dim == grad.dim() - 1:
                    row_var.lerp_(sums[w['at'] + 1].div(spec.shape[-1]), w['b'])
                    row_mean = row_var.mean(dim=-2, keepdim=True)
                elif spec is not None:
                    col_var.lerp_(sums[w['at'] + 1].div(spec.shape[-2]), w['b'])
                    row_mean = sums[w['at'] + 2].div(spec.shape[-2])
                else:
                    row_mean = row_var.mean(dim=-2, keepdim=True)
                var_estimate = row_var @ col_var
                var_estimate.div_(row_mean.clamp_(min=eps1))
            else:
                state['variance'].lerp_(grad * grad, w['b'])
                var_estimate = state['variance'].clone()
            update = var_estimate.clamp_(min=eps1 * eps1).rsqrt_()
            update.mul_(grad)
            w['update'], w['numel'] = update, numel
            if spec is not None:
                updates.append(update.square().sum()[None])
        update_sums = iter(self._sum(updates) if updates else [])
        for w in work:
            update = w['update']
            norm = update.norm(2).item() if w['spec'] is None else next(update_sums).sqrt().item()
            denom = max(1.0, norm / ((w['numel'] ** 0.5) * w['group']['d']))
            w['p'].add_(update, alpha=-w['alpha'] / denom)
        return loss


# --------------------------------------------------------------------- Muon
class Muon(_OnModelAxis, torch.optim.Muon):
    """``torch.optim.Muon`` on this rank's blocks (module docstring): the
    momentum stays a block, the update is orthogonalized at full size."""

    plain = torch.optim.Muon

    @torch.no_grad()
    def step(self, closure=None):
        from torch.optim._muon import _adjust_lr, _zeropower_via_newtonschulz

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        work = []
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                if torch.is_complex(p):
                    raise RuntimeError("Muon does not support complex parameters")
                if p.grad.is_sparse:
                    raise RuntimeError("Muon does not support sparse gradients")
                grad = p.grad
                if grad.ndim != 2:
                    raise ValueError("Param gradient must be a 2D matrix")
                state = self.state[p]
                if 'momentum_buffer' not in state:
                    state['momentum_buffer'] = torch.zeros_like(grad, memory_format=torch.preserve_format)
                buf = state['momentum_buffer']
                buf.lerp_(grad, 1 - group['momentum'])
                update = grad.lerp(buf, group['momentum']) if group['nesterov'] else buf
                work.append((group, p, update))
        cuts = [_cut(self._blocks[p]) if p in self._blocks else None for _, p, _ in work]
        fulls = _gather([(update, c) for (_, _, update), c in zip(work, cuts)], self._split.group)
        for (group, p, _), full, c in zip(work, fulls, cuts):
            ortho = _zeropower_via_newtonschulz(full, group['ns_coefficients'], group['ns_steps'], group['eps'])
            if c is not None:
                ortho = ortho.narrow(c.dim, c.lo, c.hi - c.lo)
            lr = _scalar(group['lr'])
            p.mul_(1 - lr * group['weight_decay'])
            p.add_(ortho, alpha=-_adjust_lr(lr, group['adjust_lr_fn'], full.shape))
        return loss


# -------------------------------------------------------- conversion, state
_KINDS = {torch.optim.LBFGS: LBFGS, torch.optim.Adafactor: Adafactor, torch.optim.Muon: Muon}


def on_model_axis(optimizer, nets, split, closure_style):
    """``optimizer`` made to step on this rank's blocks of ``nets``' split
    leaves (``split``: the rank's :class:`ModelSplit`): a
    ``torch.optim.LBFGS``, ``Adafactor`` or ``Muon`` becomes this module's
    class of it (the same object, its state kept); an elementwise optimizer
    is returned as it is. Another optimizer that reads across its
    parameters, a closure-style one (``closure_style``) or a subclass of the
    three, would step on each rank from its blocks alone, and raises a
    ``ValueError``."""
    cls = type(optimizer) if isinstance(optimizer, _OnModelAxis) else _KINDS.get(type(optimizer))
    if cls is None:
        if closure_style or isinstance(optimizer, tuple(_KINDS)):
            raise ValueError(f"{type(optimizer).__name__} reads across its parameters, and on a 'model' mesh axis "
                             f"each rank holds only its blocks of the split leaves: there the solvers step "
                             f"torch.optim.LBFGS, Adafactor and Muon on the blocks, and elementwise optimizers as "
                             f"they are")
        return optimizer
    optimizer.__class__ = cls
    optimizer._patch_step_function()  # what Optimizer.__init__ does for a class: its step runs the step hooks
    if getattr(optimizer.__dict__.get('step'), '_wrapped_by_lr_sched', False):
        # a learning-rate scheduler made before wrapped the plain class's step on the instance: wrap this one's
        opt_ref = weakref.ref(optimizer)

        def step(*args, **kwargs):
            opt = opt_ref()
            opt._opt_called = True
            return cls.step(opt, *args, **kwargs)

        step._wrapped_by_lr_sched = True
        optimizer.step = step
    optimizer._attach(split, stored_blocks(nets))
    return optimizer


def plain_class(optimizer):
    """The ``torch.optim`` class whose state ``optimizer`` keeps: its own, or
    the one a class of this module steps as."""
    return optimizer.plain if isinstance(optimizer, _OnModelAxis) else type(optimizer)


def _factor_cut(key, v, spec):
    """The Cut of state tensor ``v`` (under ``key``) of a split leaf whose
    block is ``spec``, or None where ``v`` is whole on every rank: a moment
    is cut as the leaf; Adafactor's factor along the split dimension is cut
    and the one reduced over it is whole."""
    full = list(spec.shape)
    if key in ('row_var', 'col_var'):
        reduced = len(full) - (1 if key == 'row_var' else 2)
        if reduced == spec.dim:
            return None
        full[reduced] = 1
        return Cut(spec.dim, spec.lo, spec.hi, tuple(full))
    block = list(full)
    block[spec.dim] = spec.hi - spec.lo
    return Cut(spec.dim, spec.lo, spec.hi, tuple(full)) if list(v.shape) == block else None


@torch.no_grad()
def full_optimizer_state(opt, nets):
    """``opt.state_dict()`` with the state of each stored block of ``nets``
    at its full leaf's size: what it is without a model mesh. Every cut
    state tensor (:func:`_factor_cut`) is gathered in one ``all_reduce``;
    L-BFGS maps its flat vectors (:meth:`LBFGS.full_state_dict`). Every rank
    of the model group calls it alike."""
    if isinstance(opt, LBFGS):
        return opt.full_state_dict()
    blocks = stored_blocks(nets)
    sd = opt.state_dict()
    if not blocks:
        return sd
    params = [p for group in opt.param_groups for p in group['params']]
    items, where = [], []
    for i, st in sd['state'].items():
        spec = blocks.get(params[i])
        for key, v in st.items():
            if spec is not None and torch.is_tensor(v) and v.ndim and (c := _factor_cut(key, v, spec)) is not None:
                items.append((v, c))
                where.append((i, key))
    state = {i: dict(st) for i, st in sd['state'].items()}
    for (i, key), full in zip(where, _gather(items, next(iter(blocks.values())).split.group)):
        state[i][key] = full
    return {**sd, 'state': state}


def placed_optimizer_state(sd, params, nets, optimizer_class):
    """The full-size ``optimizer_class`` state ``sd`` (``params[i]``: the
    parameter of its state ``i``, a stored block of ``nets`` or another)
    with this rank's part of each split leaf's state: a moment's block, the
    factor along the split dimension's block, and L-BFGS's flat vectors over
    the rank's blocks. No collective."""
    blocks = stored_blocks(nets)
    if not blocks:
        return sd
    if issubclass(optimizer_class, torch.optim.LBFGS):
        order = [params[i] for i in sd['param_groups'][0]['params']]
        full = [math.prod(blocks[p].shape) if p in blocks else p.numel() for p in order]

        def place(v):
            if isinstance(v, list):
                return [place(x) for x in v]
            if not torch.is_tensor(v) or v.ndim != 1 or v.numel() != sum(full):
                return v
            return torch.cat([piece if p not in blocks else blocks[p].right_inverse(piece.view(blocks[p].shape))
                              .reshape(-1) for p, piece in zip(order, torch.split(v, full))])

        return {**sd, 'state': {i: {k: place(v) for k, v in st.items()} for i, st in sd['state'].items()}}
    state = {}
    for i, st in sd['state'].items():
        spec = blocks.get(params[i])
        state[i] = st if spec is None else {k: _narrowed(v, spec) for k, v in st.items()}
    return {**sd, 'state': state}


def _narrowed(v, spec):
    """This rank's block of full-size state tensor ``v`` of a split leaf: cut
    along the split dimension where ``v`` spans it (a moment, a factor
    along it), else ``v`` whole (a step count, a factor reduced over it)."""
    if not torch.is_tensor(v) or v.ndim != len(spec.shape) or v.shape[spec.dim] != spec.shape[spec.dim]:
        return v
    return v.narrow(spec.dim, spec.lo, spec.hi - spec.lo).clone(memory_format=torch.contiguous_format)
