r"""Batched Taylor-mode series propagation for Fields, orders <= 2.

Counterpart of ``neurodiffeq_tpu/ops/taylor.py``. A :class:`TSeries` holds,
for one batch of N collocation points:

- ``c0``: the value, shape ``(N, m)``;
- ``derivs[k-1]``: the k-th directional derivatives along the context's D
  probe directions, stacked into one ``(D, N|1, m)`` tensor.

Only the stacked layout exists here. Coordinate tangents are constant across
the batch and stay so through every affine layer, so the first-order tangent
of a width-H hidden layer is a ``(D, 1, H)`` tensor (the rows of W1), and
batch-shaped tangents appear only where a nonlinearity mixes in
batch-dependent values.

Rules: coordinates and constants have closed-form series; affine layers map
coefficients exactly; elementwise ops use closed-form chain rules (first
and second partials computed once on ``(N, m)`` data and broadcast over
directions; ``atan2`` has its binary rule), and a path ``torch.func.jvp``
for ops without one.

The main context's directions are the coordinate axes. A genuinely mixed
partial such as u_xy is recovered by polarization: an auxiliary context
probes synthetic directions over the partial's axes (for u_xy the one
direction (x + y) / sqrt 2) and :func:`partial_entry` solves the directional
derivatives for the mixed entry, subtracting the pure ones
(:func:`_extraction_plan`). Mixed partials of total order 2 work, so the
div-grad and curl identities and the H1 losses of first-order residuals
over several coordinates stay batched. Orders above 2 raise, naming
``ROADMAP.md`` §1 item 16.
The expression DAG is memoized per :class:`TContext`, so the network forward
pass is computed once for u, u_x, u_xx, u_y and u_yy.
"""
import math
import operator

import numpy as np
import torch

__all__ = ['TSeries', 'TContext', 'teval', 'elementwise_series', 'constant_series',
           'coordinate_series', 'affine_series', 'lifted_series', 'concat_series',
           'slice_series', 'sum_series', 'add_series', 'derivative_series', 'partial_entry']

_HIGH_ORDER = ("Taylor orders above 2 are not ported yet "
               "(ROADMAP.md §1 item 16, 'Taylor orders >= 3 without jet')")

class TSeries:
    __slots__ = ('c0', 'derivs', 'meta')

    def __init__(self, c0, derivs, meta=None):
        self.c0 = c0          # (N, m)
        self.derivs = derivs  # list over orders 1..K of (D, N|1, m)
        self.meta = meta      # 'raw_coords': c0 = points, tangents = I

    @property
    def order(self):
        return len(self.derivs)


class TContext:
    """Evaluation context for one collocation set; ``cache`` memoizes
    (field -> TSeries / value) by id.

    The main context's probe directions are the coordinate axes
    (``is_axes``). An auxiliary context (:meth:`aux_for`) probes synthetic
    directions over a subset ``axes`` of the coordinates, from which
    :func:`partial_entry` recovers mixed partials by polarization; it has a
    cache of its own, and ``base`` points every context and view at the
    main context, on whose cache the auxiliary contexts and the extracted
    partials memoize. ``root`` is the context at its own full order, which
    its :meth:`at_order` views share."""

    def __init__(self, points, order):
        if order > 2:
            raise NotImplementedError(_HIGH_ORDER)
        self.points = points
        self.order = order
        d = points.shape[1]
        self.directions = _directions(np.eye(d), points)  # (D = d, d)
        self.n_dirs = d
        # (id, kind) -> (field, payload); the field reference keeps ids stable
        self.cache = {}
        self.base = self
        self.root = self
        self.is_axes = True
        self.axes = None       # aux only: the coordinate indices the directions span
        self.dirs_sub = None   # aux only: the (J, len(axes)) numpy direction matrix

    def memo(self, field, kind, compute):
        key = (id(field), kind)
        hit = self.cache.get(key)
        if hit is not None:
            return hit[1]
        out = compute()
        self.cache[key] = (field, out)
        return out

    def at_order(self, order):
        """A view of this context at another series order, sharing its
        directions and cache."""
        if order == self.order:
            return self
        if order > 2:
            raise NotImplementedError(_HIGH_ORDER)
        view = object.__new__(TContext)
        view.__dict__.update(self.__dict__)
        view.order = order
        return view

    def aux_for(self, axes, order):
        """The auxiliary polarization context for mixed partials over
        ``axes`` at total ``order``: its directions are the extraction
        plan's, embedded into the full coordinate space. Memoized on the
        base context, so that every extraction over the same (axes, order)
        shares one series evaluation of each field."""
        base = self.base
        key = ('auxctx', axes, order)
        hit = base.cache.get(key)
        if hit is not None:
            return hit[1]
        dirs = _extraction_plan(len(axes), order)[2]
        full = np.zeros((dirs.shape[0], base.points.shape[1]))
        full[:, list(axes)] = dirs
        ctx = object.__new__(TContext)
        ctx.points = base.points
        ctx.order = order
        ctx.directions = _directions(full, base.points)
        ctx.n_dirs = dirs.shape[0]
        ctx.cache = {}
        ctx.base = base
        ctx.root = ctx
        ctx.is_axes = False
        ctx.axes = axes
        ctx.dirs_sub = dirs
        base.cache[key] = (None, ctx)
        return ctx

    def zeros(self):
        """A ``(D, 1, 1)`` zero derivative entry on the context's device."""
        p = self.points
        return torch.zeros((self.n_dirs, 1, 1), dtype=p.dtype, device=p.device)


_DIRECTIONS = {}  # (matrix bytes, shape, dtype, device) -> tensor


def _directions(matrix, points):
    """The direction matrix as a tensor of the points' dtype on their device,
    made once per matrix, dtype and device (it is never written to)."""
    key = (matrix.tobytes(), matrix.shape, points.dtype, points.device)
    out = _DIRECTIONS.get(key)
    if out is None:
        out = _DIRECTIONS[key] = torch.tensor(matrix, dtype=points.dtype, device=points.device)
    return out


def teval(field, ctx, order=None):
    """Memoized Taylor evaluation of a Field under a context.

    The cache keeps the deepest series computed so far per field; shallower
    requests are served from it, deeper ones re-evaluate and replace it.
    """
    want = ctx.order if order is None else order
    key = (id(field), 's')
    hit = ctx.cache.get(key)
    if hit is not None and hit[1].order >= want:
        return hit[1]
    out = field.trule(ctx.at_order(want))
    ctx.cache[key] = (field, out)
    return out


def _compositions(n, m):
    """All m-tuples of nonnegative ints summing to n, in lexicographic order."""
    if m == 1:
        return [(n,)]
    out = []
    for first in range(n + 1):
        for rest in _compositions(n - first, m - 1):
            out.append((first,) + rest)
    return out


def _multinomial(n, beta):
    c = math.factorial(n)
    for b in beta:
        c //= math.factorial(b)
    return c


_EXTRACTION_PLANS = {}


def _extraction_plan(m, n):
    r"""Static polarization plan for the full-support mixed partials of total
    order ``n`` over ``m`` coordinate axes (every axis order >= 1).

    The n-th directional derivative along :math:`v` expands as
    :math:`D^n_v u = \sum_{|\beta|=n} \binom{n}{\beta} v^\beta \partial^\beta u`.
    Partials whose support misses an axis are cheaper problems (pure ones
    read off the axis-aligned series; smaller-support mixed ones recurse),
    so the plan solves only for the :math:`J = \binom{n-1}{m-1}`
    full-support unknowns, subtracting the known terms from each directional
    derivative first. u_xy needs one synthetic direction:
    :math:`u_{xy} = D^2_{(x+y)/\sqrt2}u - (u_{xx}+u_{yy})/2`.

    Returns ``(betas_full, betas_partial, dirs, Minv, Mpartial)``:

    - ``betas_full``: the J solved multi-indices (each a tuple of m orders);
    - ``betas_partial``: multi-indices of order n with at least one zero axis
      (their values are supplied by the caller, recursively);
    - ``dirs``: (J, m) float64 directions: half-circle angles avoiding the
      axes for m = 2, seeded rank-checked unit vectors for m >= 3 (drawn from
      ``np.random.RandomState(seed)`` as the JAX package draws them, so the
      two packages' plans are equal bit for bit);
    - ``Minv``: (J, J) inverse of the full-support coefficient matrix;
    - ``Mpartial``: (J, len(betas_partial)) coefficients of the known terms.
    """
    key = (m, n)
    hit = _EXTRACTION_PLANS.get(key)
    if hit is not None:
        return hit
    all_betas = _compositions(n, m)
    betas_full = [b for b in all_betas if all(x >= 1 for x in b)]
    betas_partial = [b for b in all_betas if not all(x >= 1 for x in b)]
    J = len(betas_full)
    if m == 1:
        dirs = np.ones((1, 1))
    elif m == 2:
        thetas = np.pi * (np.arange(J) + 1.0) / (2 * (J + 1))
        dirs = np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    else:
        for seed in range(64):
            rng = np.random.RandomState(seed)
            dirs = rng.normal(size=(J, m))
            dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
            if np.linalg.cond(_plan_matrix(dirs, betas_full, n)) < 1e7:
                break
        else:  # pragma: no cover - 64 seeds are never all ill-conditioned
            raise RuntimeError(f"no well-conditioned direction set for m={m}, n={n}")
    Minv = np.linalg.inv(_plan_matrix(dirs, betas_full, n))
    Mpartial = _plan_matrix(dirs, betas_partial, n)
    plan = (betas_full, betas_partial, dirs, Minv, Mpartial)
    _EXTRACTION_PLANS[key] = plan
    return plan


def _plan_matrix(dirs, betas, n):
    M = np.empty((len(dirs), len(betas)))
    for j, v in enumerate(dirs):
        for b, beta in enumerate(betas):
            M[j, b] = _multinomial(n, beta) * np.prod(v ** np.asarray(beta))
    return M


def _merge_alpha(alpha, axis, order):
    """Add ``order`` derivatives along ``axis`` to a multi-index (tuple of
    (axis, order) pairs sorted by axis)."""
    d = dict(alpha)
    d[axis] = d.get(axis, 0) + order
    return tuple(sorted(d.items()))


def partial_entry(field, alpha, ctx):
    r"""The (possibly mixed) partial :math:`\partial^\alpha` of a
    Taylor-capable field, as a broadcast-shaped ``(N|1, m)`` tensor.

    ``alpha`` is a tuple of ``(axis, order)`` pairs (orders >= 1).
    Derivative fields fold into their parent first
    (:math:`\partial^\alpha \partial^p_a u = \partial^{\alpha + p e_a} u`),
    so chains of ``diff`` extract from the innermost trule-bearing field. A
    pure partial reads off the main context's axis-aligned series, always:
    a network's series there is computed once at the context's full order
    (and on the card by the fused kernel), where the JAX package would run
    the net again in a single-direction context when the main series is
    shallower. A mixed partial is solved from an auxiliary polarization
    context (:func:`_extraction_plan`). Total orders above 2 raise.
    Everything memoizes on the base context.
    """
    base = ctx.base
    while getattr(field, '_dinfo', None) is not None:
        parent, palpha = field._dinfo
        for ax, o in palpha:
            alpha = _merge_alpha(alpha, ax, o)
        field = parent
    key = ('pent', id(field), alpha)
    hit = base.cache.get(key)
    if hit is not None:
        return hit[1]
    n_total = sum(o for _, o in alpha)
    if n_total > 2:
        raise NotImplementedError(_HIGH_ORDER)
    if len(alpha) == 1:
        axis, order = alpha[0]
        out = teval(field, base, order=order).derivs[order - 1][axis]
    else:
        axes = tuple(ax for ax, _ in alpha)
        betas_full, betas_partial, _, Minv, Mpartial = _extraction_plan(len(axes), n_total)
        entries = teval(field, ctx.aux_for(axes, n_total), order=n_total).derivs[n_total - 1]
        # the known smaller-support terms: pure reads or recursive extractions
        known = [partial_entry(field, tuple((ax, b) for ax, b in zip(axes, beta) if b), ctx)
                 for beta in betas_partial]
        out = None
        for j, w in enumerate(Minv[betas_full.index(tuple(o for _, o in alpha))]):
            rhs = entries[j]
            for c, pv in zip(Mpartial[j], known):
                rhs = rhs - float(c) * pv
            term = float(w) * rhs
            out = term if out is None else out + term
    base.cache[key] = (field, out)
    return out


def derivative_series(parent, alpha, ctx):
    r"""Series of the derivative field :math:`\partial^\alpha u` (``alpha``:
    a tuple of ``(axis, order)`` pairs).

    For a single-axis derivative under an axis-aligned context, the entries
    along its own axis are read off the parent's series evaluated ``p``
    orders deeper (one shared network pass, which keeps patterns like
    ``diff(r^2 * u_r, r)`` batched). Every other entry is a mixed partial,
    recovered by :func:`partial_entry`. Under an auxiliary context (this
    derivative field is an operand of an expression being polarized), each
    directional derivative expands over the context's axes:
    :math:`D^k_v \partial^\alpha u = \sum_{|\beta|=k} \binom{k}{\beta}
    v^\beta \partial^{\alpha+\beta} u`.
    """
    K = ctx.order
    n = ctx.points.shape[0]

    if len(alpha) == 1 and ctx.is_axes:
        dir_index, p = alpha[0]
        ps = teval(parent, ctx, order=p + K)
        m = ps.c0.shape[1]
        c0 = ps.derivs[p - 1][dir_index].expand(n, m)
        derivs = []
        for k in range(1, K + 1):
            same = ps.derivs[p + k - 1][dir_index]
            derivs.append(_pack_dirs([same if d == dir_index
                                      else partial_entry(parent, _merge_alpha(alpha, d, k), ctx)
                                      for d in range(ctx.n_dirs)]))
        return TSeries(c0, derivs)

    c0 = partial_entry(parent, alpha, ctx)
    c0 = c0.expand(n, c0.shape[1])
    derivs = []
    if ctx.is_axes:
        for k in range(1, K + 1):
            derivs.append(_pack_dirs([partial_entry(parent, _merge_alpha(alpha, d, k), ctx)
                                      for d in range(ctx.n_dirs)]))
        return TSeries(c0, derivs)

    axes, dirs = ctx.axes, ctx.dirs_sub
    for k in range(1, K + 1):
        row = []
        for j in range(ctx.n_dirs):
            entry = None
            for beta in _compositions(k, len(axes)):
                coeff = _multinomial(k, beta) * float(np.prod(dirs[j] ** np.asarray(beta)))
                al = alpha
                for ax, b in zip(axes, beta):
                    if b:
                        al = _merge_alpha(al, ax, b)
                term = coeff * partial_entry(parent, al, ctx)
                entry = term if entry is None else entry + term
            row.append(entry)
        derivs.append(_pack_dirs(row))
    return TSeries(c0, derivs)


def _pack_dirs(row):
    """Stack per-direction ``(N|1, m)`` entries into one ``(D, N|1, m)``
    tensor, broadcasting them to a common row and column count."""
    rows = max(e.shape[0] for e in row)
    m = max(e.shape[1] for e in row)
    return torch.stack([e.expand(rows, m) for e in row])


def constant_series(value, ctx, n_samples):
    """Series of a per-sample-constant (or broadcast-constant) value."""
    p = ctx.points
    c0 = torch.as_tensor(value, dtype=p.dtype, device=p.device)
    if c0.ndim == 0:
        c0 = c0.reshape(1, 1)
    elif c0.ndim == 1:
        c0 = c0[None, :]
    c0 = c0.expand(n_samples, c0.shape[-1])
    return TSeries(c0, [ctx.zeros()] * ctx.order)


def coordinate_series(index, ctx):
    """Series of the index-th coordinate: value = points[:, i], first
    derivative = the directions' i-th components (constant across the
    batch), second = 0."""
    c0 = ctx.points[:, index:index + 1]
    d1 = ctx.directions[:, index][:, None, None]
    derivs = [d1] + [ctx.zeros()] * (ctx.order - 1)
    return TSeries(c0, derivs[:ctx.order])


def affine_series(ts, W, b=None):
    """Exact propagation through ``x @ W (+ b)``; preserves broadcast shapes.
    ``W`` is ``(n_in, n_out)``."""
    c0 = ts.c0 @ W
    if b is not None:
        c0 = c0 + b
    return TSeries(c0, [d @ W for d in ts.derivs])


def elementwise_series(op, operands, order):
    r"""Propagate series through an elementwise op.

    :param op: elementwise function of ``len(operands)`` tensors.
    :param operands: list of TSeries with broadcast-compatible shapes.
    :param order: series order K (0, 1 or 2).
    """
    c0_out = op(*[s.c0 for s in operands])
    if order == 0:
        return TSeries(c0_out, [])
    if order > 2:
        raise NotImplementedError(_HIGH_ORDER)
    return _elementwise_manual(op, operands, order, c0_out)


def _chain_unary(a, order, c0_out, f1, f2):
    """Assemble the unary chain rule from precomputed f'(x), f''(x)."""
    if order == 0:
        return TSeries(c0_out, [])
    a1 = a.derivs[0]
    derivs = [f1 * a1]
    if order == 2:
        a2 = a.derivs[1]
        derivs.append(f1 * a2 if f2 is None else f1 * a2 + f2 * a1 * a1)
    return TSeries(c0_out, derivs)


# closed-form (f', f'') for unary ops, reusing the forward value v where
# possible: one transcendental per op instead of a generic nested jvp
def _d_tanh(x, v):
    f1 = 1 - v * v
    return f1, -2 * v * f1


def _d_sigmoid(x, v):
    f1 = v * (1 - v)
    return f1, f1 * (1 - 2 * v)


def _d_sqrt(x, v):
    f1 = 0.5 / v
    return f1, -0.5 * f1 / x


def _d_log(x, v):
    inv = 1 / x
    return inv, -inv * inv


def _d_erf(x, v):
    f1 = (2 / math.sqrt(math.pi)) * torch.exp(-x * x)
    return f1, -2 * x * f1


def _d_tan(x, v):
    f1 = 1 + v * v
    return f1, 2 * v * f1


def _d_atan(x, v):
    f1 = 1 / (1 + x * x)
    return f1, -2 * x * f1 * f1


def _d_asin(x, v):
    f1 = torch.rsqrt(1 - x * x)
    return f1, x * f1 * f1 * f1


def _d_acos(x, v):
    f1 = -torch.rsqrt(1 - x * x)
    return f1, x * f1 * f1 * f1


_UNARY_RULES = {
    torch.tanh: _d_tanh,
    torch.exp: lambda x, v: (v, v),
    torch.sin: lambda x, v: (torch.cos(x), -v),
    torch.cos: lambda x, v: (-torch.sin(x), -v),
    torch.sinh: lambda x, v: (torch.cosh(x), v),
    torch.cosh: lambda x, v: (torch.sinh(x), v),
    torch.log: _d_log,
    torch.sqrt: _d_sqrt,
    torch.sigmoid: _d_sigmoid,
    torch.neg: lambda x, v: (-torch.ones_like(x), None),
    torch.abs: lambda x, v: (torch.sign(x), None),
    torch.erf: _d_erf,
    torch.tan: _d_tan,
    torch.atan: _d_atan,
    torch.asin: _d_asin,
    torch.acos: _d_acos,
}

# every op a Field may be lifted through with a Taylor rule
RULE_OPS = frozenset(_UNARY_RULES) | {
    operator.add, operator.sub, operator.mul, operator.truediv, operator.pow, torch.atan2}


def _elementwise_manual(op, operands, order, c0_out):
    """Chain rules for order <= 2: exact algebra for + - * /, closed forms
    for the unary ops, and a path jvp for anything else."""
    if len(operands) == 2:
        a, b = operands
        if op is operator.add or op is operator.sub:
            return TSeries(c0_out, [op(x, y) for x, y in zip(a.derivs, b.derivs)])
        if op is operator.mul:
            a0, b0 = a.c0, b.c0
            x1, y1 = a.derivs[0], b.derivs[0]
            derivs = [x1 * b0 + a0 * y1]
            if order == 2:
                x2, y2 = a.derivs[1], b.derivs[1]
                derivs.append(x2 * b0 + a0 * y2 + 2 * x1 * y1)
            return TSeries(c0_out, derivs)
        if op is operator.truediv:
            inv_b, q = 1 / b.c0, c0_out
            # q' = (a' - q b') / b ;  q'' = (a'' - q b'' - 2 q' b') / b
            q1 = (a.derivs[0] - q * b.derivs[0]) * inv_b
            derivs = [q1]
            if order == 2:
                derivs.append((a.derivs[1] - q * b.derivs[1] - 2 * q1 * b.derivs[0]) * inv_b)
            return TSeries(c0_out, derivs)
        if op is torch.atan2:  # atan2(y, x): d = (x dy - y dx) / (x^2 + y^2)
            y0, x0 = a.c0, b.c0
            inv = 1 / (x0 * x0 + y0 * y0)
            fy, fx = x0 * inv, -y0 * inv
            y1, x1 = a.derivs[0], b.derivs[0]
            derivs = [fy * y1 + fx * x1]
            if order == 2:
                # f_yy = -f_xx = -2xy / rho^2, f_xy = (y^2 - x^2) / rho^2
                fxx, fxy = 2 * x0 * y0 * inv * inv, (y0 * y0 - x0 * x0) * inv * inv
                derivs.append(fy * a.derivs[1] + fx * b.derivs[1]
                              + fxx * (x1 * x1 - y1 * y1) + 2 * fxy * x1 * y1)
            return TSeries(c0_out, derivs)

    if len(operands) == 1:
        rule = _UNARY_RULES.get(op)
        if rule is not None:
            f1, f2 = rule(operands[0].c0, c0_out)
            return _chain_unary(operands[0], order, c0_out, f1, f2)

    # generic rule: nest jvp through a scalar path parameter s with
    # args a(s) = a0 + a1 s + a2 s^2/2. The second s-derivative at 0 is the
    # second directional derivative including all cross terms.
    from torch.func import jvp
    zero = torch.zeros((), dtype=c0_out.dtype, device=c0_out.device)
    one = torch.ones_like(zero)
    n_dirs = operands[0].derivs[0].shape[0]
    d1_parts, d2_parts = [], []
    for d in range(n_dirs):
        def path(s, _d=d):
            args = []
            for sr in operands:
                a = sr.c0 + s * sr.derivs[0][_d]
                if order == 2:
                    a = a + (0.5 * s * s) * sr.derivs[1][_d]
                args.append(a)
            return op(*args)

        if order == 1:
            d1_parts.append(jvp(path, (zero,), (one,))[1])
        else:
            d1, d2 = jvp(lambda s, _p=path: jvp(_p, (s,), (one,))[1], (zero,), (one,))
            d1_parts.append(d1)
            d2_parts.append(d2)
    derivs = [torch.stack(d1_parts)]
    if order == 2:
        derivs.append(torch.stack(d2_parts))
    return TSeries(c0_out, derivs)


def lifted_series(op, arg_descs, ctx):
    """Series propagation for a lifted elementwise op with mixed arguments.

    :param op: the op (its identity selects the rule).
    :param arg_descs: list of ('series', TSeries) / ('const', value) in call order.
    :param ctx: the Taylor context.
    """
    order = ctx.order
    series_args = [d[1] for d in arg_descs if d[0] == 'series']
    if order == 0:
        vals = [d[1].c0 if d[0] == 'series' else d[1] for d in arg_descs]
        return TSeries(op(*vals), [])

    # constant-aware shortcuts: zero-derivative constants stay symbolic
    if len(arg_descs) == 2 and len(series_args) == 1:
        (k0, a0), (k1, a1) = arg_descs
        s = series_args[0]
        const_first = k0 == 'const'
        c = a0 if const_first else a1
        if op is operator.add:
            return TSeries(s.c0 + c, list(s.derivs))
        if op is operator.sub:
            if const_first:
                return TSeries(c - s.c0, [-d for d in s.derivs])
            return TSeries(s.c0 - c, list(s.derivs))
        if op is operator.mul:
            return TSeries(s.c0 * c, [d * c for d in s.derivs])
        if op is operator.truediv:
            if const_first:  # c / x: the unary 1/x, scaled
                c0 = c / s.c0
                inv = 1 / s.c0
                f1 = -c0 * inv
                return _chain_unary(s, order, c0, f1, -2 * f1 * inv)
            inv = 1 / c
            return TSeries(s.c0 * inv, [d * inv for d in s.derivs])
        if op is operator.pow:
            if not const_first:  # x ** p, p constant
                p = c
                f1 = p * s.c0 ** (p - 1)
                trivial = isinstance(p, (int, float)) and float(p) in (0.0, 1.0)
                f2 = None if trivial else (p * (p - 1)) * s.c0 ** (p - 2)
                return _chain_unary(s, order, s.c0 ** p, f1, f2)
            # c ** x, c constant
            c0 = c ** s.c0
            ln_c = math.log(c) if isinstance(c, (int, float)) else torch.log(c)
            return _chain_unary(s, order, c0, c0 * ln_c, c0 * ln_c * ln_c)

    operands = [payload if kind == 'series' else constant_series(payload, ctx, ctx.points.shape[0])
                for kind, payload in arg_descs]
    return elementwise_series(op, operands, order)


def _expand_dirs(d, n, m):
    return d.expand(d.shape[0], n, m)


def concat_series(operands, order):
    """Column-concatenate series (the Taylor rule of ``fields.cat``)."""
    c0 = torch.cat([s.c0 for s in operands], dim=1)
    n = c0.shape[0]
    derivs = []
    for k in range(order):
        rows = 1 if all(s.derivs[k].shape[1] == 1 for s in operands) else n
        derivs.append(torch.cat([_expand_dirs(s.derivs[k], rows, s.c0.shape[1])
                                 for s in operands], dim=2))
    return TSeries(c0, derivs)


def _col_slice(col):
    if isinstance(col, int):
        return slice(col, col + 1) if col != -1 else slice(-1, None)
    return col


def slice_series(ts, col):
    """Column-select series (the Taylor rule of ``field[:, col]``)."""
    sl = _col_slice(col)

    def take(x):
        return x if x.shape[-1] == 1 else x[..., sl]

    return TSeries(ts.c0[:, sl], [take(d) for d in ts.derivs])


def sum_series(ts):
    """Column-sum series (the Taylor rule of ``field.sum(axis=1)``)."""
    m = ts.c0.shape[1]

    def reduce(x):
        return x * m if x.shape[-1] == 1 else x.sum(dim=-1, keepdim=True)

    return TSeries(ts.c0.sum(dim=1, keepdim=True), [reduce(d) for d in ts.derivs])


def add_series(a, b):
    """Exact sum of two series."""
    return TSeries(a.c0 + b.c0, [x + y for x, y in zip(a.derivs, b.derivs)])
