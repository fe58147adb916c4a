r"""Batched Taylor-mode series propagation for Fields, at any order.

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
coefficients exactly; products and quotients follow Leibniz; a unary op
supplies its derivatives f', f'', ... at the value (closed forms, with
polynomial recurrences past order 2) and Faa di Bruno's formula assembles
the series from them (:func:`_chain_unary`), so ``x ** 2`` keeps its closed
form at every order; ``atan2``, ``maximum`` and ``minimum`` have binary
rules, and a path ``torch.func.jvp`` serves ops without one. The JAX package
hands orders above 2 to ``jax.experimental.jet``; torch has none, and these
rules take its place.

The main context's directions are the coordinate axes. A genuinely mixed
partial such as u_xy is recovered by polarization: an auxiliary context
probes synthetic directions over the partial's axes (for u_xy the one
direction (x + y) / sqrt 2) and :func:`partial_entry` solves the directional
derivatives for the mixed entry, subtracting the pure ones
(:func:`_extraction_plan`), at any total order.
The expression DAG is memoized per :class:`TContext`, so the network forward
pass is computed once for u, u_x, u_xx, u_y and u_yy.
"""
import math
import numbers
import operator

import numpy as np
import torch
from numpy.polynomial import polynomial as npoly

__all__ = ['TSeries', 'TContext', 'teval', 'elementwise_series', 'constant_series',
           'coordinate_series', 'affine_series', 'lifted_series', 'concat_series',
           'slice_series', 'sum_series', 'add_series', 'derivative_series', 'partial_entry']

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
    its :meth:`at_order` views share.

    ``stacked`` is always True: the port has the JAX package's stacked
    layout only, so a rule written for that package that branches on it
    takes the stacked branch."""

    stacked = True

    def __init__(self, points, order):
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
    made once per matrix, dtype and device (it is never written to). One
    made while ``torch.export`` traces is a stand-in of that trace and is
    not kept."""
    key = (matrix.tobytes(), matrix.shape, points.dtype, points.device)
    out = _DIRECTIONS.get(key)
    if out is None:
        out = torch.tensor(matrix, dtype=points.dtype, device=points.device)
        if not torch.compiler.is_compiling():
            _DIRECTIONS[key] = out
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
    context (:func:`_extraction_plan`). Everything memoizes on the base
    context.
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


def coordinate_series(index, ctx, stop=None):
    """Series of the index-th coordinate (of coordinates ``index`` to
    ``stop``, a run of columns): value = points[:, i], first derivative =
    the directions' i-th components (constant across the batch), second =
    0."""
    stop = index + 1 if stop is None else stop
    c0 = ctx.points[:, index:stop]
    if ctx.order == 0:
        return TSeries(c0, [])
    return TSeries(c0, [ctx.directions[:, index:stop][:, None, :]] + [ctx.zeros()] * (ctx.order - 1))


def affine_series(ts, W, b=None):
    """Exact propagation through ``x @ W (+ b)``; preserves broadcast shapes.
    ``W`` is ``(n_in, n_out)``."""
    c0 = ts.c0 @ W
    if b is not None:
        c0 = c0 + b
    return TSeries(c0, [d @ W for d in ts.derivs])


def _check_dirs(operands, n_dirs):
    """Raise unless every operand's series has ``n_dirs`` directions (None:
    no check; an order-0 series has none to check)."""
    if n_dirs is None:
        return
    for s in operands:
        if s.derivs and s.derivs[0].shape[0] != n_dirs:
            raise ValueError(f"n_dirs={n_dirs} does not match the operands' {s.derivs[0].shape[0]} directions")


def elementwise_series(op, operands, order, n_dirs=None):
    r"""Propagate series through an elementwise op.

    :param op: elementwise function of ``len(operands)`` tensors.
    :param operands: list of TSeries with broadcast-compatible shapes.
    :param order: series order K.
    :param n_dirs: number of probe directions D, as the JAX package passes
        it; checked against the operands' if given.
    """
    _check_dirs(operands, n_dirs)
    c0_out = op(*[s.c0 for s in operands])
    if order == 0:
        return TSeries(c0_out, [])
    return _elementwise_rules(op, operands, order, c0_out)


def _leibniz(a, b, K, start=0):
    r"""Derivatives ``start``..K of a product from the derivative lists ``a``
    and ``b`` (value first): :math:`(ab)^{(k)} = \sum_j \binom{k}{j} a^{(j)} b^{(k-j)}`."""
    out = []
    for k in range(start, K + 1):
        acc = None
        for j in range(k + 1):
            term = a[j] * b[k - j]
            if 0 < j < k:
                term = math.comb(k, j) * term
            acc = term if acc is None else acc + term
        out.append(acc)
    return out


def _quotient(a, b, K, q0):
    r"""Derivatives 0..K of ``a / b`` (value ``q0``) from the derivative lists:
    :math:`q^{(k)} = (a^{(k)} - \sum_{j \ge 1} \binom{k}{j} b^{(j)} q^{(k-j)}) / b`."""
    inv = 1 / b[0]
    q = [q0]
    for k in range(1, K + 1):
        acc = a[k]
        for j in range(1, k + 1):
            term = b[j] * q[k - j]
            acc = acc - (term if j == k else math.comb(k, j) * term)
        q.append(acc * inv)
    return q


def _chain_unary(a, order, c0_out, fs):
    r"""The series of f(a) from the derivatives ``fs[j-1]`` = :math:`f^{(j)}(a_0)`
    (None where one vanishes), by Faa di Bruno's formula
    :math:`(f \circ a)^{(k)} = \sum_j f^{(j)}(a_0) B_{k,j}(a', a'', \dots)`,
    with the partial Bell polynomials built by their recurrence
    :math:`B_{k,j} = \sum_i \binom{k-1}{i-1} a^{(i)} B_{k-i,j-1}`."""
    if order == 0:
        return TSeries(c0_out, [])
    bell = {}

    def B(k, j):
        if j == 1:
            return a.derivs[k - 1]
        hit = bell.get((k, j))
        if hit is None:
            for i in range(1, k - j + 2):
                term = a.derivs[i - 1] * B(k - i, j - 1)
                c = math.comb(k - 1, i - 1)
                term = term if c == 1 else c * term
                hit = term if hit is None else hit + term
            bell[(k, j)] = hit
        return hit

    derivs = []
    for k in range(1, order + 1):
        acc = None
        for j in range(1, k + 1):
            if fs[j - 1] is not None:
                term = fs[j - 1] * B(k, j)
                acc = term if acc is None else acc + term
        derivs.append(torch.zeros_like(a.derivs[k - 1]) if acc is None else acc)
    return TSeries(c0_out, derivs)


# derivatives f', f'', ... of the unary ops at the value, ``(x, v, K) -> K``
# entries, reusing the forward value v where possible: closed forms through
# order 2 (one transcendental per op), recurrences past it

# f^(j) of tanh, sigmoid and tan as polynomials in the value t: P_0 = t and
# P_{j+1} = P_j'(t) Q(t), with Q = t' (1 - t^2, t - t^2, 1 + t^2)
_POLY_Q = {'tanh': [1., 0., -1.], 'sigmoid': [0., 1., -1.], 'tan': [1., 0., 1.]}
_POLYS = {}


def _value_poly(kind, j):
    key = (kind, j)
    if key not in _POLYS:
        _POLYS[key] = (np.array([0., 1.]) if j == 0
                       else npoly.polymul(npoly.polyder(_value_poly(kind, j - 1)), _POLY_Q[kind]))
    return _POLYS[key]


def _horner(coeffs, x):
    """The polynomial with coefficients ``coeffs`` (lowest first) at ``x``."""
    acc = torch.full_like(x, float(coeffs[-1]))
    for c in reversed(coeffs[:-1]):
        acc = acc * x + float(c)
    return acc


def _poly_rule(kind, low):
    """A rule whose derivatives are polynomials in the value (``_value_poly``),
    with the closed forms ``low(x, v)`` for orders 1 and 2."""
    def rule(x, v, K):
        fs = list(low(x, v))[:K]
        return fs + [_horner(_value_poly(kind, j), v) for j in range(len(fs) + 1, K + 1)]

    return rule


def _d_tanh(x, v):
    f1 = 1 - v * v
    return f1, -2 * v * f1


def _d_sigmoid(x, v):
    f1 = v * (1 - v)
    return f1, f1 * (1 - 2 * v)


def _d_tan(x, v):
    f1 = 1 + v * v
    return f1, 2 * v * f1


def _cyclic(K, cycle):
    """f^(j) = cycle[(j - 1) % len(cycle)] for j = 1..K (sin, cos, sinh, cosh)."""
    return [cycle[j % len(cycle)] for j in range(K)]


def _d_sin(x, v, K):
    c = torch.cos(x)
    return _cyclic(K, [c, -v] if K <= 2 else [c, -v, -c, v])


def _d_cos(x, v, K):
    s = torch.sin(x)
    return _cyclic(K, [-s, -v] if K <= 2 else [-s, -v, s, v])


def _d_log(x, v, K):
    inv = 1 / x
    fs = [inv, -inv * inv][:K]
    for j in range(3, K + 1):  # f^(j) = (-1)^(j-1) (j-1)! / x^j
        fs.append(-(j - 1) * fs[-1] * inv)
    return fs


def _d_sqrt(x, v, K):
    f1 = 0.5 / v
    fs = [f1, -0.5 * f1 / x][:K]
    for j in range(3, K + 1):  # f^(j) = (1/2 - j + 1) f^(j-1) / x
        fs.append((0.5 - (j - 1)) * fs[-1] / x)
    return fs


def _d_erf(x, v, K):
    f1 = (2 / math.sqrt(math.pi)) * torch.exp(-x * x)
    fs = [f1, -2 * x * f1][:K]
    h_prev, h = 2 * x, 4 * x * x - 2  # Hermite H_1, H_2: f^(j) = (-1)^(j-1) H_{j-1}(x) f'
    for j in range(3, K + 1):
        fs.append((h if j % 2 else -h) * f1)
        h_prev, h = h, 2 * x * h - 2 * (j - 1) * h_prev
    return fs


def _rational_rule(base, step, power, sign=1):
    """f^(j) = sign * R_j(x) * f'^(power(j)) for the inverse trig functions,
    with R_1 = 1 and ``R_{j+1} = step(R_j, j)`` (numpy polynomials in x)."""
    polys = {1: np.array([1.])}

    def R(j):
        if j not in polys:
            polys[j] = step(R(j - 1), j - 1)
        return polys[j]

    def rule(x, v, K):
        f1, f2 = base(x, v)
        fs = [f1, f2][:K]
        for j in range(3, K + 1):
            fs.append(sign * _horner(R(j), x) * (f1 / sign) ** power(j))
        return fs

    return rule


def _d_atan(x, v):
    f1 = 1 / (1 + x * x)
    return f1, -2 * x * f1 * f1


def _d_asin(x, v):
    f1 = torch.rsqrt(1 - x * x)
    return f1, x * f1 * f1 * f1


def _d_acos(x, v):
    f1 = -torch.rsqrt(1 - x * x)
    return f1, x * f1 * f1 * f1


# atan: f^(j) = Q_j(x) / (1 + x^2)^j with Q_{j+1} = Q_j' (1 + x^2) - 2 j x Q_j;
# asin: f^(j) = R_j(x) / (1 - x^2)^(j - 1/2) with R_{j+1} = R_j' (1 - x^2) + (2j - 1) x R_j
_atan_step = lambda q, j: npoly.polysub(npoly.polymul(npoly.polyder(q), [1., 0., 1.]),  # noqa: E731
                                        npoly.polymul(q, [0., 2. * j]))
_asin_step = lambda r, j: npoly.polyadd(npoly.polymul(npoly.polyder(r), [1., 0., -1.]),  # noqa: E731
                                        npoly.polymul(r, [0., 2. * j - 1.]))

_UNARY_RULES = {
    torch.tanh: _poly_rule('tanh', _d_tanh),
    torch.sigmoid: _poly_rule('sigmoid', _d_sigmoid),
    torch.tan: _poly_rule('tan', _d_tan),
    torch.exp: lambda x, v, K: [v] * K,
    torch.sin: _d_sin,
    torch.cos: _d_cos,
    torch.sinh: lambda x, v, K: _cyclic(K, [torch.cosh(x), v]),
    torch.cosh: lambda x, v, K: _cyclic(K, [torch.sinh(x), v]),
    torch.log: _d_log,
    torch.sqrt: _d_sqrt,
    torch.neg: lambda x, v, K: [-torch.ones_like(x)] + [None] * (K - 1),
    torch.abs: lambda x, v, K: [torch.sign(x)] + [None] * (K - 1),
    torch.erf: _d_erf,
    torch.atan: _rational_rule(_d_atan, _atan_step, lambda j: j),
    torch.asin: _rational_rule(_d_asin, _asin_step, lambda j: 2 * j - 1),
    torch.acos: _rational_rule(_d_acos, _asin_step, lambda j: 2 * j - 1, sign=-1),
}


def _pair(a, b):
    """The two arguments as tensors: a Python number takes the other's dtype and device."""
    if isinstance(a, numbers.Number):
        a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    elif isinstance(b, numbers.Number):
        b = torch.as_tensor(b, dtype=a.dtype, device=a.device)
    return a, b


def maximum(a, b):
    """``torch.maximum`` that also takes a Python number for either argument."""
    return torch.maximum(*_pair(a, b))


def minimum(a, b):
    """``torch.minimum`` that also takes a Python number for either argument."""
    return torch.minimum(*_pair(a, b))


# every op a Field may be lifted through with a Taylor rule
RULE_OPS = frozenset(_UNARY_RULES) | {
    operator.add, operator.sub, operator.mul, operator.truediv, operator.pow, torch.atan2, maximum, minimum}


def _elementwise_rules(op, operands, order, c0_out):
    """Leibniz for ``*`` and ``/``, Faa di Bruno for the unary ops, binary
    rules for ``atan2``, ``maximum`` and ``minimum``, and a path jvp for
    anything else."""
    K = order
    if len(operands) == 2:
        a, b = operands
        if op is operator.add or op is operator.sub:
            return TSeries(c0_out, [op(x, y) for x, y in zip(a.derivs, b.derivs)])
        if op is operator.mul:
            return TSeries(c0_out, _leibniz([a.c0] + a.derivs, [b.c0] + b.derivs, K, start=1))
        if op is operator.truediv:
            return TSeries(c0_out, _quotient([a.c0] + a.derivs, [b.c0] + b.derivs, K, c0_out)[1:])
        if op is torch.atan2:
            # z = atan2(y, x): z' = (x y' - y x') / (x^2 + y^2), and z^(k) = (z')^(k-1)
            y, x = [a.c0] + a.derivs, [b.c0] + b.derivs
            num = [p - q for p, q in zip(_leibniz(x, y[1:], K - 1), _leibniz(y, x[1:], K - 1))]
            rho = [p + q for p, q in zip(_leibniz(x, x, K - 1), _leibniz(y, y, K - 1))]
            return TSeries(c0_out, _quotient(num, rho, K - 1, num[0] / rho[0]))
        if op is maximum or op is minimum:
            # the derivatives of the larger (smaller) operand, averaged at ties
            # (the weights of torch's and JAX's derivative rules)
            wins = a.c0 > b.c0 if op is maximum else a.c0 < b.c0
            w = wins.to(c0_out.dtype) + 0.5 * (a.c0 == b.c0).to(c0_out.dtype)
            return TSeries(c0_out, [w * x + (1 - w) * y for x, y in zip(a.derivs, b.derivs)])

    if len(operands) == 1:
        rule = _UNARY_RULES.get(op)
        if rule is not None:
            return _chain_unary(operands[0], K, c0_out, rule(operands[0].c0, c0_out, K))

    # generic rule: nest jvp through a scalar path parameter s with args
    # a(s) = sum_k a_k s^k / k!. The k-th s-derivative at 0 is the k-th
    # directional derivative, all cross terms included.
    zero = torch.zeros((), dtype=c0_out.dtype, device=c0_out.device)
    one = torch.ones_like(zero)
    n_dirs = operands[0].derivs[0].shape[0]
    parts = [[] for _ in range(K)]
    for d in range(n_dirs):
        def path(s, _d=d):
            args = []
            for sr in operands:
                a = sr.c0
                for k, dk in enumerate(sr.derivs[:K], 1):
                    a = a + (s ** k / math.factorial(k)) * dk[_d]
                args.append(a)
            return op(*args)

        g = path
        for k in range(K):
            g = _derivative_of(g, one)
            parts[k].append(g(zero))
    return TSeries(c0_out, [torch.stack(p) for p in parts])


def _derivative_of(g, one):
    from torch.func import jvp
    return lambda s: jvp(g, (s,), (one,))[1]


def _reciprocal_derivs(x, v, K):
    """f^(j) of f = c / x at x for j = 1..K, given the value ``v = c / x``:
    c (-1)^j j! / x^(j+1)."""
    inv = 1 / x
    fs = [-v * inv]
    for j in range(2, K + 1):
        fs.append(-j * fs[-1] * inv)
    return fs


def _power_derivs(x, p, K):
    r"""f^(j) of :math:`x^p` for a constant p: :math:`p (p-1) \cdots (p-j+1) x^{p-j}`,
    in closed form at every order; None once the falling factorial of a
    whole p vanishes, so ``x ** 2`` has no term in :math:`x^{-1}` (which
    would make its derivatives NaN at x = 0)."""
    fs, coef = [], 1.0
    for j in range(1, K + 1):
        coef = coef * (p - (j - 1))
        if isinstance(coef, numbers.Number) and coef == 0:
            return fs + [None] * (K - j + 1)
        fs.append(coef * x ** (p - j))
    return fs


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
            if const_first:
                c0 = c / s.c0
                return _chain_unary(s, order, c0, _reciprocal_derivs(s.c0, c0, order))
            inv = 1 / c
            return TSeries(s.c0 * inv, [d * inv for d in s.derivs])
        if op is operator.pow:
            if not const_first:  # x ** p, p constant
                return _chain_unary(s, order, s.c0 ** c, _power_derivs(s.c0, c, order))
            # c ** x, c constant: f^(j) = c^x ln(c)^j
            c0 = c ** s.c0
            ln_c = math.log(c) if isinstance(c, (int, float)) else torch.log(c)
            fs = [c0 * ln_c]
            for _ in range(1, order):
                fs.append(fs[-1] * ln_c)
            return _chain_unary(s, order, c0, fs)
        if op is maximum or op is minimum:  # the series where it wins (ties included), else 0
            c0 = op(s.c0, c)
            return _chain_unary(s, order, c0, [(c0 == s.c0).to(c0.dtype)] + [None] * (order - 1))

    operands = [payload if kind == 'series' else constant_series(payload, ctx, ctx.points.shape[0])
                for kind, payload in arg_descs]
    return elementwise_series(op, operands, order)


def _expand_dirs(d, n, m):
    return d.expand(d.shape[0], n, m)


def concat_series(operands, order, n_dirs=None):
    """Column-concatenate series (the Taylor rule of ``fields.cat``);
    ``n_dirs`` as in :func:`elementwise_series`."""
    _check_dirs(operands, n_dirs)
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


def sum_series(ts, keepdims=True):
    """Column-sum series (the Taylor rule of ``field.sum(axis=1)``). The
    sum keeps its column, as the JAX package's does whatever ``keepdims``
    says; ``keepdims=False`` raises rather than be ignored."""
    if not keepdims:
        raise ValueError("sum_series keeps the column dimension: a series is (N, m); pass keepdims=True")
    m = ts.c0.shape[1]

    def reduce(x):
        return x * m if x.shape[-1] == 1 else x.sum(dim=-1, keepdim=True)

    return TSeries(ts.c0.sum(dim=1, keepdim=True), [reduce(d) for d in ts.derivs])


def add_series(a, b):
    """Exact sum of two series."""
    return TSeries(a.c0 + b.c0, [x + y for x, y in zip(a.derivs, b.derivs)])
