r"""Per-sample differentiable fields and the ``diff`` primitive.

Counterpart of ``neurodiffeq_tpu/fields.py``. A :class:`Field` is an
``(N, m)`` tensor-like quantity that remembers how it depends on the
coordinates of its :class:`CoordSet`. Every field carries ``fn``, a batched
function of the points, ``(N, d) -> (N, m)``, each row a function of its own
point only. Two evaluation strategies:

1. **Batched Taylor mode** (the default, and the hot path;
   :mod:`neurodiffeq_tpu_torch.ops.taylor`). Fields built from coordinates,
   networks and lifted elementwise ops carry a ``trule`` that propagates
   truncated Taylor series in batch, memoized per collocation set, so u,
   u_x, u_xx, u_y and u_yy share one network forward pass (on the card, one
   launch of the hand-written kernel).
2. **Composition** (always available). A derivative differentiates ``fn``
   again and again (:func:`_grad_levels`): since each row depends on its own
   point only, the gradient of a column's sum over the rows is the
   per-sample derivative that the JAX package gets from ``vmap`` of nested
   ``jvp``. A sub-expression with no Taylor rule (a boundary anchor from
   :func:`pin`, a network without rules, ``where``) falls back to it,
   counting one fallback (:func:`taylor_fallback_count`);
   ``eval_mode('compose')`` evaluates everything this way.

Field widths are tracked when a field is built, so ``Field.shape`` needs no
evaluation. ``torch.exp(field)`` raises ``TypeError``: a Field is not a
tensor, and an implicit conversion would sever its dependence on the
coordinates. Use :func:`exp` and the other lifted functions here.
"""
import numbers
import operator

import numpy as np
import torch

from ._version_utils import deprecated_alias
from .ops.taylor import RULE_OPS, _col_slice, maximum as _maximum, minimum as _minimum

__all__ = [
    'Field', 'CoordSet', 'coordinates', 'coords_from_points', 'scalar_field', 'network_field', 'composite',
    'pin', 'substitute', 'cat', 'diff', 'safe_diff', 'unsafe_diff',
    'set_diff_method', 'get_diff_method', 'set_eval_mode', 'get_eval_mode', 'eval_mode',
    'taylor_fallback_count', 'reset_taylor_fallback_count',
    # field-aware math
    'exp', 'log', 'sin', 'cos', 'tan', 'tanh', 'sinh', 'cosh', 'sqrt', 'abs', 'sigmoid', 'atan',
    'atan2', 'asin', 'acos', 'erf', 'power', 'where', 'maximum', 'minimum',
]

# How the compose path takes high-order derivatives. The JAX package picks
# between nested jvp and jax.experimental.jet ('auto' tries jet); torch has
# no jet, and every method repeats reverse-mode torch.autograd.grad
# (_grad_levels): eager, it runs a third of the operations of nested
# torch.func.jvp on the heat residual with insulated ends. The three names
# are accepted for parity and give the same values.
_DIFF_METHOD = 'auto'

# Field evaluation strategy: 'taylor' (batched series propagation with the
# per-subexpression compose fallback) or 'compose' (always composition).
_EVAL_MODE = 'taylor'


def set_diff_method(method):
    """Set the compose path's high-order strategy: 'auto', 'jet' or 'jvp'
    (all three repeat ``torch.autograd.grad`` here)."""
    global _DIFF_METHOD
    if method not in ('auto', 'jet', 'jvp'):
        raise ValueError(f"Unknown diff method {method}")
    _DIFF_METHOD = method


def get_diff_method():
    return _DIFF_METHOD


def _check_mode(mode):
    if mode not in ('taylor', 'compose'):
        raise ValueError(f"Unknown eval mode {mode}")
    return mode


def set_eval_mode(mode):
    """Set the Field evaluation strategy: 'taylor' (default) or 'compose'."""
    global _EVAL_MODE
    _EVAL_MODE = _check_mode(mode)


def get_eval_mode():
    return _EVAL_MODE


class eval_mode:
    """Context manager scoping the evaluation strategy:
    ``with eval_mode('compose'): ...``. 'compose' is the always-correct
    reference path; no kernel serves it."""

    def __init__(self, mode):
        self.mode = _check_mode(mode)
        self._prev = None

    def __enter__(self):
        global _EVAL_MODE
        self._prev, _EVAL_MODE = _EVAL_MODE, self.mode
        return self

    def __exit__(self, *exc):
        global _EVAL_MODE
        _EVAL_MODE = self._prev
        return False


class CoordSet:
    """The shared ``(N, d)`` batch of collocation points underlying a family
    of Fields; owns the memoized Taylor-evaluation context and the compose
    path's first gradients (:func:`_first_grads`). Under a mesh the points
    are this rank's block of a global batch, and ``shard``
    (:class:`~neurodiffeq_tpu_torch.parallel.sharding.RowShard`) says which;
    None otherwise."""

    __slots__ = ('points', 'shard', '_tctx', '_grads')

    def __init__(self, points, shard=None):
        if points.ndim != 2:
            raise ValueError(f"points must be (N, d), got shape {tuple(points.shape)}")
        self.points = points
        self.shard = shard
        self._tctx = None
        self._grads = {}

    @property
    def n_samples(self):
        return self.points.shape[0]

    @property
    def n_dims(self):
        return self.points.shape[1]

    def get_ctx(self, order):
        """Taylor context of at least the given order (shared and memoized)."""
        from .ops.taylor import TContext
        if self._tctx is None or self._tctx.order < order:
            self._tctx = TContext(self.points, order)
        return self._tctx

    def release(self):
        """Empty the memoized Taylor contexts and first gradients. Their
        fields refer back to this set (and a context to itself), cycles that
        only Python's cycle collector would free, with every tensor and
        autograd graph they hold; a solver releases each batch's set once
        its loss is built (the loss's own graph keeps what its backward
        needs)."""
        from .ops.taylor import TContext
        if self._tctx is not None:
            for _, payload in list(self._tctx.cache.values()):
                if isinstance(payload, TContext):  # a polarization context
                    payload.cache.clear()
            self._tctx.cache.clear()
        self._tctx = None
        self._grads = {}

    def coord_fields(self):
        """The d coordinate components as Fields (each knows its index)."""
        return tuple(Field(self, width=1, fn=_make_coord_fn(i), index=i, trule=_make_coord_trule(i))
                     for i in range(self.n_dims))


def _make_coord_fn(i):
    return lambda p: p[:, i:i + 1]


def _make_coord_trule(i, stop=None):
    def trule(ctx):
        from .ops.taylor import coordinate_series
        return coordinate_series(i, ctx, stop)

    return trule


def coordinates(*arrays, dtype=None, device=None):
    """Build coordinate Fields from per-component arrays.

    :param arrays: d arrays, each of shape (N,) or (N, 1), numpy or torch.
    :param dtype: dtype of the points (the port's default if None).
    :param device: device of the points (the port's default if None).
    :return: A tuple of d coordinate Fields sharing one CoordSet.
    """
    from .utils import resolve
    device, dtype = resolve(device, dtype)
    cols = [torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, dtype=dtype, device=device).reshape(-1)
            for a in arrays]
    n = cols[0].shape[0]
    for c in cols:
        if c.shape[0] != n:
            raise ValueError(f"coordinate arrays must have equal lengths, got {n} != {c.shape[0]}")
    return CoordSet(torch.stack(cols, dim=1)).coord_fields()


def coords_from_points(points, shard=None):
    """Build coordinate Fields from a single ``(N, d)`` tensor (this rank's
    block of a global batch where ``shard`` says so)."""
    return CoordSet(points, shard).coord_fields()


class Field:
    r"""An ``(N, m)`` quantity that remembers how it depends on the coordinates.

    - ``fn(points) -> (N, m)``: the batched function of the points, each
      row a function of its own point only (the compose path);
    - ``trule(ctx) -> TSeries``: batched Taylor propagation rule;
    - ``_combine = (kind, op, specs, operands)``: how to rebuild the value
      from batched operand values (elementwise/cat/slice/sum);
    - ``_dinfo = (parent, alpha)``: this field is the partial
      :math:`\partial^\alpha` of ``parent``;
    - ``torder``: the series order this field's value needs;
    - ``width``: the column count m.
    """

    __slots__ = ('coords', 'width', 'fn', 'index', '_value', 'trule', 'torder',
                 '_combine', '_dinfo')

    def __init__(self, coords, width, fn, index=None, trule=None, torder=0,
                 combine=None, dinfo=None):
        self.coords = coords
        self.width = width
        self.fn = fn
        self.index = index  # set only for raw coordinate components
        self._value = None
        self.trule = trule
        self.torder = torder
        self._combine = combine
        self._dinfo = dinfo

    # ------------------------------------------------------------------ value
    @property
    def value(self):
        """Evaluate (and cache) the field on its collocation points -> (N, m)."""
        if self._value is None:
            if _EVAL_MODE == 'taylor':
                self._value = self._value_with_ctx(self.coords.get_ctx(self.torder))
            else:
                self._value = self._compose_value()
        return self._value

    def _compose_value(self):
        return _call(self, self.coords.points)

    def _value_with_ctx(self, ctx):
        def compute():
            n = self.coords.n_samples
            if self._dinfo is not None:
                from .ops.taylor import partial_entry
                parent, alpha = self._dinfo
                d = partial_entry(parent, alpha, ctx)
                return d.expand(n, d.shape[-1])
            if self.trule is not None:
                from .ops.taylor import teval
                return teval(self, ctx, order=0).c0
            if self._combine is not None:
                kind, op, specs, operands = self._combine
                it = iter(operands)
                vals = [next(it)._value_with_ctx(ctx) if skind == 'field' else payload
                        for skind, payload in specs]
                if kind == 'elementwise':
                    return op(*vals).expand(n, self.width)
                if kind == 'cat':
                    return torch.cat([_as_2d(v, n, ctx.points) for v in vals], dim=1)
                if kind == 'slice':
                    return vals[0][:, _col_slice(op)]
                if kind == 'sum':
                    return vals[0].sum(dim=1, keepdim=True)
                raise RuntimeError(f"unknown combine kind {kind}")  # pragma: no cover
            global _TAYLOR_FALLBACKS
            _TAYLOR_FALLBACKS += 1
            return self._compose_value()

        return ctx.memo(self, 'v', compute)

    @property
    def values(self):
        return self.value

    def detach(self):
        return self.value.detach()

    def numpy(self):
        return self.value.detach().cpu().numpy()

    @property
    def shape(self):
        return (self.coords.n_samples, self.width)

    @property
    def ndim(self):
        return 2

    def __len__(self):
        return self.coords.n_samples

    # numpy defers binary ops to the reflected methods below
    __array_ufunc__ = None

    # ------------------------------------------------------------- arithmetic
    def __add__(self, other):
        return _lift_call(operator.add, self, other)

    def __radd__(self, other):
        return _lift_call(operator.add, other, self)

    def __sub__(self, other):
        return _lift_call(operator.sub, self, other)

    def __rsub__(self, other):
        return _lift_call(operator.sub, other, self)

    def __mul__(self, other):
        return _lift_call(operator.mul, self, other)

    def __rmul__(self, other):
        return _lift_call(operator.mul, other, self)

    def __truediv__(self, other):
        return _lift_call(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return _lift_call(operator.truediv, other, self)

    def __pow__(self, other):
        return _lift_call(operator.pow, self, other)

    def __rpow__(self, other):
        return _lift_call(operator.pow, other, self)

    def __neg__(self):
        return _lift_call(torch.neg, self)

    def abs(self):
        return _lift_call(torch.abs, self)

    __abs__ = abs

    # comparisons evaluate eagerly to plain boolean tensors
    def __lt__(self, other):
        return self.value < _raw(other)

    def __le__(self, other):
        return self.value <= _raw(other)

    def __gt__(self, other):
        return self.value > _raw(other)

    def __ge__(self, other):
        return self.value >= _raw(other)

    # ---------------------------------------------------------------- slicing
    def __getitem__(self, key):
        """Column selection: ``u[:, i]`` and ``u[:, a:b]`` (keeps 2-D values)."""
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] == slice(None)):
            raise TypeError("Fields only support column indexing of the form u[:, i] or u[:, a:b]")
        col = key[1]
        if not isinstance(col, (int, slice)):
            raise TypeError(f"Unsupported column index {col}")
        sl = _col_slice(col)
        width = len(range(self.width)[sl])
        trule = None
        if self.trule is not None:
            def trule(ctx, _parent=self, _col=col):
                from .ops.taylor import teval, slice_series
                return slice_series(teval(_parent, ctx), _col)

        return Field(self.coords, width, lambda p, _parent=self: _call(_parent, p)[:, sl], trule=trule,
                     torder=self.torder, combine=('slice', col, [('field', None)], [self]))

    def reshape(self, *shape):
        """Only the identity and ``(-1, 1)`` reshapes keep a field: they
        return it; any other returns the reshaped value."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if shape in ((-1, 1), self.shape):
            return self
        return self.value.reshape(*shape)

    # -------------------------------------------------------------- reductions
    def mean(self, axis=None):
        return self.value.mean() if axis is None else self.value.mean(dim=axis)

    def sum(self, axis=None, keepdims=False):
        """Full reduction returns a tensor; ``axis=1`` keeps a (N, 1) Field
        whatever ``keepdims`` says (a Field is always 2-D)."""
        if axis in (1, -1):
            trule = None
            if self.trule is not None:
                def trule(ctx, _parent=self):
                    from .ops.taylor import teval, sum_series
                    return sum_series(teval(_parent, ctx))

            return Field(self.coords, 1, lambda p, _parent=self: _call(_parent, p).sum(dim=1, keepdim=True),
                         trule=trule, torder=self.torder, combine=('sum', None, [('field', None)], [self]))
        return self.value.sum() if axis is None else self.value.sum(dim=axis, keepdim=keepdims)

    def max(self, axis=None):
        return self.value.amax() if axis is None else self.value.amax(dim=axis)

    def min(self, axis=None):
        return self.value.amin() if axis is None else self.value.amin(dim=axis)

    def item(self):
        return self.value.item()

    def __repr__(self):
        return f"Field(shape={self.shape})"


# Count of Fields whose batched Taylor evaluation found no rule and composed
# instead. Zero across a residual means the whole loss ran on the batched engine.
_TAYLOR_FALLBACKS = 0


def taylor_fallback_count():
    """Number of compose-fallback evaluations since the last reset."""
    return _TAYLOR_FALLBACKS


def reset_taylor_fallback_count():
    global _TAYLOR_FALLBACKS
    _TAYLOR_FALLBACKS = 0


def _raw(x):
    return x.value if isinstance(x, Field) else x


# (id(field), id(points), grad mode) -> (field, points, value) while an
# outermost _call runs: a field that a formula names twice (a Neumann anchor
# of IBVP1D's insulated variant, the columns of one net) is evaluated once
_CALLS = None


def _call(field, points):
    """``field.fn`` at ``points``, as an ``(N, width)`` tensor."""
    global _CALLS
    if _CALLS is None:
        _CALLS = {}
        try:
            return _call(field, points)
        finally:
            _CALLS = None
    key = (id(field), id(points), torch.is_grad_enabled())
    hit = _CALLS.get(key)
    if hit is None:
        out = field.fn(points)
        if out.ndim < 2:
            out = out.reshape(1, -1)
        hit = _CALLS[key] = (field, points, out.expand(points.shape[0], field.width))
    return hit[2]


def _as_2d(v, n, like):
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if v.ndim == 0:
        return v.reshape(1, 1).expand(n, 1)
    if v.ndim == 1:
        return v[None, :].expand(n, v.shape[0])
    return v


def _is_scalar_like(x):
    if isinstance(x, numbers.Number):
        return True
    return getattr(x, 'ndim', None) == 0


def _const_payload(a, n, like):
    """A non-Field argument as a constant: Python scalars stay scalars,
    arrays become tensors on the points' device ((N,) -> (N, 1)); boolean
    masks stay boolean."""
    if _is_scalar_like(a):
        return float(a) if isinstance(a, np.generic) else a
    arr = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a, device=like.device)
    if arr.dtype != torch.bool:
        arr = arr.to(like.dtype)
    if arr.ndim == 1 and arr.shape[0] == n:
        arr = arr[:, None]
    return arr


def _specs(args, cs):
    """The evaluation plan of ``args``: ('field', None) or ('const', payload) each."""
    n = cs.n_samples
    for a in args:
        if isinstance(a, Field) and a.coords is not cs:
            raise ValueError(
                "Cannot combine Fields defined on different coordinate sets "
                "(they correspond to different collocation batches).")
    return [('field', None) if isinstance(a, Field) else ('const', _const_payload(a, n, cs.points)) for a in args]


def _operand_values(specs, fields, points):
    it = iter(fields)
    return [_call(next(it), points) if kind == 'field' else payload for kind, payload in specs]


def _lift_call(op, *args, _composite=False):
    """Apply an elementwise op across Fields / scalars / per-sample tensors.

    Non-Field tensors whose leading dimension is N are per-sample constants
    (constant with respect to the coordinates); others broadcast.
    """
    fields = [a for a in args if isinstance(a, Field)]
    cs = fields[0].coords
    specs = _specs(args, cs)
    width = 1
    for a, (kind, payload) in zip(args, specs):
        w = a.width if kind == 'field' else (payload.shape[-1] if getattr(payload, 'ndim', 0) >= 1 else 1)
        width = max(width, w)
    torder = max(f.torder for f in fields)

    def fn(p, _specs=tuple(specs), _operands=tuple(fields)):
        return op(*_operand_values(_specs, _operands, p))

    trule = None
    if (_composite or op in RULE_OPS) and all(f.trule is not None for f in fields):
        def trule(ctx, _specs=tuple(specs), _operands=tuple(fields), _op=op):
            from .ops.taylor import teval, lifted_series
            it = iter(_operands)
            arg_descs = [('series', teval(next(it), ctx)) if kind == 'field' else ('const', payload)
                         for kind, payload in _specs]
            return lifted_series(_op, arg_descs, ctx)

    return Field(cs, width, fn, trule=trule, torder=torder, combine=('elementwise', op, specs, fields))


def lift(op):
    """Wrap an elementwise torch function to accept Fields."""

    def lifted(*args):
        if not any(isinstance(a, Field) for a in args):
            return op(*args)
        return _lift_call(op, *args)

    lifted.__name__ = getattr(op, '__name__', 'lifted')
    lifted.__doc__ = f"Field-aware ``{lifted.__name__}``."
    return lifted


def composite(fn, *args):
    """Combine several Fields through ONE elementwise function ``fn`` of
    their batched values (plain torch formulas). The whole formula
    propagates its Taylor series as one unit (a path ``torch.func.jvp`` per
    direction), where every operand has a rule."""
    return _lift_call(fn, *args, _composite=True)


exp = lift(torch.exp)
log = lift(torch.log)
sin = lift(torch.sin)
cos = lift(torch.cos)
tan = lift(torch.tan)
tanh = lift(torch.tanh)
sinh = lift(torch.sinh)
cosh = lift(torch.cosh)
sqrt = lift(torch.sqrt)
abs = lift(torch.abs)  # noqa: A001 - deliberate parity with the JAX package
sigmoid = lift(torch.sigmoid)
atan = lift(torch.atan)
_atan2 = lift(torch.atan2)
asin = lift(torch.asin)
acos = lift(torch.acos)
erf = lift(torch.erf)
power = lift(operator.pow)
maximum = lift(_maximum)
minimum = lift(_minimum)
# no Taylor rule (as in the JAX package): a where of fields composes
where = lift(torch.where)


def atan2(y, x):
    """Field-aware ``atan2(y, x)``; Python numbers may stand for either
    argument (``torch.atan2`` itself takes tensors only)."""
    return _atan2(*(torch.tensor(float(a), dtype=torch.float64) if isinstance(a, numbers.Number) else a
                    for a in (y, x)))


def scalar_field(per_sample_fn, coords):
    """Build a Field from a per-sample function of the coordinate components.

    :param per_sample_fn: maps d scalar coordinates to a scalar (or an
        ``(m,)`` vector); it is vectorized with ``torch.func.vmap``.
    :param coords: coordinate Fields (as returned by :func:`coordinates`) or a CoordSet.
    """
    cs = coords if isinstance(coords, CoordSet) else coords[0].coords

    def fn(p):
        return torch.func.vmap(lambda xs: per_sample_fn(*xs.unbind(0)))(p).reshape(p.shape[0], -1)

    with torch.no_grad():
        width = torch.as_tensor(per_sample_fn(*cs.points[0].unbind(0))).numel()
    return Field(cs, width, fn)


def network_field(module, coords, ith_unit=None):
    """The raw network-output Field ``module(*coords)``.

    :param module: a network (or any batched callable ``(N, k) -> (N, m)``);
        one with ``taylor_apply(series, ctx)`` and ``n_output_units`` (e.g.
        :class:`~neurodiffeq_tpu_torch.networks.FCNN`) gets the batched
        Taylor path, and its plain forward is the compose path.
    :param coords: coordinate Fields (a subset, in the order the network
        consumes them) or a CoordSet.
    :param ith_unit: if set, select a single output column.
    """
    if isinstance(coords, CoordSet):
        cs, idxs = coords, list(range(coords.n_dims))
    else:
        cs = coords[0].coords
        for c in coords:
            if c.index is None:
                raise TypeError("network inputs must be raw coordinate Fields")
        idxs = [c.index for c in coords]
    # a contiguous run of inputs is a basic slice: its columns are views
    cols = slice(idxs[0], idxs[-1] + 1) if idxs == list(range(idxs[0], idxs[-1] + 1)) else idxs
    unit = slice(None) if ith_unit is None else _col_slice(ith_unit)

    def fn(p):
        return module(p[:, cols])[:, unit]

    trule = None
    if getattr(module, 'supports_taylor', False):
        key = ('net', id(module), tuple(idxs))

        def trule(ctx):
            from .ops.taylor import TSeries, slice_series
            # One network pass per context for the module and its inputs, at
            # the context's full order: the conditions of a shared net slice
            # its columns from it, and a consumer that needs a deeper series
            # later (the H1 losses differentiate the residual) finds it
            # memoized instead of running the net again.
            hit = ctx.cache.get(key)
            if hit is None or hit[1].order < max(ctx.order, ctx.root.order):
                run = ctx.at_order(max(ctx.order, ctx.root.order))
                p = run.points
                d1 = run.directions[:, cols][:, None, :]
                derivs = ([d1] + [torch.zeros_like(d1)] * (run.order - 1))[:run.order]
                # the fused kernel assumes the identity directions on all the inputs
                meta = 'raw_coords' if run.is_axes and idxs == list(range(p.shape[1])) else None
                hit = ctx.cache[key] = (module, module.taylor_apply(TSeries(p[:, cols], derivs, meta=meta), run))
            out = hit[1]
            return out if ith_unit is None else slice_series(out, ith_unit)

    if ith_unit is not None:
        width = 1
    elif hasattr(module, 'output_width'):  # a width that depends on the inputs (MonomialNN)
        width = module.output_width(len(idxs))
    else:
        width = module.n_output_units
    return Field(cs, width, fn, trule=trule)


def _replace_column(points, i, c):
    """``points`` with column ``i`` replaced by the (N,) tensor ``c`` (differentiably)."""
    return torch.cat([points[:, :i], c[:, None], points[:, i + 1:]], dim=1)


def pin(field, coord_index, const, derivative_order=0):
    r"""Evaluate a field, or its k-th derivative along one coordinate, at a
    pinned (constant) value of that coordinate.

    ``pin(u, i, c, k)`` is :math:`\partial^k u/\partial x_i^k` at
    :math:`x_i = c`: a field of the remaining coordinates, with zero
    derivative in direction ``i``, as the reference's independent anchor
    tensors give (``x1 = x_max * ones_like(x).requires_grad_()``, then
    ``diff(ANN(x1, t), x1)``), and as this function computes it. It has no
    Taylor rule, so it composes.

    :param field: the Field to anchor.
    :param coord_index: which coordinate to pin.
    :param const: the anchored value.
    :param derivative_order: order of the derivative in the pinned direction
        taken *before* anchoring; 0 returns the pinned field itself.
    """
    if isinstance(field, Field) and field.index is not None:
        raise ValueError("Cannot pin a raw coordinate field")

    def fn(p):
        c = torch.full((p.shape[0],), float(const), dtype=p.dtype, device=p.device)
        return _nested_grad(lambda c_: _call(field, _replace_column(p, coord_index, c_)), c, derivative_order,
                            lambda g: g[:, None])

    return Field(field.coords, field.width, fn)


def substitute(field, coord_index, const):
    """Alias of :func:`pin` with ``derivative_order=0``."""
    return pin(field, coord_index, const)


def cat(fields, dim=1):
    """Concatenate Fields (and/or constants) along the column axis -> one Field."""
    if dim not in (1, -1):
        raise ValueError("Fields can only be concatenated along columns (dim=1)")
    args = list(fields)
    field_args = [a for a in args if isinstance(a, Field)]
    cs = field_args[0].coords
    n = cs.n_samples
    specs = _specs(args, cs)
    width = sum(a.width if isinstance(a, Field) else _as_2d(p, n, cs.points).shape[1]
                for a, (_, p) in zip(args, specs))
    torder = max(f.torder for f in field_args)
    idxs = [a.index if isinstance(a, Field) else None for a in args]
    if None not in idxs and idxs == list(range(idxs[0], idxs[-1] + 1)):
        # a run of raw coordinates is a slice of the points (all of them: the
        # points themselves), so its compose path splits and joins nothing
        lo, hi = idxs[0], idxs[-1] + 1
        return Field(cs, width, lambda p: p[:, lo:hi], trule=_make_coord_trule(lo, hi),
                     combine=('cat', None, specs, field_args))

    def fn(p, _specs=tuple(specs), _operands=tuple(field_args)):
        return torch.cat([_as_2d(v, p.shape[0], p) for v in _operand_values(_specs, _operands, p)], dim=1)

    trule = None
    if all(f.trule is not None for f in field_args):
        def trule(ctx, _specs=tuple(specs), _operands=tuple(field_args)):
            from .ops.taylor import teval, constant_series, concat_series
            it = iter(_operands)
            series = [teval(next(it), ctx) if kind == 'field'
                      else constant_series(payload, ctx, ctx.points.shape[0])
                      for kind, payload in _specs]
            return concat_series(series, ctx.order)

    return Field(cs, width, fn, trule=trule, torder=torder, combine=('cat', None, specs, field_args))


# ---------------------------------------------------------------------- diff

def _grad_levels(out, z, order, pick, keep):
    """``order`` derivatives of the rows ``out`` with respect to ``z``, by
    repeated reverse-mode ``torch.autograd.grad`` of each column's sum over
    the rows: each row depends on its own inputs only, so that gradient is
    the per-row derivative. ``pick(g)`` takes the direction differentiated
    along from a gradient (a column of the points, or all of a pinned
    value). ``keep``: record the last level's graph too (a loss then
    differentiates the result again). The graph that ``out`` hangs on is
    kept: a field's first gradients serve all its derivatives
    (:func:`_first_grads`), so one derivative under ``no_grad`` must not
    free it for the next."""
    for k in range(order):
        if not out.requires_grad:  # constant in z
            return torch.zeros_like(out)
        grads = [torch.autograd.grad(out[:, j].sum(), z, create_graph=keep or k < order - 1, retain_graph=True,
                                     allow_unused=True, materialize_grads=True)[0]
                 for j in range(out.shape[1])]
        out = torch.cat([pick(g) for g in grads], dim=1)
    return out


def _leaf(x):
    """``x`` itself where it is differentiable (inside another composition,
    or an input that requires grad), else a leaf copy to differentiate by."""
    return x if x.requires_grad else x.detach().requires_grad_()


def _nested_grad(f, x, order, pick):
    """The ``order``-th derivative of the row-wise function ``f`` at ``x``
    (:func:`_grad_levels`), detached under ``no_grad``."""
    if order == 0:
        return f(x)
    keep = torch.is_grad_enabled()
    with torch.enable_grad():
        z = _leaf(x)
        out = _grad_levels(f(z), z, order, pick, keep)
    return out if keep else out.detach()


def _first_grads(u):
    """The gradients of u's columns at u's own points, taken once per field
    and kept, with their graph, on its coordinate set: every derivative of
    u there (u_t and u_xx of a residual, say) starts from them."""
    cs = u.coords
    hit = cs._grads.get(id(u))
    if hit is None:
        with torch.enable_grad():
            z = _leaf(cs.points)
            out = _call(u, z)
            grads = [torch.autograd.grad(out[:, j].sum(), z, create_graph=True, allow_unused=True,
                                         materialize_grads=True)[0] if out.requires_grad else torch.zeros_like(z)
                     for j in range(out.shape[1])]
        hit = cs._grads[id(u)] = (u, z, grads)
    return hit[1], hit[2]


def _derivative_fn(u, idx, order):
    """The compose path's ``order``-th derivative of ``u`` along coordinate ``idx``."""
    def pick(g):
        return g[:, idx:idx + 1]

    def dfn(p):
        if p is not u.coords.points:  # inside another composition
            return _nested_grad(lambda z: _call(u, z), p, order, pick)
        keep = torch.is_grad_enabled()
        z, grads = _first_grads(u)
        with torch.enable_grad():
            out = _grad_levels(torch.cat([pick(g) for g in grads], dim=1), z, order - 1, pick, keep)
        return out if keep else out.detach()

    return dfn


@deprecated_alias(x='u')
def unsafe_diff(u, t, order=1):
    """Like :func:`diff` but skips shape validation."""
    return diff(u, t, order=order, shape_check=False)


@deprecated_alias(x='u')
def safe_diff(u, t, order=1):
    """Like :func:`diff` with mandatory shape validation."""
    return diff(u, t, order=order, shape_check=True)


@deprecated_alias(x='u')
def diff(u, t, order=1, shape_check=True):
    r"""The derivative of a field with respect to a coordinate: du/dt of given order.

    When ``u`` has a Taylor rule, the value is read off its shared batched
    Taylor series (one network forward for every derivative of every order
    and direction); otherwise it composes repeated reverse-mode
    ``torch.autograd.grad`` of ``u.fn`` (:func:`_grad_levels`). Either way
    the result is a lazy Field on the same points that can be differentiated
    further.

    :param u: The dependent variable, a Field of column width 1.
    :param t: The independent variable: a coordinate Field.
    :param order: Derivative order, defaults to 1.
    :param shape_check: Validate that u is (N, 1) and lives on t's batch.
    """
    if not isinstance(u, Field):
        raise TypeError(
            f"diff expects a Field as the dependent variable, got {type(u)}. "
            f"(Raw tensors have no recorded dependence on the coordinates.)")
    if not isinstance(t, Field) or t.index is None:
        raise TypeError(
            "diff expects the independent variable to be a coordinate Field "
            "(a component returned by `coords_from_points(...)` or passed into the equation).")
    if order < 1:
        raise ValueError(f"order must be >= 1, got {order}")
    if shape_check:
        if u.coords is not t.coords:
            raise ValueError("u and t must live on the same collocation batch; "
                             "got fields from different coordinate sets")
        if u.width != 1:
            raise ValueError(
                f"Input shapes must both be (n_samples, 1); got {u.shape} for the "
                f"dependent variable. Pass shape_check=False for multi-column fields.")

    dfn = _derivative_fn(u, t.index, order)
    from .ops.taylor import _merge_alpha
    if u._dinfo is not None:
        parent, palpha = u._dinfo
        alpha = _merge_alpha(palpha, t.index, order)
    elif u.trule is not None:
        parent, alpha = u, ((t.index, order),)
    else:
        return Field(u.coords, u.width, dfn)  # no rule: composes, counting a fallback

    def trule(ctx):
        from .ops.taylor import derivative_series
        return derivative_series(parent, alpha, ctx)

    torder = parent.torder + sum(o for _, o in alpha)
    return Field(u.coords, u.width, dfn, dinfo=(parent, alpha), torder=torder, trule=trule)
