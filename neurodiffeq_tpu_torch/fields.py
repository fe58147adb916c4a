r"""Per-sample differentiable fields and the ``diff`` primitive.

Counterpart of ``neurodiffeq_tpu/fields.py``. A :class:`Field` is an
``(N, m)`` tensor-like quantity that remembers how it depends on the
coordinates of its :class:`CoordSet`. Its value, and the values of its
derivatives, come from the batched Taylor engine
(:mod:`neurodiffeq_tpu_torch.ops.taylor`): fields built from coordinates,
networks and lifted elementwise ops carry a ``trule`` that propagates
truncated Taylor series in batch, memoized per collocation set, so u, u_x,
u_xx, u_y and u_yy share one network forward pass.

The JAX package falls back to per-sample ``vmap``-of-``jvp`` composition
where a sub-expression has no Taylor rule. That fallback is not ported:
such a field counts one fallback (:func:`taylor_fallback_count`) and raises
``NotImplementedError``.

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
from .ops.taylor import RULE_OPS, _col_slice

__all__ = [
    'Field', 'CoordSet', 'coords_from_points', 'network_field', 'cat', 'diff',
    'taylor_fallback_count', 'reset_taylor_fallback_count',
    # field-aware math
    'exp', 'log', 'sin', 'cos', 'tan', 'tanh', 'sinh', 'cosh', 'sqrt', 'abs', 'sigmoid', 'atan',
    'atan2', 'asin', 'acos', 'erf',
]

_NO_FALLBACK = ("this sub-expression has no batched Taylor rule, and the per-sample "
                "compose fallback is not ported (ROADMAP.md §1 item 3)")


class CoordSet:
    """The shared ``(N, d)`` batch of collocation points underlying a family
    of Fields; owns the memoized Taylor-evaluation context."""

    __slots__ = ('points', '_tctx')

    def __init__(self, points):
        if points.ndim != 2:
            raise ValueError(f"points must be (N, d), got shape {tuple(points.shape)}")
        self.points = points
        self._tctx = None

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

    def coord_fields(self):
        """The d coordinate components as Fields (each knows its index)."""
        return tuple(Field(self, width=1, index=i, trule=_make_coord_trule(i))
                     for i in range(self.n_dims))


def _make_coord_trule(i):
    def trule(ctx):
        from .ops.taylor import coordinate_series
        return coordinate_series(i, ctx)

    return trule


def coords_from_points(points):
    """Build coordinate Fields from a single ``(N, d)`` tensor."""
    return CoordSet(points).coord_fields()


class Field:
    r"""An ``(N, m)`` quantity that remembers how it depends on the coordinates.

    - ``trule(ctx) -> TSeries``: batched Taylor propagation rule;
    - ``_combine = (kind, op, specs, operands)``: how to rebuild the value
      from batched operand values (elementwise/cat/slice/sum);
    - ``_dinfo = (parent, alpha)``: this field is the partial
      :math:`\partial^\alpha` of ``parent``;
    - ``torder``: the series order this field's value needs;
    - ``width``: the column count m.
    """

    __slots__ = ('coords', 'width', 'index', '_value', 'trule', 'torder',
                 '_combine', '_dinfo')

    def __init__(self, coords, width, index=None, trule=None, torder=0,
                 combine=None, dinfo=None):
        self.coords = coords
        self.width = width
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
            self._value = self._value_with_ctx(self.coords.get_ctx(self.torder))
        return self._value

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
            raise NotImplementedError(_NO_FALLBACK)

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

    def __abs__(self):
        return _lift_call(torch.abs, self)

    # ---------------------------------------------------------------- slicing
    def __getitem__(self, key):
        """Column selection: ``u[:, i]`` and ``u[:, a:b]`` (keeps 2-D values)."""
        if not (isinstance(key, tuple) and len(key) == 2 and key[0] == slice(None)):
            raise TypeError("Fields only support column indexing of the form u[:, i] or u[:, a:b]")
        col = key[1]
        if not isinstance(col, (int, slice)):
            raise TypeError(f"Unsupported column index {col}")
        width = len(range(self.width)[_col_slice(col)])
        trule = None
        if self.trule is not None:
            def trule(ctx, _parent=self, _col=col):
                from .ops.taylor import teval, slice_series
                return slice_series(teval(_parent, ctx), _col)

        return Field(self.coords, width, trule=trule, torder=self.torder,
                     combine=('slice', col, [('field', None)], [self]))

    # -------------------------------------------------------------- reductions
    def mean(self, dim=None):
        return self.value.mean() if dim is None else self.value.mean(dim=dim)

    def sum(self, axis=None, keepdims=False):
        """Full reduction returns a tensor; ``axis=1`` keeps a (N, 1) Field
        whatever ``keepdims`` says (a Field is always 2-D)."""
        if axis in (1, -1):
            trule = None
            if self.trule is not None:
                def trule(ctx, _parent=self):
                    from .ops.taylor import teval, sum_series
                    return sum_series(teval(_parent, ctx))

            return Field(self.coords, 1, trule=trule, torder=self.torder,
                         combine=('sum', None, [('field', None)], [self]))
        return self.value.sum() if axis is None else self.value.sum(dim=axis, keepdim=keepdims)

    def item(self):
        return self.value.item()

    def __repr__(self):
        return f"Field(shape={self.shape})"


# Count of Fields whose batched Taylor evaluation found no rule (each raises).
# Zero across a residual means the whole loss ran on the batched engine.
_TAYLOR_FALLBACKS = 0


def taylor_fallback_count():
    """Number of fallback evaluations since the last reset."""
    return _TAYLOR_FALLBACKS


def reset_taylor_fallback_count():
    global _TAYLOR_FALLBACKS
    _TAYLOR_FALLBACKS = 0


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
    arrays become tensors on the points' device ((N,) -> (N, 1))."""
    if _is_scalar_like(a):
        return float(a) if isinstance(a, np.generic) else a
    arr = torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                          dtype=like.dtype, device=like.device)
    if arr.ndim == 1 and arr.shape[0] == n:
        arr = arr[:, None]
    return arr


def _lift_call(op, *args):
    """Apply an elementwise op across Fields / scalars / per-sample tensors.

    Non-Field tensors whose leading dimension is N are per-sample constants
    (constant with respect to the coordinates); others broadcast.
    """
    fields = [a for a in args if isinstance(a, Field)]
    cs = fields[0].coords
    for f in fields[1:]:
        if f.coords is not cs:
            raise ValueError(
                "Cannot combine Fields defined on different coordinate sets "
                "(they correspond to different collocation batches).")
    n = cs.n_samples
    specs = [('field', None) if isinstance(a, Field)
             else ('const', _const_payload(a, n, cs.points)) for a in args]
    width = 1
    for a, (kind, payload) in zip(args, specs):
        w = a.width if kind == 'field' else (payload.shape[-1] if getattr(payload, 'ndim', 0) >= 1 else 1)
        width = max(width, w)
    torder = max(f.torder for f in fields)

    trule = None
    if op in RULE_OPS and all(f.trule is not None for f in fields):
        def trule(ctx, _specs=tuple(specs), _operands=tuple(fields), _op=op):
            from .ops.taylor import teval, lifted_series
            it = iter(_operands)
            arg_descs = [('series', teval(next(it), ctx)) if kind == 'field' else ('const', payload)
                         for kind, payload in _specs]
            return lifted_series(_op, arg_descs, ctx)

    return Field(cs, width, trule=trule, torder=torder,
                 combine=('elementwise', op, specs, fields))


def lift(op):
    """Wrap an elementwise torch function to accept Fields."""

    def lifted(*args):
        if not any(isinstance(a, Field) for a in args):
            return op(*args)
        return _lift_call(op, *args)

    lifted.__name__ = getattr(op, '__name__', 'lifted')
    lifted.__doc__ = f"Field-aware ``{lifted.__name__}``."
    return lifted


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


def atan2(y, x):
    """Field-aware ``atan2(y, x)``; Python numbers may stand for either
    argument (``torch.atan2`` itself takes tensors only)."""
    return _atan2(*(torch.tensor(float(a), dtype=torch.float64) if isinstance(a, numbers.Number) else a
                    for a in (y, x)))


def network_field(module, coords, ith_unit=None):
    """The raw network-output Field ``module(*coords)``.

    :param module: a network with ``taylor_apply(series, ctx)`` and
        ``n_output_units`` (e.g. :class:`~neurodiffeq_tpu_torch.networks.FCNN`).
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

    trule = None
    if getattr(module, 'supports_taylor', False):
        # a contiguous run of inputs is a basic slice: its columns are views
        cols = slice(idxs[0], idxs[-1] + 1) if idxs == list(range(idxs[0], idxs[-1] + 1)) else idxs
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
    return Field(cs, width, trule=trule)


def cat(fields, dim=1):
    """Concatenate Fields (and/or constants) along the column axis -> one Field."""
    if dim not in (1, -1):
        raise ValueError("Fields can only be concatenated along columns (dim=1)")
    args = list(fields)
    field_args = [a for a in args if isinstance(a, Field)]
    cs = field_args[0].coords
    n = cs.n_samples
    for f in field_args:
        if f.coords is not cs:
            raise ValueError("Cannot concatenate Fields on different coordinate sets")
    specs = [('field', None) if isinstance(a, Field)
             else ('const', _const_payload(a, n, cs.points)) for a in args]
    width = sum(a.width if isinstance(a, Field) else _as_2d(p, n, cs.points).shape[1]
                for a, (_, p) in zip(args, specs))
    torder = max(f.torder for f in field_args)
    trule = None
    if all(f.trule is not None for f in field_args):
        def trule(ctx, _specs=tuple(specs), _operands=tuple(field_args)):
            from .ops.taylor import teval, constant_series, concat_series
            it = iter(_operands)
            series = [teval(next(it), ctx) if kind == 'field'
                      else constant_series(payload, ctx, ctx.points.shape[0])
                      for kind, payload in _specs]
            return concat_series(series, ctx.order)

    return Field(cs, width, trule=trule, torder=torder,
                 combine=('cat', None, specs, field_args))


@deprecated_alias(x='u')
def diff(u, t, order=1, shape_check=True):
    r"""The derivative of a field with respect to a coordinate: du/dt of given order.

    The value is read off the shared batched Taylor series of ``u`` (one
    network forward for every derivative of every order and direction). The
    result is a lazy Field on the same points.

    :param u: The dependent variable, a Field of column width 1.
    :param t: The independent variable: a coordinate Field.
    :param order: Derivative order (1 or 2), defaults to 1.
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

    from .ops.taylor import _merge_alpha
    if u._dinfo is not None:
        parent, palpha = u._dinfo
        alpha = _merge_alpha(palpha, t.index, order)
    elif u.trule is not None:
        parent, alpha = u, ((t.index, order),)
    else:
        return Field(u.coords, u.width)  # no rule: evaluating it raises

    def trule(ctx):
        from .ops.taylor import derivative_series
        return derivative_series(parent, alpha, ctx)

    torder = parent.torder + sum(o for _, o in alpha)
    return Field(u.coords, u.width, dinfo=(parent, alpha), torder=torder, trule=trule)
