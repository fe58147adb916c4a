r"""Neural network modules (counterpart of ``neurodiffeq_tpu/networks.py``).

Every network and activation is an ``nn.Module``. ``FCNN``, ``Resnet`` and
``FourierFCNN`` use ``nn.Linear``'s default initialization, whose bound for
weights and biases is the same ``1/sqrt(fan_in)`` as the JAX package's
``_linear_init``; ``SIREN`` has its own (Sitzmann et al. 2020).

Besides ``forward``, a module may support batched Taylor propagation
(``supports_taylor`` and ``taylor_apply(series, ctx)``), the hot evaluation
path of :mod:`neurodiffeq_tpu_torch.fields`; activations provide
``taylor_series(series, ctx)``. Each network's ``load_jax_params`` copies the
JAX package's parameter pytree (numpy arrays) into the module, so that both
packages compute the same function.
"""
import math
import operator
import warnings

import numpy as np
import torch
from torch import nn

from .parallel.sharding import active_split, load_leaf, stored_leaf
from .utils import resolve

__all__ = ['FCNN', 'Resnet', 'MonomialNN', 'FourierFCNN', 'SIREN',
           'Tanh', 'SinActv', 'Swish', 'APTx']


def _copy_(dst, src):
    """Copy a numpy array into a tensor of the same shape."""
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} does not match {tuple(dst.shape)}")
    dst.copy_(torch.tensor(src))


@torch.no_grad()
def _load_layers(linears, layers):
    """Copy the JAX layer list ``[{'W': (n_in, n_out), 'b': (n_out,)}, ...]``
    into ``nn.Linear`` modules; a split leaf keeps this rank's block."""
    if len(layers) != len(linears):
        raise ValueError(f"expected {len(linears)} layers, got {len(layers)}")
    for lin, lp in zip(linears, layers):
        load_leaf(lin, 'weight', np.asarray(lp['W']).T)
        load_leaf(lin, 'bias', np.asarray(lp['b']))


# ------------------------------------------------------------------ activations

class Tanh(nn.Module):
    """Hyperbolic tangent activation."""
    kernel_kind = 'tanh'

    def forward(self, x):
        return torch.tanh(x)

    def taylor_series(self, series, ctx):
        from .ops.taylor import elementwise_series
        return elementwise_series(torch.tanh, [series], ctx.order)


class SinActv(nn.Module):
    """The sin activation function."""
    kernel_kind = 'sin'

    def forward(self, x):
        return torch.sin(x)

    def taylor_series(self, series, ctx):
        from .ops.taylor import elementwise_series
        return elementwise_series(torch.sin, [series], ctx.order)


def _scalars(module, names, trainable, values):
    """Register ``values`` as ``nn.Parameter`` scalars (trainable) or keep
    them as Python floats."""
    for name, v in zip(names, values):
        if trainable:
            setattr(module, name, nn.Parameter(torch.tensor(float(v))))
        else:
            setattr(module, name, float(v))


def _closed_form(actv, series, ctx, c0, f1, f2):
    """Series of an activation from its value and closed-form f', f''. As in
    the JAX package, these activations have no rule past order 2: a deeper
    context raises (``eval_mode('compose')`` differentiates their plain
    forward instead)."""
    from .ops.taylor import _chain_unary
    if ctx.order > 2:
        raise NotImplementedError(
            f"{type(actv).__name__} has Taylor rules for orders 1-2 only, and this context needs order "
            f"{ctx.order}; evaluate under fields.eval_mode('compose'), as the JAX package must too")
    return _chain_unary(series, ctx.order, c0, [f1, f2][:ctx.order])


class Swish(nn.Module):
    r"""Swish activation: ``x * sigmoid(beta * x)``, with ``beta`` an
    ``nn.Parameter`` if ``trainable``."""

    def __init__(self, beta=1.0, trainable=False):
        super().__init__()
        self.trainable = trainable
        _scalars(self, ('beta',), trainable, (beta,))

    def forward(self, x):
        return x * torch.sigmoid(self.beta * x)

    def taylor_series(self, series, ctx):
        # f = x s(bx); f' = s + bx s(1-s); f'' = 2bs(1-s) + b^2 x s(1-s)(1-2s)
        b, x = self.beta, series.c0
        s = torch.sigmoid(b * x)
        sp = s * (1 - s)
        return _closed_form(self, series, ctx, x * s, s + b * x * sp,
                            2 * b * sp + b * b * x * sp * (1 - 2 * s))

    @torch.no_grad()
    def load_jax_params(self, params):
        if self.trainable:
            _copy_(self.beta, params['beta'])
        return self


class APTx(nn.Module):
    r"""APTx activation: ``(alpha + tanh(beta x)) * gamma * x``, with the
    three scalars ``nn.Parameter``\ s if ``trainable``."""

    def __init__(self, alpha=1.0, beta=1.0, gamma=0.5, trainable=False):
        super().__init__()
        self.trainable = trainable
        _scalars(self, ('alpha', 'beta', 'gamma'), trainable, (alpha, beta, gamma))

    def forward(self, x):
        return (self.alpha + torch.tanh(self.beta * x)) * self.gamma * x

    def taylor_series(self, series, ctx):
        # f = g x (a + t), t = tanh(bx); f' = g(a + t) + g x b (1 - t^2);
        # f'' = 2 g b (1 - t^2) - 2 g x b^2 t (1 - t^2)
        a, b, g, x = self.alpha, self.beta, self.gamma, series.c0
        t = torch.tanh(b * x)
        tp = 1 - t * t
        return _closed_form(self, series, ctx, g * x * (a + t), g * (a + t) + g * x * b * tp,
                            2 * g * b * tp - 2 * g * x * b * b * t * tp)

    @torch.no_grad()
    def load_jax_params(self, params):
        if self.trainable:
            for name in ('alpha', 'beta', 'gamma'):
                _copy_(getattr(self, name), params[name])
        return self


def _as_activation(actv):
    """Accept an activation class/factory or instance; return an instance."""
    if actv is None:
        return Tanh()
    if isinstance(actv, nn.Module):
        return actv
    if callable(actv):
        made = actv()
        if isinstance(made, nn.Module):
            return made
    raise TypeError(f"Unsupported activation {actv}")


def _layer(lin, scale=None, stored=False):
    """``lin`` as ``(W (n_in, n_out), b)``, both times ``scale`` if given:
    the full leaves, or with ``stored`` what this rank stores of them
    (:func:`~neurodiffeq_tpu_torch.parallel.sharding.stored_leaf`), which
    reads no split leaf whole."""
    W, b = (stored_leaf(lin, 'weight'), stored_leaf(lin, 'bias')) if stored else (lin.weight, lin.bias)
    return (W.t(), b) if scale is None else (scale * W.t(), scale * b)


def _split_taylor(points, linears, scales, order, actv, split):
    """:func:`_mlp_taylor`'s fused call with the layer pairs split over the
    ``'model'`` axis of ``split`` (Megatron tensor parallelism): pair k is
    layers 2k and 2k + 1 where their hidden width divides the axis
    (:func:`~neurodiffeq_tpu_torch.parallel.sharding.divides`). Its slice on
    this rank (the columns of layer 2k and its bias, the rows of layer 2k +
    1: the blocks the rank stores) runs on raw coordinates through
    ``fcnn_taylor`` for pair 0, on the summed streams of the pair before
    through ``fcnn_taylor_streams`` (the activation applied inside) for the
    others; one ``all_reduce`` per pair sums the partial streams, and the
    bias of layer 2k + 1 is added after it. Runs of layers that do not
    split (a trailing layer, widths that do not divide) run whole on every
    rank of the axis, a split leaf among them gathered."""
    from .ops import taylor_mlp
    from .parallel.sharding import divides

    n_layers, d = len(linears), points.shape[1]
    segments = []  # [first layer, end, split]
    for i in range(0, n_layers, 2):
        split_pair = i + 1 < n_layers and divides(linears[i].out_features, split.size)
        if segments and not split_pair and not segments[-1][2]:
            segments[-1][1] = min(i + 2, n_layers)
        else:
            segments.append([i, min(i + 2, n_layers), split_pair])
    stack = None  # the (1 + order d, N, h) streams between segments
    for lo, hi, split_pair in segments:
        if split_pair:
            (W0, b0), (W1, b1) = (_layer(linears[i], scales[i], stored=True) for i in (lo, lo + 1))
            if W0.shape[1] != linears[lo].out_features // split.size:
                raise RuntimeError("a net split over the 'model' axis stores full-size leaves: place its blocks "
                                   "first (parallel.sharding.device_put_params)")
            seg = [(W0, b0), (W1, torch.zeros_like(b1))]
        else:
            seg = [_layer(linears[i], scales[i]) for i in range(lo, hi)]
        if lo == 0:
            parts = taylor_mlp.fcnn_taylor(points, seg, order, actv=actv)
        else:
            parts = taylor_mlp.fcnn_taylor_streams(split.enter(stack) if split_pair else stack, seg, order,
                                                   actv=actv, input_actv=actv)
        if split_pair:
            stack = split.reduce(parts, b1)
        elif hi < n_layers:
            stack = torch.cat([parts[0][None], *parts[1:]])
        else:
            return parts
    return (stack[0], stack[1:1 + d], stack[1 + d:])[:order + 1]


def _mlp_taylor(series, ctx, linears, actvs, scales=None, split=None):
    """Batched Taylor propagation through ``x -> ... actv(x W + b) ... W + b``,
    the layers ``linears`` (``nn.Linear``), each times its entry of
    ``scales`` if given (:func:`_layer`).

    While the kernel switch is on (``ops.pallas_enabled()``, the default;
    off, CPU tensors go layer by layer and CUDA tensors raise), on raw
    coordinate inputs at order 1-2 with one activation kind (tanh or
    sin), the propagation is one fused Taylor-MLP call
    (:func:`~neurodiffeq_tpu_torch.ops.taylor_mlp.fcnn_taylor`, the CUDA
    kernel for CUDA tensors, at any width), or with ``split`` (a
    :class:`~neurodiffeq_tpu_torch.parallel.sharding.ModelSplit`) one per
    layer pair of this rank's slices (:func:`_split_taylor`); otherwise it
    goes layer by layer, as every order above 2 does (the JAX package's
    kernel stops at order 2 too), whole on every rank."""
    from .ops import taylor_mlp
    from .ops.taylor import TSeries, affine_series
    scales = scales or [None] * len(linears)
    kinds = {getattr(a, 'kernel_kind', None) for a in actvs}
    if (series.meta == 'raw_coords' and 1 <= ctx.order <= 2 and len(kinds) <= 1 and None not in kinds
            and taylor_mlp._use_kernels(series.c0)):
        # a net with no hidden layer has no activation: any kind will do
        kind = kinds.pop() if kinds else 'tanh'
        if split is not None:
            outs = _split_taylor(series.c0, linears, scales, ctx.order, kind, split)
        else:
            outs = taylor_mlp.fcnn_taylor(series.c0, [_layer(lin, s) for lin, s in zip(linears, scales)], ctx.order,
                                          actv=kind)
        return TSeries(outs[0], list(outs[1:]))
    layers = [_layer(lin, s) for lin, s in zip(linears, scales)]
    for (W, b), actv in zip(layers[:-1], actvs):
        series = actv.taylor_series(affine_series(series, W, b), ctx)
    W, b = layers[-1]
    return affine_series(series, W, b)


class FCNN(nn.Module):
    """A fully connected neural network.

    :param n_input_units: Number of units in the input layer, defaults to 1.
    :param n_output_units: Number of units in the output layer, defaults to 1.
    :param n_hidden_units: [DEPRECATED] Number of hidden units in each layer.
    :param n_hidden_layers: [DEPRECATED] Number of hidden mappings (1 larger
        than the actual number of hidden layers).
    :param actv: The activation constructor (or instance) after each hidden
        layer, defaults to :class:`Tanh`.
    :param hidden_units: Number of hidden units in each hidden layer, defaults
        to ``(32, 32)``.
    :param device: device of the parameters (the port's default if None).
    :param dtype: dtype of the parameters (the port's default if None).
    """

    def __init__(self, n_input_units=1, n_output_units=1, n_hidden_units=None, n_hidden_layers=None,
                 actv=Tanh, hidden_units=None, device=None, dtype=None):
        super().__init__()
        if n_hidden_units is None and n_hidden_layers is not None:
            n_hidden_units = 32
        elif n_hidden_units is not None and n_hidden_layers is None:
            n_hidden_layers = 1
        if n_hidden_units is not None or n_hidden_layers is not None:
            if hidden_units is None:
                hidden_units = tuple(n_hidden_units for _ in range(n_hidden_layers + 1))
                warnings.warn(f"`n_hidden_units` and `n_hidden_layers` are deprecated, "
                              f"pass `hidden_units={hidden_units}` instead", FutureWarning)
            else:
                warnings.warn(f"Ignoring `n_hidden_units` and `n_hidden_layers` in favor of "
                              f"`hidden_units={hidden_units}`", FutureWarning)
        hidden_units = tuple((32, 32) if hidden_units is None else hidden_units)

        device, dtype = resolve(device, dtype)
        self.n_input_units = n_input_units
        self.n_output_units = n_output_units
        self.hidden_units = hidden_units
        units = (n_input_units,) + hidden_units + (n_output_units,)
        self.linears = nn.ModuleList(
            nn.Linear(n_in, n_out, device=device, dtype=dtype)
            for n_in, n_out in zip(units[:-1], units[1:]))
        self.actvs = nn.ModuleList(_as_activation(actv) for _ in hidden_units).to(device=device, dtype=dtype)

    def forward(self, x):
        for lin, actv in zip(self.linears[:-1], self.actvs):
            x = actv(lin(x))
        return self.linears[-1](x)

    @property
    def supports_taylor(self):
        return all(hasattr(a, 'taylor_series') for a in self.actvs)

    def layers(self):
        """``[(W, b), ...]`` with ``W`` as the ``(n_in, n_out)`` view of each
        ``nn.Linear`` weight: the JAX package's layout."""
        return [_layer(lin) for lin in self.linears]

    def taylor_apply(self, series, ctx):
        """Batched Taylor propagation of the whole network: one fused
        Taylor-MLP call where it applies (:func:`_mlp_taylor`; split over
        the ``'model'`` axis inside a solver's sharded pass), else layer by
        layer."""
        return _mlp_taylor(series, ctx, self.linears, list(self.actvs), split=active_split(self))

    @torch.no_grad()
    def load_jax_params(self, params):
        """Copy the JAX package's FCNN parameters into this module: the
        pytree ``{'layers': [{'W': (n_in, n_out), 'b': (n_out,)}, ...],
        'actv': [...]}`` or just its ``'layers'`` list (numpy arrays)."""
        _load_layers(self.linears, params['layers'] if isinstance(params, dict) else params)
        if isinstance(params, dict):
            for actv, ap in zip(self.actvs, params.get('actv') or []):
                if ap is not None:
                    actv.load_jax_params(ap)
        return self

    def extra_repr(self):
        return f"hidden_units={self.hidden_units}"


class Resnet(nn.Module):
    """FCNN plus a trainable bias-free linear skip connection."""

    def __init__(self, n_input_units=1, n_output_units=1, n_hidden_units=None, n_hidden_layers=None,
                 actv=Tanh, hidden_units=(32, 32), device=None, dtype=None):
        super().__init__()
        device, dtype = resolve(device, dtype)
        self.residual = FCNN(n_input_units=n_input_units, n_output_units=n_output_units,
                             n_hidden_units=n_hidden_units, n_hidden_layers=n_hidden_layers,
                             actv=actv, hidden_units=hidden_units, device=device, dtype=dtype)
        self.skip = nn.Linear(n_input_units, n_output_units, bias=False, device=device, dtype=dtype)
        self.n_input_units = n_input_units
        self.n_output_units = n_output_units

    def forward(self, x):
        return self.skip(x) + self.residual(x)

    @property
    def supports_taylor(self):
        return self.residual.supports_taylor

    def taylor_apply(self, series, ctx):
        from .ops.taylor import add_series, affine_series
        return add_series(affine_series(series, self.skip.weight.t()),
                          self.residual.taylor_apply(series, ctx))

    @torch.no_grad()
    def load_jax_params(self, params):
        self.residual.load_jax_params(params['residual'])
        _copy_(self.skip.weight, np.asarray(params['skip_W']).T)
        return self


class FourierFCNN(nn.Module):
    r"""FCNN over random Fourier features: ``x -> [cos(xB), sin(xB)] -> FCNN``
    with ``B[i,j] ~ N(0, (2*pi*sigma)^2)`` fixed at initialization (a
    buffer: it is saved with the module and never trained).

    :param n_input_units: Number of coordinate inputs, defaults to 1.
    :param n_output_units: Number of outputs, defaults to 1.
    :param n_features: Number of random frequencies; the FCNN sees
        ``2 * n_features`` inputs, defaults to 64.
    :param sigma: Frequency bandwidth, defaults to 1.0.
    :param actv: Activation constructor for the FCNN, defaults to :class:`Tanh`.
    :param hidden_units: FCNN hidden widths, defaults to ``(32, 32)``.
    """

    def __init__(self, n_input_units=1, n_output_units=1, n_features=64, sigma=1.0, actv=Tanh,
                 hidden_units=(32, 32), device=None, dtype=None):
        super().__init__()
        device, dtype = resolve(device, dtype)
        self.n_input_units = n_input_units
        self.n_output_units = n_output_units
        self.n_features = int(n_features)
        self.sigma = float(sigma)
        self.register_buffer('B', (2.0 * math.pi * self.sigma) * torch.randn(
            n_input_units, self.n_features, device=device, dtype=dtype))
        self.fcnn = FCNN(n_input_units=2 * self.n_features, n_output_units=n_output_units,
                         actv=actv, hidden_units=hidden_units, device=device, dtype=dtype)

    def forward(self, x):
        z = x @ self.B
        return self.fcnn(torch.cat([torch.cos(z), torch.sin(z)], dim=-1))

    @property
    def supports_taylor(self):
        return self.fcnn.supports_taylor

    def taylor_apply(self, series, ctx):
        from .ops.taylor import affine_series, concat_series, elementwise_series
        z = affine_series(series, self.B)
        feats = concat_series([elementwise_series(torch.cos, [z], ctx.order),
                               elementwise_series(torch.sin, [z], ctx.order)], ctx.order)
        return self.fcnn.taylor_apply(feats, ctx)

    @torch.no_grad()
    def load_jax_params(self, params):
        _copy_(self.B, params['B'])
        self.fcnn.load_jax_params(params['fcnn'])
        return self

    def extra_repr(self):
        return f"n_features={self.n_features}, sigma={self.sigma}"


class SIREN(nn.Module):
    r"""Sinusoidal representation network: every hidden layer is
    ``sin(w0 * (h W + b))`` (Sitzmann et al. 2020).

    Weight init: first layer ``U(-1/fan_in, 1/fan_in)``; every later layer
    ``U(-sqrt(6/fan_in)/w0, sqrt(6/fan_in)/w0)`` (the readout included);
    biases ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.

    :param n_input_units: Number of coordinate inputs, defaults to 1.
    :param n_output_units: Number of outputs, defaults to 1.
    :param hidden_units: Hidden widths, defaults to ``(32, 32)``.
    :param w0: Frequency scale of the sine layers, defaults to 30.0.
    :param w0_first: Frequency scale of the first layer; defaults to ``w0``.
    """
    supports_taylor = True

    def __init__(self, n_input_units=1, n_output_units=1, hidden_units=(32, 32), w0=30.0,
                 w0_first=None, device=None, dtype=None):
        super().__init__()
        device, dtype = resolve(device, dtype)
        self.n_input_units = n_input_units
        self.n_output_units = n_output_units
        self.hidden_units = tuple(hidden_units)
        self.w0 = float(w0)
        self.w0_first = float(w0 if w0_first is None else w0_first)
        units = (n_input_units,) + self.hidden_units + (n_output_units,)
        self.linears = nn.ModuleList(nn.Linear(n_in, n_out, device=device, dtype=dtype)
                                     for n_in, n_out in zip(units[:-1], units[1:]))
        with torch.no_grad():
            for i, lin in enumerate(self.linears):
                n_in = lin.in_features
                bound = 1.0 / n_in if i == 0 else math.sqrt(6.0 / n_in) / self.w0
                lin.weight.uniform_(-bound, bound)
                lin.bias.uniform_(-1.0 / math.sqrt(n_in), 1.0 / math.sqrt(n_in))
        self._sin = SinActv()

    def _layer_w0(self, i):
        return self.w0_first if i == 0 else self.w0

    def forward(self, x):
        for i, lin in enumerate(self.linears[:-1]):
            x = torch.sin(self._layer_w0(i) * lin(x))
        return self.linears[-1](x)

    def taylor_apply(self, series, ctx):
        # sin(w0 (h W + b)) is an FCNN sin layer with weights w0 W and w0 b:
        # the folded layers take the FCNN path and its kernel, and gradients
        # flow through the folding
        scales = [self._layer_w0(i) for i in range(len(self.hidden_units))] + [None]
        return _mlp_taylor(series, ctx, self.linears, [self._sin] * len(self.hidden_units), scales,
                           active_split(self))

    def load_jax_params(self, params):
        """Copy the JAX package's SIREN parameters ``{'layers': [...]}``."""
        _load_layers(self.linears, params['layers'])
        return self

    def extra_repr(self):
        return f"hidden_units={self.hidden_units}, w0={self.w0}, w0_first={self.w0_first}"


class MonomialNN(nn.Module):
    """Expands input to ``[x^d for d in degrees]`` concatenated along columns.
    Output width = n_inputs * n_degrees."""
    supports_taylor = True

    def __init__(self, degrees):
        super().__init__()
        if isinstance(degrees, int):
            degrees = [d for d in range(1, degrees + 1)]
        self.degrees = tuple(degrees)
        if len(self.degrees) == 0:
            raise ValueError("No degrees used, check `degrees` argument again")
        if 0 in self.degrees:
            warnings.warn("One of the degrees is 0 which might introduce redundant features")
        if len(set(self.degrees)) < len(self.degrees):
            warnings.warn(f"Duplicate degrees found: {self.degrees}")

    def output_width(self, n_inputs):
        return n_inputs * len(self.degrees)

    def forward(self, x):
        return torch.cat([x ** d for d in self.degrees], dim=-1)

    def taylor_apply(self, series, ctx):
        from .ops.taylor import concat_series, lifted_series
        return concat_series([lifted_series(operator.pow, [('series', series), ('const', d)], ctx)
                              for d in self.degrees], ctx.order)

    def load_jax_params(self, params):
        return self

    def extra_repr(self):
        return f"degrees={self.degrees}"
