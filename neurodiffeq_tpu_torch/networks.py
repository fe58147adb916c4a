r"""Neural network modules (counterpart of ``neurodiffeq_tpu/networks.py``).

``FCNN``, ``Tanh`` and ``SinActv`` are ``nn.Module``\ s. ``FCNN`` uses
``nn.Linear``'s default initialization, whose bound for weights and biases
is the same ``1/sqrt(fan_in)`` as the JAX package's ``_linear_init``.

Besides ``forward``, a module may support batched Taylor propagation
(``supports_taylor`` and ``taylor_apply(series, ctx)``), the hot evaluation
path of :mod:`neurodiffeq_tpu_torch.fields`.
"""
import warnings

import numpy as np
import torch
from torch import nn

from .utils import resolve

__all__ = ['FCNN', 'Tanh', 'SinActv']


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
        self.actvs = nn.ModuleList(_as_activation(actv) for _ in hidden_units)

    def forward(self, x):
        for lin, actv in zip(self.linears[:-1], self.actvs):
            x = actv(lin(x))
        return self.linears[-1](x)

    @property
    def supports_taylor(self):
        return all(isinstance(a, (Tanh, SinActv)) for a in self.actvs)

    def layers(self):
        """``[(W, b), ...]`` with ``W`` as the ``(n_in, n_out)`` view of each
        ``nn.Linear`` weight: the JAX package's layout."""
        return [(lin.weight.t(), lin.bias) for lin in self.linears]

    def taylor_apply(self, series, ctx):
        """Batched Taylor propagation of the whole network. On raw
        coordinate inputs at order 1-2 with one activation kind (tanh or
        sin), the propagation is one fused Taylor-MLP call
        (:func:`~neurodiffeq_tpu_torch.ops.taylor_mlp.fcnn_taylor`, the
        CUDA kernel for CUDA tensors); otherwise it goes layer by layer."""
        from .ops.taylor import TSeries, affine_series
        kinds = {a.kernel_kind for a in self.actvs}
        if series.meta == 'raw_coords' and 1 <= ctx.order <= 2 and len(kinds) <= 1:
            from .ops.taylor_mlp import fcnn_taylor
            # a net with no hidden layer has no activation: any kind will do
            outs = fcnn_taylor(series.c0, self.layers(), ctx.order,
                               actv=kinds.pop() if kinds else 'tanh')
            return TSeries(outs[0], list(outs[1:]))
        for (W, b), actv in zip(self.layers()[:-1], self.actvs):
            series = actv.taylor_series(affine_series(series, W, b), ctx)
        W, b = self.layers()[-1]
        return affine_series(series, W, b)

    @torch.no_grad()
    def load_jax_params(self, layers):
        """Copy the JAX package's parameter list ``[{'W': (n_in, n_out),
        'b': (n_out,)}, ...]`` (numpy arrays) into this module, so that both
        packages compute the same function."""
        if len(layers) != len(self.linears):
            raise ValueError(f"expected {len(self.linears)} layers, got {len(layers)}")
        for lin, lp in zip(self.linears, layers):
            W, b = np.asarray(lp['W']), np.asarray(lp['b'])
            if W.shape != (lin.in_features, lin.out_features) or b.shape != (lin.out_features,):
                raise ValueError(f"layer shapes {W.shape}, {b.shape} do not match {lin}")
            lin.weight.copy_(torch.tensor(W.T))
            lin.bias.copy_(torch.tensor(b))
        return self

    def extra_repr(self):
        return f"hidden_units={self.hidden_units}"
