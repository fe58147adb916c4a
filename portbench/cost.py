"""The frozen yardstick: operations and bytes of one Taylor-mode forward of
an FCNN, the published peaks of one NVIDIA H100 SXM, and the least time the
card could take for that forward.

The counts are ``chip_smoke.py``'s ``taylor_cost`` and ``stream_cost``,
copied here so that no later change to the program moves them. They count
what the mathematics needs, whatever a kernel does: per point, a hidden
unit of the first layer costs 2d for its pre-activation, the activation and
its chain rule (tanh: 1 + 4; sin: 2 + 1), d for the first-order tangents
and 2d more at order 2; a later layer costs 2 S h_in h_out in products for
the S = 1 + order * d streams, and per unit the activation, its chain rule
and d (order 1) or 5d (order 2) for the tangent updates; the output layer
2 S h_in n_out in products. Bytes: the points, the parameters and the S
output streams, each once.

The bound puts every product on the tensor cores at the float32-accurate
3xTF32 rate (a third of 495 TFLOP/s) and the rest at the CUDA cores'
float32 rate, so a kernel that runs its products on either reads at most
100% of it.
"""

# NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # CUDA cores, float32 and float64, by element size
PEAK_MMA = {4: 495e12 / 3, 8: 67e12}  # tensor cores: 3xTF32 for float32, DMMA for float64
PEAK_BYTES = 3.35e12  # HBM3


def activation_ops(actv):
    """Operations per unit of the activation and its chain rule."""
    if actv == 'tanh':
        return 1 + 4
    if actv == 'sin':
        return 2 + 1
    raise ValueError(f"unknown activation {actv!r}")


def forward_cost(dims, actv, order, n, esize):
    """(products, elementwise operations, bytes) of one Taylor-mode forward
    of the FCNN ``dims`` (inputs, hidden..., outputs) at ``n`` points to
    ``order`` along the d = dims[0] coordinate axes."""
    d, n_out = dims[0], dims[-1]
    s = 1 + order * d
    params = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = esize * (n * d + params + n * n_out * s)
    if len(dims) == 2:  # no hidden layer: the value's products only
        return n * 2 * d * n_out, 0, nbytes
    act = activation_ops(actv)
    products = 2 * d * dims[1]
    elementwise = dims[1] * (act + d + (2 * d if order == 2 else 0))
    for h_in, h_out in zip(dims[1:-2], dims[2:-1]):
        products += 2 * s * h_in * h_out
        elementwise += h_out * (act + (5 * d if order == 2 else d))
    products += 2 * s * dims[-2] * n_out
    return n * products, n * elementwise, nbytes


def bound_seconds(products, elementwise, nbytes, esize):
    """(least seconds the card could take, 'operations' or 'bytes')."""
    t_ops = products / PEAK_MMA[esize] + elementwise / PEAK_FLOPS[esize]
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def forward_bound_seconds(dims, actv, order, n, esize):
    """The least seconds of one forward (:func:`forward_cost`)."""
    return bound_seconds(*forward_cost(dims, actv, order, n, esize), esize)[0]
