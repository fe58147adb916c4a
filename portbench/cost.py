"""The frozen yardstick: operations and bytes of one Taylor-mode forward of
a configuration's net (an FCNN or a PirateNet), the published peaks of one
NVIDIA H100 SXM, and the least time the card could take for that forward.

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

A configuration names its net's count by ``"net"`` (:func:`config_forward_cost`):
``"fcnn"`` (the default) is :func:`forward_cost`, ``"pirate"`` is
:func:`pirate_forward_cost`.
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


def pirate_forward_cost(d, embed_dim, hidden_dim, blocks, n_out, actv, order, n, esize):
    """(products, elementwise operations, bytes) of one Taylor-mode forward
    of a PirateNet (Wang, Li, Chen and Perdikaris 2024, arXiv:2402.00326;
    ``jaxpi/archs.py::PirateNet``) at ``n`` points to ``order`` along its
    ``d`` inputs, S = 1 + order * d streams, m = ``embed_dim``, h =
    ``hidden_dim``, L = ``blocks``, a = the activation's operations
    (:func:`activation_ops`) and t = d (order 1) or 5d (order 2), the FCNN's
    tangent updates of a unit. Per point:

    - the embedding [cos(xB), sin(xB)], B of d x m/2: 2 d (m/2) products on
      the value alone (its tangents are B's constant rows), and per
      frequency cos and sin with their chain rule, 2 + 2d (+ 3d at order 2:
      the squared tangent once, then each function's second term);
    - U = act(Phi W_U + b_U), V = act(Phi W_V + b_V), and in each block
      f = act(x W_1 + b_1), g = act(z_1 W_2 + b_2), h = act(z_2 W_3 + b_3)
      with W_1 m x h, W_2 h x h, W_3 h x m: 2 S h_in h_out products each on
      the S streams, and a + t per unit of each activation;
    - U - V once, S a unit; each gate mix z = V + f (U - V), two a block:
      per unit the Leibniz product f (U - V), 1 + 3d (+ 5d at order 2, on
      Taylor coefficients), and the sum with V, S;
    - each residual mix x' = alpha h + (1 - alpha) x, alpha a scalar leaf:
      3 S per unit of m;
    - the output x W_out + b_out: 2 S m n_out products.

    So products = 2 d (m/2) + 2 S (2 m h + L (2 m h + h^2) + m n_out) and
    elementwise = (m/2) (2 + 2d + 3d [order 2]) + (2 + 2L) h (a + t)
    + L m (a + t) + S h + 2 L h (1 + 3d + 5d [order 2] + S) + 3 L S m.
    Every dense layer is weight-factorised, W = diag(exp(s)) V with s and
    b one per output unit: that costs O(parameters) once a step, not per
    point, so it is counted in bytes alone. Bytes: the points, every leaf
    once (B; V, s and b of each dense layer; alpha of each block) and the S
    output streams."""
    m, h, s = embed_dim, hidden_dim, 1 + order * d
    if m % 2:
        raise ValueError(f"embed_dim {m} is odd: the embedding has m/2 frequencies")
    two = order == 2
    dense = lambda h_in, h_out: h_in * h_out + 2 * h_out  # V, s and b
    params = d * m // 2 + 2 * dense(m, h) + blocks * (dense(m, h) + dense(h, h) + dense(h, m) + 1) + dense(m, n_out)
    nbytes = esize * (n * d + params + n * n_out * s)
    unit = activation_ops(actv) + (5 * d if two else d)
    products = 2 * d * (m // 2) + 2 * s * (2 * m * h + blocks * (2 * m * h + h * h) + m * n_out)
    elementwise = ((m // 2) * (2 + 2 * d + (3 * d if two else 0)) + (2 + 2 * blocks) * h * unit
                   + blocks * m * unit + s * h + 2 * blocks * h * (1 + 3 * d + (5 * d if two else 0) + s)
                   + 3 * blocks * s * m)
    return n * products, n * elementwise, nbytes


def config_forward_cost(cfg, n, esize):
    """:func:`forward_cost` or :func:`pirate_forward_cost` of the net that
    ``cfg`` names by ``"net"`` (``"fcnn"`` if it names none), at ``n``
    points. An FCNN reads ``n_input_units``, ``hidden_units`` and
    ``n_output_units``; a PirateNet ``n_input_units``,
    ``fourier_emb.embed_dim``, ``hidden_dim``, ``num_layers`` (its blocks)
    and ``n_output_units``; both ``activation`` and ``taylor_order``."""
    net, actv, order = cfg.get('net', 'fcnn'), cfg['activation'], cfg['taylor_order']
    if net == 'fcnn':
        dims = [cfg['n_input_units'], *cfg['hidden_units'], cfg['n_output_units']]
        return forward_cost(dims, actv, order, n, esize)
    if net == 'pirate':
        return pirate_forward_cost(cfg['n_input_units'], cfg['fourier_emb']['embed_dim'], cfg['hidden_dim'],
                                   cfg['num_layers'], cfg['n_output_units'], actv, order, n, esize)
    raise ValueError(f"no forward count for net {net!r}: cost.py counts 'fcnn' and 'pirate'")


def config_bound_seconds(cfg, n, esize):
    """The least seconds of one forward (:func:`config_forward_cost`)."""
    return bound_seconds(*config_forward_cost(cfg, n, esize), esize)[0]
