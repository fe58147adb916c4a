"""The frozen cost model against hand counts at the cells' shapes, and the
metric arithmetic on synthetic inputs."""
import re

import pytest

from portbench import cost, devtrace, harness, stats

CAVITY = [2, 128, 128, 128, 128, 128, 3]
LAPLACE = [2, 512, 1]


def hand_count(dims, n):
    """Per point, order 2 along d = 2 axes (S = 5 streams), tanh (1 + 4 per unit)."""
    if dims == CAVITY:
        products = 2 * 2 * 128 + 4 * (2 * 5 * 128 * 128) + 2 * 5 * 128 * 3  # 659,712
        elementwise = 128 * (5 + 2 + 2 * 2) + 4 * 128 * (5 + 5 * 2)  # 9,088
        params = (2 * 128 + 128) + 4 * (128 * 128 + 128) + (128 * 3 + 3)  # 66,819
        outputs = 3
    else:
        products = 2 * 2 * 512 + 2 * 5 * 512  # 7,168
        elementwise = 512 * (5 + 2 + 2 * 2)  # 5,632
        params = 2 * 512 + 512 + 512 + 1  # 2,049
        outputs = 1
    return n * products, n * elementwise, 4 * (2 * n + params + 5 * outputs * n)


@pytest.mark.parametrize('dims, n', [(CAVITY, 131072), (CAVITY, 1048576), (LAPLACE, 65536), (LAPLACE, 4194304)])
def test_forward_cost_matches_hand_counts(dims, n):
    assert cost.forward_cost(dims, 'tanh', 2, n, 4) == hand_count(dims, n)


@pytest.mark.parametrize('dims, n, want_ms', [(CAVITY, 131072, 0.5418), (CAVITY, 1048576, 4.3347),
                                              (LAPLACE, 65536, 0.008356), (LAPLACE, 4194304, 0.5348)])
def test_bound_is_products_on_tensor_cores_and_the_rest_on_cuda_cores(dims, n, want_ms):
    products, elementwise, nbytes = hand_count(dims, n)
    t, by = cost.bound_seconds(products, elementwise, nbytes, 4)
    assert by == 'operations'
    assert t == pytest.approx(products / (495e12 / 3) + elementwise / 67e12)
    assert t * 1e3 == pytest.approx(want_ms, rel=1e-3)
    cfg = {'n_input_units': dims[0], 'hidden_units': dims[1:-1], 'n_output_units': dims[-1], 'activation': 'tanh',
           'taylor_order': 2}
    assert cost.config_bound_seconds(cfg, n, 4) == t


def test_bytes_bound_a_wide_output():
    # no hidden layer, many outputs: the S output streams dominate
    products, elementwise, nbytes = cost.forward_cost([2, 4096], 'tanh', 2, 1 << 20, 4)
    assert elementwise == 0 and products == (1 << 20) * 2 * 2 * 4096
    t, by = cost.bound_seconds(products, elementwise, nbytes, 4)
    assert by == 'bytes' and t == pytest.approx(nbytes / 3.35e12)


def pirate_hand_count(n):
    """PirateNet, d = 2, m = h = 8, 2 blocks, 3 outputs, tanh (1 + 4), order 2 (S = 5), per point."""
    products = (2 * 2 * 4  # the embedding x B, B 2 x 4: 16
                + 2 * (2 * 5 * 8 * 8)  # U and V: 1,280
                + 2 * 3 * (2 * 5 * 8 * 8)  # W_1, W_2, W_3 of each block: 3,840
                + 2 * 5 * 8 * 3)  # the output: 240; 5,376 in all
    act = 5 + 5 * 2  # tanh's value and chain rule, and the tangent updates at order 2
    elementwise = (4 * (2 + 2 * 2 + 3 * 2)  # cos and sin of 4 frequencies with their chain rule: 48
                   + 2 * 8 * act  # U and V: 240
                   + 5 * 8  # U - V on the five streams: 40
                   + 2 * ((8 + 8 + 8) * act  # f, g and h: 360
                          + 2 * 8 * ((1 + 3 * 2 + 5 * 2) + 5)  # two gate mixes, Leibniz and the sum: 352
                          + 8 * 3 * 5))  # the residual mix: 120; 1,992 in all
    params = 2 * 4 + 2 * (8 * 8 + 8 + 8) + 2 * (3 * (8 * 8 + 8 + 8) + 1) + (8 * 3 + 3 + 3)  # 680
    return n * products, n * elementwise, 4 * (2 * n + params + 5 * 3 * n)


@pytest.mark.parametrize('n', [1, 256, 65536])
def test_pirate_forward_cost_matches_a_hand_count(n):
    assert pirate_hand_count(1) == (5376, 1992, 4 * (2 + 680 + 15))
    assert cost.pirate_forward_cost(2, 8, 8, 2, 3, 'tanh', 2, n, 4) == pirate_hand_count(n)


def test_pirate_forward_cost_at_the_published_size_follows_its_formula():
    # the paper's cavity net: d = 2, m = h = 256, 3 blocks, 3 outputs, order 2, 65,536 points
    d, m, h, L, n_out, n = 2, 256, 256, 3, 3, 65536
    s, unit = 1 + 2 * d, 5 + 5 * d
    products = 2 * d * (m // 2) + 2 * s * (2 * m * h + L * (2 * m * h + h * h) + m * n_out)
    elementwise = ((m // 2) * (2 + 2 * d + 3 * d) + (2 + 2 * L) * h * unit + L * m * unit + s * h
                   + 2 * L * h * (1 + 3 * d + 5 * d + s) + 3 * L * s * m)
    assert products == 7217152  # about 7.2 M a point
    got = cost.pirate_forward_cost(d, m, h, L, n_out, 'tanh', 2, n, 4)
    assert got[:2] == (n * products, n * elementwise)
    t, by = cost.bound_seconds(*got, 4)
    assert by == 'operations' and t * 1e3 == pytest.approx(2.955, rel=1e-3)  # about 2.9 ms a forward
    cfg = {'net': 'pirate', 'n_input_units': d, 'fourier_emb': {'embed_dim': m, 'embed_scale': 1.0},
           'hidden_dim': h, 'num_layers': L, 'n_output_units': n_out, 'activation': 'tanh', 'taylor_order': 2}
    assert cost.config_forward_cost(cfg, n, 4) == got and cost.config_bound_seconds(cfg, n, 4) == t
    # order 1: S = 3, no second-order terms
    s1, unit1 = 1 + d, 5 + d
    e1 = ((m // 2) * (2 + 2 * d) + (2 + 2 * L) * h * unit1 + L * m * unit1 + s1 * h
          + 2 * L * h * (1 + 3 * d + s1) + 3 * L * s1 * m)
    assert cost.pirate_forward_cost(d, m, h, L, n_out, 'tanh', 1, 1, 4)[1] == e1


def test_a_net_without_a_count_raises():
    with pytest.raises(ValueError, match='no forward count'):
        cost.config_forward_cost({'net': 'siren', 'activation': 'sin', 'taylor_order': 2}, 1, 4)


def test_peaks_are_the_published_h100_sxm_figures():
    assert cost.PEAK_FLOPS[4] == 67e12 and cost.PEAK_MMA[4] == pytest.approx(165e12)
    assert cost.PEAK_BYTES == 3.35e12 and cost.PEAK_MMA[8] == 67e12


def slice_of(kernels, lo=0.0, hi=10.0, steps=2, backward_s=0.0, bound=1.0, patterns=('taylor',)):
    return devtrace.Slice(steps=steps, lo=lo, hi=hi, kernels=kernels,
                          backward_s=backward_s, forward_bound_s=bound,
                          forward_patterns=[re.compile(p) for p in patterns])


def reader(name):
    return harness.load_module(harness.HERE / 'metrics' / f'{name}.py')


def test_idle_share_counts_overlapping_kernels_once():
    # 0-2 and 1-3 overlap (busy 0-3), 5-6 alone, 9-12 half outside the slice [0, 10]
    s = slice_of([('a', 0.0, 2.0), ('b', 1.0, 3.0), ('c', 5.0, 6.0), ('d', 9.0, 12.0)])
    assert s.busy_s() == pytest.approx(3.0 + 1.0 + 1.0)
    assert reader('device_idle_pct.train').read(s) == pytest.approx(50.0)
    assert stats.gaps([(0, 2), (1, 3), (5, 6), (9, 12)], 0, 10) == [(6, 9), (3, 5)]


def test_idle_reader_finds_nothing_without_device_operations():
    assert reader('device_idle_pct.eval').read(slice_of([])) is None


def test_p95_is_over_every_sample_not_over_chunk_medians():
    samples = [10.0] * 90 + [100.0] * 10  # 10% of the epochs stall
    assert stats.percentile(samples, 95) == pytest.approx(100.0)
    chunk_medians = [stats.percentile(samples[i:i + 10], 50) for i in range(0, 100, 10)]
    assert stats.percentile(chunk_medians, 95) < 60.0  # what a p95 of medians would hide
    assert stats.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)  # numpy's linear rule


def test_rate_is_over_the_whole_window_with_its_stall():
    times = [0.01] * 99 + [1.0]  # a one-second stall
    assert stats.rate(100 * 1000, sum(times)) == pytest.approx(100000 / 1.99)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_roofline_and_mfu_readers():
    # two epochs, forward kernels 4 s in all: 2 s each against a 1 s bound
    s = slice_of([('taylor_mlp_kernel', 0.0, 3.0), ('taylor_mlp_kernel', 5.0, 6.0), ('gemm', 6.0, 8.0)],
                 backward_s=4.0)
    assert reader('fwd_roofline_pct.train').read(s) == pytest.approx(50.0)
    assert reader('step_mfu_pct.train').read(s) == pytest.approx(100 * 3 * 2 / 10)
    assert reader('request_mfu_pct.eval').read(s) == pytest.approx(100 * 2 / 10)
    assert reader('backward_ms_per_epoch.train').read(s) == pytest.approx(2000.0)
    assert reader('launches_per_epoch.train').read(s) == pytest.approx(1.5)
    assert reader('fwd_roofline_pct.eval').read(slice_of([('gemm', 0.0, 1.0)])) is None
    assert reader('backward_ms_per_epoch.train').read(slice_of([('gemm', 0.0, 1.0)])) is None


def event(name, start, end, device=False, parent=None, device_total=0.0, annotation=False):
    from types import SimpleNamespace
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                           device_type=SimpleNamespace(name='CUDA' if device else 'CPU'),
                           device_time_total=device_total, is_user_annotation=annotation)


def test_reduce_events_counts_outermost_backward_and_skips_annotations():
    sl = event(devtrace.SLICE_RANGE, 100.0, 900.0)
    bw = event('autograd::engine::evaluate_function: PythonBackward', 200.0, 400.0, device_total=150.0)
    inner = event('autograd::engine::evaluate_function: MmBackward0', 250.0, 300.0, parent=bw, device_total=40.0)
    op = event('aten::mul', 500.0, 510.0, parent=sl)
    events = [sl, bw, inner, op,
              event('taylor_mlp_kernel', 120.0, 180.0, device=True),
              event(devtrace.SLICE_RANGE, 100.0, 900.0, device=True, annotation=True),
              event('Optimizer.step#Adam.step', 600.0, 700.0, device=True, annotation=True)]
    lo, hi, kernels, backward_s, host_ops = devtrace.reduce_events(events)
    assert (lo, hi) == pytest.approx((100e-6, 900e-6))
    assert kernels == [('taylor_mlp_kernel', pytest.approx(120e-6), pytest.approx(180e-6))]
    assert backward_s == pytest.approx(150e-6)  # the nested range is inside the outer one's total
    assert [name for name, _, _ in host_ops] == [bw.name, 'aten::mul']


def test_breakdown_names_the_host_op_under_each_idle_stretch():
    s = slice_of([('k', 0.0, 4.0), ('k', 6.0, 10.0)], patterns=())
    s.host_ops = [('aten::item', 3.5, 6.5)]
    b = s.breakdown()
    assert b['device_ops'] == [['k', pytest.approx(8.0)]]
    assert b['idle_gaps'] == [['aten::item', pytest.approx(2.0)]]


def test_ks_statistics_against_hand_values():
    import torch
    n = 400
    even = (torch.arange(n, dtype=torch.float64) + 0.5) / n  # every gap 0.5 / n
    assert stats.ks_uniform(even) == pytest.approx(0.5 / n * n ** 0.5)
    assert stats.ks_uniform(torch.zeros(n)) == pytest.approx(n ** 0.5)
    grid = torch.linspace(0, 1, 101, dtype=torch.float64)
    assert stats.ks_on_grid(even, lambda x: x, grid) == pytest.approx(0.0, abs=1e-12)  # read at grid's points alone
    assert stats.ks_on_grid(even, lambda x: x, grid + 0.1 / n) == pytest.approx(0.1 / n * n ** 0.5)
    assert stats.ks_on_grid(even * 0.5, lambda x: x, grid) == pytest.approx(0.5 * n ** 0.5)


@pytest.mark.parametrize('law, node', [
    ('Generator1D.uniform', {'class': 'Generator1D', 'size': 4096, 't_min': -1.0, 't_max': 3.0, 'method': 'uniform'}),
    ('Generator2D.equally-spaced-noisy', {'class': 'Generator2D', 'grid': [48, 64], 'xy_min': [0.0, -2.0],
                                          'xy_max': [1.0, 2.0], 'method': 'equally-spaced-noisy'})])
def test_a_law_passes_its_own_draws_and_fails_broken_ones(law, node):
    import torch
    mod = harness.load_module(harness.HERE / 'laws' / f'{law}.py')
    g = torch.Generator().manual_seed(7)
    if mod.COLUMNS == 1:
        a, b = node['t_min'], node['t_max']
        sound = [a + (b - a) * torch.rand(node['size'], generator=g, dtype=torch.float64) for _ in range(8)]
        sound = [(c,) for c in sound]
        broken = {'squeezed': (a + (b - a) * 0.5 * torch.rand(node['size'], generator=g),)}
    else:
        axes = [torch.linspace(lo, hi, n, dtype=torch.float64)
                for lo, hi, n in zip(node['xy_min'], node['xy_max'], node['grid'])]
        gx, gy = [t.flatten() for t in torch.meshgrid(*axes, indexing='ij')]
        sx, sy = [(hi - lo) / n / 4 for lo, hi, n in zip(node['xy_min'], node['xy_max'], node['grid'])]
        noisy = lambda k: (gx + k * sx * torch.randn(gx.shape, generator=g, dtype=torch.float64),
                           gy + k * sy * torch.randn(gy.shape, generator=g, dtype=torch.float64))
        sound = [noisy(1.0) for _ in range(8)]
        broken = {'no noise': (gx, gy), 'noise x3': noisy(3.0), 'half the grid': (gx[:gx.numel() // 2], gy[:gy.numel() // 2]),
                  'far outside': (gx + 11 * sx * (gx == gx.max()), gy)}
    for cols in sound:
        got = mod.check(node, cols)
        assert got['outside'] == 0 and got['law'] < 2.5, got
    for what, cols in broken.items():
        got = mod.check(node, cols)
        assert got['outside'] > 0 or got['law'] > 5, (what, got)
