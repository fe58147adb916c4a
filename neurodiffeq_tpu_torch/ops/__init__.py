"""Batched Taylor-mode series propagation and the fused Taylor-MLP kernel.

The public surface of the JAX package's ``ops``: the Taylor engine
(:mod:`.taylor`) and the kernel's switch and JAX-convention entry
(:mod:`.taylor_mlp`).
"""
from .taylor import TSeries, TContext, teval, elementwise_series, constant_series
from .taylor_mlp import enable_pallas, disable_pallas, pallas_enabled, pallas_config, fcnn_taylor_pallas

__all__ = ['TSeries', 'TContext', 'teval', 'elementwise_series', 'constant_series',
           'enable_pallas', 'disable_pallas', 'pallas_enabled', 'fcnn_taylor_pallas', 'pallas_config']
