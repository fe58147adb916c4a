"""Batched Taylor-mode series propagation and the fused Taylor-MLP kernel."""
