r"""Data parallelism over the collocation points (counterpart of
``neurodiffeq_tpu/parallel/``).

The scaling axis of a PINN workload is the number of collocation points per
batch. The JAX package shards that axis over a ``jax.sharding.Mesh`` from one
controller; PyTorch runs one process per rank. Every solver accepts
``mesh=`` (:func:`make_mesh`): each rank draws the same global batch from the
same generator state, evaluates its own contiguous block of rows, and the
solver combines the loss exactly and sums the parameter gradients over the
ranks in one ``all_reduce`` per optimizer step, so that every loss, metric
and gradient is the one the unsharded run computes.

For wide networks a second ``'model'`` mesh axis adds Megatron-style tensor
parallelism: pass ``make_mesh(model_axis_size=m)`` and each rank of a model
group evaluates its slice of every FCNN and SIREN layer pair (even layers
split output columns, odd layers input rows), with one ``all_reduce`` of
the partial Taylor streams per pair. Pairs after the first run on the
summed streams through their own kernel entry (``fcnn_taylor_streams``).
Each rank stores only its blocks of the split leaves, and so do the
gradients and the optimizer state (:func:`device_put_params`, the JAX
package's ``shard_params`` layout); solutions, saved files and checkpoints
hold the full-size tensors (:func:`full_state`), gathered on every rank.

Start the ranks with ``torchrun --nproc_per_node=N script.py`` (one per card
under NCCL) or from Python with :func:`launch`.
"""
from .launch import launch
from .sharding import (make_mesh, points_sharding, replicated_sharding, shard_points,
                       megatron_param_shardings, shard_params, device_put_params, full_state)

__all__ = ['make_mesh', 'points_sharding', 'replicated_sharding', 'shard_points',
           'megatron_param_shardings', 'shard_params', 'device_put_params', 'full_state', 'launch']
