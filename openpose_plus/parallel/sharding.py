"""Device mesh construction and sharding rules.

Replacement for the reference's KungFu data-parallel layer
(train.py :: parallel_train + kungfu-run launcher [HIGH; empty mount —
SURVEY.md §2/§5]): instead of wrapping the optimizer in an all-reduce
(KungFu SynchronousSGDOptimizer over NCCL/TCP), the training step is
jit-compiled over a named mesh — batches sharded over the `data` axis,
params replicated — and XLA inserts the gradient all-reduce (NCCL
between GPUs).

A second optional `spatial` axis shards the image height dimension (XLA
GSPMD spatial partitioning of convolutions, with automatic halo exchange):
the answer for very high-res frames, and this framework's
beyond-DP parallelism axis. The reference has nothing comparable (its only
parallelism is DP; SURVEY.md §2 records this).
"""

from __future__ import annotations

from typing import Any, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from openpose_plus.config import ParallelConfig


def init_multihost(cfg: ParallelConfig) -> None:
    """Initialize the multi-host runtime (kungfu-run analogue; no-op on a
    single host)."""
    if cfg.multihost:
        jax.distributed.initialize()


def build_mesh(cfg: Optional[ParallelConfig] = None,
               devices: Optional[list] = None) -> Mesh:
    """(data, spatial) mesh over all (or the given) devices."""
    cfg = cfg or ParallelConfig()
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    sp = cfg.spatial_parallelism
    if n % sp != 0:
        raise ValueError(f"{n} devices not divisible by spatial={sp}")
    dev_array = np.asarray(devices).reshape(n // sp, sp)
    return Mesh(dev_array, (cfg.data_axis, cfg.spatial_axis))


def batch_sharding(mesh: Mesh, spatial: bool = True) -> NamedSharding:
    """Images (B, H, W, C): B over data, H over spatial (GSPMD halo
    exchange handles conv overlaps)."""
    cfg_axes = mesh.axis_names
    if spatial:
        return NamedSharding(mesh, P(cfg_axes[0], cfg_axes[1]))
    return NamedSharding(mesh, P(cfg_axes[0]))


def map_sharding(mesh: Mesh) -> NamedSharding:
    """Target/output maps (B, h, w, C): batch over data only (maps are 46x54
    — too small to shard spatially)."""
    return NamedSharding(mesh, P(mesh.axis_names[0]))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_params(params: Any, mesh: Mesh) -> Any:
    """Replicate the parameter pytree onto the mesh (reference: KungFu
    BroadcastGlobalVariablesOp at step 0)."""
    return jax.device_put(params, replicated(mesh))


def shard_batch(batch: Any, mesh: Mesh, spatial_leaves: tuple[str, ...] = ("images",)
                ) -> Any:
    """Place a dict batch: 4D image tensors get data(+spatial) sharding,
    everything else data-only."""
    out = {}
    for k, v in batch.items():
        if k in spatial_leaves and v.ndim == 4:
            out[k] = jax.device_put(v, batch_sharding(mesh))
        elif getattr(v, "ndim", 0) == 0:
            # rank-0 leaves (step counters, scalars) replicate — a
            # leading-dim PartitionSpec would be invalid for them
            out[k] = jax.device_put(v, replicated(mesh))
        else:
            out[k] = jax.device_put(v, map_sharding(mesh))
    return out


def process_local_slice(global_count: int) -> tuple[int, int]:
    """[start, stop) of this host's shard of a globally-indexed dataset
    (reference: dataset.shard(cluster_size, rank))."""
    n = jax.process_count()
    r = jax.process_index()
    per = (global_count + n - 1) // n
    lo = min(r * per, global_count)   # clamp: trailing ranks may be empty
    return lo, min(global_count, lo + per)
