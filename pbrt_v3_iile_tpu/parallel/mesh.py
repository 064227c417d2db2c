"""Device mesh construction and sharding helpers.

Replacement for the reference's thread-pool parallelism
(ref: src/core/parallel.cpp ParallelFor2D + the IILE ThreadPool,
tools/threadpool.h): work is sharded over a `jax.sharding.Mesh` with
axes
  "dp"   — data parallel (probe/training batches)
  "tile" — image-tile / ray-wavefront parallel (SURVEY P1)
The mesh follows the algorithm only: every GPU of a host reaches every
other at the same rate, so no axis is shaped by a topology.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_DP = "dp"
AXIS_TILE = "tile"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """2D (dp, tile) mesh over the available devices."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    tile = 1
    for cand in (4, 2):
        if n % cand == 0 and n >= cand:
            tile = cand
            break
    dp = n // tile
    arr = np.asarray(devices).reshape(dp, tile)
    return Mesh(arr, (AXIS_DP, AXIS_TILE))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(mesh: Mesh) -> NamedSharding:
    """Shard leading dim over every mesh axis (full data parallel)."""
    return NamedSharding(mesh, P((AXIS_DP, AXIS_TILE)))


def shard_rows(mesh: Mesh) -> NamedSharding:
    """Shard image rows over the tile axis."""
    return NamedSharding(mesh, P(AXIS_TILE))
