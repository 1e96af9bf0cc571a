"""Device mesh helpers for the sharded counter.

The reference's only scaling axis is OpenMP threads over cache-coherent
shared memory (reference src/mains/main.cpp:132-218); the equivalent here is
a flat 1-D `jax.sharding.Mesh` whose `shard` axis owns disjoint hash-prefix
ranges of the count table, with k-mers routed to owners by `all_to_all`
(SURVEY.md §2.3).  Every GPU of a host reaches every other at the same
rate, so the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

SHARD_AXIS = "shard"


def make_shard_mesh(n_shards: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    if n_shards > len(devices):
        raise ValueError(
            f"requested {n_shards} shards but only {len(devices)} devices"
        )
    return jax.make_mesh((n_shards,), (SHARD_AXIS,),
                         devices=devices[:n_shards])


def shard_leading(mesh: Mesh) -> NamedSharding:
    """Sharding that splits the leading axis across the shard axis."""
    return NamedSharding(mesh, PartitionSpec(SHARD_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
