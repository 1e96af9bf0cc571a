#!/usr/bin/env python
"""Microbenchmarks of the primitives the counting pipeline is built from.

Measures device time (steady state, after one warmup) for:
  sort1/sort2/sort6  — lax.sort with 1/2/6 uint32 operands
  gather             — random 32-bit gather
  cumsum             — int32 prefix sum
  scatter_add        — .at[].add (for comparison; the hot path avoids it)
  extract            — window extraction network
  gf2                — GF(2) hash via int8 matmul (k=14)

Usage: python tools/microbench.py [--n 16777216] [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def _force(out):
    """Force completion with a scalar readback of a value that depends
    on the whole result."""
    import jax

    leaves = jax.tree_util.tree_leaves(out)
    return jax.device_get(leaves[0].ravel()[0])


def timeit(fn, *args, reps=3):
    _force(fn(*args))  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(reps):
        _force(fn(*args))
    return (time.perf_counter() - t0) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp
    import numpy as np

    n = args.n
    rng = np.random.default_rng(0)
    keys = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    keys2 = jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
    vals = jnp.asarray(rng.integers(0, 2**31, size=n, dtype=np.int32))
    idx = jnp.asarray(rng.integers(0, n, size=n, dtype=np.int32))

    results = {}

    results["sort1"] = timeit(
        jax.jit(lambda k: jax.lax.sort((k,), num_keys=1)), keys
    )
    results["sort2"] = timeit(
        jax.jit(lambda a, b: jax.lax.sort((a, b), num_keys=1)), keys, keys2
    )
    results["sort6"] = timeit(
        jax.jit(lambda a, b: jax.lax.sort(
            (a, b, b, b, b, b), num_keys=2)), keys, keys2
    )
    results["gather"] = timeit(
        jax.jit(lambda v, i: v[i]), vals, idx
    )
    idx_mono = jnp.asarray(np.sort(np.asarray(idx)))
    results["gather_mono"] = timeit(
        jax.jit(lambda v, i: v[i]), vals, idx_mono
    )
    vals2d = jnp.asarray(
        rng.integers(0, 2**31, size=(n // 8, 8), dtype=np.int32)
    )
    idx_rows = jnp.asarray(
        np.sort(rng.integers(0, n // 8, size=n // 8, dtype=np.int32))
    )
    results["gather_rows8"] = timeit(
        jax.jit(lambda v, i: v[i]), vals2d, idx_rows
    )
    host_buf = np.asarray(rng.integers(0, 2**32, size=n // 8, dtype=np.uint32))
    results["h2d_8MB"] = timeit(lambda b: jnp.asarray(b) + 1, host_buf)
    results["cumsum"] = timeit(
        jax.jit(lambda v: jnp.cumsum(v & 1)), vals
    )
    results["scatter_add"] = timeit(
        jax.jit(lambda v, i: jnp.zeros((n,), jnp.int32).at[i].add(v)),
        vals, idx,
    )

    from tsxcount_tpu.config import BatchSpec, KmerSpec
    from tsxcount_tpu.ops.gf2 import GF2Hash
    from tsxcount_tpu.ops.window import extract_kmers

    spec = KmerSpec(14)
    batch = BatchSpec(spec, capacity_words=n // 16)
    words = jnp.asarray(
        rng.integers(0, 2**32, size=batch.total_words, dtype=np.uint32)
    )
    results["extract"] = timeit(
        jax.jit(lambda w: extract_kmers(w, batch)), words
    )
    h = GF2Hash(spec)
    km = jnp.asarray(
        rng.integers(0, 2**28, size=(n, 1), dtype=np.uint32)
    )
    results["gf2"] = timeit(jax.jit(h.apply), km)

    print(f"platform={jax.default_backend()} n={n}")
    for name, dt in results.items():
        print(f"{name:>12}: {dt*1e3:9.2f} ms  {n/dt/1e6:10.1f} Melem/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
