#!/usr/bin/env python
"""lax.sort cost structure probe — guides the dedupe-sort optimization.

Measures, at batch-dedupe shape (default 9.6M rows):
  * lax.sort with q key operands (q = lanes+flag of each bench k);
  * the same rows as a BATCHED sort (B independent segments) — what a
    radix/bucket partition would buy before per-bucket sorting;
  * key-only sort vs keys+payload (movement cost per extra column).

Usage: python tools/sortbench.py [--n 9633792] [--reps 3] [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def fence(out):
    import jax

    leaves = jax.tree_util.tree_leaves(out)
    return jax.device_get(leaves[0].ravel()[0])


_BASE = 0.0  # null dispatch+fence latency, measured in main()


def timeit(fn, *args, reps=3):
    """Amortized: dispatch `reps` async calls, fence once, subtract the
    null baseline (dispatch and fence latency swamp single calls)."""
    fence(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    fence(outs[-1])
    return max(0.0, (time.perf_counter() - t0 - _BASE)) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=602112 * 16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--qs", default="1,2,4,8",
                    help="key-operand counts to probe (k=14/31/63/127)")
    ap.add_argument("--batches", default="1,16,64,256",
                    help="segment counts for the batched-sort probe")
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    n = args.n
    rng = np.random.default_rng(0)
    cols = [
        jnp.asarray(rng.integers(0, 2**32, size=n, dtype=np.uint32))
        for _ in range(max(int(q) for q in args.qs.split(",")))
    ]
    global _BASE
    null = jax.jit(lambda x: x + 1)
    z = jax.device_put(jnp.zeros((8,), jnp.int32))
    fence(null(z))
    t0 = time.perf_counter()
    outs = [null(z) for _ in range(args.reps)]
    fence(outs[-1])
    _BASE = time.perf_counter() - t0
    print(f"platform={jax.default_backend()} n={n} "
          f"(null baseline {_BASE/args.reps*1e3:.2f} ms/call)")

    for q in (int(x) for x in args.qs.split(",")):
        ops = tuple(cols[:q])
        dt = timeit(
            jax.jit(lambda *o, q=q: jax.lax.sort(o, num_keys=q)),
            *ops, reps=args.reps,
        )
        print(f"  sort q={q} keys          : {dt*1e3:9.1f} ms "
              f"{n/dt/1e6:8.1f} Melem/s")

    # key-width scaling: does the sort's cost track key BITS (radix)?
    for bits in (20, 28, 32):
        kcol = cols[0] >> jnp.uint32(32 - bits)
        dt = timeit(
            jax.jit(lambda c: jax.lax.sort((c,), num_keys=1)), kcol,
            reps=args.reps,
        )
        print(f"  sort q=1 {bits:>2}-bit keys  : {dt*1e3:9.1f} ms "
              f"{n/dt/1e6:8.1f} Melem/s")

    # payload scaling: 1 key + p payloads
    for p in (1, 3, 7):
        ops = tuple(cols[: 1 + p])
        dt = timeit(
            jax.jit(lambda *o: jax.lax.sort(o, num_keys=1)),
            *ops, reps=args.reps,
        )
        print(f"  sort 1 key + {p} payload : {dt*1e3:9.1f} ms "
              f"{n/dt/1e6:8.1f} Melem/s")

    # radix-on-hash probe (SURVEY §7 hard-part #1): same total column
    # width, but only the top 2 columns are comparator KEYS (uniform hash
    # prefix) and the rest ride as payload — vs all columns as keys
    # nk=2: GF(2) 64-bit hash prefix (top_lane flag shared); nk=3: cheap
    # mix prefix (standalone flag + mix_hi + mix_lo), payload = raw
    # lanes — the mix-first candidate shapes: k=31 -> 3/5, k=63 -> 3/7,
    # k=127 -> 3/11 vs the all-comparator 2/2, 4/4, 8/8
    for total in (3, 5, 7, 9, 11):
        for nk in (2, 3, total):
            ops = tuple(cols[:total])
            dt = timeit(
                jax.jit(lambda *o, nk=nk: jax.lax.sort(o, num_keys=nk)),
                *ops, reps=args.reps,
            )
            print(f"  sort {nk} keys /{total:2} cols    : {dt*1e3:9.1f} ms "
                  f"{n/dt/1e6:8.1f} Melem/s")

    # batched segment sort: same total rows, B independent segments
    for b in (int(x) for x in args.batches.split(",")):
        if n % b:
            continue
        seg = cols[0].reshape(b, n // b)
        dt = timeit(
            jax.jit(lambda s: jax.lax.sort(s, dimension=1)), seg,
            reps=args.reps,
        )
        print(f"  batched sort B={b:<4}     : {dt*1e3:9.1f} ms "
              f"{n/dt/1e6:8.1f} Melem/s")

    # batched segment sort WITH payload — the bucket-partition candidate:
    # B buckets of n/B rows, q columns total (nk comparator keys).  If the
    # per-row cost drops superlinearly with segment size, a linear radix
    # partition + batched per-bucket sort beats one flat lax.sort.
    for total, nk in ((3, 3), (5, 3), (9, 3), (9, 9)):
        for b in (int(x) for x in args.batches.split(",")):
            if n % b:
                continue
            segs = tuple(c.reshape(b, n // b) for c in cols[:total])
            dt = timeit(
                jax.jit(lambda *s, nk=nk: jax.lax.sort(
                    s, dimension=1, num_keys=nk)),
                *segs, reps=args.reps,
            )
            print(f"  batched {nk}k/{total}c B={b:<5}  : {dt*1e3:9.1f} ms "
                  f"{n/dt/1e6:8.1f} Melem/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
