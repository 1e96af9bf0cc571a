#!/usr/bin/env python
"""Amortized phase breakdown of the SHARDED counter at --shards 1 vs the
plain single-device pipeline on the same data (k=14 hp-off, 2
batches/pass).

Times, amortized like tools/stepbench.py (async back-to-back dispatches,
one fence, null dispatch baseline subtracted):
  * single-chip _dedupe       (extract -> count_unique)
  * sharded _step             (extract -> dedupe -> slice -> exchange)
  * single-chip _merge chain  (fold R=2 stacked batch histograms)
  * sharded _merge chain      (fold R=2 received run groups)

Usage: python tools/shardstep_bench.py [--reps 6] [--platform cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=14)
    ap.add_argument("--l", type=int, default=24)
    ap.add_argument("--batch-words", type=int, default=602112)
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from tsxcount_tpu.core.counter import KmerCounter
    from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

    single = KmerCounter(k=args.k, l=args.l, batch_words=args.batch_words,
                         merge_every=2, collapse_homopolymers=False,
                         read_len_hint=384)
    shard = ShardedKmerCounter(k=args.k, n_shards=1, l=args.l,
                               batch_words=args.batch_words, merge_every=2,
                               collapse_homopolymers=False,
                               read_len_hint=384)
    batch = single.batch
    spec = single.spec

    rng = np.random.default_rng(0)
    buf_np = np.zeros(batch.buf_words, dtype=np.uint32)
    buf_np[: batch.capacity_words] = rng.integers(
        0, 2**32, size=batch.capacity_words, dtype=np.uint32
    )
    tw, m = batch.total_words, batch.max_intervals
    n_iv = max(1, min(m, batch.positions // 600))
    bounds = np.linspace(0, batch.positions, n_iv + 1, dtype=np.uint32)
    buf_np[tw : tw + n_iv] = bounds[:-1]
    buf_np[tw + m : tw + m + n_iv] = bounds[1:] - spec.k

    def fence(x):
        leaves = jax.tree_util.tree_leaves(x)
        jax.device_get(leaves[0].ravel()[0])

    null = jax.jit(lambda x: x + 1)
    z = jax.device_put(jnp.zeros((8,), jnp.int32))
    fence(null(z))
    t0 = time.perf_counter()
    outs = [null(z) for _ in range(args.reps)]
    fence(outs[-1])
    base = time.perf_counter() - t0
    print(f"{'null dispatch+fence':>24}: {base/args.reps*1e3:9.2f} ms")

    def timed(label, fn, *fargs, reps=args.reps):
        fence(fn(*fargs))
        t0 = time.perf_counter()
        outs = [fn(*fargs) for _ in range(reps)]
        fence(outs[-1])
        dt = (time.perf_counter() - t0 - base) / reps
        print(f"{label:>24}: {dt*1e3:9.1f} ms")
        return dt

    buf = jax.device_put(buf_np)
    timed("single _dedupe", single._dedupe, buf)

    sbuf = shard._to_global(buf_np[None, :])
    recv_keys, recv_counts, recv_lens, spill = shard._step(sbuf)
    timed("sharded _step", shard._step, sbuf)

    # merge chains: donation consumes the state, so fold back-to-back and
    # fence once — exactly the shape of the real per-pass merge work
    k1, c1, v1 = single._dedupe(buf)
    ks = jnp.stack([k1, k1])
    cs = jnp.stack([c1, c1])
    vs = jnp.stack([v1, v1])

    def single_chain(reps):
        st = single.store.init_state()
        fence(st.n)
        t0 = time.perf_counter()
        for _ in range(reps):
            st = single._merge(st, ks, cs, vs)
        fence(st.n)
        return (time.perf_counter() - t0 - base) / reps

    print(f"{'single _merge R=2':>24}: {single_chain(args.reps)*1e3:9.1f} ms")

    def shard_chain(reps):
        st = shard._init_state()
        fence(jax.tree_util.tree_leaves(st)[0])
        t0 = time.perf_counter()
        for _ in range(reps):
            st = shard._merge(st, [recv_keys, recv_keys],
                              [recv_counts, recv_counts],
                              [recv_lens, recv_lens])
        fence(jax.tree_util.tree_leaves(st)[0])
        return (time.perf_counter() - t0 - base) / reps

    print(f"{'sharded _merge R=2':>24}: {shard_chain(args.reps)*1e3:9.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
