#!/usr/bin/env python
"""Breakdown of the counting step's phases at bench shapes.

Timing is AMORTIZED: each phase dispatches `reps` asynchronous calls
back-to-back and fences once at the end (the device executes in order),
then subtracts a null-dispatch baseline, so per-call dispatch and fence
latency does not swamp the short phases.

Phases: H2D transfer, extract (cols / stacked), extract+sort,
extract+dedupe (per batch), merge_stacked (per R batches), and the
packer (host).  Guides optimization: run after changing the pipeline.
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
    ap.add_argument("--l", type=int, default=25)
    ap.add_argument("--batch-words", type=int, default=602112)
    ap.add_argument("--merge-every", type=int, default=2)
    ap.add_argument("--platform", default=None)
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from tsxcount_tpu.config import BatchSpec, KmerSpec
    from tsxcount_tpu.core.store import CountStore
    from tsxcount_tpu.ops.count import count_unique, pack_flag_key_cols
    from tsxcount_tpu.ops.window import (
        extract_kmer_cols,
        extract_kmers,
        intervals_to_valid,
    )

    spec = KmerSpec(args.k)
    batch = BatchSpec(spec, args.batch_words)
    store = CountStore(spec, capacity=1 << args.l)
    r = args.merge_every

    rng = np.random.default_rng(0)
    buf_np = np.full(batch.buf_words, 0xFFFFFFFF, dtype=np.uint32)
    buf_np[: batch.total_words] = rng.integers(
        0, 2**32, size=batch.total_words, dtype=np.uint32
    )
    buf_np[batch.capacity_words : batch.total_words] = 0
    # synthetic intervals: ~one valid run per 600 positions (bench-like)
    tw, m = batch.total_words, batch.max_intervals
    n_iv = max(1, min(m, batch.positions // 600))
    bounds = np.linspace(0, batch.positions, n_iv + 1, dtype=np.uint32)
    buf_np[tw : tw + n_iv] = bounds[:-1]
    buf_np[tw + m : tw + m + n_iv] = bounds[1:] - spec.k  # k-wide gaps

    def fence(x):
        leaves = jax.tree_util.tree_leaves(x)
        jax.device_get(leaves[0].ravel()[0])

    # null baseline: dispatch+fence cost of a trivial program
    null = jax.jit(lambda x: x + 1)
    z = jax.device_put(jnp.zeros((8,), jnp.int32))
    fence(null(z))
    t0 = time.perf_counter()
    outs = [null(z) for _ in range(args.reps)]
    fence(outs[-1])
    base = time.perf_counter() - t0
    print(f"{'null dispatch+fence':>22}: {base/args.reps*1e3:9.2f} ms "
          f"(subtracted below)")

    def timed(label, fn, *fargs, reps=args.reps):
        fence(fn(*fargs))
        t0 = time.perf_counter()
        outs = [fn(*fargs) for _ in range(reps)]
        fence(outs[-1])
        dt = (time.perf_counter() - t0 - base) / reps
        print(f"{label:>22}: {dt*1e3:9.1f} ms")
        return dt

    touch = jax.jit(lambda b: b[::65536].sum())
    fence(touch(jax.device_put(buf_np)))
    t0 = time.perf_counter()
    for _ in range(args.reps):
        fence(touch(jax.device_put(buf_np)))
    print(f"{'h2d+touch':>22}: "
          f"{(time.perf_counter()-t0)/args.reps*1e3:9.1f} ms "
          f"({buf_np.nbytes/2**20:.1f} MiB)")

    buf = jax.device_put(buf_np)
    timed("extract cols", jax.jit(
        lambda b: [c.sum() for c in
                   extract_kmer_cols(b[: batch.total_words], batch)]), buf)
    timed("extract stacked", jax.jit(
        lambda b: extract_kmers(b[: batch.total_words], batch)), buf)
    timed("intervals_to_valid", jax.jit(
        lambda b: intervals_to_valid(b[batch.total_words :], batch)), buf)

    def sort_only(b):
        cols = extract_kmer_cols(b[: batch.total_words], batch)
        valid = intervals_to_valid(b[batch.total_words :], batch)
        ops = pack_flag_key_cols(cols, ~valid, spec)
        return jax.lax.sort(ops, num_keys=len(ops))

    timed("extract+sort", jax.jit(sort_only), buf)

    def dedupe_fn(b):
        cols = extract_kmer_cols(b[: batch.total_words], batch)
        valid = intervals_to_valid(b[batch.total_words :], batch)
        return count_unique(cols, valid, spec=spec)

    dedupe = jax.jit(dedupe_fn)
    uc = dedupe(buf)
    timed("extract+dedupe", dedupe, buf)

    k_s = jnp.stack([uc.keys] * r)
    c_s = jnp.stack([uc.counts] * r)
    v_s = jnp.stack([uc.valid] * r)
    # merge timing mirrors production EXACTLY: one merge per dispatch,
    # state DONATED and threaded through sequential python-level calls of
    # ONE reused jit.  (The previous in-program chain of 4 merges hit the
    # documented (8,128)-layout trap — a 16x-padded copy of [2^l, lanes]
    # keys, 16 GB at k=127 l=25 — exactly the "one jit per program,
    # reused" rule this tool exists to police.)
    for tag in ("merge_stacked",):
        def merge_1(state, k, c, v):
            return store.merge_stacked(state, k, c, v)

        merge = jax.jit(merge_1, donate_argnums=(0,))

        state = merge(store.init_state(), k_s, c_s, v_s)  # warm compile
        fence(state)
        t0 = time.perf_counter()
        for _ in range(args.reps):
            state = merge(state, k_s, c_s, v_s)
        fence(state)
        dt = (time.perf_counter() - t0 - base) / args.reps
        print(f"{f'merge R={r} {tag}':>22}: {dt*1e3:9.1f} ms")
        del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
