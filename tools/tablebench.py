#!/usr/bin/env python
"""QuotientTable insert decomposition — where does a table batch's time
go?

Times, amortized (async dispatches, one fence, null baseline subtracted):
  * full insert of one realistic deduped batch (the production shape);
  * the per-round claims sort alone (2 ops, full batch);
  * one scatter round alone (digits.add + keys.set + used.set);
  * insert round count for this batch (fill-driven);
  * insert at HALF batch rows (the n_unique prefix idea: the deduped
    batch is compacted, so rows beyond n_unique are dead weight).

Usage: python tools/tablebench.py [--k 14] [--l 26] [--reps 3]
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
    ap.add_argument("--l", type=int, default=26)
    ap.add_argument("--n", type=int, default=602112 * 16)
    ap.add_argument("--unique-frac", type=float, default=0.3,
                    help="fraction of rows valid+unique (real k=14 ~0.3)")
    ap.add_argument("--reps", type=int, default=3)
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

    from tsxcount_tpu.config import KmerSpec
    from tsxcount_tpu.core.table import QuotientTable, _triangular
    from tsxcount_tpu.ops.gf2 import GF2Hash

    spec = KmerSpec(args.k)
    table = QuotientTable(spec, args.l, GF2Hash(spec))
    n = args.n
    rng = np.random.default_rng(0)
    n_u = int(n * args.unique_frac)
    ukeys = np.zeros((n, spec.lanes), np.uint32)
    ukeys[:n_u] = rng.integers(0, 2**32, size=(n_u, spec.lanes),
                               dtype=np.uint32)
    ukeys[:n_u, -1] &= np.uint32(spec.top_lane_mask)
    ucounts = np.ones(n, np.int32)
    uvalid = np.arange(n) < n_u

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
    print(f"platform={jax.default_backend()} n={n} n_unique={n_u} "
          f"l={args.l} (null {base/args.reps*1e3:.2f} ms/call)")

    ukeys_d = jnp.asarray(ukeys)
    ucounts_d = jnp.asarray(ucounts)
    uvalid_d = jnp.asarray(uvalid)

    # NB: STANDALONE tiny jits over [slots, few] state arrays at l=26 can
    # make XLA pick a (8,128)-tiled layout (minor dim padded to 128 =
    # 25x inflation, 32 GiB, compile-time OOM).  Build ONE jit per
    # program and reuse it (each fresh jax.jit wrapper re-negotiates
    # layouts); bench the single-program insert only at l <= 24.
    from tests.test_table import _split_insert

    st = table.init_state()
    out = _split_insert(table, st, ukeys_d, ucounts_d, uvalid_d)
    fence(out.n)
    hist = np.asarray(jax.device_get(out.probe_hist))
    rounds = int(np.nonzero(hist)[0].max()) + 1 if hist.any() else 0
    print(f"  insert rounds used      : {rounds} "
          f"(hist head {hist[:8].tolist()})")

    def timed(label, fn, *fargs, reps=args.reps):
        fence(fn(*fargs))
        t0 = time.perf_counter()
        outs = [fn(*fargs) for _ in range(reps)]
        fence(outs[-1])
        dt = (time.perf_counter() - t0 - base) / reps
        print(f"  {label:24}: {dt*1e3:9.1f} ms")
        return dt

    # full insert into an EMPTY table each call (state not donated here so
    # the same input state can repeat)
    if args.l <= 24:
        timed("insert (empty table)",
              lambda: insert(st, ukeys_d, ucounts_d, uvalid_d))

    # the production path: host-driven split rounds at shrinking widths
    # + the residue loop, the way the counter drives it
    def split_insert():
        return _split_insert(table, st, ukeys_d, ucounts_d, uvalid_d).n

    timed("insert split-phase", split_insert)

    # claims sort alone at full width
    idx = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.asarray(rng.integers(0, table.slots, size=n, dtype=np.int64)
                      .astype(np.int32))
    ckey = jnp.where(uvalid_d, pos, table.slots).astype(jnp.uint32)
    timed("claims sort (2 ops)",
          jax.jit(lambda c, i: jax.lax.sort((c, i), num_keys=2)), ckey, idx)

    # flat element scatter/gather rounds (what residue_phase pays)
    cols = table.slot_cols
    vals_flat = jnp.asarray(
        rng.integers(0, 3, size=n * cols, dtype=np.uint32)
    )
    ecs = jnp.arange(cols, dtype=jnp.int32)

    def scatter_round(slots_flat, posx):
        safe = jnp.where(uvalid_d, posx, table.slots + idx)
        eidx = jnp.concatenate(
            [c * table.slots + safe for c in range(cols)]
        )
        res = slots_flat.at[eidx].add(
            vals_flat, mode="drop", unique_indices=True
        )
        return res[0]

    timed("scatter round (element)", jax.jit(scatter_round),
          out.slots, pos)

    def gather_round(slots_flat, posx):
        tot = jnp.zeros((), jnp.uint32)
        for c in range(cols):
            tot = tot + jnp.sum(
                jnp.take(slots_flat, c * table.slots + posx, mode="clip")
            )
        return tot

    timed("gather round (element)", jax.jit(gather_round),
          out.slots, pos)

    # insert with rows sliced to the unique prefix (half batch);
    # single-program insert only below the layout-hazard size
    if args.l <= 24:
        half = n // 2
        insert_half = jax.jit(
            lambda s: table.insert(s, ukeys_d[:half], ucounts_d[:half],
                                   uvalid_d[:half]).n
        )
        timed("insert (P/2 rows)", insert_half, st)
    return 0


if __name__ == "__main__":
    sys.exit(main())
