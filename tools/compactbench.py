#!/usr/bin/env python
"""Stream-compaction forms, timed on the device at the dedupe batch size.

Moves the flagged rows of a batch to the front, in order, carrying C
uint32 columns along (the boundary-row compaction of ops/count.py and the
store merge).  Forms compared:

  sort          one lax.sort keyed on where(flag, position, P), columns
                riding as payload
  scatter       exclusive cumsum of the flags, then one scatter per column
                to unique destinations (dropped rows get out-of-range
                destinations)
  scatter_rows  the same, scattering one [P, C] row block
  pos_gather    one scatter of source positions, then one gather per column
                (ops/count.py compact_rows, the form the package uses)

Each form is checked against the sort form, then timed (median of --reps
calls, each ending in block_until_ready).  Prints one JSON line per
(columns, density, form), and writes them to --out when given.

Usage: python tools/compactbench.py [--p 9633792] [--reps 20]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tsxcount_tpu.ops.count import compact_rows  # noqa: E402


def compact_sort(flag, cols):
    p = flag.shape[0]
    key = jnp.where(flag, jnp.arange(p, dtype=jnp.int32), p)
    out = jax.lax.sort((key,) + tuple(cols), num_keys=1)
    return out[0], list(out[1:])


def _dst(flag):
    p = flag.shape[0]
    ar = jnp.arange(p, dtype=jnp.int32)
    csum = jnp.cumsum(flag.astype(jnp.int32)) - 1
    return ar, jnp.where(flag, csum, p + ar)


def compact_scatter(flag, cols):
    p = flag.shape[0]
    ar, dst = _dst(flag)
    put = lambda fill, c: fill.at[dst].set(
        c, mode="drop", unique_indices=True
    )
    pos = put(jnp.full((p,), p, jnp.int32), ar)
    return pos, [put(jnp.zeros_like(c), c) for c in cols]


def compact_scatter_rows(flag, cols):
    p = flag.shape[0]
    ar, dst = _dst(flag)
    pos = jnp.full((p,), p, jnp.int32).at[dst].set(
        ar, mode="drop", unique_indices=True
    )
    block = jnp.stack(cols, axis=1)
    out = jnp.zeros_like(block).at[dst].set(
        block, mode="drop", unique_indices=True
    )
    return pos, [out[:, j] for j in range(len(cols))]


FORMS = {
    "sort": compact_sort,
    "scatter": compact_scatter,
    "scatter_rows": compact_scatter_rows,
    "pos_gather": compact_rows,  # the package's form
}


def _time(fn, *args, reps):
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=602112 * 16)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--columns", default="1,8")
    ap.add_argument("--densities", default="0.5,0.95")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    rows = []
    for n_cols in (int(c) for c in args.columns.split(",")):
        cols = [
            jnp.asarray(rng.integers(0, 2**32, size=args.p, dtype=np.uint32))
            for _ in range(n_cols)
        ]
        for density in (float(d) for d in args.densities.split(",")):
            flag = jnp.asarray(rng.random(args.p) < density)
            n = int(jnp.sum(flag))
            ref_pos, ref_cols = jax.jit(compact_sort)(flag, cols)
            ref = [np.asarray(c)[:n] for c in [ref_pos] + ref_cols]
            for name, form in FORMS.items():
                fn = jax.jit(form)
                pos, out = fn(flag, cols)
                got = [np.asarray(c)[:n] for c in [pos] + out]
                exact = all(np.array_equal(a, b) for a, b in zip(got, ref))
                tail_ok = bool(np.all(np.asarray(pos)[n:] == args.p))
                med, best = _time(fn, flag, cols, reps=args.reps)
                row = {
                    "form": name, "p": args.p, "columns": n_cols,
                    "density": density, "exact": exact and tail_ok,
                    "median_ms": med * 1e3, "min_ms": best * 1e3,
                    "platform": dev.platform, "device_kind": dev.device_kind,
                }
                rows.append(row)
                print(json.dumps(row), flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0 if all(r["exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
