#!/usr/bin/env python
"""Smoke test of the counting path on one GPU, end to end, at real size.

Phases (each prints one line; any failure exits non-zero):
  device      the JAX backend is a GPU; the native packer builds and loads
  fixture     the CLI (cli.main, in this process) counts the checked-in
              golden fixture three ways (--shards 1, --shards 0, --mode TSX)
              with --check: 0 mismatched, 0 missing, 0 extra
  primitives  the device primitives against their host forms at real widths:
              GF(2) hash and inverse, the ARX lane mix, count_unique on one
              full batch, one CountStore.merge_stacked at cap 2^26 + 2P
  M1..M4      four counting jobs through count_file, as the CLI builds them,
              each checked exactly against the host oracle below: window
              total, distinct keys, sum of all counts, and sampled counts of
              >= 100,000 present keys (the polyA k-mer among them) and 1,000
              absent keys; cold wall time, warm k-mers/s of a fresh-store
              pass, device peak memory
      M1  k=31, --shards 1 (sharded pipeline, n=1), l=28, 200,000 reads
      M2  k=31, --shards 0 (plain counter), l=28, 200,000 reads, with
          bench.py's batch (602112 words, merge every 2): the LSM cascade
      M3  k=127, --shards 1, l=26, 50,000 reads (the 8-lane path)
      M4  k=31, --mode TSX (quotient table), l=27, 50,000 reads

Reads come from bench.py's generator (500-1000 bp plus a 100-300 bp polyA
tail, seed 42).  Generated inputs and oracle summaries are cached under
.smoke_data/.  The host oracle imports numpy only, never the package.

Usage:
  python chip_smoke.py              one GPU: every phase above
  python chip_smoke.py --devices 4  four GPUs: the device phase, then M1
                                    sharded four ways (all_to_all routing)
  python chip_smoke.py --rehearse   tiny sizes on any backend (a CPU
                                    rehearsal; the sizes are not real)

Before the last line it prints the card's name and power limit as
nvidia-smi gives them; the last line is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DATA = ROOT / ".smoke_data"
FIXTURE = ROOT / "tests" / "data" / "golden.1000.fastq"


# --- host oracle (numpy only) ------------------------------------------------

_CODES = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODES[_c] = _CODES[_c + 32] = _i  # upper and lower case
_BASES = np.frombuffer(b"ACGT", np.uint8)


def read_fastq_codes(path) -> tuple[np.ndarray, np.ndarray]:
    """(codes uint8 [bases], read_starts int64 [reads + 1]) of a FASTQ file:
    every read's sequence line, concatenated; 0-3 = ACGT, 4 = other."""
    buf = np.fromfile(path, np.uint8)
    nl = np.flatnonzero(buf == 10)
    line_start = np.concatenate([[0], nl[:-1] + 1])
    starts, ends = line_start[1::4], nl[1::4]  # line 2 of each record
    edge = np.zeros(len(buf) + 1, np.int8)
    edge[starts] += 1
    edge[ends] -= 1
    seq = buf[np.cumsum(edge[:-1], dtype=np.int8).astype(bool)]
    read_starts = np.concatenate([[0], np.cumsum(ends - starts)])
    return _CODES[seq], read_starts


def window_starts(codes: np.ndarray, read_starts: np.ndarray,
                  k: int) -> np.ndarray:
    """Start of every k-window that lies inside one read and holds only
    ACGT (the counter's n_policy='drop' semantics)."""
    bad = np.concatenate([[0], np.cumsum(codes > 3, dtype=np.int64)])
    per_read = np.maximum(np.diff(read_starts) - k + 1, 0)
    first = np.cumsum(per_read) - per_read
    s = (np.repeat(read_starts[:-1], per_read)
         + np.arange(per_read.sum()) - np.repeat(first, per_read))
    return s[bad[s + k] == bad[s]]


def packed32(codes: np.ndarray) -> np.ndarray:
    """uint64 [bases]: bases s..s+31 packed 2 bits each, base s in the top
    bits (zeros past the end)."""
    w = (codes & 3).astype(np.uint64)
    span = 1
    while span < 32:
        nxt = np.zeros_like(w)
        nxt[: len(w) - span] = w[span:]
        w = (w << np.uint64(2 * span)) | nxt
        span *= 2
    return w


def _decode_packed(keys: np.ndarray, k: int) -> list[str]:
    """k <= 32 packed keys (base 0 in the top bits) -> strings."""
    shifts = np.uint64(2) * np.arange(k - 1, -1, -1, dtype=np.uint64)
    codes = (keys[:, None] >> shifts[None, :]) & np.uint64(3)
    blob = _BASES[codes.astype(np.uint8)].tobytes().decode()
    return [blob[i * k : (i + 1) * k] for i in range(len(keys))]


def _fingerprint(lanes: list[np.ndarray]) -> np.ndarray:
    h = np.full(len(lanes[0]), 0x9E3779B97F4A7C15, np.uint64)
    with np.errstate(over="ignore"):
        for x in lanes:
            h = (h ^ x) * np.uint64(0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(31)
            h = h * np.uint64(0x94D049BB133111EB)
            h ^= h >> np.uint64(29)
    return h


def _lanes(w32: np.ndarray, s: np.ndarray, k: int) -> list[np.ndarray]:
    """Exact 2k-bit keys of the windows at s, as ceil(k/32) uint64 lanes."""
    n = -(-k // 32)
    out = [w32[s + 32 * j] for j in range(n)]
    out[-1] = out[-1] >> np.uint64(2 * (32 * n - k))
    return out


@dataclasses.dataclass
class Oracle:
    n_windows: int
    distinct: int
    present: list          # sampled stored k-mers (polyA first)
    present_counts: list   # their exact counts
    absent: list           # k-mers that occur nowhere in the input


def host_oracle(path, k: int, n_present: int, n_absent: int,
                seed: int = 1) -> Oracle:
    """Exact k-mer statistics of a FASTQ file.  k <= 32: packed uint64 keys
    and np.unique.  Wider k: exact multi-lane keys grouped by a 64-bit
    fingerprint; rows that share a fingerprint are checked to share every
    lane, so a fingerprint collision raises instead of merging keys."""
    rng = np.random.default_rng(seed)
    codes, read_starts = read_fastq_codes(path)
    starts = window_starts(codes, read_starts, k)
    w32 = packed32(codes)
    poly_a = "A" * k
    if k <= 32:
        uniq, counts = np.unique(_lanes(w32, starts, k)[0],
                                 return_counts=True)
        del w32
        pick = rng.choice(len(uniq), size=min(n_present, len(uniq)),
                          replace=False)
        pick = np.concatenate([[np.searchsorted(uniq, 0)], pick])
        if uniq[pick[0]] != 0:
            raise AssertionError("the input holds no polyA k-mer")
        present = _decode_packed(uniq[pick], k)
        present_counts = counts[pick]
        cand = rng.integers(0, 2 ** (2 * k), size=4 * n_absent + 64,
                            dtype=np.uint64)
        pos = np.minimum(np.searchsorted(uniq, cand), len(uniq) - 1)
        absent = _decode_packed(cand[uniq[pos] != cand][:n_absent], k)
        return Oracle(len(starts), len(uniq), present,
                      [int(c) for c in present_counts], absent)

    lanes = _lanes(w32, starts, k)
    del w32
    fp = _fingerprint(lanes)
    order = np.argsort(fp)
    fps = fp[order]
    same = fps[1:] == fps[:-1]
    for lane in lanes:
        ls = lane[order]
        if np.any(same & (ls[1:] != ls[:-1])):
            raise AssertionError("64-bit fingerprint collision")
    head = np.flatnonzero(np.concatenate([[True], ~same]))
    group_counts = np.diff(np.append(head, len(fps)))
    pick = rng.choice(len(head), size=min(n_present, len(head)),
                      replace=False)
    zero = _fingerprint([np.zeros(1, np.uint64)] * len(lanes))[0]
    g_poly = np.searchsorted(fps[head], zero)
    if g_poly >= len(head) or fps[head[g_poly]] != zero:
        raise AssertionError("the input holds no polyA k-mer")
    pick = np.concatenate([[g_poly], pick])
    win = starts[order[head[pick]]]
    chars = _BASES[codes[win[:, None] + np.arange(k)]].tobytes().decode()
    present = [chars[i * k : (i + 1) * k] for i in range(len(win))]
    if present[0] != poly_a:
        raise AssertionError("polyA fingerprint names another k-mer")
    rand = rng.integers(0, 4, size=(n_absent, k), dtype=np.uint8)
    rand_w = packed32(rand.reshape(-1))
    rlanes = _lanes(rand_w, np.arange(n_absent) * k, k)
    rfp = _fingerprint(rlanes)
    hit = np.isin(rfp, fps)
    absent_chars = _BASES[rand[~hit]].tobytes().decode()
    absent = [absent_chars[i * k : (i + 1) * k]
              for i in range(int((~hit).sum()))]
    return Oracle(len(starts), len(head), present,
                  [int(c) for c in group_counts[pick]], absent)


def cached_oracle(path: Path, k: int, n_present: int,
                  n_absent: int) -> Oracle:
    cache = path.with_name(f"{path.name}.k{k}.{n_present}.{n_absent}.json")
    if cache.exists():
        return Oracle(**json.loads(cache.read_text()))
    oracle = host_oracle(path, k, n_present, n_absent)
    cache.write_text(json.dumps(dataclasses.asdict(oracle)))
    return oracle


# --- phases -------------------------------------------------------------------

@dataclasses.dataclass
class Sizes:
    reads_big: int
    reads_small: int
    batch_words: int          # the CLI's default (1 << 20) at full size
    lsm_batch_words: int      # M2: bench.py's batch
    l_m1: int
    l_m2: int
    l_m3: int
    l_m4: int
    gf2_keys: int
    dedupe_positions: int
    merge_cap: int
    n_present: int
    n_absent: int


FULL = Sizes(
    reads_big=200_000, reads_small=50_000, batch_words=1 << 20,
    lsm_batch_words=602112, l_m1=28, l_m2=28, l_m3=26, l_m4=27,
    gf2_keys=1 << 20, dedupe_positions=602112 * 16, merge_cap=1 << 26,
    n_present=100_000, n_absent=1000,
)
REHEARSAL = Sizes(
    reads_big=1500, reads_small=600, batch_words=1 << 14,
    lsm_batch_words=1 << 12, l_m1=22, l_m2=22, l_m3=21, l_m4=22,
    gf2_keys=1 << 12, dedupe_positions=1 << 14, merge_cap=1 << 16,
    n_present=2000, n_absent=100,
)


def say(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields), flush=True)


def _timed(fn, reps: int = 3) -> float:
    """Median wall seconds of fn() (which blocks until the device is
    done), after one untimed warm-up call."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def _peaks(devices) -> list:
    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devices]


def phase_device(n_devices: int):
    import jax

    from tsxcount_tpu.io.native import native_available, native_build_error

    devs = jax.devices()
    if len(devs) < n_devices:
        raise SystemExit(f"{n_devices} devices asked, {len(devs)} found")
    if not native_available():
        raise SystemExit(f"native packer unavailable: {native_build_error()}")
    say("device", platform=devs[0].platform, kind=devs[0].device_kind,
        count=len(devs), jax=jax.__version__, native_packer=True)
    return devs[:n_devices]


def phase_fixture(sizes: Sizes) -> None:
    from tsxcount_tpu import cli

    for label, extra in (
        ("shards1", ["--shards", "1", "--l", "18"]),
        ("shards0", ["--shards", "0", "--l", "18"]),
        ("table", ["--mode", "TSX", "--l", "20"]),
    ):
        argv = ["count", "--input", str(FIXTURE), "--k", "14", "--check",
                *_batch_flag(sizes)]
        err = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv + extra)
        check = [ln for ln in err.getvalue().splitlines()
                 if ln.startswith("check:")]
        say(f"fixture {label}", rc=rc, check=check[-1] if check else None,
            seconds=time.perf_counter() - t0)
        if (rc != 0 or not check
                or "0 mismatched, 0 missing, 0 extra" not in check[-1]):
            sys.stderr.write(err.getvalue()[-4000:])
            raise AssertionError(f"fixture {label}: CLI parity failed")


def phase_primitives(sizes: Sizes) -> dict:
    import jax
    import jax.numpy as jnp

    from tsxcount_tpu.config import KmerSpec
    from tsxcount_tpu.core.store import CountStore, StoreState
    from tsxcount_tpu.ops.count import count_unique, int32_to_digits
    from tsxcount_tpu.ops.gf2 import GF2Hash
    from tsxcount_tpu.ops.mix import LaneMixBijection

    rng = np.random.default_rng(3)
    times = {}

    def rand_keys(spec, n):
        keys = rng.integers(0, 2**32, size=(n, spec.lanes), dtype=np.uint32)
        keys[:, -1] &= np.uint32(spec.top_lane_mask)
        return keys

    for k in (14, 31, 63, 127):
        spec = KmerSpec(k)
        keys = rand_keys(spec, sizes.gf2_keys)
        for name, fn in (("gf2", GF2Hash(spec)),
                         ("lane_mix", LaneMixBijection(spec))):
            dev = np.asarray(jax.jit(fn.apply)(jnp.asarray(keys)))
            back = np.asarray(jax.jit(fn.inv_apply)(jnp.asarray(dev)))
            if not (np.array_equal(dev, fn.apply_host(keys))
                    and np.array_equal(back, keys)):
                raise AssertionError(f"{name} k={k}: device != host form")
        say("primitive hash", k=k, keys=sizes.gf2_keys, gf2="exact",
            lane_mix="exact")

    # count_unique on one full batch: k=14 (the plain full-comparator
    # sort) against np.unique; k=127 (the uniform-prefix sort the 8-lane
    # sharded path runs) against a vocabulary whose lane 0 names each key
    p = sizes.dedupe_positions
    for k in (14, 127):
        spec = KmerSpec(k)
        vocab = rand_keys(spec, p // 4)
        vocab[:, 0] = np.arange(len(vocab), dtype=np.uint32)
        idx = rng.integers(0, len(vocab), size=p)
        valid = rng.random(p) < 0.9
        kmers = vocab[idx]
        uniform = k == 127
        fn = jax.jit(lambda a, v: count_unique(
            a, v, spec=spec, uniform_prefix=uniform, collide_mode="flag"))
        args = (jnp.asarray(kmers), jnp.asarray(valid))
        uc = fn(*args)
        n = int(uc.n_unique)
        got_k = np.asarray(uc.keys)[:n]
        got_c = np.asarray(uc.counts)[:n]
        if k == 14:
            want_k, want_c = np.unique(kmers[valid, 0], return_counts=True)
            ok = (np.array_equal(got_k[:, 0], want_k)
                  and np.array_equal(got_c, want_c))
        else:
            want = np.bincount(idx[valid], minlength=len(vocab))
            rows = got_k[:, 0]
            ok = (n == int((want > 0).sum())
                  and not bool(uc.collided)
                  and np.array_equal(got_k, vocab[rows])
                  and np.array_equal(got_c, want[rows]))
            # ascending: the ids of the sorted present keys, in key order
            order = np.lexsort(tuple(vocab[rows][:, j]
                                     for j in range(spec.lanes)))
            ok = ok and np.array_equal(order, np.arange(n))
        if not ok:
            raise AssertionError(f"count_unique k={k}: device != host")
        times[f"dedupe_k{k}_ms"] = _timed(lambda: fn(*args)) * 1e3
        say("primitive count_unique", k=k, positions=p, distinct=n,
            exact=True, ms=times[f"dedupe_k{k}_ms"])

    # one store merge at cap 2^26 plus 2P rows (k=31: 2 lanes), against a
    # numpy merge of uint64 keys
    spec = KmerSpec(31)
    cap = sizes.merge_cap
    mask62 = np.uint64((1 << 62) - 1)
    skeys = np.unique(rng.integers(0, 2**63, size=cap // 2,
                                   dtype=np.uint64) & mask62)
    scounts = rng.integers(1, 1000, size=len(skeys))
    runs = []
    for _ in range(2):
        fresh = rng.integers(0, 2**63, size=p // 4, dtype=np.uint64) & mask62
        old = rng.choice(skeys, size=p // 3, replace=False)
        rk = np.unique(np.concatenate([fresh, old]))[: p - 7]
        rc = rng.integers(1, 1000, size=len(rk))
        runs.append((rk, rc))

    def lanes_of(u64, rows):
        out = np.zeros((rows, 2), np.uint32)
        out[: len(u64), 0] = (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[: len(u64), 1] = (u64 >> np.uint64(32)).astype(np.uint32)
        return out

    store = CountStore(spec, capacity=cap)
    digits = np.asarray(int32_to_digits(jnp.asarray(
        np.pad(scounts, (0, cap - len(skeys))).astype(np.int32))))
    state = StoreState(
        keys=jnp.asarray(lanes_of(skeys, cap)), digits=jnp.asarray(digits),
        used=jnp.asarray(np.arange(cap) < len(skeys)),
        n=jnp.asarray(len(skeys), jnp.int32), overflowed=jnp.asarray(False),
    )
    ukeys = np.stack([lanes_of(rk, p) for rk, _ in runs])
    ucounts = np.stack([np.pad(rc, (0, p - len(rc))) for _, rc in runs]
                       ).astype(np.int32)
    uvalid = np.stack([np.arange(p) < len(rk) for rk, _ in runs])
    merge = jax.jit(store.merge_stacked)
    margs = (state, jnp.asarray(ukeys), jnp.asarray(ucounts),
             jnp.asarray(uvalid))
    out = merge(*margs)
    all_k = np.concatenate([skeys] + [rk for rk, _ in runs])
    all_c = np.concatenate([scounts] + [rc for _, rc in runs])
    want_k, inv = np.unique(all_k, return_inverse=True)
    want_c = np.bincount(inv, weights=all_c).astype(np.int64)
    n = int(out.n)
    got = np.asarray(out.keys)[:n].astype(np.uint64)
    got_k = got[:, 0] | (got[:, 1] << np.uint64(32))
    d = np.asarray(out.digits)[:n].astype(np.int64)
    got_c = d[:, 0] + (d[:, 1] << 20) + (d[:, 2] << 40)
    if not (n == len(want_k) and np.array_equal(got_k, want_k)
            and np.array_equal(got_c, want_c) and not bool(out.overflowed)):
        raise AssertionError("merge_stacked: device != numpy merge")
    times["merge_cap2^26_ms"] = _timed(lambda: merge(*margs)) * 1e3
    say("primitive merge_stacked", cap=cap, rows=cap + 2 * p, distinct=n,
        exact=True, ms=times["merge_cap2^26_ms"])
    return times


def _make_counter(path: Path, k: int, l: int, *flags: str):
    """The counter the CLI builds for `count --input PATH --k K --l L
    FLAGS...` (cli.make_counter on the CLI's own parser)."""
    from tsxcount_tpu import cli

    args = cli.build_parser().parse_args(
        ["count", "--input", str(path), "--k", str(k), "--l", str(l),
         *flags])
    return cli.make_counter(args)


def run_job(name: str, make, path: Path, oracle: Oracle, devices,
            extra=None):
    """Count `path` twice (cold, then a fresh-store warm pass) and check
    the result exactly against the oracle.  Returns the counter."""
    t0 = time.perf_counter()
    counter = make()
    counter.count_file(path)
    distinct_cold = counter.distinct
    cold = time.perf_counter() - t0
    counter.reset()
    t0 = time.perf_counter()
    counter.count_file(path)
    distinct = counter.distinct  # reads the merged store: the fence
    warm = time.perf_counter() - t0
    windows = counter.total_kmers
    total = counter.stored_total
    got = counter.get_counts(oracle.present)
    got_absent = counter.get_counts(oracle.absent)
    bad = sum(g != w for g, w in zip(got, oracle.present_counts))
    fields = dict(
        windows=windows, distinct=distinct, sum_of_counts=total,
        oracle_windows=oracle.n_windows, oracle_distinct=oracle.distinct,
        sampled_present=len(got), present_mismatched=bad,
        polya_count=got[0], sampled_absent=len(got_absent),
        absent_found=sum(1 for g in got_absent if g),
        cold_seconds=cold, warm_seconds=warm,
        warm_kmers_per_s=windows / warm, lsm=bool(getattr(counter, "lsm",
                                                         False)),
        peak_bytes_in_use=_peaks(devices),
    )
    if extra:
        fields.update(extra(counter))
    say(name, **fields)
    if not (windows == total == oracle.n_windows
            and distinct == distinct_cold == oracle.distinct
            and bad == 0 and fields["absent_found"] == 0):
        raise AssertionError(f"{name}: result differs from the oracle")
    return counter


def _flush_ms(counter) -> float:
    """One store flush at the job's real shape: the counter's own jitted
    merge of merge_every received runs into its store (a flat store)."""
    from tsxcount_tpu.io.packer import PackedBatch

    buf = counter._put_group([PackedBatch.empty(counter.batch)])
    recv = counter._step(buf)[:3]
    state = [counter.state]

    def flush():
        state[0] = counter._merge(
            state[0], *[[x] * counter.merge_every for x in recv]
        )
        return state[0]

    ms = _timed(flush) * 1e3
    counter.state = state[0]
    return ms


def _table_round_ms(counter) -> float:
    """One full-width reprobe round (QuotientTable.split_round, r=0) of a
    uniform batch against the job's final table (not donated)."""
    import jax
    import jax.numpy as jnp

    from tsxcount_tpu.core.table import TableState

    table = counter.table
    st = counter.state
    # the one-shard state as plain arrays (a host round trip drops the
    # mesh sharding the counter's state carries)
    st = TableState(*(jnp.asarray(np.asarray(x)) for x in (
        st.slots, st.n[0], st.spilled[0], st.probe_hist)))
    p = counter.batch.positions
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=(p, table.spec.lanes), dtype=np.uint32)
    keys[:, -1] &= np.uint32(table.spec.top_lane_mask)
    args = (jnp.asarray(keys), jnp.ones((p,), jnp.int32),
            jnp.ones((p,), jnp.bool_))
    rnd = jax.jit(lambda s, k, c, v: table.split_round(
        s, 0, *table.round0_args(k, c, v)))
    return _timed(lambda: rnd(st, *args)) * 1e3


def _input(n_reads: int) -> Path:
    sys.path.insert(0, str(ROOT))
    from bench import ensure_synth_fastq

    path = DATA / f"reads.{n_reads}.fastq"
    t0 = time.perf_counter()
    ensure_synth_fastq(path, n_reads=n_reads)
    say("input", path=path.name, reads=n_reads, bytes=path.stat().st_size,
        seconds=time.perf_counter() - t0)
    return path


def _oracle(path: Path, k: int, sizes: Sizes) -> Oracle:
    t0 = time.perf_counter()
    oracle = cached_oracle(path, k, sizes.n_present, sizes.n_absent)
    say("oracle", path=path.name, k=k, windows=oracle.n_windows,
        distinct=oracle.distinct, seconds=time.perf_counter() - t0)
    return oracle


def _batch_flag(sizes: Sizes) -> list:
    """The CLI's default batch at full size; the rehearsal's small one."""
    if sizes.batch_words == FULL.batch_words:
        return []
    return ["--batch-words", str(sizes.batch_words)]


def phases_jobs(sizes: Sizes, devices) -> None:
    big, small = _input(sizes.reads_big), _input(sizes.reads_small)
    bw = _batch_flag(sizes)
    o_small127 = _oracle(small, 127, sizes)
    o_small31 = _oracle(small, 31, sizes)
    o_big31 = _oracle(big, 31, sizes)
    # peak_bytes_in_use is the process's running maximum, so each job's
    # reading is its own only when it grows: the jobs run in ascending
    # expected peak, M1 (the CLI default path) before M2
    c = run_job("M3 k=127 shards=1", lambda: _make_counter(
        small, 127, sizes.l_m3, "--shards", "1", *bw), small, o_small127,
        devices)
    del c
    gc.collect()
    c = run_job("M4 k=31 table", lambda: _make_counter(
        small, 31, sizes.l_m4, "--mode", "TSX", *bw), small, o_small31,
        devices,
        extra=lambda cn: {"table_round_ms": _table_round_ms(cn),
                          "fill": cn.distinct / (1 << sizes.l_m4)})
    del c
    gc.collect()
    c = run_job("M1 k=31 shards=1", lambda: _make_counter(
        big, 31, sizes.l_m1, "--shards", "1", *bw), big, o_big31, devices,
        extra=lambda cn: {"flush_ms": _flush_ms(cn)})
    del c
    gc.collect()
    c = run_job("M2 k=31 shards=0 lsm", lambda: _make_counter(
        big, 31, sizes.l_m2, "--shards", "0", "--batch-words",
        str(sizes.lsm_batch_words), "--merge-every", "2"), big, o_big31,
        devices)
    if not c.lsm:
        raise AssertionError("M2: the LSM cascade did not engage")
    del c
    gc.collect()


def phase_four_devices(sizes: Sizes, devices) -> None:
    big = _input(sizes.reads_big)
    oracle = _oracle(big, 31, sizes)

    def placement(counter):
        held = {sh.device for sh in counter.state.keys.addressable_shards}
        shard_n = [int(x) for x in np.asarray(counter.state.n)]
        if held != set(devices) or min(shard_n) <= 0:
            raise AssertionError(f"shards not spread over the devices: "
                                 f"{held} {shard_n}")
        return {"shard_distinct": shard_n,
                "devices_holding_shards": len(held)}

    run_job("M1 k=31 shards=4", lambda: _make_counter(
        big, 31, sizes.l_m1, "--shards", str(len(devices)),
        *_batch_flag(sizes)), big, oracle, devices, extra=placement)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: the device phase and M1 sharded over four GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on any backend (not a measurement)")
    args = ap.parse_args()
    import jax

    if jax.default_backend() != "gpu" and not args.rehearse:
        print(f"chip_smoke: no GPU (JAX backend is {jax.default_backend()})",
              file=sys.stderr)
        return 1
    sizes = REHEARSAL if args.rehearse else FULL
    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    DATA.mkdir(exist_ok=True)
    t_start = time.perf_counter()
    devices = phase_device(args.devices)
    if args.devices == 1:
        phase_fixture(sizes)
        times = phase_primitives(sizes)
        phases_jobs(sizes, devices)
        say("device times", **times)
    else:
        phase_four_devices(sizes, devices)
    smi = nvidia_smi() if not args.rehearse else "not a GPU run"
    say("total", seconds=time.perf_counter() - t_start)
    print(smi)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
