#!/usr/bin/env python
"""Benchmark: steady-state k-mer counting throughput (kmers/s) on one GPU.

Protocol (mirrors the reference's benchmark methodology of timing whole
counting runs over synthetic FASTQ, reference analyses/perform_analyses.py +
generateFakeSequences.py: 500-1000 bp random reads + 100-300 bp polyA tail):

  1. generate a deterministic synthetic FASTQ (~18.7M k=14 windows);
  2. count it once end-to-end (pays jit compile);
  3. count it again with the same jitted pipeline — the steady-state pass —
     and report kmers/s from that pass.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
naming the device it ran on.  It refuses to print one from a non-GPU backend
unless --platform cpu asked for that explicitly.

vs_baseline compares against the reference tsxCount binary (SERIAL mode,
-O3, gcc 12) measured on ANOTHER host's CPU (a 2-vCPU container) over the
same synthetic file — see BASELINE_MEASURED.json for the raw numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

# Reference baseline, measured on another host (2-vCPU container):
#   tsxCount --input=synth.fastq --mode=SERIAL --threads=1
#   --k=14 --l=26 --s=4   over the same 20k-read synthetic file
#   (18 760 870 k=14 windows).  See BASELINE_MEASURED.json for raw numbers.
N_READS = 20_000
DATA_DIR = Path(__file__).resolve().parent / ".bench_data"


def bench_fastq_path(n_reads: int, read_len: tuple[int, int] | None = None
                     ) -> Path:
    tag = "" if read_len is None else f".len{read_len[0]}-{read_len[1]}"
    return DATA_DIR / f"tsxcount_bench.{n_reads}{tag}.fastq"


def ensure_synth_fastq(path: Path, n_reads: int = N_READS, seed: int = 42,
                       read_len: tuple[int, int] | None = None):
    """Default profile mirrors the reference generator (500-1000 bp +
    polyA tail, generateFakeSequences.py); an explicit read_len makes
    fixed-length reads with NO tail — the short-read (Illumina-like)
    regime the reference's benchmark datasets use
    (analyses/perform_analyses.py:24-26)."""
    if path.exists():
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    base = np.frombuffer(b"ACGT", np.uint8)
    tmp = path.with_name(f"{path.name}.tmp")
    with open(tmp, "wb") as f:
        for i in range(n_reads):
            if read_len is None:
                n = int(rng.integers(500, 1000))
                tail = b"A" * int(rng.integers(100, 300))
            else:
                n = int(rng.integers(read_len[0], read_len[1] + 1))
                tail = b""
            seq = base[rng.integers(0, 4, size=n)].tobytes() + tail
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, seq, b"I" * len(seq)))
    tmp.replace(path)


TARGET_BATCH_WORDS = 602112  # inherited default; re-derive on the GPU (A6)


def auto_batch_words(path: Path, k: int, collapse: bool) -> int:
    """Batch words sized to the dataset: an untimed native prepass counts
    the packed words the (collapse-aware) stream actually emits, then the
    batch count targeting ~TARGET words/batch divides it evenly (rounded
    up to 4096 words, with 0.4% slack for seam-overlap drift)."""
    from tsxcount_tpu.config import BatchSpec, KmerSpec
    from tsxcount_tpu.io.native import NativeFileReader, native_available

    if not native_available():
        return TARGET_BATCH_WORDS
    batch = BatchSpec(KmerSpec(k), TARGET_BATCH_WORDS, 384)
    reader = NativeFileReader(path, batch, collapse=collapse)
    for _ in reader:
        pass
    words = reader.stats.packed_words
    if not words:
        return TARGET_BATCH_WORDS
    n = max(1, round(words / TARGET_BATCH_WORDS))
    # 4096-word granularity: positions (16*words) stay a multiple of 2^16
    return -(-int(words * 1.004) // (n * 4096)) * 4096


def peak_rss_mb() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def device_peak_mb() -> float | None:
    """Peak device memory in use, when the backend reports it."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    return None if peak is None else round(peak / 2**20, 1)


def load_measured_baseline() -> float | None:
    p = Path(__file__).parent / "BASELINE_MEASURED.json"
    if p.exists():
        data = json.loads(p.read_text())
        return data.get("reference_serial_kmers_per_s")
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=14)
    ap.add_argument("--l", type=int, default=24)
    # 0 = auto: size batches to the dataset's actual packed-word count
    # (an untimed native prepass measures it, collapse-aware) targeting
    # ~602112 words/batch — fixed-shape H2D buffers then carry no dead
    # tail.  Any explicit even value whose positions (16*words) are a
    # 4096 multiple works.
    ap.add_argument("--batch-words", type=int, default=0)
    ap.add_argument("--platform", default=None,
                    help="force a jax platform; 'cpu' is the only way to "
                         "get a result line off the GPU")
    ap.add_argument("--backend", default="sort")
    ap.add_argument("--reads", type=int, default=N_READS,
                    help="synthetic read count (default matches the "
                         "reference baseline measurement)")
    ap.add_argument("--read-len", default=None,
                    help="fixed read length 'MIN,MAX' (no polyA tail) — "
                         "e.g. '150,150' for the Illumina short-read "
                         "regime; default: reference profile 500-1000 bp "
                         "+ polyA")
    ap.add_argument("--merge-every", type=int, default=2,
                    help="batches folded per store merge (R)")
    ap.add_argument("--passes", type=int, default=6,
                    help="steady-state passes; the reported time is the "
                         "fastest (timeit-style)")
    ap.add_argument("--shards", type=int, default=1,
                    help="run the ShardedKmerCounter over N devices; "
                         "0 = the plain single-device KmerCounter.  "
                         "Default 1, as the CLI (identical exact result)")
    ap.add_argument("--lsm", action="store_true", default=None,
                    help="force the LSM store (default: auto-engage when "
                         "the cascade beats flat re-sorts)")
    ap.add_argument("--no-lsm", dest="lsm", action="store_false",
                    help="force the flat store")
    # Default OFF — bench, counter API, and CLI all agree.
    ap.add_argument("--hp-collapse", dest="hp_collapse",
                    action="store_true", default=False,
                    help="enable homopolymer run-length collapse at ingest")
    ap.add_argument("--no-hp-collapse", dest="hp_collapse",
                    action="store_false",
                    help="disable homopolymer run-length collapse at ingest")
    ap.add_argument("--hash-first", dest="hash_first", default=None,
                    action="store_true",
                    help="hash before dedupe + 64-bit prefix sort "
                         "(default: counter auto rule)")
    ap.add_argument("--no-hash-first", dest="hash_first",
                    action="store_false")
    ap.add_argument("--mix-prefix", dest="mix_prefix", default=None,
                    action="store_true",
                    help="mixing-hash sort prefix over extended keys")
    ap.add_argument("--no-mix-prefix", dest="mix_prefix",
                    action="store_false")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    if dev.platform != "gpu" and args.platform != "cpu":
        print(f"error: no GPU (JAX backend is {dev.platform}); pass "
              "--platform cpu to measure the CPU on purpose",
              file=sys.stderr)
        return 2
    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    from tsxcount_tpu.core.counter import KmerCounter

    read_len = None
    if args.read_len:
        lo, _, hi = args.read_len.partition(",")
        read_len = (int(lo), int(hi or lo))
    bench_fastq = bench_fastq_path(args.reads, read_len)
    ensure_synth_fastq(bench_fastq, n_reads=args.reads, read_len=read_len)

    if not args.batch_words:
        args.batch_words = auto_batch_words(
            bench_fastq, args.k, args.hp_collapse
        )

    if args.shards:
        from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

        # flags the sharded counter does not take: say so instead of
        # silently benchmarking a default configuration
        if args.hash_first is not None:
            print("warning: --hash-first/--no-hash-first is ignored with "
                  "--shards (the sharded stream is already hashed for "
                  "routing)", file=sys.stderr)
        if args.mix_prefix is not None:
            print("warning: --mix-prefix is ignored with --shards",
                  file=sys.stderr)
        if args.lsm is not None:
            print("warning: --lsm/--no-lsm is ignored with --shards "
                  "(per-shard LSM auto-engages by the cascade rule)",
                  file=sys.stderr)
        counter = ShardedKmerCounter(
            k=args.k, n_shards=args.shards, l=args.l, backend=args.backend,
            batch_words=args.batch_words, merge_every=args.merge_every,
            capacity_factor=1.5,
            collapse_homopolymers=args.hp_collapse,
        )
    else:
        counter = KmerCounter(
            k=args.k, l=args.l, backend=args.backend,
            batch_words=args.batch_words, merge_every=args.merge_every,
            lsm=args.lsm, collapse_homopolymers=args.hp_collapse,
            hash_first=args.hash_first, mix_prefix=args.mix_prefix,
        )
    from tsxcount_tpu.utils.hbm import estimate_hbm, preflight_check

    hbm_est = estimate_hbm(
        k=args.k, l=args.l, batch_words=args.batch_words,
        backend=counter.backend, merge_every=args.merge_every,
        lsm=bool(getattr(counter, "lsm", False)),
        hash_first=getattr(counter, "hash_first", False),
        mix_prefix=bool(getattr(counter, "mix_prefix", False)),
        n_shards=max(1, args.shards),
    )
    warn = preflight_check(hbm_est)
    if warn:
        print(f"note: {warn}", file=sys.stderr)

    # the distinct-count scalar depends on the whole merged store: reading
    # it is the completion fence of each pass
    # pass 1: compile + count
    t0 = time.perf_counter()
    counter.count_file(bench_fastq)
    distinct = counter.distinct
    cold = time.perf_counter() - t0

    # fresh-store warm passes: empty the store (compiled programs kept) and
    # count again — the honest steady-state number (no re-count into an
    # already-populated store); report the best of `passes`
    fresh = float("inf")
    for _ in range(max(1, args.passes)):
        counter.reset()
        t0 = time.perf_counter()
        counter.count_file(bench_fastq)
        distinct2 = counter.distinct  # completion fence
        fresh = min(fresh, time.perf_counter() - t0)
        assert distinct2 == distinct
    kmers = counter.total_kmers  # logical windows of the last pass
    stats_last = counter.packer.stats

    # re-count pass (store already populated)
    t0 = time.perf_counter()
    counter.count_file(bench_fastq)
    _ = counter.distinct  # completion fence
    recount = time.perf_counter() - t0

    kmers_per_s = kmers / fresh
    baseline = load_measured_baseline()
    result = {
        "metric": f"kmers_per_second_k{args.k}",
        "value": round(kmers_per_s),
        "unit": "kmers/s/device",
        "vs_baseline": (
            round(kmers_per_s / baseline, 3) if baseline else None
        ),
        "k": args.k,
        "backend": args.backend,
        "read_len": args.read_len,
        "shards": args.shards,
        "lsm": bool(getattr(counter, "lsm", False)),
        "hash_first": bool(getattr(counter, "hash_first", False)),
        "mix_prefix": bool(getattr(counter, "mix_prefix", False)),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "total_kmers": kmers,
        "distinct_kmers": distinct,
        "fresh_warm_seconds": round(fresh, 3),
        "recount_seconds": round(recount, 3),
        "recount_kmers_per_s": round(kmers / recount),
        "cold_seconds": round(cold, 3),
        "batch_words": args.batch_words,
        # hp-collapse visibility: device-processed windows vs the logical
        # total, so the collapse contribution to the headline is explicit
        "windows_device": stats_last.windows,
        "hp_bonus": sum(stats_last.hp_bonus),
        # memory observability (reference protocol records max-RSS,
        # analyses/perform_analyses.py:64): host peak RSS, the measured
        # device peak, and the analytic model's estimate beside it
        "max_rss_mb": round(peak_rss_mb(), 1),
        "device_peak_mb": device_peak_mb(),
        "device_mb_est": round(hbm_est.total_mb, 1),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
