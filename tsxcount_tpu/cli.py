"""Command-line interface mirroring the reference tsxCount CLI.

Reference surface (argp options, reference src/mains/main.cpp:30-40, defaults
at 409-413): --k (14) --l (26) --s (4) --input --check --checkabort
--threads --mode {SERIAL,PTHREAD,OMP,CAS,TSX,EXPERIMENTAL,OMP_COUNT}.

Additions beyond the reference: --backend {sort,table} (the real strategy
switch; the
reference mode strings are accepted as aliases), --dump (full-table TSV
export in the reference .count format — the reference has no dump), --shards
(multi-device table sharding), --batch-words, --n-policy, --hash-seed,
--identity-hash, --stats-json.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tsxcount-tpu",
        description="exact k-mer counter on an accelerator (tsxCount "
        "capabilities, JAX/XLA architecture)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    c = sub.add_parser("count", help="count k-mers in a FASTQ/FASTA(.gz) file")
    c.add_argument("--input", required=True, help="FASTQ/FASTA file, .gz ok")
    c.add_argument("--k", type=int, default=14, help="k-mer length (default 14)")
    c.add_argument("--l", type=int, default=26,
                   help="log2 table capacity (default 26, as the reference)")
    c.add_argument("--s", type=int, default=4,
                   help="accepted for reference parity; counts here are "
                        "unbounded multi-digit, no overflow chain needed")
    c.add_argument("--threads", type=int, default=0,
                   help="host parse/pack threads (0 = auto -> 1); >1 "
                        "byte-range-splits uncompressed input across "
                        "threads (gzip degrades to 1)")
    c.add_argument("--mode", default="SERIAL",
                   help="reference mode string or backend name "
                        "(SERIAL/PTHREAD/OMP/CAS/TSX/EXPERIMENTAL/OMP_COUNT "
                        "or sort/table)")
    c.add_argument("--check", action="store_true",
                   help="verify against <input>.<k>.count golden file")
    c.add_argument("--checkabort", action="store_true",
                   help="abort on first mismatch (exit 200)")
    c.add_argument("--golden", default=None,
                   help="override golden file path for --check")
    c.add_argument("--dump", default=None,
                   help="write full counts as kmer\\tcount TSV")
    c.add_argument("--shards", type=int, default=1,
                   help="table shards across devices.  Default 1 runs "
                        "the sharded pipeline on ONE device (bench.py's "
                        "default too; identical exact results).  0 = the "
                        "plain single-device counter (where "
                        "--hash-first/--mix-prefix apply)")
    c.add_argument("--batch-words", type=int, default=1 << 20,
                   help="uint32 words per device batch (16 bases/word); "
                        "a multiple of 4096 keeps positions on the 2^16 "
                        "grid the other defaults assume")
    c.add_argument("--read-len", type=int, default=0,
                   help="expected read length in bases; sizes the "
                        "interval-coded validity budget per batch "
                        "(0 = auto-detect from the first read)")
    c.add_argument("--merge-every", type=int, default=4,
                   help="batches folded per store merge (sort backend)")
    c.add_argument("--hp-collapse", dest="hp_collapse",
                   action="store_true", default=None,
                   help="enable homopolymer run-length collapse at ingest "
                        "(exact either way; collapse splices all-X runs "
                        "longer than 2k-2 and applies the elided window "
                        "counts at read time).  Default: off (bench.py and "
                        "the CLI agree); turn on for tail-heavy data. "
                        "On --load-state the checkpoint's setting wins "
                        "unless a flag overrides it")
    c.add_argument("--no-hp-collapse", dest="hp_collapse",
                   action="store_false",
                   help="disable homopolymer collapse (overrides a loaded "
                        "checkpoint's setting)")
    c.add_argument("--lsm", action="store_true", default=None,
                   help="force the log-structured multi-level store (sort "
                        "backend): amortizes merges for streams whose table "
                        "is much larger than one batch; exact counts "
                        "preserved.  Default: engaged automatically when "
                        "the cascade is cheaper than flat re-sorts")
    c.add_argument("--no-lsm", dest="lsm", action="store_false",
                   help="force the flat store (disable LSM auto-engage)")
    c.add_argument("--lsm-growth", type=int, default=8,
                   help="LSM level size ratio (default 8)")
    c.add_argument("--n-policy", choices=("drop", "random"), default="drop",
                   help="N handling: drop windows (default) or random "
                        "substitution (reference bug-compat)")
    c.add_argument("--hash-seed", type=int, default=None,
                   help="GF(2) hash matrix seed (default: fixed)")
    c.add_argument("--identity-hash", action="store_true",
                   help="debug: identity hash instead of random GF(2)")
    c.add_argument("--routing-hash", choices=("mix", "gf2"), default="mix",
                   help="sharded routing bijection: 'mix' (ARX lane mix, "
                        "default) or 'gf2' (the GF(2) matmul; what older "
                        "sharded checkpoints used)")
    c.add_argument("--hash-first", choices=("auto", "mix", "gf2", "off"),
                   default="auto",
                   help="plain-counter (--shards 0) sort backend: apply a "
                        "bijective hash BEFORE dedupe and sort a >=64-bit "
                        "uniform prefix with the other lanes as payload.  "
                        "'mix' = ARX lane-mix (auto-on for k >= 113), "
                        "'gf2' = the GF(2) matmul, 'off' forces the "
                        "full-comparator sort, 'auto' (default) applies "
                        "the k rule")
    c.add_argument("--mix-prefix", action="store_true", default=None,
                   help="plain-counter sort backend: dedupe-sort on a "
                        "cheap mixing-hash prefix over extended keys "
                        "(exact; off by default)")
    c.add_argument("--stats-json", action="store_true",
                   help="emit stats as one JSON line")
    c.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print an ingest progress line to stderr every N "
                        "batches (0 = off)")
    c.add_argument("--canonical", action="store_true",
                   help="count canonical kmers min(kmer, revcomp) — "
                        "beyond-reference feature, off by default for "
                        "reference parity")
    c.add_argument("--save-state", default=None,
                   help="write a resumable .npz checkpoint after counting "
                        "(capability the reference lacks)")
    c.add_argument("--load-state", default=None,
                   help="resume from a .npz checkpoint before counting")
    c.add_argument("--platform", default=None,
                   help="force a jax platform (e.g. cpu for debugging; "
                        "default: the environment's, normally the GPU)")
    c.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax profiler trace of the counting run "
                        "(in-process tracing; the reference only had "
                        "/usr/bin/time + VTune outside the process)")
    return p


def make_counter(args: argparse.Namespace):
    """The counter `count` builds from its parsed arguments (also used by
    chip_smoke.py, so the smoke test runs exactly what the CLI runs)."""
    from tsxcount_tpu.core.counter import KmerCounter
    from tsxcount_tpu.ops.gf2 import DEFAULT_SEED

    kwargs = dict(
        k=args.k,
        l=args.l,
        s=args.s,
        backend=args.mode,
        batch_words=args.batch_words,
        n_policy=args.n_policy,
        hash_seed=DEFAULT_SEED if args.hash_seed is None else args.hash_seed,
        identity_hash=args.identity_hash,
        canonical=args.canonical,
        merge_every=args.merge_every,
        lsm=args.lsm,
        lsm_growth=args.lsm_growth,
        threads=args.threads,
        read_len_hint=args.read_len,
        progress_every=args.progress,
    )
    hp_collapse = False if args.hp_collapse is None else args.hp_collapse
    if args.load_state:
        # the checkpoint's own shape (shards/backend/k/l) wins over flags
        from tsxcount_tpu.core.checkpoint import load_counter

        counter = load_counter(args.load_state, batch_words=args.batch_words)
        if args.hp_collapse is not None:
            # explicit flag overrides the checkpoint's collapse setting
            counter.collapse_hp = args.hp_collapse
            counter.packer.collapse = args.hp_collapse and counter.spec.k >= 2
    elif args.shards >= 1:
        # the sharded pipeline even at --shards 1 (bench.py's default),
        # with identical exact results
        from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

        if args.hash_first != "auto":
            print("warning: --hash-first is ignored with --shards >= 1 "
                  "(the sharded stream hashes for routing; use --shards 0 "
                  "for the plain counter)", file=sys.stderr)
        if args.mix_prefix is not None:
            print("warning: --mix-prefix is ignored with --shards >= 1 "
                  "(use --shards 0 for the plain counter)", file=sys.stderr)
        counter = ShardedKmerCounter(
            n_shards=args.shards,
            collapse_homopolymers=hp_collapse,
            routing_hash=args.routing_hash, **kwargs,
        )
    else:
        hash_first = {"auto": None, "off": False}.get(
            args.hash_first, args.hash_first
        )
        counter = KmerCounter(collapse_homopolymers=hp_collapse,
                              mix_prefix=args.mix_prefix,
                              hash_first=hash_first, **kwargs)
    return counter


def cmd_count(args: argparse.Namespace) -> int:
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from tsxcount_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    # deferred imports keep --help snappy and let tests patch the backend
    from tsxcount_tpu.core.counter import CheckAbort, TableFull
    from tsxcount_tpu.io.native import native_available, native_build_error
    from tsxcount_tpu.utils.goldenfile import write_golden

    # the device is always named, so a CPU run is never mistaken for one
    # on the accelerator
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)
    if not native_available():
        print("warning: native packer unavailable, using the pure-Python "
              f"packer (much slower): {native_build_error()}",
              file=sys.stderr)

    t0 = time.perf_counter()
    counter = make_counter(args)

    # config echo, like the reference startup dump (main.cpp:420-427)
    print(f"k={args.k} l={args.l} s={args.s} mode={args.mode} "
          f"backend={counter.backend} shards={args.shards} "
          f"input={args.input}", file=sys.stderr)
    # device-memory preflight: surface a predicted OOM BEFORE the compile
    # (utils/hbm.py; the reference analog records max-RSS per run,
    # analyses/plot_analyses.py:91-120)
    from tsxcount_tpu.utils.hbm import estimate_hbm, preflight_check

    hbm_warn = preflight_check(estimate_hbm(
        k=counter.spec.k, l=counter.l, batch_words=args.batch_words,
        backend=counter.backend,
        merge_every=getattr(counter, "merge_every", 1),
        lsm=bool(getattr(counter, "lsm", False)),
        hash_first=getattr(counter, "hash_first", False),
        mix_prefix=bool(getattr(counter, "mix_prefix", False)),
        n_shards=max(1, args.shards),
    ))
    if hbm_warn:
        print(f"note: {hbm_warn}", file=sys.stderr)
    if counter.backend == "table":
        print(
            "note: the table backend is the reference-semantics parity "
            "path (slot encoding, reconstruction, probe histograms); the "
            "sort backend (--mode SERIAL) is the speed path",
            file=sys.stderr,
        )

    import contextlib

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        import jax

        profile_ctx = jax.profiler.trace(args.profile)
    try:
        with profile_ctx:
            counter.count_file(args.input)
    except TableFull as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 42  # reference exit code (TSXHashMap.h:340-343)

    wall = time.perf_counter() - t0
    stats = counter.stats()
    stats["wall_seconds"] = round(wall, 4)
    stats["kmers_per_second"] = (
        round(stats["windows"] / wall) if wall > 0 else 0
    )
    if args.stats_json:
        print(json.dumps(stats))
    else:
        for key, val in stats.items():
            print(f"{key}: {val}", file=sys.stderr)

    if args.save_state:
        from tsxcount_tpu.core.checkpoint import save_counter

        save_counter(counter, args.save_state)
        print(f"saved state to {args.save_state}", file=sys.stderr)

    if args.dump:
        write_golden(args.dump, counter.to_dict(), sort=True)
        print(f"dumped {counter.distinct} kmers to {args.dump}",
              file=sys.stderr)

    if args.check or args.checkabort:
        golden = args.golden or f"{args.input}.{args.k}.count"
        try:
            res = counter.check(golden, abort=args.checkabort)
        except CheckAbort as e:
            print(f"CHECK ABORT: {e}", file=sys.stderr)
            return 200  # reference exit code (main.cpp:287-290)
        print(
            f"check: {res.n_matched}/{res.n_checked} matched, "
            f"{len(res.mismatches)} mismatched, {len(res.missing)} missing, "
            f"{res.extra_distinct} extra",
            file=sys.stderr,
        )
        if not res.ok:
            for kmer_str, want, got in (res.mismatches + res.missing)[:20]:
                print(f"  {kmer_str}: expected {want}, got {got}",
                      file=sys.stderr)
            return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.command == "count":
            return cmd_count(args)
    except FileNotFoundError as e:
        print(f"ERROR: file not found: {e.filename or e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
    raise AssertionError("unreachable")


if __name__ == "__main__":
    sys.exit(main())
