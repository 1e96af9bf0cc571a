#!/usr/bin/env python
"""Two-process jax.distributed smoke test on CPU (multi-host path validation).

Spawns N worker processes, each a separate jax process with its own CPU
device, forming one global mesh; every worker packs its record stripe of the
same FASTQ and the sharded counter runs as a single SPMD program with
all_to_all over the (simulated) DCN.  Worker 0 verifies exact counts.

Run directly: python tools/multihost_smoke.py [--workers 2]
Exit 0 = counts exact across processes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def worker_main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    coord = os.environ["SMOKE_COORD"]
    nproc = int(os.environ["SMOKE_NPROC"])
    pid = int(os.environ["SMOKE_PID"])
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == nproc  # 1 cpu device per process

    sys.path.insert(0, str(REPO))
    from tsxcount_tpu.parallel.distributed import count_file_distributed
    from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

    fastq = os.environ["SMOKE_FASTQ"]
    k = int(os.environ.get("SMOKE_K", "9"))
    counter = ShardedKmerCounter(
        k=k, n_shards=nproc, l=15, batch_words=64
    )
    mode = count_file_distributed(counter, fastq, stride=7)
    # byte-range splitting: each host must have parsed only ~1/N of the
    # records (never all of them), and the host shares must partition the
    # file exactly
    from jax.experimental import multihost_utils as mhu

    import numpy as np

    total_reads = int(os.environ["SMOKE_READS"])
    local_reads = counter.packer.stats.reads
    all_reads = np.asarray(mhu.process_allgather(
        np.asarray([local_reads], np.int64))).reshape(-1)
    assert int(all_reads.sum()) == total_reads, (all_reads, total_reads)
    if mode == "range" and nproc > 1:
        assert local_reads < total_reads, (
            f"host {pid} parsed every record ({local_reads}) despite "
            f"byte-range mode"
        )
    if pid == 0:
        print(f"worker0: input mode={mode}, per-host reads="
              f"{all_reads.tolist()} (total {total_reads})")
    # stats() is GLOBAL now (cross-process ingest-stat sum + shard gather):
    # assert reads/windows/distinct directly from it, no workarounds
    st = counter.stats()
    assert st["reads"] == total_reads, (st["reads"], total_reads)
    golden = json.loads(Path(os.environ["SMOKE_GOLDEN"]).read_text())
    assert st["windows"] + sum(st["hp_bonus"]) == sum(golden.values())
    assert counter.total_kmers == sum(golden.values())
    distinct = st["distinct_kmers"]
    # SPMD: every process must execute the same computations (the lookup is
    # a collective program); only worker 0 reports
    assert distinct == len(golden), (distinct, len(golden))
    some = sorted(golden)[:64]
    got = counter.get_counts(some)
    assert got == [golden[km] for km in some], "count mismatch"
    if pid == 0:
        print(f"worker0: distinct={distinct} expected={len(golden)}")
        print("worker0: multihost counts exact")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--k", type=int, default=9,
                    help="kmer length (>= 31 exercises the multi-lane "
                         "sort/merge programs across processes)")
    args = ap.parse_args()

    import collections

    import numpy as np

    rng = np.random.default_rng(0)
    tmp = Path(tempfile.mkdtemp(prefix="multihost_smoke_"))
    fastq = tmp / "in.fastq"
    golden_path = tmp / "golden.json"
    min_len = max(12, args.k + 3)
    reads = [
        "".join(np.random.default_rng(i).choice(list("ACGT"),
                size=int(rng.integers(min_len, min_len + 48))))
        for i in range(60)
    ]
    with open(fastq, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    counts: collections.Counter = collections.Counter()
    for seq in reads:
        for i in range(max(0, len(seq) - args.k + 1)):
            counts[seq[i : i + args.k]] += 1
    golden_path.write_text(json.dumps(dict(counts)))

    env_base = {
        **os.environ,
        "SMOKE_COORD": "127.0.0.1:39191",
        "SMOKE_NPROC": str(args.workers),
        "SMOKE_FASTQ": str(fastq),
        "SMOKE_GOLDEN": str(golden_path),
        "SMOKE_READS": str(len(reads)),
        "SMOKE_WORKER": "1",
        "SMOKE_K": str(args.k),
    }
    procs = []
    for pid in range(args.workers):
        env = dict(env_base, SMOKE_PID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, __file__],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    rc = 0
    for pid, proc in enumerate(procs):
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            rc = 1
        tag = "FAIL" if proc.returncode else "ok"
        print(f"--- worker {pid} [{tag}] ---")
        print("\n".join(out.splitlines()[-12:]))
    print("MULTIHOST SMOKE:", "FAIL" if rc else "PASS")
    return rc


if __name__ == "__main__":
    if os.environ.get("SMOKE_WORKER"):
        sys.exit(worker_main())
    sys.exit(main())
