"""CLI surface tests (reference main.cpp argp surface parity)."""

import subprocess
import sys

import numpy as np
import pytest

from tsxcount_tpu.cli import main

from tests.test_packer import naive_kmers, rand_reads


@pytest.fixture()
def fastq(tmp_path):
    rng = np.random.default_rng(0)
    reads = rand_reads(rng, 30, 10, 80)
    path = tmp_path / "in.fastq"
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return path, reads


def test_cli_count_dump_check_roundtrip(fastq, tmp_path):
    path, reads = fastq
    golden = tmp_path / "golden.count"
    want = naive_kmers(reads, 9)
    with open(golden, "w") as f:
        for km, c in want.items():
            f.write(f"{km}\t{c}\n")
    dump = tmp_path / "dump.count"
    rc = main([
        "count", "--input", str(path), "--k", "9", "--l", "12",
        "--batch-words", "64", "--dump", str(dump),
        "--check", "--golden", str(golden), "--stats-json",
    ])
    assert rc == 0
    from tsxcount_tpu.utils.goldenfile import read_golden

    assert read_golden(dump) == dict(want)


def test_cli_checkabort_exit_200(fastq, tmp_path):
    path, reads = fastq
    golden = tmp_path / "golden.count"
    km = next(iter(naive_kmers(reads, 9)))
    golden.write_text(f"{km}\t99999\n")
    rc = main([
        "count", "--input", str(path), "--k", "9", "--l", "12",
        "--batch-words", "64", "--checkabort", "--golden", str(golden),
    ])
    assert rc == 200


def test_cli_table_full_exit_42(fastq):
    path, _ = fastq
    rc = main([
        "count", "--input", str(path), "--k", "9", "--l", "3",
        "--batch-words", "64",
    ])
    assert rc == 42


def test_cli_mode_alias_table(fastq, tmp_path):
    path, reads = fastq
    golden = tmp_path / "golden.count"
    want = naive_kmers(reads, 9)
    with open(golden, "w") as f:
        for km, c in want.items():
            f.write(f"{km}\t{c}\n")
    rc = main([
        "count", "--input", str(path), "--k", "9", "--l", "14",
        "--batch-words", "64", "--mode", "TSX",
        "--check", "--golden", str(golden),
    ])
    assert rc == 0


def test_cli_help_runs():
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0


def test_bench_script_runs_on_cpu(tmp_path):
    """Keeps bench.py (the driver's entry point) green end-to-end."""
    import json

    repo = __file__.rsplit("/tests/", 1)[0]
    proc = subprocess.run(
        [sys.executable, f"{repo}/bench.py", "--platform", "cpu",
         "--reads", "100", "--l", "17", "--batch-words", "4096"],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["metric"] == "kmers_per_second_k14"
    assert result["value"] > 0
    assert result["vs_baseline"] is not None


def test_bench_refuses_unasked_cpu():
    """Without a GPU and without --platform cpu, bench.py prints no
    result line and exits non-zero."""
    import os

    repo = __file__.rsplit("/tests/", 1)[0]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, f"{repo}/bench.py", "--reads", "10"],
        capture_output=True, text=True, timeout=120, env=env,
    )
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr


def test_cli_default_shards1_is_sharded_and_exact(fastq, tmp_path):
    # the CLI default (--shards 1) runs the sharded pipeline (bench.py's
    # configuration too) with exact results
    import tsxcount_tpu.cli as cli

    path, reads = fastq
    want = dict(naive_kmers(reads, 9))
    captured = {}
    orig = cli.cmd_count

    from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

    save = ShardedKmerCounter.__init__

    def spy(self, *a, **kw):
        captured["cls"] = type(self).__name__
        return save(self, *a, **kw)

    ShardedKmerCounter.__init__ = spy
    try:
        dump = tmp_path / "dump.count"
        rc = main([
            "count", "--input", str(path), "--k", "9", "--l", "12",
            "--batch-words", "64", "--dump", str(dump),
        ])
    finally:
        ShardedKmerCounter.__init__ = save
    assert rc == 0
    assert captured.get("cls") == "ShardedKmerCounter"
    from tsxcount_tpu.utils.goldenfile import read_golden

    assert read_golden(dump) == want


def test_cli_shards0_plain_counter_hash_first(fastq, tmp_path):
    # --shards 0 = the plain counter; --hash-first plumbs through (r4
    # VERDICT #4: bench-only before)
    path, reads = fastq
    want = dict(naive_kmers(reads, 9))
    dump = tmp_path / "dump.count"
    rc = main([
        "count", "--input", str(path), "--k", "9", "--l", "12",
        "--batch-words", "64", "--shards", "0", "--hash-first", "mix",
        "--dump", str(dump),
    ])
    assert rc == 0
    from tsxcount_tpu.utils.goldenfile import read_golden

    assert read_golden(dump) == want
