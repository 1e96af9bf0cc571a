"""Native C++ packer parity vs the pure-Python reference packer."""

import gzip

import numpy as np
import pytest

from tsxcount_tpu.config import BatchSpec, KmerSpec
from tsxcount_tpu.io.native import NativeFileReader, native_available, native_build_error
from tsxcount_tpu.io.packer import ReadPacker

from tests.test_packer import kmers_from_batches, naive_kmers, rand_reads

pytestmark = pytest.mark.skipif(
    not native_available(), reason=f"native packer: {native_build_error()}"
)


def write_fastq(path, reads):
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")


def python_batches(reads, batch, **kw):
    packer = ReadPacker(batch, **kw)
    out = []
    for seq in reads:
        out.extend(packer.feed(seq))
    out.extend(packer.finish())
    return out, packer.stats


@pytest.mark.parametrize("k", [4, 14, 31])
def test_native_bit_identical_to_python(tmp_path, k):
    rng = np.random.default_rng(k)
    reads = rand_reads(rng, 50, 1, 200)
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), capacity_words=64)

    py_batches, py_stats = python_batches(reads, batch)
    reader = NativeFileReader(path, batch)
    nat_batches = list(reader)

    assert len(nat_batches) == len(py_batches)
    for nb, pb in zip(nat_batches, py_batches):
        np.testing.assert_array_equal(nb.buf, pb.buf)  # words AND intervals
        assert nb.n_valid == pb.n_valid
    assert reader.stats.reads == py_stats.reads
    assert reader.stats.reads_skipped == py_stats.reads_skipped
    assert reader.stats.windows == py_stats.windows
    assert reader.stats.bases == py_stats.bases


def test_native_gzip_and_long_read_split(tmp_path):
    k = 14
    rng = np.random.default_rng(9)
    reads = ["".join(rng.choice(list("ACGT"), size=5000))] + rand_reads(
        rng, 10, 5, 100
    )
    path = tmp_path / "t.fastq.gz"
    with gzip.open(path, "wt") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    batch = BatchSpec(KmerSpec(k), capacity_words=32)
    got = kmers_from_batches(NativeFileReader(path, batch), k)
    assert got == naive_kmers(reads, k)


def test_native_fasta_multiline(tmp_path):
    k = 6
    path = tmp_path / "t.fasta"
    with open(path, "w") as f:
        f.write(">s1 desc\nACGTACGTAC\nGTACGTACGT\n>s2\nTTTTGGGG\n")
    reads = ["ACGTACGTACGTACGTACGT", "TTTTGGGG"]
    batch = BatchSpec(KmerSpec(k), capacity_words=16)
    got = kmers_from_batches(NativeFileReader(path, batch), k)
    assert got == naive_kmers(reads, k)


def test_native_n_policy_drop(tmp_path):
    k = 5
    reads = ["ACGTNACGTACGT", "NNNNN", "ACGTACG"]
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), capacity_words=8)
    got = kmers_from_batches(NativeFileReader(path, batch), k)
    assert got == naive_kmers(reads, k)


def test_native_interval_budget_truncation_parity(tmp_path):
    # N-dense read with more valid runs than the interval budget: the
    # native packer must truncate/early-flush bit-identically to Python
    k = 4
    reads = [("ACGTA" + "N") * 3000, "ACGT" * 10]
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), capacity_words=2048)
    py_batches, py_stats = python_batches(reads, batch)
    nat_batches = list(NativeFileReader(path, batch))
    assert len(nat_batches) == len(py_batches) >= 3
    for nb, pb in zip(nat_batches, py_batches):
        np.testing.assert_array_equal(nb.buf, pb.buf)
        assert nb.n_valid == pb.n_valid


def test_native_byte_ranges_partition_records(tmp_path):
    """Every record is owned by exactly one byte range, for any cut set —
    including cuts landing exactly on record starts."""
    from collections import Counter

    from tsxcount_tpu.io.native import split_ranges

    k = 6
    rng = np.random.default_rng(11)
    reads = rand_reads(rng, 40, 3, 120)
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), capacity_words=16)
    want = naive_kmers(reads, k)

    import os

    size = os.path.getsize(path)
    # record-start offsets (each record = 4 lines starting with @rI)
    rec_offsets = []
    off = 0
    for line in open(path, "rb"):
        if line.startswith(b"@r"):
            rec_offsets.append(off)
        off += len(line)

    cut_sets = [
        split_ranges(path, 3),
        split_ranges(path, 7),
        # cuts exactly at record starts (the ownership edge case)
        [(0, rec_offsets[10]), (rec_offsets[10], rec_offsets[20]),
         (rec_offsets[20], size)],
    ]
    for ranges in cut_sets:
        got: Counter = Counter()
        reads_seen = 0
        for s, e in ranges:
            rr = NativeFileReader(path, batch, byte_start=s, byte_end=e)
            part = kmers_from_batches(rr, k)
            for kmer_str, cnt in part.items():
                got[kmer_str] += cnt
        assert dict(got) == want


@pytest.mark.parametrize("threads", [2, 5])
def test_native_threaded_reader_counts(tmp_path, threads):
    k = 8
    rng = np.random.default_rng(13)
    reads = rand_reads(rng, 60, 3, 150)
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    batch = BatchSpec(KmerSpec(k), capacity_words=16)
    reader = NativeFileReader(path, batch, threads=threads)
    got = kmers_from_batches(reader, k)
    assert got == naive_kmers(reads, k)
    assert reader.stats.reads == len(reads)


def test_native_fasta_byte_ranges(tmp_path):
    from collections import Counter

    k = 5
    path = tmp_path / "t.fasta"
    reads = ["ACGTACGTACGTACGTACGT", "TTTTGGGGCCCCAAAA", "GATTACAGATTACA"]
    with open(path, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f">s{i}\n{seq[:10]}\n{seq[10:]}\n")
    batch = BatchSpec(KmerSpec(k), capacity_words=8)
    want = naive_kmers(reads, k)
    import os

    size = os.path.getsize(path)
    for n in (2, 4):
        got: Counter = Counter()
        from tsxcount_tpu.io.native import split_ranges

        for s, e in split_ranges(path, n):
            part = kmers_from_batches(
                NativeFileReader(path, batch, byte_start=s, byte_end=e), k
            )
            for kmer_str, cnt in part.items():
                got[kmer_str] += cnt
        assert dict(got) == want


def test_native_gzip_rejects_ranges_degrades_threads(tmp_path):
    k = 5
    path = tmp_path / "t.fastq.gz"
    reads = ["ACGTACGTACGT", "TTTTGGGG"]
    with gzip.open(path, "wt") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    batch = BatchSpec(KmerSpec(k), capacity_words=8)
    with pytest.raises(ValueError, match="uncompressed"):
        NativeFileReader(path, batch, byte_start=10, byte_end=20)
    # threads > 1 on gzip silently degrades to one stream
    got = kmers_from_batches(NativeFileReader(path, batch, threads=4), k)
    assert got == naive_kmers(reads, k)


def test_counter_threads_end_to_end(tmp_path):
    from tsxcount_tpu.core.counter import KmerCounter

    k = 9
    rng = np.random.default_rng(17)
    reads = rand_reads(rng, 50, 3, 150)
    path = tmp_path / "t.fastq"
    write_fastq(path, reads)
    counter = KmerCounter(k=k, l=14, batch_words=32, threads=3)
    counter.count_file(path)
    assert counter.to_dict() == naive_kmers(reads, k)
    assert counter.packer.stats.reads == len(reads)


def test_native_malformed_fastq(tmp_path):
    path = tmp_path / "bad.fastq"
    path.write_text("not a fastq\nACGT\n")
    batch = BatchSpec(KmerSpec(4), capacity_words=8)
    with pytest.raises(ValueError, match="parse error"):
        list(NativeFileReader(path, batch))


def test_native_builds_from_source(tmp_path, monkeypatch):
    """The library is built from fastxpack.cpp into a path keyed by the
    source and the compiler command; another source or other flags get
    another build."""
    import ctypes

    from tsxcount_tpu.io import native

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    path = native.lib_path()
    assert path.parent == tmp_path / "build" and not path.exists()
    assert native._build(path), native._build_error
    assert ctypes.CDLL(str(path)).fxp_open_range
    assert not list(path.parent.glob("*.tmp"))

    src = tmp_path / "fastxpack.cpp"
    src.write_text(native._SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "_SRC", src)
    edited = native.lib_path()
    monkeypatch.setattr(native, "_FLAGS", native._FLAGS + ["-DTSX_TEST"])
    assert len({path, edited, native.lib_path()}) == 3
