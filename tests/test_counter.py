"""End-to-end KmerCounter tests, including the golden-file parity check.

The golden check is THE correctness baseline of the reference project
(reference .travis.yml:14, .circleci/config.yml:26-28): k=14 counts of a
1000-read file must match its .14.count file on every entry.  The repo
carries its own seeded fixture (tests/data, see conftest.py), counted by
tools/make_golden.py.
"""

import collections

import numpy as np
import pytest

from tsxcount_tpu.core.counter import KmerCounter, TableFull
from tsxcount_tpu.utils.goldenfile import read_golden

from tests.test_packer import naive_kmers, rand_reads


@pytest.mark.fast
@pytest.mark.parametrize("backend", ["sort", "table"])
def test_counter_matches_naive(backend):
    rng = np.random.default_rng(11)
    reads = rand_reads(rng, 40, 5, 120)
    counter = KmerCounter(k=9, l=12, backend=backend, batch_words=32)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, 9))


@pytest.mark.parametrize("backend", ["sort", "table"])
def test_counter_multiword_keys(backend):
    rng = np.random.default_rng(21)
    reads = rand_reads(rng, 10, 40, 200)
    counter = KmerCounter(k=33, l=12, backend=backend, batch_words=64)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, 33))


@pytest.mark.parametrize("k", [16, 48])
def test_counter_full_top_lane(k):
    """k % 16 == 0: the key fills its top lane, so the validity flag needs
    a separate sort operand (pack_flag_key's top_lane_bits == 32 case)."""
    rng = np.random.default_rng(k)
    reads = rand_reads(rng, 15, k + 2, 2 * k + 50)
    counter = KmerCounter(k=k, l=12, batch_words=64)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, k))


def test_counter_get_counts_queries():
    rng = np.random.default_rng(5)
    reads = rand_reads(rng, 20, 20, 60)
    counter = KmerCounter(k=7, l=12, batch_words=32)
    counter.add_reads(reads)
    counter.finish()
    want = naive_kmers(reads, 7)
    some = list(want)[:50] + ["A" * 7]
    got = counter.get_counts(some)
    assert got == [want.get(km, 0) for km in some]


def test_counter_synthetic_stress_known_frequencies():
    """Port of testHashMapOld (reference testExecution.h:363-497): known
    relative frequencies N, N/2, N/2, N/4 must come out exact."""
    n = 2048
    kmers = ["ACGTACGTACGTAC", "TTTTACGTACGTAC", "ACGTACGTTTTTTT",
             "GGGGACGTACGTAC"]
    freqs = [n, n // 2, n // 2, n // 4]
    reads = []
    for km, f in zip(kmers, freqs):
        reads.extend([km] * f)
    rng = np.random.default_rng(0)
    order = rng.permutation(len(reads))
    counter = KmerCounter(k=14, l=12, batch_words=16)
    counter.add_reads([reads[i] for i in order])
    counter.finish()
    got = counter.to_dict()
    assert got == dict(zip(kmers, freqs))


def test_counter_table_full_raises():
    rng = np.random.default_rng(2)
    reads = rand_reads(rng, 30, 30, 60)
    counter = KmerCounter(k=10, l=4, backend="sort", batch_words=32)
    counter.add_reads(reads)
    with pytest.raises(TableFull):
        counter.finish()


def test_counter_mode_aliases():
    assert KmerCounter(k=5, l=8, backend="SERIAL", batch_words=8).backend == "sort"
    assert KmerCounter(k=5, l=8, backend="TSX", batch_words=8).backend == "table"


@pytest.mark.fast
@pytest.mark.parametrize("backend", ["sort", "table"])
def test_golden_small_t7_k14(backend, small_t7_fastq, small_t7_golden):
    """Bit-exact k=14 parity vs the checked-in golden file."""
    # sort: capacity just above the 194954 distinct kmers; table: reprobing
    # needs headroom (the reference default l=26 runs at 0.3% fill)
    l = 18 if backend == "sort" else 20
    counter = KmerCounter(
        k=14, l=l, backend=backend, batch_words=1 << 14
    )
    counter.count_file(small_t7_fastq)
    golden = read_golden(small_t7_golden)
    assert counter.distinct == len(golden) == 194954
    res = counter.check(small_t7_golden)
    assert res.ok, (res.mismatches[:5], res.missing[:5], res.extra_distinct)
    assert res.n_matched == 194954


def test_golden_dump_roundtrip(small_t7_fastq, small_t7_golden, tmp_path):
    from tsxcount_tpu.utils.goldenfile import write_golden

    counter = KmerCounter(k=14, l=18, batch_words=1 << 14)
    counter.count_file(small_t7_fastq)
    out = tmp_path / "dump.count"
    write_golden(out, counter.to_dict())
    assert read_golden(out) == read_golden(small_t7_golden)


def _revcomp(s):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    return "".join(comp[c] for c in reversed(s))


@pytest.mark.parametrize("k", [7, 14, 33])
def test_counter_canonical(k):
    """--canonical counts min(kmer, revcomp) — beyond-reference feature."""
    import collections

    rng = np.random.default_rng(k)
    reads = rand_reads(rng, 25, k, 3 * k + 30)
    counter = KmerCounter(k=k, l=13, batch_words=64, canonical=True)
    counter.add_reads(reads)
    counter.finish()
    want = collections.Counter()
    for kmer_str, c in naive_kmers(reads, k).items():
        want[min(kmer_str, _revcomp(kmer_str))] += c
    assert counter.to_dict() == dict(want)
    some = list(want)[:20]
    assert counter.get_counts(some) == [want[km] for km in some]


def test_counter_k200_beyond_reference_width():
    """Keys wider than the reference's k<=128 headline (13 uint32 lanes)."""
    rng = np.random.default_rng(200)
    reads = rand_reads(rng, 6, 220, 400)
    counter = KmerCounter(k=200, l=12, batch_words=128)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, 200))
