"""Sharded multi-device counter tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

from tsxcount_tpu.core.counter import KmerCounter
from tsxcount_tpu.parallel.sharded import ShardedKmerCounter

from tests.test_packer import naive_kmers, rand_reads


@pytest.mark.fast
@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_sharded_matches_naive(n_shards):
    rng = np.random.default_rng(n_shards)
    reads = rand_reads(rng, 60, 5, 120)
    counter = ShardedKmerCounter(
        k=9, n_shards=n_shards, l=14, batch_words=32
    )
    # n_shards == 1 runs the raw-key degenerate path (no routing hash)
    assert counter.hashed_store == (n_shards > 1)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, 9))


def test_one_shard_raw_mode_checkpoint_and_queries(tmp_path):
    from tsxcount_tpu.core.checkpoint import load_counter, save_counter

    rng = np.random.default_rng(9)
    reads = rand_reads(rng, 30, 10, 90)
    counter = ShardedKmerCounter(k=9, n_shards=1, l=14, batch_words=32)
    counter.add_reads(reads)
    counter.finish()
    want = naive_kmers(reads, 9)
    some = list(want)[:20] + ["G" * 9]
    assert counter.get_counts(some) == [want.get(km, 0) for km in some]
    path = tmp_path / "one.npz"
    save_counter(counter, path)
    resumed = load_counter(path, batch_words=32)
    assert resumed.to_dict() == dict(want)


def test_sharded_multiword_keys():
    rng = np.random.default_rng(77)
    reads = rand_reads(rng, 16, 80, 300)
    counter = ShardedKmerCounter(k=63, n_shards=4, l=14, batch_words=64)
    counter.add_reads(reads)
    counter.finish()
    assert counter.to_dict() == dict(naive_kmers(reads, 63))


def test_sharded_get_counts_and_stats():
    rng = np.random.default_rng(5)
    reads = rand_reads(rng, 40, 20, 80)
    counter = ShardedKmerCounter(k=7, n_shards=4, l=14, batch_words=32)
    counter.add_reads(reads)
    counter.finish()
    want = naive_kmers(reads, 7)
    some = list(want)[:40] + ["A" * 7]
    assert counter.get_counts(some) == [want.get(km, 0) for km in some]
    st = counter.stats()
    assert st["n_shards"] == 4
    assert st["distinct_kmers"] == len(want)
    assert sum(st["shard_distinct"]) == len(want)


def test_sharded_agrees_with_single_device():
    rng = np.random.default_rng(123)
    reads = rand_reads(rng, 50, 10, 100)
    single = KmerCounter(k=11, l=14, batch_words=32)
    single.add_reads(reads)
    single.finish()
    sharded = ShardedKmerCounter(k=11, n_shards=8, l=17, batch_words=32)
    sharded.add_reads(reads)
    sharded.finish()
    assert sharded.to_dict() == single.to_dict()


@pytest.mark.fast
def test_sharded_golden_small_t7(small_t7_fastq, small_t7_golden):
    """Multi-device bit-exact parity on the checked-in golden file."""
    counter = ShardedKmerCounter(
        k=14, n_shards=8, l=21, batch_words=1 << 12
    )
    counter.count_file(small_t7_fastq)
    from tsxcount_tpu.utils.goldenfile import read_golden

    golden = read_golden(small_t7_golden)
    assert counter.distinct == len(golden)
    res = counter.check(small_t7_golden)
    assert res.ok, (res.mismatches[:3], res.missing[:3], res.extra_distinct)


def test_sharded_table_backend_matches_naive():
    rng = np.random.default_rng(33)
    reads = rand_reads(rng, 40, 10, 100)
    counter = ShardedKmerCounter(
        k=9, n_shards=4, l=16, backend="table", batch_words=32
    )
    counter.add_reads(reads)
    counter.finish()
    want = dict(naive_kmers(reads, 9))
    assert counter.to_dict() == want
    some = list(want)[:30] + ["A" * 9]
    assert counter.get_counts(some) == [want.get(km, 0) for km in some]


def test_sharded_canonical():
    from tests.test_counter import _revcomp
    import collections

    rng = np.random.default_rng(55)
    reads = rand_reads(rng, 30, 15, 80)
    counter = ShardedKmerCounter(
        k=9, n_shards=4, l=15, batch_words=32, canonical=True
    )
    counter.add_reads(reads)
    counter.finish()
    want = collections.Counter()
    for kmer_str, c in naive_kmers(reads, 9).items():
        want[min(kmer_str, _revcomp(kmer_str))] += c
    assert counter.to_dict() == dict(want)


def test_routing_hash_gf2_mode_still_exact(tmp_path):
    """The r3 GF(2) routing bijection stays available (routing_hash='gf2')
    and checkpoint round-trips tag the mode so old files keep decoding."""
    from tsxcount_tpu.core.checkpoint import load_counter, save_counter

    reads = rand_reads(np.random.default_rng(21), 12, 30, 90)
    for rh in ("gf2", "mix"):
        c = ShardedKmerCounter(k=11, n_shards=4, l=15, batch_words=32,
                               routing_hash=rh)
        assert c.routing_hash == rh
        c.add_reads(reads)
        c.finish()
        want = dict(naive_kmers(reads, 11))
        assert c.to_dict() == want
        path = tmp_path / f"s_{rh}.npz"
        save_counter(c, path)
        r = load_counter(path, batch_words=32)
        assert r.routing_hash == rh
        assert r.to_dict() == want


def test_spill_recovery_exact_counts():
    # VERDICT r4 #6: a routed batch overflowing per-destination capacity
    # must not lose the run — the sorted tail past route_cap rides the
    # spill carry and finish() re-routes it.  capacity_factor 0.25 at
    # 3072 positions/batch forces route_cap=1024 < per-destination
    # uniques, so every batch spills a few hundred rows per destination.
    rng = np.random.default_rng(123)
    reads = rand_reads(rng, 40, 150, 151)
    counter = ShardedKmerCounter(
        k=13, n_shards=2, l=16, batch_words=192, capacity_factor=0.25,
    )
    assert counter._carry_enabled and counter.route_cap == 1024
    counter.add_reads(reads)
    counter.finish()
    assert counter._spill_recovered > 0
    assert counter.to_dict() == dict(naive_kmers(reads, 13))
    st = counter.stats()
    assert st["spill_recovered"] == counter._spill_recovered


def test_spill_recovery_one_shard_raw_mode():
    # the degenerate 1-shard raw-key path takes the same carry machinery
    # 1 shard routes EVERY row to destination 0, so keep the per-batch
    # unique count between route_cap (1024) and route_cap + carry chunk
    rng = np.random.default_rng(7)
    reads = rand_reads(rng, 30, 60, 61)
    counter = ShardedKmerCounter(
        k=11, n_shards=1, l=16, batch_words=192, capacity_factor=0.2,
    )
    assert counter._carry_enabled
    counter.add_reads(reads)
    counter.finish()
    assert counter._spill_recovered > 0
    assert counter.to_dict() == dict(naive_kmers(reads, 11))


def test_spill_beyond_carry_raises_table_full():
    # cumulative spill past the carry capacity is still a hard TableFull
    from tsxcount_tpu.core.counter import TableFull

    rng = np.random.default_rng(99)
    reads = rand_reads(rng, 200, 150, 151)  # ~10 spilling batches
    counter = ShardedKmerCounter(
        k=13, n_shards=2, l=16, batch_words=192, capacity_factor=0.25,
    )
    counter.add_reads(reads)
    with pytest.raises(TableFull):
        counter.finish()


def test_spill_recovery_checkpoint_flush(tmp_path):
    # flush() (the checkpoint drain) recovers the carry too
    from tsxcount_tpu.core.checkpoint import load_counter, save_counter

    rng = np.random.default_rng(5)
    reads = rand_reads(rng, 40, 150, 151)
    counter = ShardedKmerCounter(
        k=13, n_shards=2, l=16, batch_words=192, capacity_factor=0.25,
    )
    counter.add_reads(reads)
    path = tmp_path / "spill.npz"
    save_counter(counter, path)
    assert counter._spill_recovered > 0
    resumed = load_counter(path, batch_words=192)
    assert resumed.to_dict() == dict(naive_kmers(reads, 13))
