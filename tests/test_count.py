"""Sort+segmented-sum counting and store merge tests."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsxcount_tpu.config import KmerSpec, counts_to_int, int_to_counts
from tsxcount_tpu.core.store import CountStore
from tsxcount_tpu.ops.count import count_unique, int32_to_digits, renorm_digits
from tsxcount_tpu.ops.lanes import np_lanes_to_int


def _random_kmer_batch(rng, n, lanes, top_mask, vocab=32):
    """Batch with heavy duplication drawn from a small vocabulary."""
    vocab_keys = rng.integers(0, 2**32, size=(vocab, lanes), dtype=np.uint32)
    vocab_keys[:, -1] &= top_mask
    idx = rng.integers(0, vocab, size=n)
    return vocab_keys[idx]


@pytest.mark.parametrize("lanes,k", [(1, 14), (2, 32), (4, 63), (8, 127)])
def test_count_unique_exact(lanes, k):
    spec = KmerSpec(k)
    rng = np.random.default_rng(lanes)
    kmers = _random_kmer_batch(rng, 512, spec.lanes, spec.top_lane_mask)
    valid = rng.random(512) < 0.9
    uc = jax.jit(count_unique)(jnp.asarray(kmers), jnp.asarray(valid))
    n = int(uc.n_unique)
    keys = np.asarray(uc.keys)[:n]
    counts = np.asarray(uc.counts)[:n]
    expected = collections.Counter(
        tuple(row) for row, ok in zip(kmers.tolist(), valid.tolist()) if ok
    )
    got = {tuple(row): int(c) for row, c in zip(keys.tolist(), counts)}
    assert got == dict(expected)
    # ascending order over the valid prefix
    ints = np_lanes_to_int(keys)
    assert all(ints[i] < ints[i + 1] for i in range(n - 1))


def _expected_hist(kmers, valid):
    return collections.Counter(
        tuple(row) for row, ok in zip(kmers.tolist(), valid.tolist()) if ok
    )


def _got_hist(uc):
    n = int(uc.n_unique)
    keys = np.asarray(uc.keys)[:n]
    counts = np.asarray(uc.counts)[:n]
    return {tuple(row): int(c) for row, c in zip(keys.tolist(), counts)}


@pytest.mark.parametrize("lanes,k", [(1, 14), (2, 31), (4, 63)])
def test_count_unique_matches_numpy(lanes, k):
    """Batch-sized dedupe against a host histogram, with the valid flags
    marking exactly the n_unique prefix."""
    spec = KmerSpec(k)
    rng = np.random.default_rng(100 + lanes)
    p = 4096
    kmers = _random_kmer_batch(rng, p, spec.lanes, spec.top_lane_mask,
                               vocab=300)
    valid = rng.random(p) < 0.85
    uc = jax.jit(lambda a, b: count_unique(a, b, spec=spec))(
        jnp.asarray(kmers), jnp.asarray(valid)
    )
    assert _got_hist(uc) == dict(_expected_hist(kmers, valid))
    n = int(uc.n_unique)
    np.testing.assert_array_equal(np.asarray(uc.valid), np.arange(p) < n)


@pytest.mark.parametrize("lanes,k", [(2, 31), (3, 48), (4, 63), (8, 127)])
def test_count_unique_uniform_prefix_matches_full_sort(lanes, k):
    """The 64-bit-prefix dedupe sort (hashed-key fast path) must agree
    with the full multi-key sort on uniformly distributed keys."""
    spec = KmerSpec(k)
    rng = np.random.default_rng(7 + lanes)
    p = 2048
    kmers = _random_kmer_batch(rng, p, spec.lanes, spec.top_lane_mask,
                               vocab=200)
    valid = rng.random(p) < 0.85
    kj, vj = jnp.asarray(kmers), jnp.asarray(valid)
    ref = count_unique(kj, vj, spec=spec)
    got = count_unique(kj, vj, spec=spec, uniform_prefix=True)
    n = int(ref.n_unique)
    assert int(got.n_unique) == n
    np.testing.assert_array_equal(
        np.asarray(got.keys)[:n], np.asarray(ref.keys)[:n]
    )
    np.testing.assert_array_equal(
        np.asarray(got.counts)[:n], np.asarray(ref.counts)[:n]
    )


def test_count_unique_uniform_prefix_collision_fallback():
    """Distinct keys that share the whole 64-bit prefix force the exact
    cond fallback — counts must still be correct."""
    spec = KmerSpec(63)  # 4 lanes, top_lane_bits=30 (flag in-lane)
    rng = np.random.default_rng(3)
    p = 256
    kmers = _random_kmer_batch(rng, p, spec.lanes, spec.top_lane_mask,
                               vocab=40)
    # two distinct keys, equal in the top TWO lanes (the sort prefix),
    # differing only in lane 0 — a deliberate prefix collision
    a = np.array([1, 2, 3, 4], np.uint32)
    b = np.array([9, 2, 3, 4], np.uint32)
    kmers[10] = kmers[100] = kmers[200] = a
    kmers[11] = kmers[150] = b
    valid = np.ones(p, bool)
    ref = count_unique(jnp.asarray(kmers), jnp.asarray(valid), spec=spec)
    got = count_unique(jnp.asarray(kmers), jnp.asarray(valid), spec=spec,
                       uniform_prefix=True)
    n = int(ref.n_unique)
    assert int(got.n_unique) == n
    np.testing.assert_array_equal(
        np.asarray(got.keys)[:n], np.asarray(ref.keys)[:n]
    )
    np.testing.assert_array_equal(
        np.asarray(got.counts)[:n], np.asarray(ref.counts)[:n]
    )


@pytest.mark.parametrize("all_valid", [True, False])
def test_count_unique_all_and_none_valid(all_valid):
    spec = KmerSpec(14)
    p = 4096
    rng = np.random.default_rng(7)
    kmers = _random_kmer_batch(rng, p, 1, spec.top_lane_mask, vocab=9)
    valid = np.full(p, all_valid)
    uc = count_unique(jnp.asarray(kmers), jnp.asarray(valid), spec=spec)
    assert _got_hist(uc) == dict(_expected_hist(kmers, valid))
    n = int(uc.n_unique)
    assert int(np.asarray(uc.counts)[:n].sum()) == int(valid.sum())


def test_count_unique_all_invalid():
    spec = KmerSpec(14)
    kmers = jnp.zeros((64, 1), jnp.uint32)
    valid = jnp.zeros((64,), jnp.bool_)
    uc = count_unique(kmers, valid)
    assert int(uc.n_unique) == 0


def test_poly_t_not_confused_with_invalid():
    # all-ones key (poly-T) must still be counted when valid
    spec = KmerSpec(16)
    kmers = jnp.full((8, 1), 0xFFFFFFFF, jnp.uint32)
    valid = jnp.asarray([True] * 5 + [False] * 3)
    uc = count_unique(kmers, valid)
    assert int(uc.n_unique) == 1
    assert int(uc.counts[0]) == 5


def test_u64_digit_roundtrip_and_carry_sum():
    """Digit triples round-trip 64-bit counts, and the blocked device sum
    of digit columns (the stores' total) carries exactly past 2^32."""
    from tsxcount_tpu.ops.count import digit_column_sums, digit_sums_to_int

    vals = [0, 1, 2**20 - 1, 2**20, 2**32 - 1, 2**32, 2**40 + 12345,
            2**52 - 7]
    d = np.asarray([int_to_counts(v) for v in vals], np.int32)
    assert [counts_to_int(*row) for row in d] == vals
    # 5000 rows of digits near 2^20: every block sum is near 2^31, and
    # the total crosses 2^32 several times
    rng = np.random.default_rng(5)
    many = rng.integers(2**20 - 64, 2**20, size=(5000, 3)).astype(np.int32)
    sums = jax.jit(digit_column_sums)([jnp.asarray(many[:, j])
                                       for j in range(3)])
    want = sum(counts_to_int(*row) for row in many.tolist())
    assert digit_sums_to_int(sums) == want


def test_absorb_counts_cross_2_32():
    """Store-to-store absorb (LSM cascade) summing counts past 2^32."""
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=1024)
    big = 2**33 + 17
    key = np.array([[5]], np.uint32)

    def state_with(count):
        st = store.init_state()
        digits = np.zeros((1024, 3), np.int32)
        digits[0] = int_to_counts(count)
        keys = np.zeros((1024, 1), np.uint32)
        keys[0] = key
        return st._replace(
            keys=jnp.asarray(keys),
            digits=jnp.asarray(digits),
            used=jnp.asarray(np.arange(1024) < 1),
            n=jnp.asarray(1, jnp.int32),
        )

    out = jax.jit(store.absorb)(state_with(big), state_with(2**31 + 3))
    keys_h, counts_h, n = store.to_host(out)
    assert n == 1
    assert int(counts_h[0]) == big + 2**31 + 3
    assert store.total(out) == big + 2**31 + 3
    for v in [0, 1, 5, 2**20 - 1, 2**20, 2**31 - 1, 2**40 + 123]:
        assert counts_to_int(*int_to_counts(v)) == v
    # renorm propagates carries
    d = jnp.asarray([[(1 << 20) + 5, (1 << 20) - 1, 0]], jnp.int32)
    out = np.asarray(renorm_digits(d))[0]
    assert counts_to_int(*out) == ((1 << 20) + 5) + (((1 << 20) - 1) << 20)


def test_store_merge_accumulates_across_batches():
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=256)
    state = store.init_state()
    rng = np.random.default_rng(0)
    expected = collections.Counter()
    merge = jax.jit(store.merge)
    for _ in range(5):
        kmers = _random_kmer_batch(rng, 128, 1, spec.top_lane_mask, vocab=40)
        valid = rng.random(128) < 0.8
        expected.update(
            int(row[0]) for row, ok in zip(kmers.tolist(), valid.tolist()) if ok
        )
        uc = count_unique(jnp.asarray(kmers), jnp.asarray(valid))
        state = merge(state, uc.keys, uc.counts, uc.valid)
    keys, counts, n = store.to_host(state)
    got = {int(k[0]): int(c) for k, c in zip(keys, counts)}
    assert got == dict(expected)
    assert not bool(jax.device_get(state.overflowed))


def test_store_large_counts_cross_digit_boundary():
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=16)
    state = store.init_state()
    merge = jax.jit(store.merge)
    key = jnp.asarray([[42]], jnp.uint32)
    # feed count close to int32 max repeatedly -> total crosses 2^32
    big = (1 << 30) + 12345
    for _ in range(5):
        state = merge(
            state,
            key,
            jnp.asarray([big], jnp.int32),
            jnp.asarray([True]),
        )
    _, counts, n = store.to_host(state)
    assert n == 1
    assert int(counts[0]) == 5 * big


def test_store_overflow_flag():
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=4)
    state = store.init_state()
    kmers = jnp.asarray(np.arange(8, dtype=np.uint32)[:, None])
    uc = count_unique(kmers, jnp.ones((8,), jnp.bool_))
    state = store.merge(state, uc.keys, uc.counts, uc.valid)
    assert bool(jax.device_get(state.overflowed))


def test_store_lookup():
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=64)
    state = store.init_state()
    kmers = np.array([[7], [3], [9], [3], [7], [7]], dtype=np.uint32)
    uc = count_unique(jnp.asarray(kmers), jnp.ones((6,), jnp.bool_))
    state = store.merge(state, uc.keys, uc.counts, uc.valid)
    queries = jnp.asarray(np.array([[3], [7], [9], [100]], dtype=np.uint32))
    digits, found = jax.jit(store.lookup)(state, queries)
    digits = np.asarray(digits)
    assert found.tolist() == [True, True, True, False]
    assert [counts_to_int(*d) for d in digits] == [2, 3, 1, 0]
