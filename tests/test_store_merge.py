"""CountStore.merge_stacked and absorb against a host dict merge.

Cases: R in {1, 2, 3} stacked batch runs; heavy duplication; an
all-invalid batch; disjoint and unbalanced run sizes; a store whose unused
tail holds junk keys; every key width (k = 14, 16, 31, 63, 127, including
k=16's standalone flag column); and digit sums that cross 2^31 and 2^32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsxcount_tpu.config import KmerSpec, counts_to_int, int_to_counts
from tsxcount_tpu.core.store import CountStore, StoreState


def _rand_keys(rng, n, spec, vocab=None):
    """n distinct sorted keys (msb lane last, lexicographic ascending)."""
    lanes = spec.lanes
    if vocab is not None:
        keys = vocab[rng.choice(len(vocab), size=min(n, len(vocab)),
                                replace=False)]
    else:
        keys = rng.integers(0, 2**32, size=(n, lanes), dtype=np.uint32)
        keys[:, -1] &= np.uint32(spec.top_lane_mask)
    keys = np.unique(keys, axis=0)
    return keys[np.lexsort(tuple(keys[:, j] for j in range(lanes)))]


def _state(spec, cap, keys, counts, junk_tail=False, rng=None):
    n = len(keys)
    lanes = spec.lanes
    k = np.zeros((cap, lanes), np.uint32)
    k[:n] = keys
    digits = np.zeros((cap, 3), np.int32)
    if n:
        digits[:n] = [int_to_counts(int(c)) for c in counts]
    if junk_tail:
        # real-looking unsorted keys and counts beyond the used prefix
        k[n:] = rng.integers(0, 2**32, size=(cap - n, lanes),
                             dtype=np.uint32)
        k[n:, -1] &= np.uint32(spec.top_lane_mask)
        digits[n:, 0] = rng.integers(1, 50, size=cap - n)
    return StoreState(
        keys=jnp.asarray(k), digits=jnp.asarray(digits),
        used=jnp.asarray(np.arange(cap) < n),
        n=jnp.asarray(n, jnp.int32), overflowed=jnp.asarray(False),
    )


def _batches(rng, spec, r, p, sizes, vocab=None, max_count=50):
    lanes = spec.lanes
    ukeys = np.zeros((r, p, lanes), np.uint32)
    ucounts = np.zeros((r, p), np.int32)
    uvalid = np.zeros((r, p), bool)
    for i, size in enumerate(sizes):
        keys = _rand_keys(rng, size, spec, vocab) if size else \
            np.zeros((0, lanes), np.uint32)
        n = len(keys)
        ukeys[i, :n] = keys
        # junk beyond the valid prefix must be ignored
        ukeys[i, n:] = rng.integers(0, 2**16, size=(p - n, lanes))
        ucounts[i] = rng.integers(1, max_count, size=p)
        uvalid[i, :n] = True
    return ukeys, ucounts, uvalid


def _host_dict(keys, digits, n):
    keys = np.asarray(keys)[:n]
    digits = np.asarray(digits)[:n]
    return {tuple(k): counts_to_int(*d) for k, d in zip(keys.tolist(),
                                                         digits.tolist())}


def _check(store, out, want):
    n = int(out.n)
    assert n == len(want)
    got = _host_dict(out.keys, out.digits, n)
    assert got == want
    keys = np.asarray(out.keys)[:n]
    order = np.lexsort(tuple(keys[:, j] for j in range(keys.shape[1])))
    np.testing.assert_array_equal(order, np.arange(n))  # ascending
    np.testing.assert_array_equal(np.asarray(out.used), np.arange(
        store.capacity) < n)
    assert store.total(out) == sum(want.values())
    assert not bool(out.overflowed)


def _merge_case(k, r, store_n, batch_sizes, seed, cap=4096, p=2048,
                vocab_size=None, junk_tail=False, max_count=50):
    spec = KmerSpec(k)
    rng = np.random.default_rng(seed)
    vocab = (_rand_keys(rng, vocab_size, spec)
             if vocab_size is not None else None)
    skeys = _rand_keys(rng, store_n, spec, vocab) if store_n else \
        np.zeros((0, spec.lanes), np.uint32)
    scounts = rng.integers(1, max_count, size=len(skeys))
    store = CountStore(spec, capacity=cap)
    state = _state(spec, cap, skeys, scounts, junk_tail, rng)
    ukeys, ucounts, uvalid = _batches(rng, spec, r, p, batch_sizes,
                                      vocab, max_count)
    want = {tuple(kk): int(c) for kk, c in zip(skeys.tolist(), scounts)}
    for i in range(r):
        for kk, c, ok in zip(ukeys[i].tolist(), ucounts[i], uvalid[i]):
            if ok:
                want[tuple(kk)] = want.get(tuple(kk), 0) + int(c)
    out = jax.jit(store.merge_stacked)(
        state, jnp.asarray(ukeys), jnp.asarray(ucounts), jnp.asarray(uvalid)
    )
    _check(store, out, want)


@pytest.mark.parametrize("r", [1, 2, 3])
def test_merge_stacked_r_runs(r):
    _merge_case(31, r, 700, [900, 1200, 600][:r], seed=r)


def test_merge_stacked_heavy_duplication():
    # every run drawn from one 300-key vocabulary: most keys appear in the
    # store and in all three batches (R+1 rows per run), and counts near
    # 2^30 carry across the 2^31 int32 range
    _merge_case(31, 3, 250, [280, 290, 300], seed=5, vocab_size=300,
                max_count=2**30)


def test_merge_stacked_all_invalid_batch():
    _merge_case(63, 2, 500, [0, 700], seed=11)


def test_merge_stacked_disjoint_and_unbalanced():
    spec = KmerSpec(14)
    store = CountStore(spec, capacity=8192)
    skeys = np.arange(0, 7000, dtype=np.uint32)[:, None]
    bkeys = np.arange(100_000, 100_048, dtype=np.uint32)[:, None]
    scounts = np.full(len(skeys), 3)
    state = _state(spec, 8192, skeys, scounts)
    ukeys = np.zeros((1, 1024, 1), np.uint32)
    ukeys[0, :48] = bkeys
    ucounts = np.full((1, 1024), 2, np.int32)
    uvalid = (np.arange(1024) < 48)[None]
    out = jax.jit(store.merge_stacked)(
        state, jnp.asarray(ukeys), jnp.asarray(ucounts), jnp.asarray(uvalid)
    )
    want = {(int(kk),): 3 for kk in skeys[:, 0]}
    want.update({(int(kk),): 2 for kk in bkeys[:, 0]})
    _check(store, out, want)


def test_merge_stacked_junk_store_tail():
    """Unused store rows holding junk keys and counts (a state restored
    from another layout, or never zeroed) must not leak into the merge."""
    _merge_case(31, 1, 1000, [1500], seed=17, junk_tail=True)


@pytest.mark.parametrize("m,n", [(1024, 1024), (2000, 48), (0, 2048),
                                 (3072, 1024)])
def test_merge_stacked_run_sizes(m, n):
    _merge_case(14, 1, m, [n], seed=m + n)


@pytest.mark.parametrize("k", [14, 16, 31, 63, 127])
def test_merge_stacked_key_widths(k):
    _merge_case(k, 2, 700, [800, 800], seed=k, vocab_size=2000)


@pytest.mark.parametrize("k", [14, 16, 31, 63, 127])
def test_absorb_key_widths(k):
    spec = KmerSpec(k)
    rng = np.random.default_rng(40 + k)
    vocab = _rand_keys(rng, 3000, spec)
    upper = CountStore(spec, capacity=4096)
    lower_cap = 2048
    ak = _rand_keys(rng, 1500, spec, vocab)
    bk = _rand_keys(rng, 1200, spec, vocab)
    ac = rng.integers(1, 2**31, size=len(ak))
    bc = rng.integers(1, 2**31, size=len(bk))
    a = _state(spec, 4096, ak, ac)
    b = _state(spec, lower_cap, bk, bc)
    want = {tuple(kk): int(c) for kk, c in zip(ak.tolist(), ac)}
    for kk, c in zip(bk.tolist(), bc):
        want[tuple(kk)] = want.get(tuple(kk), 0) + int(c)
    out = jax.jit(upper.absorb)(a, b)
    _check(upper, out, want)


def test_absorb_junk_tails():
    spec = KmerSpec(31)
    rng = np.random.default_rng(23)
    store = CountStore(spec, capacity=4096)
    ak = _rand_keys(rng, 900, spec)
    bk = np.concatenate([ak[100:400], _rand_keys(rng, 500, spec)])
    bk = np.unique(bk, axis=0)
    bk = bk[np.lexsort((bk[:, 0], bk[:, 1]))]
    ac = rng.integers(1, 99, size=len(ak))
    bc = rng.integers(1, 99, size=len(bk))
    a = _state(spec, 4096, ak, ac, junk_tail=True, rng=rng)
    b = _state(spec, 2048, bk, bc, junk_tail=True, rng=rng)
    want = {tuple(kk): int(c) for kk, c in zip(ak.tolist(), ac)}
    for kk, c in zip(bk.tolist(), bc):
        want[tuple(kk)] = want.get(tuple(kk), 0) + int(c)
    _check(store, jax.jit(store.absorb)(a, b), want)
