"""Quotient table tests: insert/lookup/reconstruction parity."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsxcount_tpu.config import KmerSpec, counts_to_int
from tsxcount_tpu.core.table import QuotientTable
from tsxcount_tpu.ops.count import count_unique
from tsxcount_tpu.ops.gf2 import GF2Hash


def _make_table(k=14, l=10, seed=1, max_reprobes=64):
    spec = KmerSpec(k)
    return QuotientTable(spec, l, GF2Hash(spec, seed=seed),
                         max_reprobes=max_reprobes), spec


def _insert_batch(table, state, keys_np, valid_np):
    uc = count_unique(jnp.asarray(keys_np), jnp.asarray(valid_np))
    return jax.jit(table.insert)(state, uc.keys, uc.counts, uc.valid)


@pytest.mark.parametrize("k", [14, 33, 127])
def test_insert_lookup_exact(k):
    table, spec = _make_table(k=k, l=9)
    state = table.init_state()
    rng = np.random.default_rng(k)
    vocab = rng.integers(0, 2**32, size=(100, spec.lanes), dtype=np.uint32)
    vocab[:, -1] &= spec.top_lane_mask
    vocab = np.unique(vocab, axis=0)
    expected = collections.Counter()
    for _ in range(4):
        idx = rng.integers(0, len(vocab), size=256)
        batch = vocab[idx]
        valid = rng.random(256) < 0.9
        expected.update(
            tuple(r) for r, ok in zip(batch.tolist(), valid.tolist()) if ok
        )
        state = _insert_batch(table, state, batch, valid)
    assert int(jax.device_get(state.spilled)) == 0
    assert int(jax.device_get(state.n)) == len(expected)

    queries = np.array([list(kk) for kk in expected], dtype=np.uint32)
    digits, found = jax.jit(table.lookup)(state, jnp.asarray(queries))
    assert bool(np.asarray(found).all())
    got = [counts_to_int(*d) for d in np.asarray(digits)]
    want = [expected[tuple(q)] for q in queries.tolist()]
    assert got == want

    # absent keys are not found
    absent = vocab[:8].copy()
    absent[:, 0] ^= 0xDEADBEEF
    absent[:, -1] &= spec.top_lane_mask
    _, found = jax.jit(table.lookup)(state, jnp.asarray(absent))
    present = {tuple(r) for r in vocab.tolist()}
    for row, f in zip(absent.tolist(), np.asarray(found).tolist()):
        if tuple(row) not in present:
            assert not f


def test_reconstruct_all_kmers():
    """getAllKmers parity: every stored slot reconstructs its exact k-mer
    via the inverse hash (reference TSXHashMap.h:660-722)."""
    table, spec = _make_table(k=14, l=8)
    state = table.init_state()
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**28, size=(150, 1), dtype=np.uint32)
    state = _insert_batch(table, state, keys, np.ones(150, bool))
    kmers, counts, n = table.to_host(state)
    expected = collections.Counter(int(k[0]) for k in keys)
    got = {int(k[0]): int(c) for k, c in zip(kmers, counts)}
    assert got == dict(expected)


def test_heavy_collisions_reprobe_chain():
    # tiny table, identity hash -> forced collisions exercise reprobing
    spec = KmerSpec(14)
    table = QuotientTable(spec, 4, GF2Hash(spec, identity=True),
                          max_reprobes=15)
    state = table.init_state()
    # 12 keys all with identical low-4 hash bits (pos0 identical)
    keys = np.array([[i << 4] for i in range(12)], dtype=np.uint32)
    state = _insert_batch(table, state, keys, np.ones(12, bool))
    assert int(jax.device_get(state.spilled)) == 0
    digits, found = table.lookup(state, jnp.asarray(keys))
    assert bool(np.asarray(found).all())
    assert all(counts_to_int(*d) == 1 for d in np.asarray(digits))
    kmers, counts, n = table.to_host(state)
    assert n == 12
    assert sorted(int(k[0]) for k in kmers) == [i << 4 for i in range(12)]


def test_spill_on_full_table():
    spec = KmerSpec(14)
    table = QuotientTable(spec, 3, GF2Hash(spec, seed=2), max_reprobes=7)
    state = table.init_state()
    keys = np.arange(64, dtype=np.uint32)[:, None]  # 64 keys, 8 slots
    state = _insert_batch(table, state, keys, np.ones(64, bool))
    assert int(jax.device_get(state.spilled)) > 0


def test_deterministic_layout():
    table, spec = _make_table(k=14, l=8)
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 2**28, size=(200, 1), dtype=np.uint32)
    s1 = _insert_batch(table, table.init_state(), keys, np.ones(200, bool))
    s2 = _insert_batch(table, table.init_state(), keys, np.ones(200, bool))
    np.testing.assert_array_equal(np.asarray(s1.slots), np.asarray(s2.slots))


def test_get_positions_debug_api():
    """getPosition/getKmerPositions parity: slot+reprobe consistent with
    the triangular probe sequence and the stored key encoding."""
    import jax.numpy as jnp

    table, spec = _make_table(k=14, l=8)
    state = table.init_state()
    rng = np.random.default_rng(12)
    keys = rng.integers(0, 2**28, size=(100, 1), dtype=np.uint32)
    keys = np.unique(keys, axis=0)
    state = _insert_batch(table, state, keys, np.ones(len(keys), bool))
    pos, rep, found = jax.jit(table.get_positions)(state, jnp.asarray(keys))
    pos, rep, found = map(np.asarray, (pos, rep, found))
    assert found.all()
    # verify against host-side hash arithmetic
    h = table.hash_fn.apply_host(keys)
    pos0 = h[:, 0] & ((1 << 8) - 1)
    expect = (pos0 + rep * (rep + 1) // 2) % table.slots
    np.testing.assert_array_equal(pos, expect)
    # absent key
    absent = np.array([[0x0FABCDEF]], dtype=np.uint32)
    if not any((absent == k).all() for k in keys):
        p2, r2, f2 = table.get_positions(state, jnp.asarray(absent))
        if not bool(np.asarray(f2)[0]):
            assert int(np.asarray(p2)[0]) == -1


def test_two_level_residue_schedule_exact():
    """The r4 two-level insert (full-width rounds -> compacted residue
    rounds) must agree exactly with per-key reference counts on a batch
    whose collisions force MANY rounds through both loops, including a
    tiny residue_frac so the residue buffer is exercised hard."""
    import numpy as np

    table, spec = _make_table(k=14, l=6, max_reprobes=40)
    rng = np.random.default_rng(9)
    p = 1024
    # few distinct keys, heavy duplication across slots of a 64-slot table
    base = rng.integers(0, 4**7, size=40, dtype=np.uint32)
    keys = np.unique(base)[:, None].astype(np.uint32)
    n_k = len(keys)
    ukeys = np.zeros((p, 1), np.uint32)
    ukeys[:n_k] = keys
    ucounts = np.zeros(p, np.int32)
    ucounts[:n_k] = rng.integers(1, 9, size=n_k)
    uvalid = np.arange(p) < n_k
    state = jax.jit(table.insert)(
        table.init_state(), jnp.asarray(ukeys), jnp.asarray(ucounts),
        jnp.asarray(uvalid),
    )
    assert int(jax.device_get(state.spilled)) == 0
    assert int(jax.device_get(state.n)) == n_k
    digits, found = jax.jit(table.lookup)(state, jnp.asarray(ukeys[:n_k]))
    assert bool(np.all(np.asarray(jax.device_get(found))))
    got = np.asarray(jax.device_get(digits))[:, 0]
    np.testing.assert_array_equal(got, ucounts[:n_k])


def test_residue_overflow_spills_exactly():
    """Rows that cannot fit the residue buffer once the reprobe budget is
    exhausted must be counted spilled (not silently dropped)."""
    import numpy as np

    spec = KmerSpec(14)
    # 8 slots, 2 reprobes: most of a 300-key batch must spill
    table = QuotientTable(spec, 3, GF2Hash(spec, seed=3), max_reprobes=2)
    rng = np.random.default_rng(4)
    p = 512
    keys = np.unique(
        rng.integers(0, 4**7, size=400, dtype=np.uint32)
    )[:300][:, None]
    n_k = len(keys)
    ukeys = np.zeros((p, 1), np.uint32)
    ukeys[:n_k] = keys
    ucounts = np.ones(p, np.int32)
    uvalid = np.arange(p) < n_k
    state = jax.jit(table.insert)(
        table.init_state(), jnp.asarray(ukeys), jnp.asarray(ucounts),
        jnp.asarray(uvalid),
    )
    resolved = int(jax.device_get(state.n))
    spilled = int(jax.device_get(state.spilled))
    assert resolved + spilled == n_k  # nothing lost, nothing double-counted
    assert spilled > 0


def _rand_batch(rng, n, n_u, spec):
    import numpy as np

    ukeys = np.zeros((n, spec.lanes), np.uint32)
    uniq = rng.choice(2**min(28, 2 * spec.k), size=n_u, replace=False)
    for j in range(spec.lanes):
        ukeys[:n_u, j] = (uniq >> (32 * j)) & 0xFFFFFFFF
    ukeys[:n_u, -1] &= np.uint32(spec.top_lane_mask)
    ucounts = rng.integers(1, 9, size=n, dtype=np.int32)
    uvalid = np.arange(n) < n_u
    return ukeys, ucounts, uvalid


def _slice_carry(carry, w):
    p0, cl, c, a = carry
    return p0[:w], tuple(x[:w] for x in cl), c[:w], a[:w]


def _split_insert(table, st, k, c, v):
    """The single-device counter's insert flow: full-width split rounds
    at shrinking widths, then the residue loop."""
    st, carry, _, n_left = table.split_round(
        st, 0, *table.round0_args(k, c, v)
    )
    f = int(jax.device_get(n_left))
    if f == 0:
        return st._replace(slots=table._renorm_flat(st.slots))
    w1 = min(k.shape[0], max(256, 1 << (f - 1).bit_length()))
    st, carry, _, n_left = table.split_round(
        st, 1, *_slice_carry(carry, w1)
    )
    f = int(jax.device_get(n_left))
    if f == 0:
        return st._replace(slots=table._renorm_flat(st.slots))
    w2 = min(w1, max(256, 1 << (f - 1).bit_length()))
    return table.residue_phase(st, _slice_carry(carry, w2), 2, w2)


def _table_dict(table, st):
    kk, cc, _ = table.to_host(st)
    return {tuple(int(x) for x in k): int(c) for k, c in zip(kk, cc)}


def test_split_flow_matches_insert():
    # the split flow (split rounds + residue) against the one-program
    # insert: same counts, same n, no spill
    spec = KmerSpec(14)
    rng = np.random.default_rng(3)
    table = QuotientTable(spec, 10, GF2Hash(spec))
    n, n_u = 2048, 700
    ukeys, ucounts, uvalid = _rand_batch(rng, n, n_u, spec)
    args = (jnp.asarray(ukeys), jnp.asarray(ucounts), jnp.asarray(uvalid))
    st_s = _split_insert(table, table.init_state(), *args)
    st_l = table.insert(table.init_state(), *args)
    assert int(st_s.n) == n_u == int(st_l.n)
    assert int(st_s.spilled) == 0
    assert _table_dict(table, st_s) == _table_dict(table, st_l)


def test_split_flow_multi_batch_exact():
    # multi-batch ingest through the split flow: counts add exactly and
    # matches hit keys claimed in earlier batches at any reprobe depth
    spec = KmerSpec(14)
    rng = np.random.default_rng(17)
    table = QuotientTable(spec, 16, GF2Hash(spec))
    st = table.init_state()
    truth = {}
    for _ in range(4):
        n = 2048
        n_u = int(rng.integers(700, 1500))
        uniq = rng.choice(2**16, size=n_u, replace=False).astype(np.uint32)
        ukeys = np.zeros((n, 1), np.uint32)
        ukeys[:n_u, 0] = uniq
        ucounts = rng.integers(1, 5, size=n).astype(np.int32)
        uvalid = np.arange(n) < n_u
        for k_, c_ in zip(uniq, ucounts[:n_u]):
            truth[(int(k_),)] = truth.get((int(k_),), 0) + int(c_)
        st = _split_insert(
            table, st, jnp.asarray(ukeys), jnp.asarray(ucounts),
            jnp.asarray(uvalid),
        )
    assert int(st.n) == len(truth)
    assert int(st.spilled) == 0
    assert table.total(st) == sum(truth.values())
    assert _table_dict(table, st) == truth


def _round_case(name):
    """(table, ukeys, ucounts, uvalid) for one element-round case."""
    spec = KmerSpec(14)
    if name.startswith("random"):
        seed = int(name[-1])
        rng = np.random.default_rng(seed)
        table = QuotientTable(spec, 12, GF2Hash(spec, seed=seed + 1))
        return (table,) + _rand_batch(rng, 2048, 1500, spec)
    rng = np.random.default_rng(42)
    if name == "dense":
        # every slot of a 2^11 table claimed: long reprobe chains
        table = QuotientTable(spec, 11, GF2Hash(spec), max_reprobes=2047)
        return (table,) + _rand_batch(rng, 2048, 2048, spec)
    if name == "sparse":
        table = QuotientTable(spec, 12, GF2Hash(spec))
        return (table,) + _rand_batch(rng, 2048, 1, spec)
    if name == "none_active":
        table = QuotientTable(spec, 11, GF2Hash(spec))
        return (table,) + _rand_batch(rng, 512, 0, spec)
    ident = QuotientTable(spec, 12, GF2Hash(spec, identity=True),
                          max_reprobes=64)
    if name == "edge_slots":
        # identity hash: slots at the ends of the table and neighbours
        slots = np.array([0, 1, 1023, 1024, 1025, 2047, 2048, 4095])
        keys = (np.arange(1, 9, dtype=np.uint32) << 12) | slots
    elif name == "one_slot":
        # 40 keys probing from one slot: a 40-deep triangular chain
        keys = (np.arange(1, 41, dtype=np.uint32) << 12) | 7
    elif name == "alternating":
        # every other slot, each claimed twice: half the rows reprobe
        slots = np.arange(0, 4096, 2)
        keys = np.concatenate([
            (np.uint32(1) << 12) | slots, (np.uint32(2) << 12) | slots,
        ]).astype(np.uint32)
    else:  # "wrap": probes that wrap past the last slot
        keys = (np.arange(1, 30, dtype=np.uint32) << 12) | 4090
    n = 4096 if len(keys) > 2048 else 2048
    ukeys = np.zeros((n, 1), np.uint32)
    ukeys[: len(keys), 0] = keys
    ucounts = rng.integers(1, 9, size=n).astype(np.int32)
    return ident, ukeys, ucounts, np.arange(n) < len(keys)


@pytest.mark.parametrize("name", [
    "random0", "random1", "random2", "random3", "dense", "sparse",
    "none_active", "edge_slots", "one_slot", "alternating", "wrap",
])
def test_element_rounds_match_dict(name):
    table, ukeys, ucounts, uvalid = _round_case(name)
    st = _split_insert(
        table, table.init_state(), jnp.asarray(ukeys), jnp.asarray(ucounts),
        jnp.asarray(uvalid),
    )
    truth = {
        tuple(int(x) for x in k): int(c)
        for k, c, v in zip(ukeys, ucounts, uvalid) if v
    }
    assert int(st.spilled) == 0
    assert int(st.n) == len(truth)
    assert table.total(st) == sum(truth.values())
    assert _table_dict(table, st) == truth
    hist = np.asarray(st.probe_hist)
    assert int(hist.sum()) == len(truth)
