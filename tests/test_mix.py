"""Mix-prefix dedupe (ops/mix.py) — exactness, host/device agreement,
collision detection, and the extended-key counter path.

The mixing hash replaces the GF(2) matmul as a uniform sort prefix
(SURVEY §7 hard-part #1, second attack).  It adds sort columns, so it
ships opt-in (core/counter.py _MIX_AUTO_MIN_LANES); these tests pin its
EXACTNESS and the collision-taint machinery that also protects the
hash-first and sharded uniform-prefix paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tsxcount_tpu.config import KmerSpec
from tsxcount_tpu.core.counter import KmerCounter, PrefixCollision
from tsxcount_tpu.ops.count import count_unique
from tsxcount_tpu.ops.mix import (
    extend_cols,
    extend_keys_host,
    make_ext_spec,
    mix_cols,
    mix_cols_host,
)


def naive_kmers(reads, k):
    from collections import Counter

    c = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            c[r[i : i + k]] += 1
    return dict(c)


def _reads(n=25, length=150, seed=11):
    rng = np.random.default_rng(seed)
    return [
        "".join("ACGT"[x] for x in rng.integers(0, 4, size=length))
        for _ in range(n)
    ]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_device_host_mix_agree(lanes):
    rng = np.random.default_rng(3 + lanes)
    keys = rng.integers(0, 2**32, size=(512, lanes), dtype=np.uint32)
    lo_h, hi_h = mix_cols_host(keys)
    lo_d, hi_d = mix_cols([jnp.asarray(keys[:, j]) for j in range(lanes)])
    np.testing.assert_array_equal(np.asarray(lo_d), lo_h)
    np.testing.assert_array_equal(np.asarray(hi_d), hi_h)


def test_mix_uniformity_top_bits():
    """Routing needs the top mix bits uniform over real k-mer sets: the
    64 sequential k-mers of one read must spread over 16 buckets."""
    keys = np.arange(4096, dtype=np.uint32).reshape(-1, 1)  # adversarial:
    # sequential values (adjacent k-mer windows differ by shifts)
    _, hi = mix_cols_host(keys)
    buckets = np.bincount(hi >> np.uint32(28), minlength=16)
    assert buckets.min() > 0.5 * 4096 / 16
    assert buckets.max() < 2.0 * 4096 / 16
    # and no 64-bit collisions among 4096 distinct keys
    lo, hi = mix_cols_host(keys)
    pairs = set(zip(lo.tolist(), hi.tolist()))
    assert len(pairs) == 4096


@pytest.mark.parametrize("k", [31, 63, 127])
def test_count_unique_mix_prefix_exact(k):
    spec = KmerSpec(k)
    ext = make_ext_spec(spec)
    rng = np.random.default_rng(k)
    n = 1024
    base = rng.integers(0, 2**32, size=(96, spec.lanes), dtype=np.uint32)
    base[:, -1] &= np.uint32(spec.top_lane_mask)
    rows = base[rng.integers(0, len(base), size=n)]
    valid = rng.random(n) < 0.9
    cols = [jnp.asarray(rows[:, j]) for j in range(spec.lanes)]
    uc = count_unique(
        extend_cols(cols), jnp.asarray(valid), spec=ext,
        uniform_prefix=True, collide_mode="flag",
    )
    assert not bool(uc.collided)
    # reference histogram over valid rows
    want = {}
    for i in range(n):
        if valid[i]:
            t = tuple(rows[i])
            want[t] = want.get(t, 0) + 1
    nu = int(uc.n_unique)
    assert nu == len(want)
    keys = np.asarray(uc.keys)[:nu]
    counts = np.asarray(uc.counts)[:nu]
    got = {
        tuple(keys[i, : spec.lanes]): int(counts[i]) for i in range(nu)
    }
    assert got == want
    # mix columns are consistent with the raw lanes
    np.testing.assert_array_equal(
        keys, extend_keys_host(keys[:, : spec.lanes].copy())
    )


def test_collision_flag_fires():
    """Forced prefix collision (two distinct keys, identical mix columns —
    impossible for the real mix, synthesized here) must set collided."""
    spec = KmerSpec(63)
    ext = make_ext_spec(spec)
    n = 256
    rows = np.zeros((n, ext.lanes), np.uint32)
    rows[:, 0] = np.arange(n)  # distinct raw lane 0
    # mix columns all equal -> guaranteed prefix collision
    rows[:, -2:] = 7
    cols = [jnp.asarray(rows[:, j]) for j in range(ext.lanes)]
    uc = count_unique(
        cols, jnp.ones(n, bool), spec=ext,
        uniform_prefix=True, collide_mode="flag",
    )
    assert bool(uc.collided)


@pytest.mark.parametrize("k", [31, 127])
def test_counter_mix_prefix_matches_naive(k):
    reads = _reads()
    c = KmerCounter(k=k, l=14, batch_words=64, mix_prefix=True)
    assert c.mix_prefix
    c.add_reads(reads)
    c.finish()
    want = naive_kmers(reads, k)
    assert c.to_dict() == want
    qs = list(want)[:40] + ["A" * k]
    assert c.get_counts(qs) == [want.get(q, 0) for q in qs]


def test_counter_mix_canonical_and_checkpoint(tmp_path):
    from tsxcount_tpu.core.checkpoint import load_counter, save_counter

    reads = _reads(n=12)
    c = KmerCounter(k=63, l=12, batch_words=64, mix_prefix=True,
                    canonical=True)
    ref = KmerCounter(k=63, l=12, batch_words=64, mix_prefix=False,
                      canonical=True)
    for x in (c, ref):
        x.add_reads(reads)
        x.finish()
    assert c.to_dict() == ref.to_dict()
    path = tmp_path / "mix.npz"
    save_counter(c, path)
    resumed = load_counter(path, batch_words=64)
    assert resumed.mix_prefix
    assert resumed.to_dict() == ref.to_dict()


def test_mix_hash_first_exclusive():
    with pytest.raises(ValueError):
        KmerCounter(k=31, l=10, mix_prefix=True, hash_first=True)


def test_collision_recount_via_count_file(tmp_path, monkeypatch):
    """A tainted ingest must recount the file with the full sort and stay
    exact.  The collision is injected by monkeypatching the mix to a
    constant (every batch collides)."""
    from tsxcount_tpu.ops import mix as mix_mod

    real = mix_mod.mix_cols

    def degenerate(cols):
        lo, hi = real(cols)
        return jnp.zeros_like(lo), jnp.zeros_like(hi)

    monkeypatch.setattr(mix_mod, "mix_cols", degenerate)
    reads = _reads(n=10)
    fastq = tmp_path / "r.fastq"
    with open(fastq, "w") as f:
        for i, seq in enumerate(reads):
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    c = KmerCounter(k=31, l=14, batch_words=64, mix_prefix=True)
    c.count_file(fastq)  # internally recounts with the full sort
    assert c._mix_full_sort  # the retry actually happened
    assert c.to_dict() == naive_kmers(reads, 31)
    # streaming API with prior data cannot replay: surfaces the error
    c2 = KmerCounter(k=31, l=14, batch_words=64, mix_prefix=True)
    c2.add_reads(reads)
    with pytest.raises(PrefixCollision):
        c2.finish()
