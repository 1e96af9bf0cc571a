"""Device-resident sorted count store (the "sort" backend table).

Capability mirror of the reference TSXHashMap read side — exact per-kmer
counts, distinct-kmer total, full-table export (reference
src/tsxcount/TSXHashMap.h:548-638 getKmerCount, 645-648 distinct total,
660-722 getAllKmers) — but represented as a sorted array of
(key lanes, count digits) pairs merged batch-by-batch, instead of a
bit-packed reprobing table guarded by TSX/CAS/locks.

Counts are 3 base-2^20 int32 digits (60 bits): the analog of the reference's
primary s-bit value + overflow-entry digits (TSXHashMap.h:548-638), sized so
segmented sums can never overflow an int32 lane.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tsxcount_tpu.config import COUNT_DIGITS, KmerSpec, counts_to_int
from tsxcount_tpu.ops.count import (
    _boundary_flags,
    _invalid_bits,
    _segmented_sum_rev,
    compact_rows,
    digit_column_sums,
    digit_sums_to_int,
    int32_to_digits,
    pack_flag_key,
    renorm_digits,
    unpack_flag_key,
)
from tsxcount_tpu.ops.lanes import keys_equal, keys_less


class StoreState(NamedTuple):
    keys: jax.Array    # uint32 [cap, lanes], ascending over used prefix
    digits: jax.Array  # int32  [cap, 3]
    used: jax.Array    # bool   [cap]
    n: jax.Array       # int32  scalar: number of distinct keys
    overflowed: jax.Array  # bool scalar: capacity was ever exceeded


class CountStore:
    """Fixed-capacity sorted (key -> count) map with pure-functional ops."""

    def __init__(self, spec: KmerSpec, capacity: int):
        self.spec = spec
        self.capacity = int(capacity)

    def init_state(self) -> StoreState:
        cap, lanes = self.capacity, self.spec.lanes
        return StoreState(
            keys=jnp.zeros((cap, lanes), jnp.uint32),
            digits=jnp.zeros((cap, COUNT_DIGITS), jnp.int32),
            used=jnp.zeros((cap,), jnp.bool_),
            n=jnp.zeros((), jnp.int32),
            overflowed=jnp.zeros((), jnp.bool_),
        )

    def merge(self, state: StoreState, ukeys: jax.Array, ucounts: jax.Array,
              uvalid: jax.Array) -> StoreState:
        """Merge one batch histogram (from count_unique) into the store."""
        return self.merge_stacked(
            state, ukeys[None], ucounts[None], uvalid[None]
        )

    def merge_stacked(self, state: StoreState, ukeys: jax.Array,
                      ucounts: jax.Array, uvalid: jax.Array) -> StoreState:
        """Merge R deduped batch histograms into the store in ONE sort.

        ukeys [R, P, lanes], ucounts [R, P], uvalid [R, P].  Sorted merge:
        concat, one lexicographic sort with the count digits as payload;
        every key run has at most R+1 rows (each input is deduped), so
        per-key digit totals come from a log2(R+1)-step segmented sum, and
        run heads are compacted to the front.  Deferring merges this way
        amortizes the O(capacity) re-sort over R batches — the streaming
        cost is O(P log R + capacity/R) per batch instead of O(capacity).
        """
        r, p, lanes = ukeys.shape
        return self._fold(
            state,
            keys=ukeys.reshape(-1, lanes),
            digits=int32_to_digits(ucounts.reshape(-1).astype(jnp.int32)),
            unused=~uvalid.reshape(-1),
            fanin=r + 1,
            overflowed=state.overflowed,
        )

    def absorb(self, state: StoreState, other: StoreState) -> StoreState:
        """Merge another store's contents into this one (store-to-store).

        `other` may have a different (typically smaller) capacity but must
        share the KmerSpec.  Digit triples are summed per key — counts of
        keys present in both stores add exactly (the LSM cascade step).
        """
        return self._fold(
            state, keys=other.keys, digits=other.digits, unused=~other.used,
            fanin=2, overflowed=state.overflowed | other.overflowed,
        )

    def _fold(self, state: StoreState, keys: jax.Array, digits: jax.Array,
              unused: jax.Array, fanin: int, overflowed: jax.Array
              ) -> StoreState:
        """Sort the store's rows together with extra (keys, digits) rows,
        sum the digits of equal keys (at most `fanin` rows share one) and
        rebuild the store from the run heads."""
        cap = self.capacity
        spec = self.spec
        inv = jnp.concatenate([~state.used, unused])
        keys = jnp.concatenate([state.keys, keys], axis=0)
        digits = jnp.concatenate([state.digits, digits], axis=0)
        ops = pack_flag_key(keys, inv, spec)
        *sorted_all, = jax.lax.sort(
            ops + (digits[:, 0], digits[:, 1], digits[:, 2]),
            num_keys=len(ops),
        )
        ops_s = list(sorted_all[: len(ops)])
        d = jnp.stack(sorted_all[len(ops) :], axis=1)
        flag = _boundary_flags(ops_s)
        # run totals anchored at first rows, then the run heads compacted
        dsum = _segmented_sum_rev(d, flag, fanin)
        _, rep = compact_rows(
            flag, ops_s + [dsum[:, 0], dsum[:, 1], dsum[:, 2]]
        )
        new_keys, _ = unpack_flag_key(
            [col[:cap] for col in rep[: len(ops)]], spec
        )
        new_digits = jnp.stack(
            [col[:cap] for col in rep[len(ops) :]], axis=1
        )
        inv_rows = _invalid_bits(ops_s[0], ops_s, spec)
        n_new = jnp.sum(flag & ~inv_rows, dtype=jnp.int32)
        n_kept = jnp.minimum(n_new, cap)
        return StoreState(
            keys=new_keys,
            digits=renorm_digits(new_digits),
            used=jnp.arange(cap, dtype=jnp.int32) < n_kept,
            n=n_kept,
            overflowed=overflowed | (n_new > cap),
        )

    def lookup(self, state: StoreState, queries: jax.Array
               ) -> tuple[jax.Array, jax.Array]:
        """Binary-search counts for (N, lanes) query keys.

        Returns (digits int32 [N, 3], found bool [N]).  Replaces the
        reference's probe-walk lookup (TSXHashMap.h:477-543).
        """
        n_q = queries.shape[0]
        hi = jnp.broadcast_to(state.n, (n_q,)).astype(jnp.int32)
        # derive lo from hi (not a fresh zeros) so it inherits hi's
        # varying-manual-axes under shard_map
        lo = hi * 0
        iters = max(1, self.capacity).bit_length() + 1

        def body(_, lohi):
            lo, hi = lohi
            active = lo < hi
            mid = (lo + hi) >> 1
            kmid = state.keys[jnp.clip(mid, 0, self.capacity - 1)]
            lt = keys_less(kmid, queries)
            lo = jnp.where(active & lt, mid + 1, lo)
            hi = jnp.where(active & ~lt, mid, hi)
            return lo, hi

        lo, hi = jax.lax.fori_loop(0, iters, body, (lo, hi))
        idx = jnp.clip(lo, 0, self.capacity - 1)
        found = (lo < state.n) & keys_equal(state.keys[idx], queries)
        digits = jnp.where(found[:, None], state.digits[idx], 0)
        return digits, found

    # --- host-side export ---

    def total(self, state: StoreState) -> int:
        """Sum of every stored count (equals the windows counted)."""
        d = jnp.where(state.used[:, None], state.digits, 0)
        return digit_sums_to_int(jax.device_get(
            digit_column_sums([d[:, j] for j in range(COUNT_DIGITS)])
        ))

    def to_host(self, state: StoreState) -> tuple[np.ndarray, np.ndarray, int]:
        """Fetch (keys [n, lanes], counts [n] python ints, n)."""
        n = int(jax.device_get(state.n))
        keys = np.asarray(jax.device_get(state.keys[:n]))
        digits = np.asarray(jax.device_get(state.digits[:n]))
        counts = np.array(
            [counts_to_int(*d) for d in digits], dtype=object
        ) if n else np.zeros((0,), dtype=object)
        return keys, counts, n
