"""Sort + segmented-reduction exact counting primitives.

This replaces the reference's entire concurrency story: instead of
serializing concurrent increments on a shared bit-packed table (TSX
transactions / CAS / locks — reference src/tsxcount/TSXHashMapTSXPerf.h,
TSXHashMapCAS.h etc.), occurrences of equal k-mers are brought together by a
lexicographic sort and reduced with conflict-free vector ops.  Exact,
deterministic, no contention by construction.

Design:
  * the validity flag is packed into the spare high bits of the key itself,
    so a k<=15 batch sorts a SINGLE uint32 operand (k<=31: two), and invalid
    windows sort to the end for free;
  * run boundaries are compacted to the front with an exclusive cumsum and
    one scatter to unique destinations (compact_rows), so per-segment counts
    are adjacent differences of boundary positions;
  * bounded-fanin segment sums (merge: <=R+1 rows per key; sharded receive:
    <=n_shards rows) use log2-step shifted adds instead of a general scan.
"""


from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from tsxcount_tpu.config import (
    COUNT_DIGIT_BITS,
    COUNT_DIGIT_MASK,
    COUNT_DIGITS,
    KmerSpec,
)


class UniqueCounts(NamedTuple):
    """Compacted unique-key histogram of one batch (fixed shape).

    Entries [0, n_unique) are real and ascending; the tail is garbage
    (marked by valid=False).
    """

    keys: jax.Array     # uint32 [P, lanes], sorted ascending where valid
    counts: jax.Array   # int32  [P]
    valid: jax.Array    # bool   [P]
    n_unique: jax.Array # int32  scalar
    # bool scalar (collide_mode="flag" only, else None): the uniform-prefix
    # sort detected a prefix collision between two DISTINCT valid keys, so
    # this batch's histogram may be wrong and the caller must retry with
    # the full-comparator sort (ops/count.py _sort_uniform_prefix)
    collided: jax.Array | None = None


# --- packed sort keys -------------------------------------------------------

def flag_ops(spec: KmerSpec) -> int:
    """Number of uint32 sort operands for (invalid flag | key)."""
    return spec.lanes if spec.top_lane_bits < 32 else spec.lanes + 1


def pack_flag_key(kmers: jax.Array, invalid: jax.Array,
                  spec: KmerSpec) -> tuple[jax.Array, ...]:
    """(P, lanes) keys + invalid flag -> msb-first uint32 sort operands.

    The flag occupies the first spare bit above the key, making it the
    most significant sort bit: invalid rows sink to the end and can never
    alias a real k-mer (including all-ones poly-T).
    """
    lanes = kmers.shape[-1]
    return pack_flag_key_cols(
        [kmers[..., j] for j in range(lanes)], invalid, spec
    )


def pack_flag_key_cols(cols: Sequence[jax.Array], invalid: jax.Array,
                       spec: KmerSpec) -> tuple[jax.Array, ...]:
    """Lane columns (lsb lane first) + invalid flag -> msb-first operands."""
    inv = invalid.astype(jnp.uint32)
    if spec.top_lane_bits < 32:
        top = cols[-1] | (inv << spec.top_lane_bits)
        return (top,) + tuple(reversed(cols[:-1]))
    return (inv,) + tuple(reversed(cols))


def unpack_flag_key(ops: Sequence[jax.Array],
                    spec: KmerSpec) -> tuple[jax.Array, jax.Array]:
    """Inverse of pack_flag_key -> (keys (P, lanes), invalid bool)."""
    lanes = spec.lanes
    if spec.top_lane_bits < 32:
        top = ops[0]
        invalid = (top >> spec.top_lane_bits) != 0
        top_lane = top & jnp.uint32(spec.top_lane_mask)
        lanes_list = list(reversed(ops[1:lanes])) + [top_lane]
    else:
        invalid = ops[0] != 0
        lanes_list = list(reversed(ops[1 : lanes + 1]))
    return jnp.stack(lanes_list, axis=-1), invalid


# --- segment machinery ------------------------------------------------------

def _boundary_flags(ops_sorted: Sequence[jax.Array]) -> jax.Array:
    """bool [P]: row starts a new run of equal sort keys."""
    neq = ops_sorted[0][1:] != ops_sorted[0][:-1]
    for op in ops_sorted[1:]:
        neq = neq | (op[1:] != op[:-1])
    return jnp.concatenate([jnp.ones((1,), jnp.bool_), neq])


def compact_rows(flag: jax.Array, columns: Sequence[jax.Array]
                 ) -> tuple[jax.Array, list[jax.Array]]:
    """Move flagged rows to the front, in order, carrying `columns` along.

    An exclusive cumsum of the flags gives each flagged row its output
    slot; one scatter to unique destinations places the source positions
    (unflagged rows get distinct out-of-range slots and drop), and each
    column is one gather.  Returns (positions int32 [P] with tail = P,
    compacted columns with tail = 0).  Measured faster than the one-sort
    form on the GPU at the dedupe batch size (PERF.md).
    """
    p = flag.shape[0]
    arange = jnp.arange(p, dtype=jnp.int32)
    dst = jnp.where(flag, jnp.cumsum(flag, dtype=jnp.int32) - 1, p + arange)
    pos = jnp.full((p,), p, jnp.int32).at[dst].set(
        arange, mode="drop", unique_indices=True
    )
    live = pos < p
    return pos, [
        jnp.where(live, jnp.take(c, pos, mode="clip"), jnp.zeros((), c.dtype))
        for c in columns
    ]


def uniform_prefix_nk(spec: KmerSpec) -> int:
    """Comparator operands covering >= 64 uniform hash bits.

    The msb operand contributes spec.top_lane_bits of key (the invalid
    flag shares it) when the top lane is narrow, or zero key bits (a
    standalone flag column) when the top lane is full; every further
    operand adds 32.  A fixed nk=2 would cap the prefix at
    top_lane_bits+32 bits — at k=113 (2-bit top lane) that is 34 bits and
    9.6M-row batches would collide essentially always.  Covering >= 64
    bits makes the within-batch collision probability ~P^2/2^65 at
    every k.
    """
    key_bits_in_top = spec.top_lane_bits if spec.top_lane_bits < 32 else 0
    return 1 + -(-max(1, 64 - key_bits_in_top) // 32)


def _sort_uniform_prefix(ops: tuple, spec: KmerSpec,
                         collide_mode: str = "cond"
                         ) -> tuple[tuple, jax.Array | None]:
    """Sort rows of uniformly-prefixed keys (bijective GF(2) image, or raw
    lanes extended with the ops/mix.py mixing hash) by a >=64-bit prefix,
    with the remaining lanes riding as sort payload (SURVEY §7 hard-part
    #1: radix on uniform hash bits so the comparator runs on 2-3 columns
    instead of lanes+1).

    Exactness: two EQUAL keys agree on every column, so they still land in
    one run.  Two DISTINCT keys that collide in the whole prefix would
    corrupt run boundaries — but the prefix is uniform, so a within-batch
    collision has probability ~P^2/2^65; it is DETECTED exactly (adjacent
    rows equal in the prefix columns but differing in a payload column).

    collide_mode:
      * "cond": lax.cond fallback to the full multi-key sort.  Both
        branches compile — the fallback branch's sort temps DOUBLE peak
        device memory even though it virtually never executes.  Returns (sorted_ops, None).
      * "flag": no fallback compiled; returns (sorted_ops, collided bool
        scalar).  The caller accumulates the flag without syncing and
        retries the ingest with the full sort if it ever fires
        (detect + host-side retry).
    """
    nk = uniform_prefix_nk(spec)
    if len(ops) <= nk:
        out = jax.lax.sort(ops, num_keys=len(ops))
        return out, (jnp.zeros((), jnp.bool_)
                     if collide_mode == "flag" else None)
    sorted_pre = jax.lax.sort(ops, num_keys=nk)
    same = sorted_pre[0][1:] == sorted_pre[0][:-1]
    for op in sorted_pre[1:nk]:
        same = same & (op[1:] == op[:-1])
    diff = sorted_pre[nk][1:] != sorted_pre[nk][:-1]
    for op in sorted_pre[nk + 1 :]:
        diff = diff | (op[1:] != op[:-1])
    # only pairs of VALID rows matter: invalid rows are dedupe garbage
    # either way (flag rides the first key column, so a valid/invalid
    # pair can never be `same`)
    if spec.top_lane_bits < 32:
        row_valid = (sorted_pre[0][:-1] >> spec.top_lane_bits) == 0
    else:
        row_valid = sorted_pre[0][:-1] == 0
    collide = jnp.any(same & diff & row_valid)
    if collide_mode == "flag":
        return sorted_pre, collide
    return jax.lax.cond(
        collide,
        lambda o: jax.lax.sort(o, num_keys=len(o)),
        lambda o: sorted_pre,
        ops,
    ), None


def count_unique(kmers, valid: jax.Array,
                 weights: jax.Array | None = None,
                 spec: KmerSpec | None = None,
                 max_multiplicity: int | None = None,
                 uniform_prefix: bool = False,
                 collide_mode: str = "cond") -> UniqueCounts:
    """Exact histogram of the valid rows of `kmers`.

    kmers: (P, lanes) array, or a sequence of per-lane columns (lsb lane
    first, e.g. from extract_kmer_cols — avoids materializing the stacked
    array before the sort).
    weights: optional int32 per-row multiplicities (default 1).  With
    weights, max_multiplicity bounds how many rows can share one key
    (drives the log-step segmented sum); without, counts are adjacent
    differences of boundary positions (no scan at all).
    uniform_prefix: keys carry a uniform >=64-bit msb prefix (bijective
    GF(2) image, or raw lanes extended with the ops/mix.py mixing hash) —
    sort on that prefix with the remaining lanes as payload and exact
    collision detection (_sort_uniform_prefix).  No-weights paths only.
    collide_mode: "cond" (compiled full-sort fallback) or "flag" (report
    UniqueCounts.collided; caller retries on host) — see
    _sort_uniform_prefix.
    """
    if isinstance(kmers, (list, tuple)):
        lanes = len(kmers)
        p = kmers[0].shape[0]
        if spec is None:
            spec = _spec_from_lanes(lanes)
        ops = pack_flag_key_cols(kmers, ~valid, spec)
    else:
        p, lanes = kmers.shape
        if spec is None:
            spec = _spec_from_lanes(lanes)
        ops = pack_flag_key(kmers, ~valid, spec)

    sort_ops = (
        (lambda o: _sort_uniform_prefix(o, spec, collide_mode))
        if uniform_prefix
        else (lambda o: (jax.lax.sort(o, num_keys=len(o)), None))
    )
    collided = None
    if weights is None:
        ops_sorted, collided = sort_ops(ops)
        flag = _boundary_flags(ops_sorted)
        pos, rep = compact_rows(flag, ops_sorted)
        pos_next = jnp.concatenate([pos[1:], jnp.full((1,), p, jnp.int32)])
        counts = pos_next - pos  # garbage (=0) beyond the last segment
        ukeys, uinvalid = unpack_flag_key(rep, spec)
        inv_sorted0 = _invalid_bits(ops_sorted[0], ops_sorted, spec)
        n_unique = jnp.sum(flag & ~inv_sorted0, dtype=jnp.int32)
    else:
        ops_sorted_w = jax.lax.sort(
            ops + (weights.astype(jnp.int32),), num_keys=len(ops)
        )
        ops_sorted = list(ops_sorted_w[:-1])
        w_s = ops_sorted_w[-1]
        flag = _boundary_flags(ops_sorted)
        # first-row-anchored segmented sum, bounded fanin
        fanin = max_multiplicity or p
        w_s = _segmented_sum_rev(w_s, flag, fanin)
        _, rep = compact_rows(flag, ops_sorted + [w_s])
        counts = rep[-1]
        ukeys, uinvalid = unpack_flag_key(rep[:-1], spec)
        inv_sorted0 = _invalid_bits(ops_sorted[0], ops_sorted, spec)
        n_unique = jnp.sum(flag & ~inv_sorted0, dtype=jnp.int32)
        counts = jnp.where(
            jnp.arange(p, dtype=jnp.int32) < n_unique, counts, 0
        )

    uvalid = jnp.arange(p, dtype=jnp.int32) < n_unique
    return UniqueCounts(
        keys=ukeys, counts=counts, valid=uvalid, n_unique=n_unique,
        collided=collided,
    )


def _spec_from_lanes(lanes: int) -> KmerSpec:
    # fallback spec with a full top lane (flag goes to an extra operand);
    # callers on the hot path pass the real spec for the packed fast path
    return KmerSpec(16 * lanes)


def _invalid_bits(top_sorted: jax.Array, ops_sorted, spec: KmerSpec
                  ) -> jax.Array:
    """Per-row invalid flag from the sorted msb operand."""
    if spec.top_lane_bits < 32:
        return (top_sorted >> spec.top_lane_bits) != 0
    return ops_sorted[0] != 0


def _segmented_inclusive_sum(vals: jax.Array, flag: jax.Array,
                             max_fanin: int) -> jax.Array:
    """Inclusive segmented sum over runs delimited by flag (True = start).

    log2(max_fanin) shifted-add steps; max_fanin is a static bound on the
    longest run.  Pure elementwise/shift ops — no scan HLO, no scatter.
    vals may be 1-D [P] or 2-D [P, W] (summed along axis 0 per segment).
    """
    p = vals.shape[0]
    x, f = vals, flag
    fill_shape = lambda d: (d,) + x.shape[1:]
    d = 1
    while d < max_fanin and d < p:
        x_shift = jnp.concatenate(
            [jnp.zeros(fill_shape(d), x.dtype), x[:-d]], axis=0
        )
        f_shift = jnp.concatenate([jnp.ones((d,), jnp.bool_), f[:-d]])
        blocked = f if x.ndim == 1 else f[:, None]
        x = x + jnp.where(blocked, 0, x_shift)
        f = f | f_shift
        d *= 2
    return x


def _segmented_sum_rev(vals: jax.Array, flag: jax.Array,
                       max_fanin: int) -> jax.Array:
    """Segmented sum anchored at the FIRST row of each run.

    Mirror of _segmented_inclusive_sum: accumulate from below, blocked by
    end-of-segment flags, so row i ends up with the sum over [i, run_end].
    The first row of every run then holds the run total — exactly what the
    compaction sort extracts.  vals 1-D [P] or 2-D [P, W].
    """
    p = vals.shape[0]
    # end flag: row i is the last of its run iff row i+1 starts a new one
    endf = jnp.concatenate([flag[1:], jnp.ones((1,), jnp.bool_)])
    x, f = vals, endf
    fill_shape = lambda d: (d,) + x.shape[1:]
    d = 1
    while d < max_fanin and d < p:
        x_shift = jnp.concatenate(
            [x[d:], jnp.zeros(fill_shape(d), x.dtype)], axis=0
        )
        f_shift = jnp.concatenate([f[d:], jnp.ones((d,), jnp.bool_)])
        blocked = f if x.ndim == 1 else f[:, None]
        x = x + jnp.where(blocked, 0, x_shift)
        f = f | f_shift
        d *= 2
    return x


# --- count digits -----------------------------------------------------------

def renorm_digits(d: jax.Array) -> jax.Array:
    """Propagate carries through base-2^20 digit lanes (int32 [..., 3]).

    The analog of the reference's overflow-chain carry walk
    (`handleOverflow`, reference src/tsxcount/TSXHashMap.h:1501-1623), as a
    pure vector op.
    """
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    c0 = d0 >> COUNT_DIGIT_BITS
    d0 = d0 & COUNT_DIGIT_MASK
    d1 = d1 + c0
    c1 = d1 >> COUNT_DIGIT_BITS
    d1 = d1 & COUNT_DIGIT_MASK
    d2 = d2 + c1
    return jnp.stack([d0, d1, d2], axis=-1)


def int32_to_digits(c: jax.Array) -> jax.Array:
    """int32 counts [...,] -> digit triple [..., 3] (c must be >= 0)."""
    d0 = c & COUNT_DIGIT_MASK
    d1 = (c >> COUNT_DIGIT_BITS) & COUNT_DIGIT_MASK
    d2 = jnp.zeros_like(c)
    return jnp.stack([d0, d1, d2], axis=-1)


_SUM_BLOCK = 2048  # 2048 digits below 2^20 sum below 2^31


def digit_column_sums(cols: Sequence[jax.Array]) -> jax.Array:
    """Per-block sums of digit columns (int32 [N] each) -> [blocks, D].

    Exact in int32: a renormalized digit is below 2^20, so a block of
    _SUM_BLOCK of them sums below 2^31.  The host adds the blocks in int64
    (digit_sums_to_int) — JAX runs 32-bit unless x64 is enabled."""
    n = cols[0].shape[0]
    pad = -n % _SUM_BLOCK
    return jnp.stack([
        jnp.pad(c.astype(jnp.int32), (0, pad)).reshape(-1, _SUM_BLOCK)
        .sum(axis=1)
        for c in cols
    ], axis=1)


def digit_sums_to_int(block_sums) -> int:
    """Host side of digit_column_sums: the exact total count."""
    import numpy as np

    per_digit = np.asarray(block_sums).astype(np.int64).sum(axis=0)
    return sum(int(v) << (COUNT_DIGIT_BITS * i)
               for i, v in enumerate(per_digit))


assert COUNT_DIGITS == 3, "digit helpers assume 3 lanes"
