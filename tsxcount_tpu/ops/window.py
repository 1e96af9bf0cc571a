"""Batched k-mer window extraction on device.

The reference materializes every window as a std::string and re-packs it bit
by bit (`createKMers` reference src/mains/testExecution.h:15-36 +
`fromSequence` src/utils/SequenceUtils.h:86-160) — a per-kmer scalar loop.
The formulation here is a *shift network* with zero gathers:

With bases packed 16-per-uint32 LSB-first and positions p = 16q + s
(s in 0..15), lane j of the window starting at p is bits
[32(q+j) + 2s, 32(q+j+1) + 2s) of the base stream, i.e.

    lane_j(p) = (words[q+j] >> 2s) | (words[q+j+1] << (32-2s))

There are only 16 distinct shifts, so we precompute 16 shifted streams and
every k-mer lane is a contiguous slice — pure elementwise work that XLA
fuses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tsxcount_tpu.config import BASES_PER_WORD, BatchSpec


def extract_kmer_cols(words: jax.Array, batch: BatchSpec) -> list[jax.Array]:
    """words: uint32[total_words] -> per-lane window columns, each [positions].

    Key identity: lane j of the window at position p equals lane 0 of the
    window at position p + 16j, so ONE base stream L0 (built directly in
    position order — no transpose, no [P, lanes] materialization) serves
    every lane as a slice.  Returned lsb-lane first; the top lane is masked
    to the key width.  Invalid positions produce garbage; the caller masks
    them with the packer's validity bitmask (expand_vmask).
    """
    spec = batch.spec
    lanes = spec.lanes
    p_total = batch.positions
    # L0[16q+s] = (words[q] >> 2s) | (words[q+1] << (32-2s)); lane j needs
    # L0 up to p_total + 16*(lanes-1), i.e. words up to capacity+lanes-1
    # (available: total_words = capacity + lanes pad words).
    q_ext = batch.capacity_words + lanes - 1
    w0 = words[:q_ext, None]
    w1 = words[1 : q_ext + 1, None]
    # shifts 0,2,...,30; express `<< (32-2s)` as `<< (31-2s) << 1` so every
    # single shift amount stays < 32 (shift-by-32 is undefined).
    sh = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32))[None, :]
    stream = ((w0 >> sh) | ((w1 << (31 - sh)) << jnp.uint32(1))).reshape(-1)
    cols = [
        jax.lax.slice_in_dim(stream, 16 * j, 16 * j + p_total, axis=0)
        for j in range(lanes)
    ]
    if spec.top_lane_bits < 32:
        cols[-1] = cols[-1] & jnp.uint32(spec.top_lane_mask)
    return cols


def extract_kmers(words: jax.Array, batch: BatchSpec) -> jax.Array:
    """words: uint32[total_words] -> kmers uint32[positions, lanes].

    Row p holds the window starting at base position p.  Stacked-array
    convenience wrapper over extract_kmer_cols (the hot path feeds the
    columns straight into the sort without this materialization).
    """
    return jnp.stack(extract_kmer_cols(words, batch), axis=-1)


def expand_vmask(vmask: jax.Array, batch: BatchSpec) -> jax.Array:
    """vmask uint32[vmask_words] -> bool[positions]: bit p%32 of word p//32
    marks window position p valid (dense: 32 positions per uint32)."""
    sh = jnp.arange(32, dtype=jnp.uint32)[None, :]
    bits = (vmask[:, None] >> sh) & jnp.uint32(1)
    return bits.reshape(batch.positions).astype(jnp.bool_)


def _ones_below(n: jax.Array) -> jax.Array:
    """uint32 mask with the `n` lowest bits set, for n int32 in [0, 32]
    (shift-by-32 is undefined, so 32 is a select)."""
    nn = jnp.clip(n, 0, 31).astype(jnp.uint32)
    m = (jnp.uint32(1) << nn) - jnp.uint32(1)
    return jnp.where(n >= 32, jnp.uint32(0xFFFFFFFF), m)


def intervals_to_valid(ivs: jax.Array, batch: BatchSpec) -> jax.Array:
    """Interval-coded validity -> bool[positions], on device.

    ivs: uint32[2 * max_intervals] = [starts | ends]: sorted disjoint
    [start, end) runs of valid window positions; unused slots hold the
    sentinel 0xFFFFFFFF (sorts last, decodes to an empty mask).

    Expansion is word-granular and gather-free: merge the
    interval starts with each 32-position word's top position in ONE sort,
    then carry each interval's [start, end) forward to the words after it
    with running maxima (interval starts AND ends are both ascending, so
    last-seen == max-so-far).  A word may straddle up to J = 32//k + 2
    runs (a static bound: valid runs are separated by at least k-1 invalid
    positions — a segment's last k-1 window starts, or the k windows an N
    base kills — so run starts are >= k apart), so J shifted copies of the
    payloads ride the same sort and each contributes a clipped bit range.
    A second 2-column sort restores word order.  Both sorts are ~(W + M)
    rows — a few percent of the batch's dedupe sort.
    """
    m = batch.max_intervals
    starts = ivs[:m]
    ends = ivs[m : 2 * m]
    w = batch.vmask_words
    hi_pos = jnp.arange(w, dtype=jnp.uint32) * 32 + 31
    n_cand = 32 // batch.spec.k + 2
    # packed merge key: (position << 1) | is_word — a start ties BEFORE the
    # word whose top position it equals (searchsorted 'right' semantics).
    # Real positions are < 2^31 so the shift is lossless; the 0xFFFFFFFF
    # sentinel maps to 0xFFFFFFFE, still after every word key.
    key = jnp.concatenate([starts << 1, (hi_pos << 1) | jnp.uint32(1)])
    word_id = jnp.concatenate([
        jnp.full((m,), w, jnp.int32), jnp.arange(w, dtype=jnp.int32)
    ])
    zero_w = jnp.zeros((w,), jnp.uint32)
    pays = []
    for j in range(n_cand):
        if j:
            pad = jnp.zeros((j,), jnp.uint32)
            s_j = jnp.concatenate([pad, starts[: m - j]])
            e_j = jnp.concatenate([pad, ends[: m - j]])
        else:
            s_j, e_j = starts, ends
        pays.append(jnp.concatenate([s_j, zero_w]))
        pays.append(jnp.concatenate([e_j, zero_w]))
    sorted_all = jax.lax.sort((key, word_id) + tuple(pays), num_keys=1)
    wid_s = sorted_all[1]
    base = wid_s * 32  # for interval rows this is w*32: discarded below
    mask = jnp.zeros_like(key)
    for j in range(n_cand):
        # running max == latest interval's j-th predecessor (payloads of
        # word rows are 0 and never win); clip to this word's bit range
        cs = jax.lax.cummax(sorted_all[2 + 2 * j]).astype(jnp.int32)
        ce = jax.lax.cummax(sorted_all[3 + 2 * j]).astype(jnp.int32)
        lo = jnp.clip(cs - base, 0, 32)
        hi = jnp.clip(ce - base, 0, 32)
        mask = mask | (_ones_below(hi) & ~_ones_below(lo))
    word_mask = jax.lax.sort((wid_s, mask), num_keys=1)[1][:w]
    return expand_vmask(word_mask, batch)
