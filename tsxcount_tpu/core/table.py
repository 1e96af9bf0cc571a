"""Quotient/reprobe hash table — the jellyfish-style backend.

Semantics mirror the reference table (reference src/tsxcount/TSXHashMap.h):

  * slot index for reprobe attempt r is (hash mod 2^L + r(r+1)/2) mod 2^L —
    triangular reprobing (`reprobe` TSXHashMap.h:1046-1054, `getPosition`
    759-778);
  * a slot stores [func bits | reprobe] where func = hash >> L, so the low L
    bits of the hash are *recoverable from the slot index* (`makeKey`
    TSXHashMap.h:1056-1072, reconstruction 683-712); with the bijective GF(2)
    hash this makes the whole k-mer reconstructible from the table
    (`getAllKmers` 660-722);
  * counts are exact and unbounded (3 base-2^20 digits replace the s-bit
    value + overflow-chain encoding of TSXHashMap.h:1311-1451 — same
    observable counts, no chain walk).

What is deliberately *not* mirrored: the serialization machinery.  Where the
reference arbitrates concurrent slot claims with TSX transactions / CAS /
locks, this table resolves an entire deduplicated batch per round with a
deterministic batched claim: rows are sorted by probed slot, the winner of
an empty slot is the last contender of its run (arbitrary-but-deterministic,
like "whoever wins the transaction"), losers re-probe next round.
Conflict-free, deterministic, batched — no retries on shared memory.

STORAGE LAYOUT: one flat uint32 array in COLUMN-major (struct-of-arrays)
order — column c of slot i lives at element c*slots + i; columns are
[key lanes | 3 count digits (int32 bitcast) | used flag].  Every hot
construction is a 1-D concat/slice, gather or scatter over that array;
no small-minor [n, few] 2-D intermediate is ever materialized (XLA may tile
such arrays with the minor dimension padded far past its width).

One intentional deviation: reprobe indices are 0-based here (the reference
starts iReprobes at 1, TSXHashMap.h:189); the encoding stays self-consistent
and reconstruction-exact.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from tsxcount_tpu.config import (
    COUNT_DIGIT_BITS,
    COUNT_DIGIT_MASK,
    COUNT_DIGITS,
    KmerSpec,
    counts_to_int,
)
from tsxcount_tpu.ops.count import (
    compact_rows,
    digit_column_sums,
    digit_sums_to_int,
)
from tsxcount_tpu.ops.gf2 import GF2Hash


class TableState(NamedTuple):
    slots: jax.Array   # uint32 [cols * slots], column-major (see module doc)
    n: jax.Array       # int32 scalar: distinct kmers
    spilled: jax.Array # int32 scalar: kmers dropped after max reprobes
    probe_hist: jax.Array  # int32 [max_reprobes]: kmers resolved at round r
                           # (the abort-code histogram analog,
                           # reference TSXHashMapTSXPerf.h:195-239)


def _bitcast_u32(x: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _bitcast_i32(x: jax.Array) -> jax.Array:
    return jax.lax.bitcast_convert_type(x, jnp.int32)


def _triangular(r: jax.Array) -> jax.Array:
    return (r * (r + 1)) // 2


class QuotientTable:
    """2^L-slot reprobing table over GF(2)-hashed multi-lane keys."""

    def __init__(self, spec: KmerSpec, l_bits: int, hash_fn: GF2Hash,
                 max_reprobes: int = 64):
        if not 1 <= l_bits <= 31:
            raise ValueError("l_bits must be in [1, 31]")
        if 2 * spec.k <= l_bits:
            raise ValueError(
                f"2k={2*spec.k} must exceed l={l_bits} (func field would be empty)"
            )
        self.spec = spec
        self.l_bits = l_bits
        self.slots = 1 << l_bits
        self.hash_fn = hash_fn
        # reference max = 2^L - 1 (TSXHashMap.h:86); we bound the while loop
        self.max_reprobes = min(max_reprobes, self.slots - 1)
        self._low_mask = jnp.uint32((1 << l_bits) - 1)
        # flat doubled element destinations must fit int32
        if 2 * self.slots * self.slot_cols >= 2**31:
            raise ValueError(
                f"table too large: 2^{l_bits} slots x {self.slot_cols} "
                f"columns exceeds the int32 element-address space (the "
                f"slot array alone would be "
                f"{self.slots * self.slot_cols * 4 / 2**30:.1f} GiB)"
            )

    @property
    def slot_cols(self) -> int:
        """Columns of a slot: key lanes + digits + used."""
        return self.spec.lanes + COUNT_DIGITS + 1

    def init_state(self) -> TableState:
        return TableState(
            slots=jnp.zeros((self.slot_cols * self.slots,), jnp.uint32),
            n=jnp.zeros((), jnp.int32),
            spilled=jnp.zeros((), jnp.int32),
            probe_hist=jnp.zeros((self.max_reprobes,), jnp.int32),
        )

    # --- column views (1-D slices of the flat array) -----------------------

    def _col(self, slots_flat: jax.Array, c: int) -> jax.Array:
        s = self.slots
        return jax.lax.slice_in_dim(slots_flat, c * s, (c + 1) * s)

    def state_keys(self, state: TableState) -> jax.Array:
        """uint32 [slots, lanes] slot keys ((func << L) | reprobe)."""
        return jnp.stack(
            [self._col(state.slots, j) for j in range(self.spec.lanes)],
            axis=1,
        )

    def state_digits(self, state: TableState) -> jax.Array:
        """int32 [slots, 3] count digits."""
        lanes = self.spec.lanes
        return _bitcast_i32(jnp.stack(
            [self._col(state.slots, lanes + j) for j in range(COUNT_DIGITS)],
            axis=1,
        ))

    def state_used(self, state: TableState) -> jax.Array:
        """bool [slots] — the m_iKmerStarts analog."""
        return self._col(state.slots, self.slot_cols - 1) != 0

    def _renorm_flat(self, slots_flat: jax.Array) -> jax.Array:
        """Base-2^20 digit renormalization: carries d0 -> d1 -> d2 over
        the contiguous digit column regions (the r3 overflow-chain
        analog, TSXHashMap.h:1501-1623) — three 1-D slices, no 2-D."""
        lanes = self.spec.lanes
        mask = jnp.int32(COUNT_DIGIT_MASK)
        d0 = _bitcast_i32(self._col(slots_flat, lanes))
        d1 = _bitcast_i32(self._col(slots_flat, lanes + 1))
        d2 = _bitcast_i32(self._col(slots_flat, lanes + 2))
        c0 = d0 >> COUNT_DIGIT_BITS
        d0 = d0 & mask
        d1 = d1 + c0
        c1 = d1 >> COUNT_DIGIT_BITS
        d1 = d1 & mask
        d2 = d2 + c1
        keys = jax.lax.slice_in_dim(slots_flat, 0, lanes * self.slots)
        used = self._col(slots_flat, self.slot_cols - 1)
        return jnp.concatenate([
            keys, _bitcast_u32(d0), _bitcast_u32(d1), _bitcast_u32(d2),
            used,
        ])

    # --- probe-state derivation --------------------------------------------

    def _hash_cols(self, ukeys: jax.Array
                   ) -> tuple[jax.Array, tuple[jax.Array, ...]]:
        """(pos0 int32 [P], cleared lane columns) — cleared = hash with
        the low L bits zeroed = (func << L); OR-ing the reprobe count into
        lane 0 yields the stored slot key (makeKey analog)."""
        h = self.hash_fn.apply(ukeys)
        pos0 = (h[:, 0] & self._low_mask).astype(jnp.int32)
        cleared = (h[:, 0] & ~self._low_mask,) + tuple(
            h[:, j] for j in range(1, self.spec.lanes)
        )
        return pos0, cleared

    def round0_args(self, ukeys, ucounts, uvalid):
        """(pos0, cleared columns, counts, active) for split_round r=0."""
        pos0, cleared = self._hash_cols(ukeys)
        return pos0, cleared, ucounts.astype(jnp.int32), uvalid

    # --- the split round ---------------------------------------------------
    #
    # One full reprobe round as ONE flat-form program: stable sort by
    # probed slot; slot contents for every row by flat element gathers;
    # arbitration; one scatter-add of a combined add-row per resolved
    # contender; and a carry compaction so the surviving rows form an
    # exact prefix whose size the host reads to slice the next round
    # narrower.  All constructions are 1-D concats over the column-major
    # layout.

    def split_round(self, state: TableState, r: int, pos0, cleared,
                    counts, active):
        """One reprobe round at static index `r`.

        cleared: tuple of lane columns.  Returns (state',
        carry=(pos0_c, cleared_c, counts_c, active_c), n_enter, n_left):
        carry rows are compacted so actives occupy exactly the first
        n_left positions.
        """
        s = self.slots
        lanes = self.spec.lanes
        cols = self.slot_cols
        width = pos0.shape[0]
        inactive = jnp.uint32(0xFFFFFFFF)
        pos = (pos0 + _triangular(jnp.int32(r))) % s
        ckey = jnp.where(active, pos.astype(jnp.uint32), inactive)
        ops = (ckey, pos0, counts) + tuple(cleared)
        sorted_ops = jax.lax.sort(ops, num_keys=1, is_stable=True)
        ckey_s, pos0_s, counts_s = sorted_ops[:3]
        cleared_s = tuple(sorted_ops[3:])
        active_s = ckey_s != inactive
        pos_s = ckey_s.astype(jnp.int32)
        boundary = ckey_s[1:] != ckey_s[:-1]
        run_end = jnp.concatenate([boundary, jnp.ones((1,), jnp.bool_)])
        safe_pos = jnp.where(active_s, pos_s, 0)

        # --- slot contents: key lanes + used flag per row ---
        probe_cols = list(range(lanes)) + [cols - 1]
        g_cols = [
            jnp.take(state.slots, c * s + safe_pos, mode="clip")
            for c in probe_cols
        ]

        used_s = g_cols[-1] != 0
        ru = jnp.uint32(r)
        slotkey0_s = cleared_s[0] | ru
        key_eq = g_cols[0] == slotkey0_s
        for j in range(1, lanes):
            key_eq = key_eq & (g_cols[j] == cleared_s[j])
        match_s = active_s & used_s & key_eq
        contend_s = active_s & ~used_s
        winner = contend_s & run_end
        resolved = match_s | winner

        # --- one combined add-row per resolved contender ---
        zero_u = jnp.uint32(0)
        val_cols = [
            jnp.where(winner, slotkey0_s, zero_u)
        ] + [
            jnp.where(winner, cleared_s[j], zero_u)
            for j in range(1, lanes)
        ] + [
            _bitcast_u32(counts_s & jnp.int32(COUNT_DIGIT_MASK)),
            _bitcast_u32(
                (counts_s >> COUNT_DIGIT_BITS) & jnp.int32(COUNT_DIGIT_MASK)
            ),
            jnp.zeros((width,), jnp.uint32),
            winner.astype(jnp.uint32),
        ]
        oob = jnp.int32(cols * s)
        eidx = jnp.concatenate([
            jnp.where(
                resolved, c * s + safe_pos,
                oob + c * width + jnp.arange(width, dtype=jnp.int32),
            )
            for c in range(cols)
        ])
        slots = state.slots.at[eidx].add(
            jnp.concatenate(val_cols), mode="drop",
            unique_indices=True,
        )

        hist = jax.lax.dynamic_update_index_in_dim(
            state.probe_hist,
            state.probe_hist[r] + jnp.sum(resolved.astype(jnp.int32)),
            r, axis=0,
        )
        new_state = TableState(
            slots=slots,
            n=state.n + jnp.sum(winner.astype(jnp.int32)),
            spilled=state.spilled,
            probe_hist=hist,
        )

        # --- compact the surviving rows to an exact prefix ---
        active_next = active_s & ~resolved
        n_left = jnp.sum(active_next.astype(jnp.int32))
        carry_cols = (pos0_s, counts_s) + cleared_s
        _, comp = compact_rows(active_next, carry_cols)
        active_c = jnp.arange(width, dtype=jnp.int32) < n_left
        carry = (comp[0], tuple(comp[2:]), comp[1], active_c)
        return (new_state, carry, jnp.sum(active.astype(jnp.int32)),
                n_left)

    def residue_phase(self, state: TableState, carry, r_start: int,
                      width2: int) -> TableState:
        """Finish an insert from the compacted carry at a narrow static
        width (flat element gathers/scatters, original-order claim
        arbitration) and renormalize.  Rows active beyond the slice are
        counted spilled — impossible when width2 covers the reported
        n_left."""
        s = self.slots
        lanes = self.spec.lanes
        cols = self.slot_cols
        pos0_f, cleared_f, counts_f, active_f = carry
        lost = (
            jnp.sum(active_f.astype(jnp.int32))
            - jnp.sum(active_f[:width2].astype(jnp.int32))
        )
        pos0 = pos0_f[:width2]
        cleared = tuple(c[:width2] for c in cleared_f)
        counts = counts_f[:width2]
        idx_arr = jnp.arange(width2, dtype=jnp.int32)
        d0 = _bitcast_u32(counts & jnp.int32(COUNT_DIGIT_MASK))
        d1 = _bitcast_u32(
            (counts >> COUNT_DIGIT_BITS) & jnp.int32(COUNT_DIGIT_MASK)
        )
        zeros_w = jnp.zeros((width2,), jnp.uint32)
        probe_cols = list(range(lanes)) + [cols - 1]

        def body(carry2):
            r, unresolved, slots, n, hist = carry2
            pos = (pos0 + _triangular(r)) % s
            slotkey0 = cleared[0] | r.astype(jnp.uint32)
            g_cols = [
                jnp.take(slots, c * s + pos, mode="clip")
                for c in probe_cols
            ]
            used_g = g_cols[-1] != 0
            key_eq = g_cols[0] == slotkey0
            for j in range(1, lanes):
                key_eq = key_eq & (g_cols[j] == cleared[j])
            match = unresolved & used_g & key_eq
            empty = unresolved & ~used_g
            ckey = jnp.where(empty, pos, s).astype(jnp.uint32)
            ckey_s, idx_s = jax.lax.sort((ckey, idx_arr), num_keys=2)
            first = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_), ckey_s[1:] != ckey_s[:-1]]
            )
            win_s = first & (ckey_s < s)
            winner = jnp.zeros((width2,), jnp.bool_).at[idx_s].set(
                win_s, unique_indices=True
            )
            upd = match | winner
            val_cols = [
                jnp.where(winner, slotkey0, jnp.uint32(0))
            ] + [
                jnp.where(winner, cleared[j], jnp.uint32(0))
                for j in range(1, lanes)
            ] + [d0, d1, zeros_w, winner.astype(jnp.uint32)]
            oob = jnp.int32(cols * s)
            eidx = jnp.concatenate([
                jnp.where(upd, c * s + pos, oob + c * width2 + idx_arr)
                for c in range(cols)
            ])
            slots = slots.at[eidx].add(
                jnp.concatenate(val_cols), mode="drop",
                unique_indices=True,
            )
            n = n + jnp.sum(winner.astype(jnp.int32))
            hist = jax.lax.dynamic_update_index_in_dim(
                hist, hist[r] + jnp.sum(upd.astype(jnp.int32)), r, axis=0
            )
            return r + 1, unresolved & ~upd, slots, n, hist

        def cond(carry2):
            r, unresolved, *_ = carry2
            return (r < self.max_reprobes) & jnp.any(unresolved)

        r, unresolved, slots, n, hist = jax.lax.while_loop(
            cond, body,
            (jnp.int32(r_start), active_f[:width2], state.slots,
             state.n, state.probe_hist),
        )
        spilled = (
            state.spilled + lost + jnp.sum(unresolved.astype(jnp.int32))
        )
        return TableState(
            slots=self._renorm_flat(slots), n=n, spilled=spilled,
            probe_hist=hist,
        )

    def insert(self, state: TableState, ukeys: jax.Array, ucounts: jax.Array,
               uvalid: jax.Array) -> TableState:
        """Insert a deduplicated batch histogram (keys unique where
        uvalid) as ONE program — element-mode rounds to completion (the
        sharded per-shard path and generic callers; widths there are
        route-cap sized, where element ops win).  The single-chip counter
        uses the host-driven split_round flow instead
        (core/counter.py _table_step)."""
        pos0, cleared = self._hash_cols(ukeys)
        carry = (pos0, cleared, ucounts.astype(jnp.int32), uvalid)
        return self.residue_phase(
            state, carry, 0, ukeys.shape[0]
        )

    # --- queries -----------------------------------------------------------

    def lookup(self, state: TableState, queries: jax.Array
               ) -> tuple[jax.Array, jax.Array]:
        """Probe-walk lookup (reference getKmerCountDebug TSXHashMap.h:477-543).

        Probing stops at the first empty slot (slots are never freed, so an
        empty slot proves absence).  Returns (digits [N,3], found [N]).
        """
        lanes = self.spec.lanes
        cols = self.slot_cols
        pos0, cleared = self._hash_cols(queries)
        s = self.slots
        # derive loop carries from pos0 so they inherit its varying-manual
        # axes when called inside shard_map
        zero = pos0 * 0

        def cond(carry):
            r, active, *_ = carry
            return (r < self.max_reprobes) & jnp.any(active)

        def body(carry):
            r, active, out, found = carry
            pos = (pos0 + _triangular(r)) % s
            slotkey0 = cleared[0] | r.astype(jnp.uint32)
            g_cols = [
                jnp.take(state.slots, c * s + pos, mode="clip")
                for c in range(cols)
            ]
            used_g = g_cols[cols - 1] != 0
            key_eq = g_cols[0] == slotkey0
            for j in range(1, lanes):
                key_eq = key_eq & (g_cols[j] == cleared[j])
            match = active & used_g & key_eq
            digits_g = _bitcast_i32(
                jnp.stack(g_cols[lanes : lanes + COUNT_DIGITS], axis=1)
            )
            out = jnp.where(match[:, None], digits_g, out)
            found = found | match
            active = active & used_g & ~match
            return r + 1, active, out, found

        n_q = queries.shape[0]
        _, _, out, found = jax.lax.while_loop(
            cond, body,
            (jnp.zeros((), jnp.int32),
             zero == 0,
             jnp.zeros((n_q, COUNT_DIGITS), jnp.int32) + zero[:, None],
             zero != 0),
        )
        return out, found

    def get_positions(self, state: TableState, queries: jax.Array
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
        """Debug API: the slot index and reprobe count where each query key
        resides (reference getPosition TSXHashMap.h:759-778 and
        getKmerPositions).  Returns (pos int32 [N], reprobe int32 [N],
        found bool [N]); pos/reprobe are -1 when absent."""
        lanes = self.spec.lanes
        cols = self.slot_cols
        pos0, cleared = self._hash_cols(queries)
        s = self.slots
        zero = pos0 * 0

        def cond(carry):
            r, active, *_ = carry
            return (r < self.max_reprobes) & jnp.any(active)

        def body(carry):
            r, active, out_pos, out_r, found = carry
            pos = (pos0 + _triangular(r)) % s
            slotkey0 = cleared[0] | r.astype(jnp.uint32)
            used_g = jnp.take(
                state.slots, (cols - 1) * s + pos, mode="clip"
            ) != 0
            key_eq = jnp.take(state.slots, pos, mode="clip") == slotkey0
            for j in range(1, lanes):
                key_eq = key_eq & (
                    jnp.take(state.slots, j * s + pos, mode="clip")
                    == cleared[j]
                )
            match = active & used_g & key_eq
            out_pos = jnp.where(match, pos, out_pos)
            out_r = jnp.where(match, r, out_r)
            found = found | match
            active = active & used_g & ~match
            return r + 1, active, out_pos, out_r, found

        _, _, out_pos, out_r, found = jax.lax.while_loop(
            cond, body,
            (jnp.zeros((), jnp.int32),
             zero == 0,
             zero - 1,
             zero - 1,
             zero != 0),
        )
        return out_pos, out_r, found

    def reconstruct_all(self, state: TableState
                        ) -> tuple[jax.Array, jax.Array]:
        """Rebuild every stored k-mer from its slot — getAllKmers analog.

        For slot i holding key = (func << L) | r: the missing low L hash bits
        are (i - r(r+1)/2) mod 2^L, so hash = (key & ~lowmask) | missing and
        kmer = inv_apply(hash) (reference TSXHashMap.h:660-722, §3.4).
        Returns (kmers uint32 [slots, lanes], used bool [slots]).  Debug /
        host path — production export runs the chunked program below.
        """
        i = jnp.arange(self.slots, dtype=jnp.int32)
        key0 = self._col(state.slots, 0)
        r = (key0 & self._low_mask).astype(jnp.int32)
        missing = (i - _triangular(r)) % self.slots
        hashed = jnp.stack(
            [(key0 & ~self._low_mask) | missing.astype(jnp.uint32)]
            + [self._col(state.slots, j)
               for j in range(1, self.spec.lanes)],
            axis=1,
        )
        kmers = self.hash_fn.inv_apply(hashed)
        return kmers, self.state_used(state)

    # --- host export ---

    _EXPORT_CHUNK = 1 << 20  # slots per export program invocation

    def _export_program(self, chunk: int):
        """Cached jitted chunk exporter: reconstruct + compact `chunk`
        slots starting at a dynamic offset.

        One program per table, reused for every chunk and every call —
        never a fresh per-call jax.jit (VERDICT r4 #3).  Compaction keeps
        host traffic O(used): used rows sort to the front, the caller
        fetches only the used prefix.  Column slices are 1-D."""
        jit = getattr(self, "_export_jit", None)
        if jit is not None and self._export_jit_chunk == chunk:
            return jit
        lanes = self.spec.lanes
        s = self.slots
        cols = self.slot_cols

        def export_chunk(state: TableState, start):
            col = lambda c: jax.lax.dynamic_slice(
                state.slots, (c * s + start,), (chunk,)
            )
            key0 = col(0)
            r = (key0 & self._low_mask).astype(jnp.int32)
            i = start + jnp.arange(chunk, dtype=jnp.int32)
            missing = (i - _triangular(r)) % s
            hashed = jnp.stack(
                [(key0 & ~self._low_mask) | missing.astype(jnp.uint32)]
                + [col(j) for j in range(1, lanes)],
                axis=1,
            )
            kmers = self.hash_fn.inv_apply(hashed)
            used = col(cols - 1) != 0
            ckey = jnp.where(
                used, jnp.arange(chunk, dtype=jnp.int32), chunk
            )
            out = jax.lax.sort(
                (ckey,)
                + tuple(kmers[:, j] for j in range(lanes))
                + tuple(col(lanes + j) for j in range(COUNT_DIGITS)),
                num_keys=1,
            )
            n_used = jnp.sum(used.astype(jnp.int32))
            return out[1:], n_used

        jit = jax.jit(export_chunk)
        self._export_jit = jit
        self._export_jit_chunk = chunk
        return jit

    def to_host(self, state: TableState) -> tuple[np.ndarray, np.ndarray, int]:
        """Fetch (kmer keys [n, lanes], counts [n] python ints, n).

        Chunked + compacted: device work and host traffic are O(used
        prefix per chunk), with one scalar round trip per wave of
        chunks."""
        lanes = self.spec.lanes
        chunk = min(self.slots, self._EXPORT_CHUNK)
        program = self._export_program(chunk)
        n_chunks = -(-self.slots // chunk)
        kmer_parts: list[np.ndarray] = []
        digit_parts: list[np.ndarray] = []
        wave = 16
        for w0 in range(0, n_chunks, wave):
            outs = [
                program(state, jnp.int32(ci * chunk))
                for ci in range(w0, min(w0 + wave, n_chunks))
            ]
            ns = np.asarray(jax.device_get(
                jnp.stack([o[1] for o in outs])
            ))
            for (cols, _), n in zip(outs, ns):
                n = int(n)
                if not n:
                    continue
                # pow2 width buckets keep the eager-slice program count
                # bounded (each distinct slice shape compiles once)
                width = 1 << max(8, n - 1).bit_length()
                width = min(width, chunk)
                got = jax.device_get([c[:width] for c in cols])
                kmer_parts.append(
                    np.stack([np.asarray(c[:n]) for c in got[:lanes]],
                             axis=1)
                )
                digit_parts.append(
                    np.stack([np.asarray(c[:n]) for c in got[lanes:]],
                             axis=1).astype(np.int64)
                )
        if not kmer_parts:
            return (np.zeros((0, lanes), np.uint32),
                    np.zeros((0,), dtype=object), 0)
        kmers = np.concatenate(kmer_parts, axis=0)
        digits = np.concatenate(digit_parts, axis=0)
        counts = np.array(
            [counts_to_int(*d) for d in digits], dtype=object
        )
        return kmers, counts, len(kmers)

    def total(self, state: TableState) -> int:
        """Sum of every stored count (empty slots hold zero digits)."""
        lanes = self.spec.lanes
        return digit_sums_to_int(jax.device_get(digit_column_sums([
            self._col(state.slots, lanes + j) for j in range(COUNT_DIGITS)
        ])))

    def fill_factor(self, state: TableState) -> float:
        """Occupancy ratio — the print_stats analog (TSXHashMap.h:390-395)."""
        return float(jax.device_get(state.n)) / self.slots
