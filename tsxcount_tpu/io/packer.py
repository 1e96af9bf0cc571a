"""Host-side read packer: sequences -> fixed-shape device batches.

Replaces the reference's per-kmer string materialization
(`createKMers` sliding window, reference src/mains/testExecution.h:15-36, and
`fromSequence` per-kmer bit packing, src/utils/SequenceUtils.h:86-160) with a
batched layout the device can window-extract without gathers:

  * bases are 2-bit packed into uint32 words, 16 bases/word, LSB-first;
  * every read starts on a word boundary (fresh uint32);
  * window validity ships as INTERVALS: sorted disjoint [start, end) runs
    of valid window positions (one per read segment, split around Ns),
    since validity is read-boundary structure — ~6x fewer H2D bytes than a
    dense bitmask.  A position is valid iff the window [p, p+k) lies inside
    one read and (drop policy) contains no N.  Reads shorter than k are
    skipped, matching the reference (testExecution.h:18-19);
  * words and intervals ship as ONE uint32 buffer
    `[words | interval starts | interval ends]` (buf_words long; unused
    interval slots hold 0xFFFFFFFF) — a single device_put per batch;
  * reads longer than the remaining batch capacity are split with a k-1 base
    overlap so no window is lost or duplicated at the seam; a batch that
    fills its interval budget flushes early the same way.

N handling is policy-driven: "drop" (default — the deliberate design) or
"random" (reference bug-compat: the reference substitutes random bits,
SequenceUtils.h:126-137, which makes counts nondeterministic).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np

from tsxcount_tpu.config import BASES_PER_WORD, BatchSpec
from tsxcount_tpu.utils.sequence import encode_bases

N_POLICIES = ("drop", "random")

IV_SENTINEL = np.uint32(0xFFFFFFFF)


@dataclasses.dataclass
class PackedBatch:
    """One fixed-shape device batch.

    buf: uint32 [batch.buf_words] = [words | iv starts | iv ends];
    the words section's last pad_words are zero, unused interval slots are
    IV_SENTINEL.
    """

    buf: np.ndarray
    n_valid: int               # number of valid window positions
    n_bases: int               # bases packed into this batch (incl. overlaps)
    batch: BatchSpec

    @property
    def words(self) -> np.ndarray:
        return self.buf[: self.batch.total_words]

    @property
    def iv_starts(self) -> np.ndarray:
        tw, m = self.batch.total_words, self.batch.max_intervals
        return self.buf[tw : tw + m]

    @property
    def iv_ends(self) -> np.ndarray:
        tw, m = self.batch.total_words, self.batch.max_intervals
        return self.buf[tw + m : tw + 2 * m]

    @property
    def vmask(self) -> np.ndarray:
        """Dense validity bitmask (bit p%32 of word p//32 = position p
        valid) — the multi-chip wire format and debug view, derived from
        the intervals on demand."""
        b = self.batch
        diff = np.zeros(b.positions + 1, np.int32)
        starts = self.iv_starts
        ends = self.iv_ends
        real = starts != IV_SENTINEL
        np.add.at(diff, starts[real].astype(np.int64), 1)
        np.add.at(diff, ends[real].astype(np.int64), -1)
        valid = np.cumsum(diff[:-1]) > 0
        return np.packbits(valid, bitorder="little").view(np.uint32)

    @classmethod
    def empty(cls, batch: BatchSpec) -> "PackedBatch":
        buf = np.zeros(batch.buf_words, np.uint32)
        buf[batch.total_words :] = IV_SENTINEL
        return cls(buf=buf, n_valid=0, n_bases=0, batch=batch)


@dataclasses.dataclass
class PackStats:
    reads: int = 0
    reads_skipped: int = 0     # len < k (reference testExecution.h:18-19)
    bases: int = 0
    n_bases: int = 0           # non-ACGT bases seen
    windows: int = 0           # valid window positions emitted to batches
    batches: int = 0
    # homopolymer collapse: per-base-code counts of all-X windows elided
    # from the stream (exact; applied to the affected kmers at read time)
    # and the bases removed.  total logical windows = windows + sum(hp_bonus).
    hp_bonus: tuple = (0, 0, 0, 0)
    hp_collapsed_bases: int = 0
    # uint32 words actually emitted (batch-fill/H2D accounting; drives
    # batch auto-sizing in bench.py and HBM footprint estimates)
    packed_words: int = 0


def add_stats(a: PackStats, b: PackStats) -> PackStats:
    """Field-wise sum of two ingest-stat records (mixed add_reads +
    count_file usage, per-range native readers, cross-host reduction)."""
    return PackStats(
        reads=a.reads + b.reads,
        reads_skipped=a.reads_skipped + b.reads_skipped,
        bases=a.bases + b.bases,
        n_bases=a.n_bases + b.n_bases,
        windows=a.windows + b.windows,
        batches=a.batches + b.batches,
        hp_bonus=tuple(x + y for x, y in zip(a.hp_bonus, b.hp_bonus)),
        hp_collapsed_bases=a.hp_collapsed_bases + b.hp_collapsed_bases,
        packed_words=a.packed_words + b.packed_words,
    )


def collapse_homopolymers(codes: np.ndarray, invalid: np.ndarray, keep: int
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Splice maximal runs of one valid base longer than `keep` (= 2k-2)
    down to exactly `keep` bases.

    Window-content preservation: any window overlapping a run sees only
    that base where it overlaps, so every boundary-crossing window of the
    original read appears exactly once in the spliced read with identical
    contents and validity; only interior all-X windows disappear — exactly
    L - keep of them per run (keep = 2k-2 leaves k-1 context bases on each
    side plus the k-1 surviving interior windows).  Returns
    (codes, invalid, bonus int64[4]) where bonus[c] counts the elided
    all-c window instances.  The reference brute-forces these windows
    (addKmer per occurrence); collapsing them at ingest is the homopolymer
    analog of super-k-mer compression and keeps counts EXACT.
    """
    bonus = np.zeros(4, np.int64)
    n = len(codes)
    if n <= keep:
        return codes, invalid, bonus
    valid = ~invalid
    same = (codes[1:] == codes[:-1]) & valid[1:] & valid[:-1]
    if not same.any():
        return codes, invalid, bonus
    starts = np.concatenate(
        [np.zeros(1, np.int64), np.flatnonzero(~same) + 1]
    )
    run_id = np.cumsum(np.concatenate([[False], ~same]))
    lengths = np.diff(np.concatenate([starts, [n]]))
    long = lengths > keep
    if not long.any():
        return codes, invalid, bonus
    np.add.at(bonus, codes[starts[long]], lengths[long] - keep)
    keep_mask = (np.arange(n) - starts[run_id]) < keep
    return codes[keep_mask], invalid[keep_mask], bonus


class ReadPacker:
    """Streaming packer producing PackedBatch objects of a fixed BatchSpec."""

    def __init__(self, batch: BatchSpec, n_policy: str = "drop", seed: int = 0,
                 collapse: bool = False):
        if n_policy not in N_POLICIES:
            raise ValueError(f"n_policy must be one of {N_POLICIES}")
        self.batch = batch
        self.spec = batch.spec
        self.n_policy = n_policy
        self.rng = np.random.default_rng(seed)
        self.collapse = collapse and batch.spec.k >= 2
        self._hp_keep = 2 * batch.spec.k - 2
        self.stats = PackStats()
        self._reset()

    def _reset(self) -> None:
        b = self.batch
        self._buf = np.zeros(b.buf_words, dtype=np.uint32)
        self._buf[b.total_words :] = IV_SENTINEL
        self._cur_word = 0
        self._n_ivs = 0
        self._n_valid = 0
        self._n_bases = 0

    def _flush(self) -> PackedBatch:
        out = PackedBatch(
            buf=self._buf,
            n_valid=self._n_valid,
            n_bases=self._n_bases,
            batch=self.batch,
        )
        self.stats.batches += 1
        self.stats.packed_words += self._cur_word
        self._reset()
        return out

    def _place_segment(self, codes: np.ndarray, invalid: np.ndarray,
                       start: int, seg_len: int) -> int:
        """Pack codes[start:start+seg_len] at the current word boundary and
        record the valid-window runs fully contained in the segment.

        Returns the number of bases actually placed: seg_len normally,
        less if the interval budget truncated the segment mid-read, 0 if
        nothing fits (caller must flush and retry)."""
        k = self.spec.k
        b = self.batch
        w0 = self._cur_word
        inv = invalid[start : start + seg_len]
        n_win = seg_len - k + 1
        # maximal runs of valid window starts
        if inv.any():
            cs = np.zeros(seg_len + 1, dtype=np.int64)
            np.cumsum(inv, out=cs[1:])
            ok = (cs[k : k + n_win] - cs[:n_win]) == 0
            d = np.diff(ok.astype(np.int8), prepend=np.int8(0),
                        append=np.int8(0))
            runs_s = np.flatnonzero(d == 1)
            runs_e = np.flatnonzero(d == -1)
        elif n_win > 0:
            runs_s = np.zeros(1, dtype=np.int64)
            runs_e = np.full(1, n_win, dtype=np.int64)
        else:
            runs_s = runs_e = np.zeros(0, dtype=np.int64)

        avail = b.max_intervals - self._n_ivs
        if len(runs_s) > avail:
            # interval budget: place everything before the first run that
            # doesn't fit (its windows stay with the read's continuation)
            placed_win = int(runs_s[avail])
            if placed_win == 0:
                return 0
            runs_s, runs_e = runs_s[:avail], runs_e[:avail]
            seg_len = placed_win + k - 1

        seg = codes[start : start + seg_len].astype(np.uint32)
        seg_words = (seg_len + BASES_PER_WORD - 1) // BASES_PER_WORD
        padded = np.zeros(seg_words * BASES_PER_WORD, dtype=np.uint32)
        padded[:seg_len] = seg
        lanes = padded.reshape(seg_words, BASES_PER_WORD)
        shifts = (2 * np.arange(BASES_PER_WORD, dtype=np.uint32))[None, :]
        self._buf[w0 : w0 + seg_words] = np.bitwise_or.reduce(
            lanes << shifts, axis=1
        )

        if len(runs_s):
            gbase = w0 * BASES_PER_WORD
            tw, m = b.total_words, b.max_intervals
            i0 = self._n_ivs
            n_runs = len(runs_s)
            self._buf[tw + i0 : tw + i0 + n_runs] = gbase + runs_s
            self._buf[tw + m + i0 : tw + m + i0 + n_runs] = gbase + runs_e
            self._n_ivs += n_runs
            n_here = int((runs_e - runs_s).sum())
            self._n_valid += n_here
            self.stats.windows += n_here
        self._n_bases += seg_len
        self._cur_word += seg_words
        return seg_len

    def feed(self, seq: str | bytes) -> Iterator[PackedBatch]:
        """Pack one read; yield any batches that filled up along the way."""
        k = self.spec.k
        codes, invalid = encode_bases(seq)
        n = len(codes)
        self.stats.reads += 1
        self.stats.bases += n
        n_invalid = int(invalid.sum())
        self.stats.n_bases += n_invalid
        if n < k:
            self.stats.reads_skipped += 1
            return
        if n_invalid and self.n_policy == "random":
            # reference bug-compat: N -> random base (SequenceUtils.h:126-137)
            codes = np.where(
                invalid, self.rng.integers(0, 4, size=n, dtype=np.uint8), codes
            )
            invalid = np.zeros_like(invalid)
        if self.collapse:
            codes, invalid, bonus = collapse_homopolymers(
                codes, invalid, self._hp_keep
            )
            if bonus.any():
                st = self.stats
                st.hp_bonus = tuple(
                    int(a + b) for a, b in zip(st.hp_bonus, bonus)
                )
                st.hp_collapsed_bases += int(bonus.sum())
            n = len(codes)

        start = 0
        cap = self.batch.capacity_words
        while n - start >= k:
            avail_bases = (cap - self._cur_word) * BASES_PER_WORD
            if avail_bases < k:
                yield self._flush()
                continue
            seg_len = min(n - start, avail_bases)
            placed = self._place_segment(codes, invalid, start, seg_len)
            if placed == 0:  # interval budget exhausted: early flush
                yield self._flush()
                continue
            if start + placed >= n:
                break
            start = start + placed - (k - 1)
        if self._cur_word >= cap:
            yield self._flush()

    def finish(self) -> Iterator[PackedBatch]:
        """Yield the final partial batch, if any."""
        if self._cur_word > 0 or self._n_valid > 0:
            yield self._flush()


def pack_reads(
    reads: Iterable[str | bytes],
    batch: BatchSpec,
    n_policy: str = "drop",
    seed: int = 0,
    collapse: bool = False,
) -> Iterator[PackedBatch]:
    """Convenience: pack an iterable of sequences into batches."""
    packer = ReadPacker(batch, n_policy=n_policy, seed=seed,
                        collapse=collapse)
    for seq in reads:
        yield from packer.feed(seq)
    yield from packer.finish()
