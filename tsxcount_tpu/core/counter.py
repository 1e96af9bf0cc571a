"""KmerCounter — end-to-end streaming counting engine.

The device-side equivalent of the reference's `countKMers` driver
(reference src/mains/main.cpp:104-402): stream FASTQ/FASTA records, pack on
host, and fold fixed-shape batches through a jitted
extract -> dedupe(sort) -> merge/insert device step.  The host packer and the
device step overlap naturally through JAX's async dispatch — the analog of
the reference's reader-task/counter-task pipeline (main.cpp:132-218) without
threads or locks.

Two backends, selected like the reference's --mode dispatch
(main.cpp:429-475):
  * "sort"  — CountStore: sorted-merge count table (speed path);
  * "table" — QuotientTable: jellyfish-style reprobing table with
              reconstructible slots (parity path).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np

from tsxcount_tpu.config import BatchSpec, KmerSpec, counts_to_int
from tsxcount_tpu.core.store import CountStore
from tsxcount_tpu.core.table import QuotientTable
from tsxcount_tpu.io.fastx import read_fastx
from tsxcount_tpu.io.packer import PackedBatch, ReadPacker
from tsxcount_tpu.ops.canonical import canonicalize
from tsxcount_tpu.ops.count import count_unique
from tsxcount_tpu.ops.gf2 import DEFAULT_SEED, GF2Hash
from tsxcount_tpu.ops.window import (
    extract_kmer_cols,
    extract_kmers,
    intervals_to_valid,
)
from tsxcount_tpu.utils.goldenfile import read_golden
from tsxcount_tpu.utils.sequence import kmers_to_strings, strings_to_kmers

BACKENDS = ("sort", "table")

# reference CLI mode strings (main.cpp:41-42,53-81) -> backend strategies.
# The serialization distinctions are meaningless here (no locks to vary);
# they all map to the two conflict-free backends.
MODE_TO_BACKEND = {
    "SERIAL": "sort",
    "PTHREAD": "sort",
    "OMP": "sort",
    "CAS": "table",
    "TSX": "table",
    "EXPERIMENTAL": "table",
    "OMP_COUNT": "sort",
}

_QUERY_BATCH = 4096
_HINT_SAMPLE = 64  # reads sampled for the auto read-length hint
# mix-prefix dedupe auto-engage threshold (lanes).  The mix prefix ADDS 2-3
# sort columns to narrow the comparator; auto stays disabled (opt-in via
# mix_prefix=True) until a GPU measurement shows the trade pays (ROADMAP
# A2, C4).
_MIX_AUTO_MIN_LANES = 99  # auto disabled


def _peek_read_lens(path) -> list[int]:
    """Lengths of the first few records (for interval-budget auto-sizing)."""
    lens: list[int] = []
    for rec in read_fastx(path):
        lens.append(len(rec.seq))
        if len(lens) >= _HINT_SAMPLE:
            break
    return lens


@dataclasses.dataclass
class CheckResult:
    """Outcome of golden-file verification (reference main.cpp:224-396)."""

    n_checked: int = 0
    n_matched: int = 0
    mismatches: list = dataclasses.field(default_factory=list)  # (kmer, want, got)
    missing: list = dataclasses.field(default_factory=list)     # kmer absent
    extra_distinct: int = 0  # stored kmers never queried (coverage audit)

    @property
    def ok(self) -> bool:
        return (
            not self.mismatches and not self.missing and self.extra_distinct == 0
        )


class CheckAbort(RuntimeError):
    """Raised on first mismatch in checkabort mode (exit(200) analog)."""


class TableFull(RuntimeError):
    """Capacity exceeded — analog of the reference's exit(42)
    (TSXHashMap.h:340-343)."""


class PrefixCollision(RuntimeError):
    """Two DISTINCT keys collided in the 64-bit uniform dedupe-sort prefix
    (probability ~P^2/2^65 per batch, about 1 in 4e5 batches at the default
    batch size), so one ingested batch's histogram may be wrong.

    Detection is exact (ops/count.py _sort_uniform_prefix collide_mode
    "flag"); count_file() handles this internally by recounting the file
    with the full-comparator sort.  It surfaces to callers only from the
    streaming add_reads() API, where the input cannot be replayed — rerun
    with mix_prefix=False/hash_first=False, or feed via count_file."""


class IngestProgressMixin:
    """Periodic in-run progress line (reference prints every 100k aborts,
    TSXHashMapTSXPerf.h:541-544; the benchmark protocol records memory,
    analyses/perform_analyses.py:64).  Enabled by progress_every > 0."""

    progress_every: int = 0
    _progress_t0 = None
    _progress_last = 0

    def _maybe_progress(self, stats_fn=None) -> None:
        if not self.progress_every:
            return
        if self._progress_t0 is None:
            self._progress_t0 = time.perf_counter()
        if self.batches_processed - self._progress_last < self.progress_every:
            return
        self._progress_last = self.batches_processed
        import sys

        st = stats_fn() if stats_fn is not None else self.packer.stats
        dt = max(1e-9, time.perf_counter() - self._progress_t0)
        print(
            f"progress: batches={self.batches_processed} reads={st.reads} "
            f"windows={st.windows} ({st.windows / dt / 1e6:.1f}M win/s) "
            f"packed_mb={st.packed_words * 4 / 2**20:.0f}",
            file=sys.stderr, flush=True,
        )


class HpBonusMixin:
    """Read-time application of homopolymer-collapse bonus counts.

    The ingest spliced all-c runs down to 2k-2 bases and owes
    `stats.hp_bonus[c]` occurrences of the all-c k-mer (io/packer.py
    collapse_homopolymers).  The spliced run still contains k-1 interior
    all-c windows, so the key is always present in the store; the owed
    count is a pure host-side adjustment applied wherever counts leave the
    store (get_counts/items/check).  No device work, idempotent by
    construction, and multi-host exactness falls out of summing ingest
    stats (ShardedKmerCounter overrides _hp_stats with the global sum).
    """

    def _hp_stats(self):
        """Ingest stats the bonus derives from."""
        return self.packer.stats

    def _hp_owed_emit(self) -> dict[str, int]:
        """Owed bonus keyed by the STORED kmer string (canonical rep in
        canonical mode) — the export/items view."""
        k = self.spec.k
        out: dict[str, int] = {}
        for c, b in enumerate(self._hp_stats().hp_bonus):
            if b:
                eff = min(c, 3 - c) if self.canonical else c
                s = "ACGT"[eff] * k
                out[s] = out.get(s, 0) + int(b)
        return out

    def _hp_owed_query(self) -> dict[str, int]:
        """Owed bonus keyed by every query spelling: in canonical mode the
        all-T query must see the all-A bonus and vice versa."""
        emit = self._hp_owed_emit()
        if not emit or not self.canonical:
            return emit
        k = self.spec.k
        out = dict(emit)
        for c in range(4):
            rep = "ACGT"[min(c, 3 - c)] * k
            if rep in emit:
                out["ACGT"[c] * k] = emit[rep]
        return out


class KmerCounter(HpBonusMixin, IngestProgressMixin):
    def __init__(
        self,
        k: int,
        l: int = 26,
        s: int = 4,
        backend: str = "sort",
        batch_words: int = 1 << 16,
        n_policy: str = "drop",
        hash_seed: int = DEFAULT_SEED,
        identity_hash: bool = False,
        max_reprobes: int = 64,
        seed: int = 0,
        merge_every: int = 4,
        canonical: bool = False,
        lsm: bool | None = None,
        lsm_growth: int = 8,
        threads: int = 0,
        prefetch_depth: int = 3,
        read_len_hint: int = 0,
        collapse_homopolymers: bool = False,
        progress_every: int = 0,
        hash_first: bool | None = None,
        mix_prefix: bool | None = None,
    ):
        if backend in MODE_TO_BACKEND:
            backend = MODE_TO_BACKEND[backend]
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or a "
                             f"reference mode {sorted(MODE_TO_BACKEND)}")
        self.spec = KmerSpec(k)
        # hash-first dedupe (SURVEY §7 hard-part #1): apply the bijective
        # GF(2) hash BEFORE dedupe and sort on a 64-bit uniform prefix
        # with the other lanes as payload (ops/count.py
        # _sort_uniform_prefix) — the store then holds hashed keys and
        # exports inverse-map, exactly like the sharded path.  The
        # SHARDED counter sorts a uniform prefix for free — its stream is
        # already hashed for routing (parallel/sharded.py).
        # hash_first: False | "mix" | "gf2" (True = "mix").  Both variants
        # hash keys BEFORE dedupe so the sort compares a 64-bit uniform
        # prefix with the other lanes as payload; the store holds the
        # image and exports invert it.  "gf2" is the GF(2) matmul image
        # (per-position bit-unpack -> matmul -> pack); "mix" is the ARX
        # lane-mix Feistel (ops/mix.py LaneMixBijection), elementwise
        # work that keeps the column (unstacked) extraction.
        if hash_first is None:
            # auto rule: "mix" at 8 lanes (k >= 113), where the 8-column
            # comparator shrinks to 2, unless the user asked for
            # mix_prefix.  Inherited from the previous chip; not yet
            # re-measured on the GPU (ROADMAP A6)
            hash_first = (
                "mix" if (
                    backend == "sort" and not mix_prefix
                    and KmerSpec(k).lanes >= 8
                ) else False
            )
        if hash_first is False:
            pass
        elif hash_first is True or hash_first == "mix":
            hash_first = "mix"
        elif hash_first != "gf2":
            raise ValueError("hash_first must be False, True/'mix', "
                             "or 'gf2'")
        if hash_first == "gf2" and identity_hash:
            hash_first = False  # identity GF(2) image is not uniform
        self.hash_first = hash_first if backend == "sort" else False
        # mix-prefix dedupe (r4, SURVEY §7 hard-part #1 second attack):
        # extend raw keys with a cheap mixing hash (ops/mix.py) and
        # sort on (flag, mix_hi, mix_lo) with the raw lanes as payload —
        # the hash-first comparator saving WITHOUT the per-position GF(2)
        # matmul that made it a net loss.  The store holds extended keys
        # (raw + mix columns); exports drop the mix, queries recompute it.
        # Collisions in the 64-bit prefix are detected exactly and handled
        # by a host-side full-sort recount (collide_mode="flag" — only the
        # fast branch compiles, so no fallback sort temps are allocated).
        # Auto rule: on for lanes >= _MIX_AUTO_MIN_LANES (where the wide
        # comparator dominates the dedupe sort), sort backend only.
        if mix_prefix and self.hash_first:
            raise ValueError("mix_prefix and hash_first are exclusive "
                             "(both replace the dedupe sort comparator)")
        if mix_prefix is None:
            mix_prefix = (
                backend == "sort" and not self.hash_first
                and _MIX_AUTO_MIN_LANES <= self.spec.lanes <= 14
            )
        self.mix_prefix = bool(
            mix_prefix and backend == "sort" and not self.hash_first
        )
        if self.mix_prefix:
            from tsxcount_tpu.ops.mix import make_ext_spec

            self.store_spec = make_ext_spec(self.spec)
        else:
            self.store_spec = self.spec
        # set after a detected prefix collision: rebuild the ingest with
        # the full-comparator sort and recount (count_file drives this)
        self._mix_full_sort = False
        self._taints: list = []  # per-batch collision flags (device)
        # read_len_hint sizes the interval-coded validity budget (see
        # BatchSpec.max_intervals); 0 = auto-detect from the first read
        self._auto_hint = read_len_hint == 0
        self.batch = BatchSpec(self.spec, batch_words,
                               read_len_hint or 384)
        self.l = l
        self.s = s  # accepted for CLI parity; counts are unbounded here
        self.backend = backend
        self.n_policy = n_policy
        self.seed = seed
        self.canonical = canonical
        # host ingest pipeline: parse threads (0 = auto -> 1) and how many
        # packed batches may be in flight (packed + H2D started) ahead of
        # the device step — the reader-task/counter-task overlap of the
        # reference (main.cpp:132-218) as a bounded producer queue
        self.threads = threads if threads > 0 else 1
        self.prefetch_depth = max(1, prefetch_depth)
        # homopolymer run-length collapse at ingest (io/packer.py
        # collapse_homopolymers): splices all-X runs > 2k-2 bases and owes
        # the elided window counts, applied at READ time (get_counts/items)
        # from the ingest stats — exact (the all-c kmer always survives in
        # the spliced stream with k-1 interior windows, so only its count
        # changes), and zero extra device work per pass.  Default OFF
        # everywhere (CLI and bench agree); opt in with
        # collapse_homopolymers=True / --hp-collapse.
        self.collapse_hp = collapse_homopolymers
        self.hash_fn = GF2Hash(self.spec, seed=hash_seed, identity=identity_hash)
        # the bijection hash_first stores through (GF2Hash or the ARX
        # lane mix); the table backend keeps self.hash_fn regardless
        if self.hash_first == "mix":
            from tsxcount_tpu.ops.mix import LaneMixBijection

            self.key_map = LaneMixBijection(self.spec)
        else:
            self.key_map = self.hash_fn
        self.lsm = False
        if backend == "sort":
            capacity = 1 << l
            flush = max(1, merge_every) * self.batch.positions
            # LSM pays once the flat O(capacity) re-sort per flush exceeds
            # the cascade's amortized cost (merge into L0 at growth*flush
            # rows + capacity/growth of absorbs per flush vs capacity +
            # flush):  capacity * (growth-1) > growth^2 * flush.
            # lsm=None (the default) applies that rule automatically;
            # True/False force it (True still needs one real level above
            # L0 to mean anything).
            auto_lsm = (
                capacity * (lsm_growth - 1) > lsm_growth ** 2 * flush
            )
            use_lsm = auto_lsm if lsm is None else lsm
            if use_lsm and capacity > flush * lsm_growth:
                from tsxcount_tpu.core.lsm import LSMStore

                self.store = LSMStore(
                    self.store_spec, capacity,
                    base_capacity=flush * lsm_growth, growth=lsm_growth,
                )
                self.lsm = True
            else:
                # tables not larger than L0 gain nothing from levels; fall
                # back to the flat store
                self.store = CountStore(self.store_spec, capacity=capacity)
            self.state = self.store.init_state()
        else:
            self.table = QuotientTable(
                self.spec, l, self.hash_fn, max_reprobes=max_reprobes
            )
            self.state = self.table.init_state()
        self.merge_every = max(1, merge_every) if backend == "sort" else 1
        if backend == "sort":
            if self.lsm:
                # LSMStore.merge_stacked orchestrates its own jitted
                # level-merges around a host-side cascade counter
                self._merge = self.store.merge_stacked
            else:
                self._merge = jax.jit(
                    lambda state, k, c, v: self.store.merge_stacked(
                        state, k, c, v),
                    donate_argnums=(0,),
                )
            self._pending_uc: list = []
        self._lookup = jax.jit(self._make_lookup())
        # cached canonical query prep — a fresh per-call jax.jit would
        # recompile on every get_counts
        self._canon_queries = jax.jit(
            lambda x: canonicalize(x, self.spec)
        ) if canonical else None
        self._build_ingest()
        self.batches_processed = 0
        self.elapsed = 0.0
        # periodic in-run progress (reference prints every 100k aborts,
        # TSXHashMapTSXPerf.h:541-544): one stderr line every N batches
        self.progress_every = max(0, progress_every)
        self._progress_t0 = None

    def _build_ingest(self) -> None:
        """(Re)build everything that depends on the batch geometry: the
        packer and the jitted per-batch device program.  Called once from
        __init__ and again if the auto read-length hint resizes the batch's
        interval budget before any data has been ingested."""
        self.packer = ReadPacker(
            self.batch, n_policy=self.n_policy, seed=self.seed,
            collapse=self.collapse_hp,
        )
        if self.backend == "sort":
            # deferred merging: dedupe each batch on device, fold R batch
            # histograms into the store with ONE sort (merge_stacked) —
            # amortizes the O(capacity) re-sort across R batches
            batch = self.batch
            canonical = self.canonical
            hash_first = self.hash_first
            mix_prefix = self.mix_prefix
            store_spec = self.store_spec
            key_map = self.key_map
            # uniform-prefix sort unless a detected collision forced the
            # exact full-comparator recount path
            uniform = bool(
                (hash_first or mix_prefix) and not self._mix_full_sort
            )

            def dedupe(buf):
                # buf = [words | validity intervals]: ONE H2D transfer per
                # batch; static slices are free under jit
                words = buf[: batch.total_words]
                if canonical:
                    kmers = canonicalize(
                        extract_kmers(words, batch), batch.spec
                    )
                    if hash_first:
                        kmers = key_map.apply(kmers)
                    if mix_prefix:
                        kmers = [
                            kmers[:, j] for j in range(batch.spec.lanes)
                        ]
                elif hash_first == "mix":
                    # ARX lane mix works on the unstacked columns — no
                    # [P, lanes] materialization (the gf2 path's cost)
                    kmers = key_map.apply_cols(
                        extract_kmer_cols(words, batch)
                    )
                elif hash_first:  # "gf2": the matmul needs the stack
                    kmers = key_map.apply(extract_kmers(words, batch))
                else:
                    # lane columns feed the sort directly (no [P, lanes]
                    # stack/transpose materialization)
                    kmers = extract_kmer_cols(words, batch)
                if mix_prefix:
                    from tsxcount_tpu.ops.mix import extend_cols

                    kmers = extend_cols(kmers)
                valid = intervals_to_valid(buf[batch.total_words :], batch)
                uc = count_unique(
                    kmers, valid, spec=store_spec,
                    uniform_prefix=uniform, collide_mode="flag",
                )
                if uniform:
                    return uc.keys, uc.counts, uc.valid, uc.collided
                # no taint output on the full-comparator path: it cannot
                # collide, and an extra eager device op per batch would
                # cost a dispatch per batch
                return uc.keys, uc.counts, uc.valid

            self._dedupe_returns_taint = uniform
            self._dedupe = jax.jit(dedupe)
        else:
            self._step = jax.jit(self._make_step())
            self._tphase_cache = {}

    def _adapt_read_len(self, read_lens) -> None:
        """One-shot auto-sizing of the interval budget from the first few
        observed read lengths (read_len_hint=0).  Uses the sample MINIMUM —
        conservative: a budget sized for the shortest read never flushes
        early on longer ones.  Only the batch geometry changes; count state
        and ingest stats carry over untouched."""
        if not self._auto_hint:
            return
        self._auto_hint = False
        lens = [int(x) for x in read_lens]
        if not lens:
            return
        hint = max(self.spec.k, min(lens))
        new_batch = dataclasses.replace(self.batch, read_len_hint=hint)
        if new_batch.max_intervals == self.batch.max_intervals:
            return
        self.batch = new_batch
        stats = self.packer.stats
        self._build_ingest()
        self.packer.stats = stats

    # --- jitted device steps ---

    def _make_step(self):
        """Table-backend ingest as THREE dispatches per batch:

          1. dedupe (count_unique) — returns the compacted histogram and
             n_unique;
          2. host width choice: n_unique is fetched (one round trip) and
             the narrowest of {P/4, P/2, P} that holds every valid row is
             picked.  The insert's claim sorts, gathers, and the dominant
             per-row scatters then run at that width (the dedupe output
             is a valid PREFIX, so the slice is exact) — round 0, which
             tablebench measured as ~half the insert, typically halves;
          3. insert_phase1 + insert_phase2 at the chosen width (lazily
             jitted per width; slicing happens INSIDE the jit — an eager
             device-slice would cost a dispatch per batch)."""
        batch = self.batch

        canonical = self.canonical

        def dedupe_t(buf):
            words = buf[: batch.total_words]
            if canonical:
                kmers = canonicalize(extract_kmers(words, batch), batch.spec)
            else:
                kmers = extract_kmer_cols(words, batch)
            valid = intervals_to_valid(buf[batch.total_words :], batch)
            uc = count_unique(kmers, valid, spec=batch.spec)
            return uc.keys, uc.counts, uc.valid, uc.n_unique

        return dedupe_t

    _TABLE_RESIDUE_ELEMS = 1 << 18  # w*C below this: one while_loop tail

    def _table_round_jit(self, r: int, width: int):
        """split_round jit at static (reprobe index, width) — cached.

        The host drives rounds at SHRINKING widths: after round r the
        actives sit in a prefix whose size round r reports, so round r+1
        slices the carry to the next pow2 bucket."""
        key = ("round", r, width)
        jit = self._tphase_cache.get(key)
        if jit is None:
            table = self.table
            if r == 0:
                def f(st, k, c, v):
                    return table.split_round(
                        st, 0, *table.round0_args(
                            k[:width], c[:width], v[:width]
                        ),
                    )
            else:
                def f(st, p0, cl, c, a):
                    return table.split_round(
                        st, r, p0[:width],
                        tuple(x[:width] for x in cl), c[:width],
                        a[:width],
                    )
            jit = self._tphase_cache[key] = jax.jit(
                f, donate_argnums=(0,)
            )
        return jit

    def _table_tail_jit(self, r_start: int, width: int):
        """residue_phase jit (while_loop to completion + renorm)."""
        key = ("tail", r_start, width)
        jit = self._tphase_cache.get(key)
        if jit is None:
            table = self.table
            jit = self._tphase_cache[key] = jax.jit(
                lambda st, p0, cl, c, a: table.residue_phase(
                    st, (p0, cl, c, a), r_start, width
                ),
                donate_argnums=(0,),
            )
        return jit

    def _table_renorm_jit(self):
        jit = self._tphase_cache.get("renorm")
        if jit is None:
            table = self.table
            jit = self._tphase_cache["renorm"] = jax.jit(
                lambda st: st._replace(
                    slots=table._renorm_flat(st.slots)
                ),
                donate_argnums=(0,),
            )
        return jit

    def _table_step(self, buf) -> None:
        keys, counts, valid, nu = self._step(buf)
        p = keys.shape[0]
        n = int(jax.device_get(nu))
        width = p
        for w in (p // 4, p // 2):
            if 256 <= w and n <= w:
                width = w
                break
        cols = self.table.slot_cols
        st, carry, _, n_left = self._table_round_jit(0, width)(
            self.state, keys, counts, valid
        )
        r = 1
        while True:
            f = int(jax.device_get(n_left))
            if f == 0:
                self.state = self._table_renorm_jit()(st)
                return
            w = min(width, max(256, 1 << (f - 1).bit_length()))
            if w * cols <= self._TABLE_RESIDUE_ELEMS or r >= 6:
                self.state = self._table_tail_jit(r, w)(st, *carry)
                return
            st, carry, _, n_left = self._table_round_jit(r, w)(
                st, *carry
            )
            r += 1

    def _flush_pending(self) -> None:
        """Fold pending batch histograms into the store (sort backend)."""
        if self.backend != "sort" or not self._pending_uc:
            return
        pend = self._pending_uc
        self._pending_uc = []
        while len(pend) < self.merge_every:  # pad to the compiled R
            k, c, v = pend[0]
            pend.append(
                (jnp.zeros_like(k), jnp.zeros_like(c),
                 jnp.zeros_like(v))
            )
        self.state = self._merge(
            self.state,
            jnp.stack([p[0] for p in pend]),
            jnp.stack([p[1] for p in pend]),
            jnp.stack([p[2] for p in pend]),
        )

    def _make_lookup(self):
        if self.backend == "sort":
            return lambda state, q: self.store.lookup(state, q)
        return lambda state, q: self.table.lookup(state, q)

    def reset(self) -> None:
        """Clear all counts/ingest stats but keep the compiled device
        programs — a fresh store at steady-state cost (bench fresh-pass
        and reuse without paying jit again)."""
        if self.backend == "sort":
            self.state = self.store.init_state()
            if self.lsm:
                self.store.reset_schedule()
            self._pending_uc = []
        else:
            self.state = self.table.init_state()
        self.packer = ReadPacker(
            self.batch, n_policy=self.n_policy, seed=self.seed,
            collapse=self.collapse_hp,
        )
        self._taints = []
        self.batches_processed = 0
        self.elapsed = 0.0

    # --- ingestion ---

    @staticmethod
    def _put(pb: PackedBatch):
        # async H2D: device_put returns before the copy completes.  Words
        # and validity intervals ride ONE combined buffer = one transfer
        # per batch.  Runs on the producer thread under prefetch().
        return jax.device_put(pb.buf)

    def _consume_bufs(self, bufs, stats_fn=None) -> None:
        """Dispatch device steps over an iterator of device buffers."""
        t0 = time.perf_counter()
        for buf in bufs:
            if self.backend == "sort":
                out = self._dedupe(buf)
                self._pending_uc.append(out[:3])
                if self._dedupe_returns_taint:
                    # append only — no eager device op per batch;
                    # coalesced in bulk below and checked once at finish
                    self._taints.append(out[3])
                    if len(self._taints) >= 256:
                        self._taints = [jnp.any(jnp.stack(self._taints))]
                if len(self._pending_uc) >= self.merge_every:
                    self._flush_pending()
            else:
                self._table_step(buf)
            self.batches_processed += 1
            self._maybe_progress(stats_fn)
        self.elapsed += time.perf_counter() - t0


    def _consume(self, batches: Iterator[PackedBatch]) -> None:
        self._consume_bufs(self._put(pb) for pb in batches)

    def add_reads(self, reads: Iterable[str | bytes]) -> None:
        reads = iter(reads)
        if self._auto_hint:
            import itertools

            sample = list(itertools.islice(reads, _HINT_SAMPLE))
            self._adapt_read_len(len(s) for s in sample)
            reads = itertools.chain(sample, reads)
        for seq in reads:
            self._consume(self.packer.feed(seq))

    def finish(self) -> None:
        """Flush the final partial batch and check for capacity errors."""
        self._consume(self.packer.finish())
        self._flush_pending()
        jax.block_until_ready(self.state)
        self._check_capacity()

    def _collapse_if_lsm(self) -> None:
        if self.backend == "sort" and self.lsm:
            self.state = self.store.collapse(self.state)

    def _check_capacity(self) -> None:
        if self.backend == "sort":
            states = self.state if self.lsm else [self.state]
            # one round trip for overflow flags of every level + the
            # dedupe-collision taints
            flags = [s.overflowed for s in states]
            taints = self._taints
            self._taints = []
            vec = np.asarray(jax.device_get(jnp.stack(flags + taints)))
            n_over = len(states)
            tainted = bool(vec[n_over:].any())
            if bool(vec[:n_over].any()):
                raise TableFull(
                    f"distinct kmers exceeded capacity 2^{self.l}; rerun with "
                    f"a larger --l (reference exits 42 here)"
                )
            if tainted:
                raise PrefixCollision(PrefixCollision.__doc__)
        else:
            spilled = int(jax.device_get(self.state.spilled))
            if spilled:
                raise TableFull(
                    f"{spilled} kmers unresolved after "
                    f"{self.table.max_reprobes} reprobes; increase --l or "
                    f"max_reprobes (reference exits 42 here)"
                )

    def count_file(self, path: str | Path, use_native: bool | None = None
                   ) -> None:
        """Count a FASTQ/FASTA(.gz) file.

        use_native: True = require the C++ packer, False = pure Python,
        None (default) = native if buildable, else Python fallback.

        A detected dedupe-prefix collision (mix_prefix/hash_first modes,
        ~1 in 4e5 batches) is handled here by recounting the file with the
        full-comparator sort — exact, transparent, and only possible when
        this counter held no earlier data (otherwise the retry would lose
        it, so the collision surfaces as PrefixCollision).
        """
        fresh = self.batches_processed == 0 and self.packer.stats.reads == 0
        try:
            self._count_file_impl(path, use_native)
        except PrefixCollision:
            if not fresh:
                raise
            import sys

            print(
                "tsxcount: dedupe-prefix collision detected; recounting "
                "with the full-comparator sort (exact, ~2x this file's "
                "cost)", file=sys.stderr,
            )
            self._mix_full_sort = True
            self.reset()
            self._build_ingest()
            self._count_file_impl(path, use_native)

    def _count_file_impl(self, path: str | Path,
                         use_native: bool | None = None) -> None:
        from tsxcount_tpu.io.native import NativeFileReader, native_available
        from tsxcount_tpu.io.pipeline import prefetch

        if self._auto_hint:
            self._adapt_read_len(_peek_read_lens(path))
        if use_native is None:
            use_native = native_available()
        if use_native:
            reader = NativeFileReader(
                path, self.batch, n_policy=self.n_policy, seed=self.seed,
                threads=self.threads, collapse=self.collapse_hp,
            )
            # parse + pack + H2D on background thread(s); device dispatch
            # on this one — the overlapped steady-state pipeline
            self._consume_bufs(
                prefetch(iter(reader), self._put, depth=self.prefetch_depth),
                stats_fn=reader.live_stats,
            )
            self._flush_pending()
            # accumulate the native reader's ingest stats (prior add_reads
            # contributions, including their owed hp bonus, are preserved)
            from tsxcount_tpu.io.packer import add_stats

            self.packer.stats = add_stats(self.packer.stats, reader.stats)
            jax.block_until_ready(self.state)
            self._check_capacity()
        else:
            packer = self.packer

            def batches():
                for rec in read_fastx(path):
                    yield from packer.feed(rec.seq)
                yield from packer.finish()

            self._consume_bufs(
                prefetch(batches(), self._put, depth=self.prefetch_depth)
            )
            self._flush_pending()
            jax.block_until_ready(self.state)
            self._check_capacity()

    # --- queries & export ---

    @property
    def distinct(self) -> int:
        self._flush_pending()
        self._collapse_if_lsm()
        state = self.state[-1] if self.lsm else self.state
        return int(jax.device_get(state.n))

    @property
    def total_kmers(self) -> int:
        st = self.packer.stats
        return st.windows + sum(st.hp_bonus)

    @property
    def stored_total(self) -> int:
        """Sum of every count held on the device: equals the windows
        counted (total_kmers less any homopolymer bonus owed at read
        time)."""
        self._flush_pending()
        self._collapse_if_lsm()
        if self.backend == "sort":
            if self.lsm:
                return self.store.levels[-1].total(self.state[-1])
            return self.store.total(self.state)
        return self.table.total(self.state)

    def get_counts(self, kmers: list[str]) -> list[int]:
        """Exact counts for a list of kmer strings (0 if absent)."""
        if not kmers:
            return []
        self._flush_pending()
        keys = strings_to_kmers(kmers, self.spec)
        if self.canonical:
            keys = np.asarray(self._canon_queries(jnp.asarray(keys)))
        if self.hash_first:  # the store holds hashed keys
            keys = self.key_map.apply_host(np.asarray(keys))
        if self.mix_prefix:  # the store holds (raw, mix) extended keys
            from tsxcount_tpu.ops.mix import extend_keys_host

            keys = extend_keys_host(np.asarray(keys))
        out: list[int] = []
        n = len(kmers)
        for off in range(0, n, _QUERY_BATCH):
            chunk = keys[off : off + _QUERY_BATCH]
            pad = _QUERY_BATCH - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0
                )
            digits, found = self._lookup(self.state, jnp.asarray(chunk))
            digits = np.asarray(jax.device_get(digits))
            found = np.asarray(jax.device_get(found))
            m = min(_QUERY_BATCH, n - off)
            for i in range(m):
                out.append(counts_to_int(*digits[i]) if found[i] else 0)
        owed = self._hp_owed_query()
        if owed:
            out = [c + owed.get(s, 0) for s, c in zip(kmers, out)]
        return out

    def items(self) -> Iterator[tuple[str, int]]:
        """Stream (kmer string, count) for every stored k-mer.

        The full-table export the reference lacks (its counts are only
        reachable via getAllKmers, TSXHashMap.h:660-722) but which
        check-at-scale requires (SURVEY.md §5 checkpoint note).
        """
        self._flush_pending()
        self._collapse_if_lsm()
        if self.backend == "sort":
            keys, counts, n = self.store.to_host(self.state)
            if self.hash_first and n:
                keys = self.key_map.inv_apply_host(keys)
            if self.mix_prefix:  # drop the mix columns; raw lanes remain
                keys = keys[:, : self.spec.lanes]
        else:
            keys, counts, n = self.table.to_host(self.state)
        strings = kmers_to_strings(keys, self.spec)
        owed = self._hp_owed_emit()
        for kmer_str, cnt in zip(strings, counts):
            yield kmer_str, int(cnt) + (owed.pop(kmer_str, 0) if owed else 0)
        # owed keys the store never saw (possible only when bonus counters
        # were set without their runs being ingested, e.g. resumed partial
        # state): still owed, still emitted
        for kmer_str, cnt in sorted(owed.items()):
            if cnt:
                yield kmer_str, cnt

    def to_dict(self) -> dict[str, int]:
        return dict(self.items())

    # --- verification (reference --check / --checkabort, main.cpp:224-396) ---

    def check(self, golden_path: str | Path, abort: bool = False,
              max_report: int = 20) -> CheckResult:
        golden = read_golden(golden_path)
        res = CheckResult()
        kmers = list(golden.keys())
        counts = self.get_counts(kmers)
        for kmer_str, got in zip(kmers, counts):
            want = golden[kmer_str]
            res.n_checked += 1
            if got == want:
                res.n_matched += 1
            else:
                entry = (kmer_str, want, got)
                target = res.missing if got == 0 else res.mismatches
                if len(target) < max_report:
                    target.append(entry)
                if abort:
                    raise CheckAbort(
                        f"count mismatch for {kmer_str}: expected {want}, "
                        f"got {got}"
                    )
        # coverage audit: every stored kmer must have been queried
        # (reference XORs queried positions against kmerStarts,
        # main.cpp:377-394); with exact-count parity this reduces to the
        # distinct totals matching.
        res.extra_distinct = max(0, self.distinct - len(golden))
        return res

    # --- observability (print_stats analog, TSXHashMap.h:390-395 and the
    #     final dump at main.cpp:479-501) ---

    def stats(self) -> dict:
        st = dataclasses.asdict(self.packer.stats)
        st.update(
            backend=self.backend,
            k=self.spec.k,
            l=self.l,
            lanes=self.spec.lanes,
            distinct_kmers=self.distinct,
            total_kmers=self.total_kmers,
            batches=self.batches_processed,
            device_seconds=round(self.elapsed, 4),
        )
        if self.backend == "table":
            st["fill_factor"] = self.table.fill_factor(self.state)
            st["spilled"] = int(jax.device_get(self.state.spilled))
            # reprobe-depth histogram (the RTM abort-code histogram analog,
            # reference TSXHashMapTSXPerf.h:195-239): trailing zeros trimmed
            hist = [int(x) for x in jax.device_get(self.state.probe_hist)]
            while hist and hist[-1] == 0:
                hist.pop()
            st["probe_histogram"] = hist
        return st

    def print_stats(self) -> None:
        for key, val in self.stats().items():
            print(f"{key}: {val}")
