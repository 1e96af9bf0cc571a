"""Multi-device sharded counting: hash-prefix routing + per-shard stores.

This module replaces the reference's entire shared-state concurrency model.
Where tsxCount lets every thread hammer one shared table and serializes with
TSX/CAS/locks (SURVEY.md §2.3), here:

  * read batches stream data-parallel: each device packs/extracts its own
    slice (the omp-task analog, reference src/mains/main.cpp:132-218);
  * each device hashes its k-mers with the bijective GF(2) map FIRST and
    dedupes the *hashed* keys (bijective => same histogram).  Because the
    dedupe sort orders rows by hashed key, the owner shard of each row —
    a range partition of the top hash bits — is a *prefix structure* of the
    sorted output: routing needs NO second sort and NO scatter, just one
    contiguous `dynamic_slice` per destination and one
    `jax.lax.all_to_all` over the mesh — interconnect traffic instead of
    cache-line contention;
  * the owner receives n_shards already-sorted, already-deduplicated runs
    and defers folding them into its private store shard across
    `merge_every` batches (the same amortized merge_stacked the
    single-device path uses);
  * per-destination capacity spill is counted (the analog of the reference's
    abort statistics, TSXHashMapTSXPerf.h:195-239) and surfaced as an error
    at finish() — exactness is never silently lost.

Stores hold HASHED keys (the bijective image); queries are hashed on the way
in and exports are inverse-hashed on the way out, exactly like the
reference's reconstruction path (TSXHashMap.h:660-722).

Works identically on several GPUs of one host and on the CPU-simulated mesh
(`--xla_force_host_platform_device_count`), and across processes once
`jax.distributed.initialize` has run (same SPMD program).
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Iterable, Iterator

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from tsxcount_tpu.config import (
    COUNT_DIGITS,
    BatchSpec,
    KmerSpec,
    counts_to_int,
)
from tsxcount_tpu.core.counter import (
    _QUERY_BATCH,
    HpBonusMixin,
    IngestProgressMixin,
    PrefixCollision,
    TableFull,
)
from tsxcount_tpu.core.store import CountStore, StoreState
from tsxcount_tpu.io.fastx import read_fastx
from tsxcount_tpu.io.packer import PackedBatch, ReadPacker
from tsxcount_tpu.ops.canonical import canonicalize
from tsxcount_tpu.ops.count import (
    count_unique,
    digit_column_sums,
    digit_sums_to_int,
)
from tsxcount_tpu.ops.gf2 import DEFAULT_SEED, GF2Hash
from tsxcount_tpu.ops.window import extract_kmers, intervals_to_valid
from tsxcount_tpu.parallel.mesh import SHARD_AXIS, make_shard_mesh
from tsxcount_tpu.utils.goldenfile import read_golden
from tsxcount_tpu.utils.sequence import kmers_to_strings, strings_to_kmers

shard_map = jax.shard_map


_SCALAR_FIELDS = ("n", "overflowed", "spilled")


def _wrap_scalars(state):
    """Give scalar state fields a singleton axis so shard_map can stack
    them into per-shard vectors (P('shard') out_specs need rank >= 1).
    Works for both StoreState and TableState."""
    return state._replace(**{
        f: getattr(state, f)[None]
        for f in _SCALAR_FIELDS if f in state._fields
    })


def _unwrap_scalars(state):
    return state._replace(**{
        f: getattr(state, f)[0]
        for f in _SCALAR_FIELDS if f in state._fields
    })


def _state_specs(state_cls):
    """Pytree of P('shard') specs matching a state NamedTuple class."""
    return state_cls(*([P(SHARD_AXIS)] * len(state_cls._fields)))


def owner_of_hash(top: jax.Array, spec: KmerSpec, n_shards: int) -> jax.Array:
    """Owner shard of each hashed key: a balanced range partition of the
    top hash lane (monotone in `top`, so sorted-by-hash rows are grouped
    by owner).  Any n_shards, not just powers of two."""
    b = min(16, spec.top_lane_bits)
    bucket = (top >> jnp.uint32(spec.top_lane_bits - b)).astype(jnp.int32)
    return (bucket * n_shards) >> b


def _owner_starts(owner_eff: jax.Array, n_shards: int) -> jax.Array:
    """starts[o] = first index with owner_eff >= o, for o in [0, n_shards].

    owner_eff must be nondecreasing int32 [P] (owners over the valid sorted
    prefix, n_shards on the invalid tail).  Vectorized binary search —
    fori_loop, no data-dependent shapes."""
    p = owner_eff.shape[0]
    targets = jnp.arange(n_shards + 1, dtype=jnp.int32)
    # derive the carries from the input so they inherit its varying
    # manual axes when called inside shard_map
    vary0 = owner_eff[0] * 0
    lo = jnp.zeros((n_shards + 1,), jnp.int32) + vary0
    hi = jnp.full((n_shards + 1,), p, jnp.int32) + vary0
    iters = max(1, p).bit_length() + 1

    def body(_, lohi):
        lo, hi = lohi
        active = lo < hi
        mid = (lo + hi) >> 1
        go_right = owner_eff[jnp.clip(mid, 0, p - 1)] < targets
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
        return lo, hi

    lo, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo


def _grouped(batches: Iterator[PackedBatch], n: int,
             batch_spec: BatchSpec) -> Iterator[list[PackedBatch]]:
    """Chunk a PackedBatch stream into lists of n (last group padded with
    empty batches so every device step has a full fixed-shape input)."""
    group: list[PackedBatch] = []
    for pb in batches:
        group.append(pb)
        if len(group) == n:
            yield group
            group = []
    if group:
        while len(group) < n:
            group.append(PackedBatch.empty(batch_spec))
        yield group


class ShardedKmerCounter(HpBonusMixin, IngestProgressMixin):
    """KmerCounter-compatible API over an N-device shard mesh."""

    def __init__(
        self,
        k: int,
        n_shards: int,
        l: int = 26,
        s: int = 4,
        backend: str = "sort",
        batch_words: int = 1 << 16,
        n_policy: str = "drop",
        hash_seed: int = DEFAULT_SEED,
        identity_hash: bool = False,
        capacity_factor: float = 2.0,
        seed: int = 0,
        devices=None,
        max_reprobes: int = 64,
        canonical: bool = False,
        merge_every: int = 4,
        lsm: bool | None = None,
        lsm_growth: int = 8,
        threads: int = 0,
        prefetch_depth: int = 3,
        read_len_hint: int = 0,
        collapse_homopolymers: bool = False,
        progress_every: int = 0,
        routing_hash: str = "mix",
    ):
        self.progress_every = max(0, progress_every)
        self.threads = threads if threads > 0 else 1
        self.prefetch_depth = max(1, prefetch_depth)
        from tsxcount_tpu.core.counter import MODE_TO_BACKEND

        self.spec = KmerSpec(k)
        self._auto_hint = read_len_hint == 0
        self.batch = BatchSpec(self.spec, batch_words, read_len_hint or 384)
        self.l = l
        self.s = s
        self.backend = MODE_TO_BACKEND.get(backend, backend)
        if self.backend not in ("sort", "table"):
            raise ValueError(f"unknown backend {backend}")
        self.n_shards = n_shards
        self.n_policy = n_policy
        self.seed = seed
        self.canonical = canonical
        self.mesh = make_shard_mesh(n_shards, devices=devices)
        self.hash_fn = GF2Hash(self.spec, seed=hash_seed, identity=identity_hash)
        # the bijection the sharded stream rides: keys are mapped BEFORE
        # dedupe so the dedupe sort doubles as the routing sort.  The
        # default is the ARX lane-mix (ops/mix.py LaneMixBijection);
        # "gf2" keeps the GF(2) matmul image (what older sharded
        # checkpoints were written with).  identity_hash
        # (debug) forces the GF(2) identity and disables the uniform-
        # prefix sort (an identity image is not uniform).
        if routing_hash not in ("mix", "gf2"):
            raise ValueError("routing_hash must be 'mix' or 'gf2'")
        if identity_hash:
            routing_hash = "gf2"
        self.routing_hash = routing_hash
        if routing_hash == "mix":
            from tsxcount_tpu.ops.mix import LaneMixBijection

            self.route_map = LaneMixBijection(self.spec)
        else:
            self.route_map = self.hash_fn
        # n_shards == 1 degenerate: ownership is trivially shard 0, so the
        # per-position bijective hash buys nothing — store RAW keys and the
        # pipeline matches the single-chip counter (queries/exports skip
        # the hash/inverse too).  The table backend still hashes: its slot
        # addressing needs uniform low bits (TSXHashMap.h:759-778 analog).
        # Exception (same auto rule as KmerCounter.hash_first): at >= 8 key
        # lanes the lane-mix image + 2-column uniform-prefix sort replaces
        # the full 8-column comparator, so wide-key single-shard stores
        # ride the bijection too.
        self.hashed_store = (
            n_shards > 1 or self.backend == "table"
            or (routing_hash == "mix" and self.spec.lanes >= 8)
        )
        # owner-side runs are merged in deferred groups of merge_every
        # batches (sort backend); the table backend resolves every batch
        # (its insert cost is per-round, not per-capacity)
        self.merge_every = max(1, merge_every) if self.backend == "sort" else 1
        # per-shard capacity: the global 2^l table split across shards
        l_local = max(1, l - max(0, n_shards.bit_length() - 1))
        if self.backend == "table":
            from tsxcount_tpu.core.table import QuotientTable

            # the stream is pre-hashed (routing needs hash order), so the
            # per-shard table runs an identity mapping on already-hashed
            # keys: slot encoding/addressing is unchanged, reconstruction
            # yields hashed keys that export inverse-maps on host
            self.table = QuotientTable(
                self.spec, l_local, GF2Hash(self.spec, identity=True),
                max_reprobes=max_reprobes,
            )
            self._backend_obj = self.table
        else:
            cap_per_shard = max(1, (1 << l) // n_shards)
            self.store = CountStore(self.spec, capacity=cap_per_shard)
            self._backend_obj = self.store
        # routing capacity per (src, dst) pair: enough for a balanced hash
        # split of one batch's unique keys, rounded up to a multiple of
        # 16384 when large (1024 otherwise)
        cap = int(capacity_factor * self.batch.positions / n_shards)
        cap = min(max(16, cap), self.batch.positions)
        align = 16384 if cap >= 16384 else 1024
        self.route_cap = -(-cap // align) * align
        # recoverable spill (VERDICT r4 #6): when a batch CAN overflow a
        # destination (route_cap < positions), each step appends the
        # sorted tail past route_cap to a per-(src,dst) carry buffer —
        # one extra dynamic slice per destination, no extra sort or
        # exchange — and finish() re-routes the carry in a follow-up
        # step instead of failing the whole run.  Only rows beyond the
        # carry's capacity (cumulative spill > route_cap per pair, i.e.
        # a doubly-astronomical skew) remain a hard TableFull.
        self._carry_enabled = self.route_cap < self.batch.positions
        self._spill_recovered = 0

        # per-shard LSM cascade (same auto-engage rule and schedule as the
        # single-chip store, core/counter.py + core/lsm.py): batch-flush
        # merges land in a small L0 per shard and cascade geometrically,
        # so long streams at cap_per_shard >> one flush stop paying the
        # O(cap_per_shard) re-sort per flush.  The cascade counter is
        # host-side deterministic integer math, identical on every process,
        # so each level is just another shard_map'd store state.
        self.lsm = False
        if self.backend == "sort":
            flush_rows = self.merge_every * n_shards * self.route_cap
            auto_lsm = (
                cap_per_shard * (lsm_growth - 1)
                > lsm_growth ** 2 * flush_rows
            )
            use_lsm = auto_lsm if lsm is None else lsm
            if use_lsm and cap_per_shard > flush_rows * lsm_growth:
                base_cap = -(-flush_rows // align) * align
                caps = [base_cap]
                while caps[-1] * lsm_growth < cap_per_shard:
                    caps.append(caps[-1] * lsm_growth)
                caps.append(cap_per_shard)
                self.lsm = True
                self.lsm_growth = int(lsm_growth)
                self._lsm_stores = [
                    CountStore(self.spec, c) for c in caps
                ]  # _backend_obj stays the TOP store (the read side);
                # merges target _lsm_stores[0]
                self._lsm_fill = max(1, base_cap // flush_rows)
                self._lsm_flushes = 0

        # homopolymer run-length collapse at ingest (io/packer.py); the
        # elided window counts are applied at READ time from the GLOBAL
        # (cross-process-summed) ingest stats — see core/counter.py's
        # read-time bonus notes; no device injection, no per-host routing
        self.collapse_hp = collapse_homopolymers
        self._mix_full_sort = False  # set after a detected prefix collision
        self._build_programs()
        self.state = self._init_state()
        self._carry = self._init_carry()
        self.packer = ReadPacker(self.batch, n_policy=n_policy, seed=seed,
                                 collapse=self.collapse_hp)
        self._pending: list[PackedBatch] = []
        self._pending_recv: list[tuple] = []
        self._spills: list = []
        self.batches_processed = 0
        self.elapsed = 0.0

    def _build_programs(self) -> None:
        self._step = (
            jax.jit(self._make_step(), donate_argnums=(1, 2, 3))
            if self._carry_enabled else jax.jit(self._make_step())
        )
        self._recover = None  # lazily built: only ever runs after a spill
        self._merge = jax.jit(self._make_merge(), donate_argnums=(0,))
        self._lookup = jax.jit(self._make_lookup())
        canonical, spec, route_map = self.canonical, self.spec, self.route_map
        hashed_store = self.hashed_store
        self._prep_queries = jax.jit(
            lambda q: (
                route_map.apply(canonicalize(q, spec) if canonical else q)
                if hashed_store
                else (canonicalize(q, spec) if canonical else q)
            )
        )
        if self.lsm:
            self._absorbs = [
                jax.jit(self._make_absorb(i), donate_argnums=(0,))
                for i in range(len(self._lsm_stores) - 1)
            ]

    def _make_absorb(self, i: int):
        """shard_map'd CountStore.absorb of level i into level i+1."""
        upper = self._lsm_stores[i + 1]

        def local_absorb(top, lower):
            new = upper.absorb(
                _unwrap_scalars(top), _unwrap_scalars(lower)
            )
            return _wrap_scalars(new)

        specs = _state_specs(self._state_cls)
        return shard_map(
            local_absorb,
            mesh=self.mesh,
            in_specs=(specs, specs),
            out_specs=specs,
        )

    def _adapt_read_len(self, read_lens) -> None:
        """One-shot interval-budget auto-sizing (see KmerCounter's twin)."""
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
        self.packer = ReadPacker(
            self.batch, n_policy=self.n_policy, seed=self.seed,
            collapse=self.collapse_hp,
        )
        self.packer.stats = stats
        self._step = (
            jax.jit(self._make_step(), donate_argnums=(1, 2, 3))
            if self._carry_enabled else jax.jit(self._make_step())
        )

    # --- sharded state ---

    @property
    def _state_cls(self):
        from tsxcount_tpu.core.table import TableState

        return TableState if self.backend == "table" else StoreState

    def _init_level(self, store):
        init = shard_map(
            lambda: _wrap_scalars(store.init_state()),
            mesh=self.mesh,
            in_specs=(),
            out_specs=_state_specs(self._state_cls),
        )
        # scalars become per-shard vectors of length n_shards
        return jax.jit(init)()

    def _init_state(self):
        if self.lsm:
            return [self._init_level(s) for s in self._lsm_stores]
        return self._init_level(self._backend_obj)

    def _init_carry(self):
        """Zeroed spill-carry buffers (keys, counts, lens) per (src, dst)
        pair, sharded over sources.  None when spill is impossible."""
        if not self._carry_enabled:
            return None
        n, lanes = self.n_shards, self.spec.lanes
        sc_buf = 2 * self.route_cap
        init = shard_map(
            lambda: (
                jnp.zeros((n, sc_buf, lanes), jnp.uint32),
                jnp.zeros((n, sc_buf), jnp.int32),
                jnp.zeros((n,), jnp.int32),
            ),
            mesh=self.mesh,
            in_specs=(),
            out_specs=(P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS)),
        )
        return jax.jit(init)()

    def _make_recover(self):
        """Follow-up routing step for the spill carry (VERDICT r4 #6):
        exchange the per-(src,dst) carry chunks exactly like the sends,
        re-dedupe the received rows (tails from different batches are
        sorted per batch but not across them), and fold them into the
        shard stores.  Compiled lazily — only a run that actually
        spilled ever pays for it."""
        n_shards = self.n_shards
        spec = self.spec
        lanes = spec.lanes
        backend = self.backend
        backend_obj = self._backend_obj
        sc_buf = 2 * self.route_cap

        def local_recover(state, ck, cc, cl):
            recv_k = jax.lax.all_to_all(ck, SHARD_AXIS, 0, 0, tiled=False)
            recv_c = jax.lax.all_to_all(cc, SHARD_AXIS, 0, 0, tiled=False)
            recv_l = jax.lax.all_to_all(
                cl.reshape(n_shards, 1), SHARD_AXIS, 0, 0, tiled=False
            ).reshape(n_shards)
            valid = (
                jnp.arange(sc_buf, dtype=jnp.int32)[None, :]
                < recv_l[:, None]
            )
            uc = count_unique(
                recv_k.reshape(-1, lanes), valid.reshape(-1),
                weights=recv_c.reshape(-1), spec=spec,
            )
            st = _unwrap_scalars(state)
            if backend == "sort":
                new = backend_obj.merge_stacked(
                    st, uc.keys[None], uc.counts[None], uc.valid[None]
                )
            else:
                new = backend_obj.insert(st, uc.keys, uc.counts, uc.valid)
            return _wrap_scalars(new)

        specs = _state_specs(self._state_cls)

        def recover(state, ck, cc, cl):
            return shard_map(
                local_recover,
                mesh=self.mesh,
                in_specs=(specs, P(SHARD_AXIS), P(SHARD_AXIS),
                          P(SHARD_AXIS)),
                out_specs=specs,
            )(state, ck, cc, cl)

        return recover

    def _recover_spill(self) -> None:
        """Re-route the accumulated spill carry into the stores, then
        reset the carry.  For the LSM cascade the recovered rows merge
        straight into the top level (exact: absorb order is free)."""
        if self._recover is None:
            self._recover = jax.jit(
                self._make_recover(), donate_argnums=(0,)
            )
        if self.lsm:
            self.state[-1] = self._recover(self.state[-1], *self._carry)
        else:
            self.state = self._recover(self.state, *self._carry)
        self._carry = self._init_carry()

    def _make_step(self):
        """The routing step: extract -> hash -> dedupe -> slice -> exchange.

        Stateless: returns this batch's received per-source runs
        (keys [n_shards, cap, lanes], counts [n_shards, cap],
        lens [n_shards]) plus the global routing spill count.  Folding the
        runs into the store is deferred to `_merge` every merge_every
        batches — the same amortization the single-chip path uses.
        """
        batch = self.batch
        spec = self.spec
        n_shards = self.n_shards
        cap = self.route_cap
        route_map = self.route_map
        canonical = self.canonical
        lanes = spec.lanes
        hashed_store = self.hashed_store
        # a detected prefix collision (astronomically rare) switches the
        # recount to the exact full-comparator sort; keys stay hashed
        # (routing and the store layout require it).  The debug identity
        # hash never sorts a "uniform" prefix (its image is the raw key).
        uniform = (
            hashed_store and not self._mix_full_sort
            and not self.hash_fn.identity
        )

        carry_enabled = self._carry_enabled
        sc = cap            # spill rows captured per (dst, batch)
        sc_buf = 2 * cap    # carry buffer rows per (src, dst) pair
        cap_room = sc_buf - sc  # max append offset with an exact write

        def local_step(buf, ck=None, cc=None, cl=None):
            # local slices keep a singleton leading shard axis; drop it.
            # buf = [words | validity intervals] (one H2D buffer per shard)
            buf = buf[0]
            words = buf[: batch.total_words]
            kmers = extract_kmers(words, batch)
            if canonical:
                kmers = canonicalize(kmers, spec)
            # bijective hash BEFORE dedupe: equal kmers <=> equal hashes,
            # and the dedupe sort then doubles as the routing sort (owners
            # are a range partition of the top hash bits).  1-shard raw
            # mode: every row is owned by shard 0, no hash needed.
            hashed = route_map.apply(kmers) if hashed_store else kmers
            valid = intervals_to_valid(buf[batch.total_words :], batch)
            # hashed keys are uniform -> the dedupe sort can run on a
            # 64-bit prefix with the other lanes as payload; collisions
            # are detected and reported (collide_mode="flag": no compiled
            # full-sort fallback doubling peak sort temps) and count_file
            # recounts on host
            uc = count_unique(
                hashed, valid, spec=spec, uniform_prefix=uniform,
                collide_mode="flag",
            )
            p = uc.keys.shape[0]

            owner = owner_of_hash(uc.keys[:, -1], spec, n_shards)
            owner_eff = jnp.where(uc.valid, owner, n_shards)
            starts = _owner_starts(owner_eff, n_shards)
            lens = jnp.diff(starts)
            send_lens = jnp.minimum(lens, cap)

            # contiguous per-destination placement: rows of owner o are
            # exactly [starts[o], starts[o]+lens[o]) of the sorted dedupe
            # output, so each send chunk is ONE dynamic slice — no
            # scatter, no second sort
            pad = cap + (sc if carry_enabled else 0)
            keys_pad = jnp.concatenate(
                [uc.keys, jnp.zeros((pad, lanes), jnp.uint32)], axis=0
            )
            counts_pad = jnp.concatenate(
                [uc.counts, jnp.zeros((pad,), jnp.int32)], axis=0
            )
            send_keys = jnp.stack([
                jax.lax.dynamic_slice_in_dim(keys_pad, starts[o], cap)
                for o in range(n_shards)
            ])
            send_counts = jnp.stack([
                jax.lax.dynamic_slice_in_dim(counts_pad, starts[o], cap)
                for o in range(n_shards)
            ])
            if carry_enabled:
                # append each destination's sorted spill tail
                # [starts[o]+cap, starts[o]+lens[o]) to the local carry at
                # offset cl[o].  An append that would not fit exactly
                # (cl[o] > cap_room, where dynamic_update_slice would
                # clamp and clobber) captures nothing — its rows count as
                # hard spill and finish() raises TableFull, so the
                # clobbered garbage past cap_room is never read.
                hard = jnp.zeros((), jnp.int32)
                for o in range(n_shards):
                    spill_o = jnp.maximum(lens[o] - cap, 0)
                    clobber = cl[o] > cap_room
                    off = jnp.minimum(cl[o], cap_room)
                    captured = jnp.where(
                        clobber, 0, jnp.minimum(spill_o, sc)
                    )
                    hard = hard + (spill_o - captured)
                    chunk_k = jax.lax.dynamic_slice_in_dim(
                        keys_pad, starts[o] + cap, sc
                    )
                    chunk_c = jax.lax.dynamic_slice_in_dim(
                        counts_pad, starts[o] + cap, sc
                    )
                    ck = jax.lax.dynamic_update_slice(
                        ck, chunk_k[None], (o, off, 0)
                    )
                    cc = jax.lax.dynamic_update_slice(
                        cc, chunk_c[None], (o, off)
                    )
                    cl = cl.at[o].set(cl[o] + captured)
                spill = hard
            else:
                spill = jnp.sum(jnp.maximum(lens - cap, 0))

            # exchange: slice j of the result = what shard j sent to me
            recv_keys = jax.lax.all_to_all(
                send_keys, SHARD_AXIS, 0, 0, tiled=False
            )
            recv_counts = jax.lax.all_to_all(
                send_counts, SHARD_AXIS, 0, 0, tiled=False
            )
            recv_lens = jax.lax.all_to_all(
                send_lens.reshape(n_shards, 1), SHARD_AXIS, 0, 0, tiled=False
            ).reshape(n_shards)
            taint = (
                uc.collided if uc.collided is not None
                else jnp.zeros((), jnp.bool_)
            )
            # [hard_spill, collision_taint] in one psum'd health vector
            health = jax.lax.psum(
                jnp.stack([spill, taint.astype(jnp.int32)]), SHARD_AXIS
            )
            if carry_enabled:
                return recv_keys, recv_counts, recv_lens, health, ck, cc, cl
            return recv_keys, recv_counts, recv_lens, health

        if carry_enabled:
            def step(buf_stacked, ck, cc, cl):
                return shard_map(
                    local_step,
                    mesh=self.mesh,
                    in_specs=(P(SHARD_AXIS),) + (P(SHARD_AXIS),) * 3,
                    out_specs=(
                        P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(),
                        P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS),
                    ),
                    )(buf_stacked, ck, cc, cl)
        else:
            def step(buf_stacked):
                return shard_map(
                    local_step,
                    mesh=self.mesh,
                    in_specs=(P(SHARD_AXIS),),
                    out_specs=(
                        P(SHARD_AXIS), P(SHARD_AXIS), P(SHARD_AXIS), P(),
                    ),
                    )(buf_stacked)

        return step

    def _make_merge(self):
        """Fold merge_every batches' received runs into the shard stores.

        Each received run is already deduplicated (per-source dedupe) and
        sorted by hashed key, so the sort backend feeds them straight into
        merge_stacked; the table backend re-dedupes across sources once
        and does a single insert.
        """
        n_shards = self.n_shards
        cap = self.route_cap
        lanes = self.spec.lanes
        spec = self.spec
        r_groups = self.merge_every
        backend = self.backend
        # LSM: batch flushes land in the small L0 store; the cascade to
        # higher levels is driven by _flush_merges
        backend_obj = (
            self._lsm_stores[0] if self.lsm else self._backend_obj
        )

        def local_merge(state, keys_list, counts_list, lens_list):
            keys = jnp.concatenate(keys_list, axis=0)     # [R*n, cap, lanes]
            counts = jnp.concatenate(counts_list, axis=0) # [R*n, cap]
            lens = jnp.concatenate(lens_list, axis=0)     # [R*n]
            valid = (
                jnp.arange(cap, dtype=jnp.int32)[None, :] < lens[:, None]
            )
            st = _unwrap_scalars(state)
            if backend == "sort":
                new_state = backend_obj.merge_stacked(
                    st, keys, counts, valid
                )
            else:
                uc = count_unique(
                    keys.reshape(-1, lanes), valid.reshape(-1),
                    weights=counts.reshape(-1), spec=spec,
                    max_multiplicity=n_shards,
                )
                new_state = backend_obj.insert(
                    st, uc.keys, uc.counts, uc.valid
                )
            return _wrap_scalars(new_state)

        def merge(state, keys_list, counts_list, lens_list):
            return shard_map(
                local_merge,
                mesh=self.mesh,
                in_specs=(
                    _state_specs(self._state_cls),
                    [P(SHARD_AXIS)] * r_groups,
                    [P(SHARD_AXIS)] * r_groups,
                    [P(SHARD_AXIS)] * r_groups,
                ),
                out_specs=_state_specs(self._state_cls),
            )(state, keys_list, counts_list, lens_list)

        return merge

    def _make_lookup(self):
        backend_obj = self._backend_obj

        def local_lookup(state, queries):
            # queries are replicated; mark them shard-varying so the search
            # carries have consistent varying-manual-axes with the
            # shard-local table state
            queries = jax.lax.pcast(queries, (SHARD_AXIS,), to="varying")
            digits, found = backend_obj.lookup(
                _unwrap_scalars(state), queries
            )
            digits = jnp.where(found[:, None], digits, 0)
            # each key lives in exactly one shard -> psum combines results
            return (
                jax.lax.psum(digits, SHARD_AXIS),
                jax.lax.psum(found.astype(jnp.int32), SHARD_AXIS) > 0,
            )

        def lookup(state, queries):
            return shard_map(
                local_lookup,
                mesh=self.mesh,
                in_specs=(_state_specs(self._state_cls), P()),
                out_specs=(P(), P()),
            )(state, queries)

        return lookup

    # --- ingestion (KmerCounter-compatible surface) ---

    @property
    def _local_shards(self) -> int:
        """Shards fed by this process (== n_shards in single-controller)."""
        return max(
            1, self.n_shards // max(1, jax.process_count())
        ) if jax.process_count() > 1 else self.n_shards

    def _to_global(self, stacked: np.ndarray):
        """Host-local (local_shards, ...) batch -> global sharded array.

        Multi-process: every process contributes its slice (SPMD, one
        global array); single process: plain device put.
        """
        if jax.process_count() == 1:
            return jnp.asarray(stacked)
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as PS

        return jax.make_array_from_process_local_data(
            NamedSharding(self.mesh, PS(SHARD_AXIS)), stacked
        )

    def _put_group(self, group: list[PackedBatch]):
        """Stack one group of per-shard host batches and start its H2D
        transfer (runs on the prefetch producer thread).  One batch per
        group (shards=1): reshape in place, no host copy."""
        if len(group) == 1:
            return self._to_global(group[0].buf[None, :])
        return self._to_global(np.stack([g.buf for g in group]))

    def _step_buf(self, buf) -> None:
        """Dispatch the routing step for one stacked device buffer and
        defer its received runs for the next merge flush."""
        if self._carry_enabled:
            (recv_keys, recv_counts, recv_lens, spill,
             *self._carry) = self._step(buf, *self._carry)
        else:
            recv_keys, recv_counts, recv_lens, spill = self._step(buf)
        self._pending_recv.append((recv_keys, recv_counts, recv_lens))
        self._spills.append(spill)
        self.batches_processed += self.n_shards
        self._maybe_progress(getattr(self, "_live_stats_fn", None))
        if len(self._pending_recv) >= self.merge_every:
            self._flush_merges()

    def _flush_merges(self, force: bool = False) -> None:
        if not self._pending_recv:
            return
        pend = self._pending_recv
        if len(pend) < self.merge_every:
            if not force:
                return
            # pad to the compiled group size with empty runs: zeroing the
            # lens invalidates every row, the key/count payloads are inert
            filler = pend[-1]
            pend = pend + [
                (filler[0], filler[1], jnp.zeros_like(filler[2]))
            ] * (self.merge_every - len(pend))
        self._pending_recv = []
        if self.lsm:
            # merge into L0, then cascade full levels upward (the same
            # deterministic host-side schedule as core/lsm.py
            # merge_stacked: level i absorbs into i+1 every
            # fill * growth^i flushes)
            self.state[0] = self._merge(
                self.state[0],
                [p[0] for p in pend],
                [p[1] for p in pend],
                [p[2] for p in pend],
            )
            self._lsm_flushes += 1
            period = self._lsm_fill
            for i in range(len(self._lsm_stores) - 1):
                if self._lsm_flushes % period == 0:
                    self.state[i + 1] = self._absorbs[i](
                        self.state[i + 1], self.state[i]
                    )
                    self.state[i] = self._init_level(self._lsm_stores[i])
                else:
                    break
                period *= self.lsm_growth
        else:
            self.state = self._merge(
                self.state,
                [p[0] for p in pend],
                [p[1] for p in pend],
                [p[2] for p in pend],
            )

    def _dispatch_pending(self, force: bool = False) -> None:
        if not self._pending:
            return
        n_local = self._local_shards
        if len(self._pending) < n_local and not force:
            return
        t0 = time.perf_counter()
        while self._pending:
            group = self._pending[:n_local]
            self._pending = self._pending[n_local:]
            if len(group) < n_local and not force:
                self._pending = group
                break
            while len(group) < n_local:
                group.append(PackedBatch.empty(self.batch))
            self._step_buf(self._put_group(group))
        self.elapsed += time.perf_counter() - t0

    def add_reads(self, reads: Iterable[str | bytes]) -> None:
        reads = iter(reads)
        if self._auto_hint:
            import itertools

            from tsxcount_tpu.core.counter import _HINT_SAMPLE

            sample = list(itertools.islice(reads, _HINT_SAMPLE))
            self._adapt_read_len(len(s) for s in sample)
            reads = itertools.chain(sample, reads)
        for seq in reads:
            for pb in self.packer.feed(seq):
                self._pending.append(pb)
                self._dispatch_pending()

    def reset(self) -> None:
        """Clear all counts/ingest stats but keep the compiled device
        programs (fresh-store warm benches and reuse without re-jitting)."""
        self.state = self._init_state()
        self._carry = self._init_carry()
        self._spill_recovered = 0
        if self.lsm:
            self._lsm_flushes = 0
        self.packer = ReadPacker(
            self.batch, n_policy=self.n_policy, seed=self.seed,
            collapse=self.collapse_hp,
        )
        self._pending = []
        self._pending_recv = []
        self._spills = []
        self.batches_processed = 0
        self.elapsed = 0.0

    def flush(self) -> None:
        """Drain all pending host batches, deferred merges, AND any spill
        carry into device state (used before checkpointing; finish() adds
        the capacity checks on top).  The carry check costs one device
        round trip — only when spill is possible at all, and flush() runs
        once per file, not per batch."""
        self._pending.extend(self.packer.finish())
        self._dispatch_pending(force=True)
        self._flush_merges(force=True)
        if self._carry_enabled:
            if jax.process_count() == 1:
                carry_n = int(jax.device_get(jnp.sum(self._carry[2])))
            else:
                carry_n = int(np.sum(self._gather(self._carry[2])))
            if carry_n:
                self._recover_spill()
                self._spill_recovered += carry_n

    def _collapse_lsm(self) -> None:
        """Absorb every LSM level into the top level (reads/exports see
        one authoritative store; exact, like core/lsm.py collapse)."""
        if not self.lsm:
            return
        for i in range(len(self._lsm_stores) - 1):
            self.state[i + 1] = self._absorbs[i](
                self.state[i + 1], self.state[i]
            )
            self.state[i] = self._init_level(self._lsm_stores[i])
        self._lsm_flushes = 0

    @property
    def _read_state(self):
        """The authoritative store state for reads (top LSM level after
        _collapse_lsm, or the flat state)."""
        return self.state[-1] if self.lsm else self.state

    def _check_spill(self) -> None:
        if not self._spills:
            return
        # ONE device round trip for all pending [spill, taint] health
        # vectors instead of a host sync per batch
        vec = np.asarray(
            jax.device_get(jnp.concatenate(self._spills))
        ).reshape(-1, 2)
        self._spills = []
        self._raise_health(int(vec[:, 0].sum()), bool(vec[:, 1].any()))

    def _raise_health(self, spill: int, tainted: bool) -> None:
        if spill:
            raise TableFull(
                f"{spill} routed kmers overflowed both the "
                f"per-destination capacity {self.route_cap} and the "
                f"spill carry; increase capacity_factor"
            )
        if tainted:
            raise PrefixCollision(PrefixCollision.__doc__)


    def _global_stats(self) -> "PackStats":
        """Ingest stats summed across processes (multi-host: each host
        packed only its input share; counts/exports/totals must reflect
        the GLOBAL stream).  Collective — every process must call it at
        the same point, which the SPMD read paths do."""
        st = self.packer.stats
        if jax.process_count() == 1:
            return st
        from jax.experimental import multihost_utils

        from tsxcount_tpu.io.packer import PackStats

        vec = np.asarray(
            [st.reads, st.reads_skipped, st.bases, st.n_bases, st.windows,
             st.batches, *st.hp_bonus, st.hp_collapsed_bases,
             st.packed_words],
            np.int64,
        )
        tot = np.asarray(
            multihost_utils.process_allgather(vec)
        ).reshape(-1, vec.size).sum(axis=0)
        return PackStats(
            reads=int(tot[0]), reads_skipped=int(tot[1]), bases=int(tot[2]),
            n_bases=int(tot[3]), windows=int(tot[4]), batches=int(tot[5]),
            hp_bonus=tuple(int(x) for x in tot[6:10]),
            hp_collapsed_bases=int(tot[10]),
            packed_words=int(tot[11]),
        )

    # read-time homopolymer bonus (HpBonusMixin): derived from the GLOBAL
    # ingest stats, so multi-host counting stays exact by summation instead
    # of per-host device injection
    _hp_stats = _global_stats

    def finish(self) -> None:
        self.flush()
        if jax.process_count() == 1:
            # fuse every health check into ONE device round trip: stack
            # the pending routing-spill counters and the backend capacity
            # flags on device, fetch once
            if self.backend == "table":
                flags = [jnp.sum(self.state.spilled)[None]]
            else:
                levels = self.state if self.lsm else [self.state]
                flags = [
                    jnp.max(st.overflowed.astype(jnp.int32))[None]
                    for st in levels
                ]
            spills = self._spills
            self._spills = []
            vec = np.asarray(jax.device_get(
                jnp.concatenate(spills + flags)
            ))
            ns = 2 * len(spills)
            sp = vec[:ns].reshape(-1, 2)
            bad = bool(vec[ns:].any())
            if bad:
                raise TableFull(
                    f"{'unresolved reprobes' if self.backend == 'table' else 'capacity overflow'}"
                    f" in a table shard; rerun with larger --l"
                )
            self._raise_health(
                int(sp[:, 0].sum()) if ns else 0,
                bool(sp[:, 1].any()) if ns else False,
            )
            return
        jax.block_until_ready(self.state)
        self._check_spill()
        if self.backend == "table":
            spilled = int(np.sum(self._gather(self.state.spilled)))
            if spilled:
                raise TableFull(
                    f"{spilled} kmers unresolved after "
                    f"{self.table.max_reprobes} reprobes in a table shard; "
                    f"increase --l"
                )
        else:
            levels = self.state if self.lsm else [self.state]
            if any(
                bool(np.any(self._gather(st.overflowed))) for st in levels
            ):
                raise TableFull(
                    f"a table shard exceeded capacity "
                    f"2^{self.l}/{self.n_shards}; rerun with larger --l"
                )

    def count_file(self, path: str | Path,
                   use_native: bool | None = None) -> None:
        """Count a FASTQ/FASTA(.gz) file over the mesh.

        Uses the native C++ parser + prefetch pipeline when available
        (threads > 1 byte-range-splits uncompressed input), exactly like
        the single-chip path (core/counter.py count_file).  A detected
        dedupe-prefix collision triggers an exact full-comparator recount
        when the counter held no earlier data (see KmerCounter.count_file).
        """
        fresh = (
            self.batches_processed == 0 and self.packer.stats.reads == 0
        )
        try:
            self._count_file_impl(path, use_native)
        except PrefixCollision:
            if not fresh or jax.process_count() > 1:
                # multi-host retry would need every process to agree to
                # recount; surface instead (probability ~P^2/2^65 per
                # batch — about 1 in 4e5 batches at the default size,
                # matching core/counter.py PrefixCollision)
                raise
            import sys

            print(
                "tsxcount: dedupe-prefix collision detected; recounting "
                "with the full-comparator sort (exact)", file=sys.stderr,
            )
            self._mix_full_sort = True
            self.reset()
            self._build_programs()
            self._count_file_impl(path, use_native)

    def _count_file_impl(self, path: str | Path,
                         use_native: bool | None = None) -> None:
        from tsxcount_tpu.io.native import NativeFileReader, native_available
        from tsxcount_tpu.io.pipeline import prefetch

        if self._auto_hint:
            from tsxcount_tpu.core.counter import _peek_read_lens

            self._adapt_read_len(_peek_read_lens(path))
        if use_native is None:
            use_native = native_available()
        if use_native:
            reader = NativeFileReader(
                path, self.batch, n_policy=self.n_policy, seed=self.seed,
                threads=self.threads, collapse=self.collapse_hp,
            )
            t0 = time.perf_counter()
            self._live_stats_fn = reader.live_stats
            groups = _grouped(iter(reader), self._local_shards, self.batch)
            try:
                for buf in prefetch(
                    groups, self._put_group, depth=self.prefetch_depth
                ):
                    self._step_buf(buf)
            finally:
                self._live_stats_fn = None
            self.elapsed += time.perf_counter() - t0
            from tsxcount_tpu.io.packer import add_stats

            self.packer.stats = add_stats(self.packer.stats, reader.stats)
            self.finish()
        else:
            self.add_reads(rec.seq for rec in read_fastx(path))
            self.finish()

    # --- queries / export ---

    def _gather(self, arr) -> np.ndarray:
        """Fetch a shard-partitioned state array on every process.

        Single-process: plain device_get.  Multi-process: concatenate the
        addressable shards and allgather across processes (shard order is
        process-major, matching make_shard_mesh's jax.devices() order).
        """
        if jax.process_count() == 1:
            return np.asarray(jax.device_get(arr))
        from jax.experimental import multihost_utils

        local = np.concatenate(
            [np.asarray(sh.data) for sh in arr.addressable_shards], axis=0
        )
        gathered = np.asarray(multihost_utils.process_allgather(local))
        return gathered.reshape(arr.shape)

    @property
    def distinct(self) -> int:
        self._flush_merges(force=True)
        self._collapse_lsm()
        return int(np.sum(self._gather(self._read_state.n)))

    @property
    def total_kmers(self) -> int:
        st = self._global_stats()
        return st.windows + sum(st.hp_bonus)

    @property
    def stored_total(self) -> int:
        """Sum of every count held on the devices, over all shards (see
        KmerCounter.stored_total)."""
        self._flush_merges(force=True)
        self._collapse_lsm()
        if self.backend == "sort":
            return self.store.total(self._read_state)
        table, n = self.table, self.n_shards
        slots = self.state.slots.reshape(n, table.slot_cols, table.slots)
        lanes = self.spec.lanes
        return digit_sums_to_int(jax.device_get(digit_column_sums([
            slots[:, lanes + j].reshape(-1) for j in range(COUNT_DIGITS)
        ])))

    def get_counts(self, kmers: list[str]) -> list[int]:
        if not kmers:
            return []
        self._flush_merges(force=True)
        self._collapse_lsm()
        keys = strings_to_kmers(kmers, self.spec)
        out: list[int] = []
        n = len(kmers)
        for off in range(0, n, _QUERY_BATCH):
            chunk = keys[off : off + _QUERY_BATCH]
            pad = _QUERY_BATCH - len(chunk)
            if pad:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0
                )
            hashed = self._prep_queries(jnp.asarray(chunk))
            digits, found = self._lookup(self._read_state, hashed)
            digits = np.asarray(jax.device_get(digits))
            found = np.asarray(jax.device_get(found))
            m = min(_QUERY_BATCH, n - off)
            for i in range(m):
                out.append(counts_to_int(*digits[i]) if found[i] else 0)
        owed = self._hp_owed_query()
        if owed:
            out = [c + owed.get(s, 0) for s, c in zip(kmers, out)]
        return out

    def _shard_rows(self, arr, shard: int, rows: int) -> np.ndarray:
        """Host copy of the first `rows` rows of one shard's slice of a
        shard-partitioned state array.  Single-process: an eager device
        slice (only those rows ever reach the host — the export stays
        O(shard), not O(global table), at 2^26+ capacities).  Multi-process:
        falls back to the cross-process gather."""
        per = arr.shape[0] // self.n_shards
        if jax.process_count() == 1:
            off = shard * per
            for sh in arr.addressable_shards:
                if (sh.index[0].start or 0) == off and sh.data.shape[0] == per:
                    return np.asarray(sh.data[:rows])
        return self._gather(arr).reshape(
            (self.n_shards, per) + arr.shape[1:]
        )[shard, :rows]

    def items(self):
        """Stream (kmer string, count), one shard at a time (bounded host
        memory: a shard's used prefix, not the global table, is resident)."""
        self._flush_merges(force=True)
        self._collapse_lsm()
        owed = self._hp_owed_emit()
        if self.backend == "table":
            src = self._items_table()
        else:
            src = self._items_sort()
        for kmer_str, cnt in src:
            yield kmer_str, cnt + (owed.pop(kmer_str, 0) if owed else 0)
        for kmer_str, cnt in sorted(owed.items()):
            if cnt:  # owed keys the store never saw (see HpBonusMixin)
                yield kmer_str, cnt

    def _items_sort(self):
        state = self._read_state
        ns = self._gather(state.n)
        for shard in range(self.n_shards):
            n = int(ns[shard])
            if n == 0:
                continue
            # stores hold hashed keys; export inverse-maps them
            keys = self._shard_rows(state.keys, shard, n)
            digits = self._shard_rows(state.digits, shard, n)
            kmers = (
                self.route_map.inv_apply_host(keys)
                if self.hashed_store else keys
            )
            strings = kmers_to_strings(kmers, self.spec)
            for i, kmer_str in enumerate(strings):
                yield kmer_str, counts_to_int(*digits[i])

    def _items_table(self):
        """Per-shard inverse-hash reconstruction (getAllKmers analog) —
        one shard's slots resident at a time (see _shard_rows)."""
        from tsxcount_tpu.core.table import TableState

        slot_elems = self.table.slots * self.table.slot_cols
        ns = self._gather(self.state.n)
        spills = self._gather(self.state.spilled)
        for shard in range(self.n_shards):
            shard_state = TableState(
                slots=jnp.asarray(
                    self._shard_rows(self.state.slots, shard, slot_elems)
                ),
                n=jnp.asarray(ns[shard]),
                spilled=jnp.asarray(spills[shard]),
                probe_hist=jnp.asarray(
                    self._shard_rows(
                        self.state.probe_hist, shard,
                        self.state.probe_hist.shape[0] // self.n_shards,
                    )
                ),
            )
            # the shard table runs an identity mapping over pre-hashed keys:
            # to_host returns hashed kmers, inverse-map them here
            hashed, counts, n = self.table.to_host(shard_state)
            kmers = self.route_map.inv_apply_host(hashed) if n else hashed
            strings = kmers_to_strings(kmers, self.spec)
            for kmer_str, cnt in zip(strings, counts):
                yield kmer_str, int(cnt)

    def to_dict(self) -> dict[str, int]:
        return dict(self.items())

    def check(self, golden_path: str | Path, abort: bool = False,
              max_report: int = 20):
        from tsxcount_tpu.core.counter import CheckAbort, CheckResult

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
        res.extra_distinct = max(0, self.distinct - len(golden))
        return res

    def stats(self) -> dict:
        st = dataclasses.asdict(self._global_stats())
        self._flush_merges(force=True)
        self._collapse_lsm()
        ns = self._gather(self._read_state.n)
        st.update(
            backend=self.backend,
            k=self.spec.k,
            l=self.l,
            lanes=self.spec.lanes,
            n_shards=self.n_shards,
            distinct_kmers=self.distinct,
            total_kmers=self.total_kmers,
            batches=self.batches_processed,
            device_seconds=round(self.elapsed, 4),
            shard_distinct=[int(x) for x in ns],
            shard_imbalance=(
                round(float(ns.max()) / max(1.0, float(ns.mean())), 4)
                if ns.size else 1.0
            ),
            spill_recovered=self._spill_recovered,
        )
        return st

    def print_stats(self) -> None:
        for key, val in self.stats().items():
            print(f"{key}: {val}")
