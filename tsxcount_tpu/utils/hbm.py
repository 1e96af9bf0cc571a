"""Analytic device-memory footprint model + preflight check.

A per-(k, l, batch, backend, options) estimate of peak device bytes —
state arrays + the worst transient of the dedupe sort and store merge —
checked BEFORE compile, so a configuration that cannot fit surfaces as a
clear message instead of a mid-run out-of-memory error.  The reference
protocol records memory for every run (reference
analyses/plot_analyses.py:91-120, via /usr/bin/time max-RSS); the measured
device peak is `memory_stats()["peak_bytes_in_use"]` (chip_smoke.py prints
it per phase).

The model is deliberately coarse and its transient factors are
uncalibrated on the GPU (ROADMAP A7); it is *ordered* correctly (larger k,
l and batches cost more; the compiled collision-fallback branch doubles
the dedupe transient).
"""

from __future__ import annotations

import dataclasses

from tsxcount_tpu.config import COUNT_DIGITS, KmerSpec

# XLA sort working-set multiplier: operands + output copy.  Uncalibrated on
# the GPU; ROADMAP A7.
_SORT_TEMP_FACTOR = 2.5
# merge/compact transient: merged rows + segmented sums + compaction
# output coexist for part of the program.  Uncalibrated; ROADMAP A7.
_MERGE_TEMP_FACTOR = 2.5


@dataclasses.dataclass
class HbmEstimate:
    state_mb: float
    dedupe_peak_mb: float
    merge_peak_mb: float
    ingest_mb: float
    total_mb: float

    def as_dict(self) -> dict:
        return {k: round(v, 1) for k, v in dataclasses.asdict(self).items()}


def _flag_ops(spec: KmerSpec) -> int:
    return spec.lanes if spec.top_lane_bits < 32 else spec.lanes + 1


def estimate_hbm(
    k: int,
    l: int,
    batch_words: int,
    backend: str = "sort",
    merge_every: int = 2,
    lsm: bool = False,
    hash_first: bool | str = False,
    mix_prefix: bool = False,
    collide_mode: str = "flag",
    n_shards: int = 1,
    prefetch_depth: int = 3,
) -> HbmEstimate:
    """Peak device bytes of one counting pipeline, in MB (10^6-ish: MiB).

    n_shards > 1 models ONE shard's device (per-device peak is what OOMs);
    routing receive buffers are included.
    """
    spec = KmerSpec(k)
    lanes = spec.lanes + (2 if mix_prefix else 0)
    positions = batch_words * 16
    cap = (1 << l) // max(1, n_shards)
    row_state = lanes * 4 + COUNT_DIGITS * 4 + 1  # keys + digits + used
    if backend == "table":
        state = (1 << l) // max(1, n_shards) * row_state
        # insert transient: per-round claims sort (pos + idx + payload)
        dedupe = positions * (_flag_ops(spec) + 2) * 4 * _SORT_TEMP_FACTOR
        merge = state  # donated in/out overlap briefly
    else:
        state = cap * row_state
        if lsm:
            state = int(state * 1.2)  # level pyramid adds ~1/growth
        ncols = _flag_ops(spec) + (2 if mix_prefix else 0)
        sort_bytes = positions * ncols * 4
        dedupe = sort_bytes * _SORT_TEMP_FACTOR
        if collide_mode == "cond" and (hash_first or mix_prefix or
                                       n_shards > 1):
            # the compiled full-sort fallback branch coexists with the
            # prefix-sorted result: peak DOUBLES
            dedupe *= 2.0
        if hash_first == "gf2" or hash_first is True:
            # bit-unpacked int8 matmul operands: P x 2k in and out.
            # Only the GF(2) variant pays this; the ARX "mix" bijection
            # (hash_first="mix", the k>=113 auto default) is elementwise
            # work with no unpacked operands.  A bare
            # True is treated as gf2 — conservative for unknown callers.
            dedupe += positions * (2 * k) * 2
        # pending batch histograms awaiting the deferred merge
        pend_rows = merge_every * positions * max(1, n_shards)
        pending = pend_rows * (lanes * 4 + 4 + 1)
        merge_rows = cap + pend_rows
        merge = (
            merge_rows * (ncols + 2) * 4 * _MERGE_TEMP_FACTOR
            + state  # the un-donated previous state during the merge
            + pending
        )
    buf_bytes = (batch_words + 2 * max(64, positions // 384)) * 4
    ingest = buf_bytes * (prefetch_depth + 1) * max(1, n_shards)
    if n_shards > 1:
        # per-(src,dst) routing capacity ~ positions/n_shards * 1.5,
        # received as n_shards runs + kept for merge_every batches
        route_rows = int(1.5 * positions)
        ingest += merge_every * route_rows * (lanes * 4 + 4)
    # dedupe of batch i+1 and the deferred merge of batches i-R..i overlap
    # through async dispatch, so their transients SUM at the peak
    total = state + dedupe + merge + ingest
    mb = 1 / 2**20
    return HbmEstimate(
        state_mb=state * mb,
        dedupe_peak_mb=dedupe * mb,
        merge_peak_mb=merge * mb,
        ingest_mb=ingest * mb,
        total_mb=total * mb,
    )


def device_hbm_capacity_mb() -> float | None:
    """Memory JAX may use on device 0, or None when the backend does not
    report it (no size is assumed)."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return stats["bytes_limit"] / 2**20


def preflight_check(est: HbmEstimate, capacity_mb: float | None = None,
                    headroom: float = 0.9) -> str | None:
    """Returns a message when the estimate exceeds `headroom` of device
    capacity, or when the check was skipped because the device hides its
    memory size; None when the estimate fits.  Callers print it and let
    the user decide (the model is an estimate, not an allocator)."""
    cap = capacity_mb if capacity_mb is not None else device_hbm_capacity_mb()
    if cap is None:
        return (
            "device memory preflight skipped: the device does not report "
            f"its memory size (estimate {est.total_mb/1024:.1f} GB)"
        )
    if est.total_mb > headroom * cap:
        return (
            f"estimated device footprint {est.total_mb/1024:.1f} GB "
            f"exceeds {headroom:.0%} of device memory ({cap/1024:.2f} GB): "
            f"expect an out-of-memory error — reduce --l or --batch-words "
            f"(state {est.state_mb/1024:.1f} G, sort peak "
            f"{est.dedupe_peak_mb/1024:.1f} G, merge peak "
            f"{est.merge_peak_mb/1024:.1f} G)"
        )
    return None
