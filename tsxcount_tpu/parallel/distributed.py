"""Multi-host counting: jax.distributed + per-host input striping.

The reference is single-node shared-memory only (SURVEY.md §2.3); this module
is the "beyond the reference" scale-out path.  Design:

  * one SPMD program: `jax.distributed.initialize` then the same
    ShardedKmerCounter step over a mesh spanning every process's devices,
    with XLA routing the all_to_all between them;
  * input splits by *byte offset*: each host opens only its 1/N byte range
    of the (shared) file and the native parser resyncs to a record boundary
    (FASTQ 4-line discipline, see _native/fastxpack.cpp fxp_open_range) —
    total parse work is O(file)/host, the chunked-reader analog of the
    reference's streaming FASTXreader (src/mains/main.cpp:132-218);
  * gzip input (not seekable) and the no-native fallback stripe by *record
    index* instead: each host parses everything but packs only records
    where (index // stride) % n_hosts == host_id — N× parse work, exact
    semantics, works on any stream;
  * per-host packed batches become the host's slice of the global batch
    array via jax.make_array_from_process_local_data.

On a single process this degenerates to ShardedKmerCounter exactly.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator

import jax

from tsxcount_tpu.io.fastx import SeqRecord, read_fastx


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize jax.distributed (no-op if already initialized or if no
    coordinator is configured).  Returns (process_id, process_count)."""
    if coordinator_address is not None:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index(), jax.process_count()


def striped_records(path: str | Path, host_id: int, n_hosts: int,
                    stride: int = 64) -> Iterator[SeqRecord]:
    """Yield only this host's stripe of records (index//stride mod n_hosts).

    Contiguous stripes of `stride` records keep per-host batches dense while
    balancing read-length variance across hosts.
    """
    for i, rec in enumerate(read_fastx(path)):
        if (i // stride) % n_hosts == host_id:
            yield rec


def host_input_mode(path: str | Path) -> str:
    """'range' (byte-offset split, O(file)/host parse) when the native
    reader can seek this file, else 'stripe' (record striping)."""
    from tsxcount_tpu.io.native import is_gzip, native_available

    return "range" if native_available() and not is_gzip(path) else "stripe"


def count_file_distributed(counter, path: str | Path,
                           stride: int = 64,
                           round_groups: int = 4) -> str:
    """Feed a ShardedKmerCounter its host-local share of `path`, STREAMING.

    SPMD discipline: every process must dispatch the SAME number of global
    steps (each step contains collectives), but per-host shares pack into
    different batch counts.  Rather than materializing the whole file in
    host RAM to pre-agree one count (the r3 design — O(file/4) resident,
    zero overlap, VERDICT r3 #5), ingest proceeds in bounded ROUNDS:

      * a producer thread parses + packs ahead (the same bounded prefetch
        pipeline the single-host path uses), at most `round_groups` device
        groups queued;
      * each round, every host takes up to `round_groups` groups, the
        round's global maximum is agreed by one small host allgather, and
        shorter hosts pad with empty groups — so all processes dispatch
        identical step counts while at most ~2*round_groups groups are
        ever resident per host;
      * rounds repeat until every host reports empty (exhausted hosts
        keep joining the allgather with 0 — same collective count
        everywhere).

    The reference streams everywhere (src/mains/main.cpp:132-218,
    FastXReader.h:307-385); this is its multi-host analog.  With
    process_count == 1 this degenerates to bounded single-host streaming.
    Returns the input mode used ('range'/'stripe').
    """
    import itertools
    import time

    import numpy as np

    from tsxcount_tpu.io.packer import PackedBatch, add_stats
    from tsxcount_tpu.io.pipeline import prefetch
    from tsxcount_tpu.parallel.sharded import _grouped

    host, n_hosts = jax.process_index(), jax.process_count()
    mode = host_input_mode(path)
    # interval-budget auto-sizing (identical on every host: same file head
    # -> same hint -> same compiled shapes); r3 never ran it on this path
    if getattr(counter, "_auto_hint", False):
        from tsxcount_tpu.core.counter import _peek_read_lens

        counter._adapt_read_len(_peek_read_lens(path))
    reader = None
    if mode == "range":
        from tsxcount_tpu.io.native import NativeFileReader, split_ranges

        start, end = split_ranges(path, n_hosts)[host]
        reader = NativeFileReader(
            path, counter.batch, n_policy=counter.n_policy,
            seed=counter.seed, threads=counter.threads,
            byte_start=start, byte_end=end,
            collapse=counter.collapse_hp,
        )
        batch_iter = iter(reader)
    else:
        def _striped_batches():
            for rec in striped_records(path, host, n_hosts, stride):
                yield from counter.packer.feed(rec.seq)
            yield from counter.packer.finish()

        batch_iter = _striped_batches()

    groups = _grouped(batch_iter, counter._local_shards, counter.batch)
    # parse/pack runs ahead on the producer thread, bounded backpressure
    ready = prefetch(groups, lambda g: g, depth=round_groups)
    rounds = 0
    t0 = time.perf_counter()
    while True:
        chunk = list(itertools.islice(ready, round_groups))
        have = len(chunk)
        if n_hosts > 1:
            from jax.experimental import multihost_utils

            counts = np.asarray(multihost_utils.process_allgather(
                np.asarray([have], np.int64)
            )).reshape(-1)
            target = int(counts.max())
        else:
            target = have
        if target == 0:
            break
        rounds += 1
        while len(chunk) < target:
            chunk.append(
                [PackedBatch.empty(counter.batch)] * counter._local_shards
            )
        for g in chunk:
            counter._step_buf(counter._put_group(g))
    counter.elapsed += time.perf_counter() - t0
    counter._stream_rounds = rounds  # observability (tests assert > 1)
    if reader is not None:
        # host-local ingest stats, accumulated; globals (total_kmers,
        # stats(), hp bonus) come from the counter's cross-process sum
        counter.packer.stats = add_stats(counter.packer.stats, reader.stats)
    counter.finish()
    return mode
