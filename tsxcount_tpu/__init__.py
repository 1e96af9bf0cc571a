"""tsxcount_tpu — an exact k-mer counting framework for accelerators.

A from-scratch re-design of the capabilities of mjoppich/tsxCount (a C++14
shared-memory k-mer counter built around a jellyfish-style bit-packed hash
table with TSX/CAS/OMP/pthread serialization variants) in JAX/XLA, run on
an NVIDIA GPU.

Design stance (see SURVEY.md §7): the reference spends most of its code making
concurrent read-modify-write of bit-packed slots safe
(reference src/tsxcount/TSXHashMap*.h).  Here that entire
serialization layer is gone: k-mer occurrences are counted with
owner-computed, conflict-free primitives — on-device lexicographic sort +
segmented sum, or a deterministic multi-round claim/scatter quotient table —
and scaled across devices by hash-prefix all-to-all routing over a
`jax.sharding.Mesh`.

Public surface:
    KmerSpec                  — k-mer geometry (lanes, masks)
    KmerCounter               — end-to-end streaming counter (file -> counts)
    CountStore                — sorted-unique device count table (sort backend)
    QuotientTable             — jellyfish-style reprobing table (table backend)
    GF2Hash                   — bijective GF(2) matrix hash (apply / inverse)
    read_golden / write_golden — `kmer\tcount` TSV IO (reference .count format)
"""

from tsxcount_tpu.config import KmerSpec
from tsxcount_tpu.utils.sequence import (
    encode_bases,
    decode_bases,
    kmer_to_string,
    string_to_kmer,
)
from tsxcount_tpu.utils.goldenfile import read_golden, write_golden
from tsxcount_tpu.ops.gf2 import GF2Hash
from tsxcount_tpu.core.store import CountStore
from tsxcount_tpu.core.table import QuotientTable
from tsxcount_tpu.core.counter import KmerCounter

__version__ = "0.1.0"

__all__ = [
    "KmerSpec",
    "KmerCounter",
    "CountStore",
    "QuotientTable",
    "GF2Hash",
    "encode_bases",
    "decode_bases",
    "kmer_to_string",
    "string_to_kmer",
    "read_golden",
    "write_golden",
]
