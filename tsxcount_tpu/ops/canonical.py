"""Canonical k-mer normalization: min(kmer, reverse_complement(kmer)).

The reference counts strand-specific k-mers only (no canonicalization —
BASELINE.md golden-file semantics).  Real counters usually fold strands;
this is the vectorized version, enabled with --canonical / canonical=True
(off by default to preserve reference parity).

2-bit encoding makes both halves cheap: complement = bitwise NOT (A=00 <->
T=11, C=01 <-> G=10), reverse = 2-bit-group reversal via a mask-shift
network, both pure elementwise ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tsxcount_tpu.config import KmerSpec
from tsxcount_tpu.ops.lanes import keys_less


def _reverse_pairs_u32(x: jax.Array) -> jax.Array:
    """Reverse the 16 2-bit groups within each uint32 lane."""
    m2 = jnp.uint32(0x33333333)
    m4 = jnp.uint32(0x0F0F0F0F)
    m8 = jnp.uint32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def reverse_complement(kmers: jax.Array, spec: KmerSpec) -> jax.Array:
    """(N, lanes) uint32 -> reverse complements, same layout."""
    lanes = spec.lanes
    # complement: ~x flips every 2-bit code to its pair
    comp = ~kmers
    # reverse 2-bit groups within lanes, then reverse lane order:
    # the key now occupies the TOP 2k bits of the lane vector
    rev = _reverse_pairs_u32(comp)[..., ::-1]
    # shift right so it re-occupies the low 2k bits
    shift = lanes * 32 - spec.bits
    if shift:
        lo = rev >> jnp.uint32(shift)
        hi = jnp.concatenate(
            [rev[..., 1:], jnp.zeros((*rev.shape[:-1], 1), rev.dtype)],
            axis=-1,
        )
        rev = lo | ((hi << jnp.uint32(31 - shift)) << jnp.uint32(1))
    if spec.top_lane_bits < 32:
        rev = rev.at[..., lanes - 1].set(
            rev[..., lanes - 1] & jnp.uint32(spec.top_lane_mask)
        )
    return rev


def canonicalize(kmers: jax.Array, spec: KmerSpec) -> jax.Array:
    """Elementwise min(kmer, revcomp) under lexicographic lane order.

    Note: numeric lane order compares the LAST base first (LSB-first
    encoding), yet for a (kmer, revcomp) pair it selects the same element as
    string order: comparing s against rc at string position 0 tests
    code(s[0]) + code(s[k-1]) < 3, and at lane order's first differing
    position tests code(s[k-1]) < 3 - code(s[0]) — the identical condition,
    recursing symmetrically on ties.  So dumps of canonical counts match the
    conventional string-min convention exactly.
    """
    rc = reverse_complement(kmers, spec)
    take_rc = keys_less(rc, kmers)
    return jnp.where(take_rc[..., None], rc, kmers)
