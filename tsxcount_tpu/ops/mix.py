"""Cheap mixing hash — a uniform sort prefix without the GF(2) matmul.

SURVEY §7 hard-part #1, second attack: the k>=31 dedupe sort pays a
`lanes(+1)`-operand lexicographic lax.sort.  A 64-bit uniform prefix
shrinks the comparator to 2-3 columns, but the bijective GF(2) hash that
produces one (ops/gf2.py — the reference's BijectiveKMapping analog) costs
a per-position bit-unpack -> matmul -> bit-pack.

A sort prefix does not need bijectivity — only uniformity.  Equal keys must
agree (any function of the key does), distinct keys should rarely collide,
and collisions are DETECTED exactly (adjacent rows equal in the prefix but
differing in a payload lane) and handled by the caller (ops/count.py
`collide_mode`).  So: a murmur3-style multiply-xor finalizer per lane,
folded across lanes into two uint32 accumulators — pure elementwise ops,
~10 instructions per lane, no matmul, no bit matrix, nothing to invert.

The "extended key" layout this enables: store rows as
[lane_0..lane_{L-1}, mix_lo, mix_hi] (lsb-first, so msb-first sort order is
flag, mix_hi, mix_lo, lanes...).  Lexicographic order on the extended key is
(mix, raw key); equal extended keys <=> equal raw keys (mix is a function of
the key).  The entire sort/merge/store machinery (pack_flag_key,
merge_stacked, the Pallas merge kernels, lookup binary search) then works
UNCHANGED on `lanes+2` columns — only the dedupe sort comparator shrinks to
3 columns (standalone flag + 64 mix bits), with the raw lanes riding as
payload.  Exports just drop the two mix columns; queries recompute the mix —
no inverse mapping needed (unlike the hashed-store design).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tsxcount_tpu.config import WORD_BITS, KmerSpec

MIX_LANES = 2  # extended key = raw lanes + (mix_lo, mix_hi)

# distinct odd multipliers per input lane (splitmix64 / murmur3 family
# constants, truncated to 32 bits; oddness makes each lane injection a
# bijection of uint32 before folding)
_LANE_MULT_A = (
    0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F,
    0x165667B1, 0xD3A2646D, 0xFD7046C5, 0xB55A4F09,
    0xCC9E2D51, 0x1B873593, 0xE6546B65, 0x38495AB5,
    0x7FEB352D, 0x846CA68B, 0x9E3779B9, 0xC2B2AE35,
    0x94D049BB, 0xBF58476D,
)
_LANE_MULT_B = (
    0x2545F491, 0x6C62272F, 0x52DCE729, 0x38EA70B3,
    0x9FB21C65, 0x1D8048FB, 0xA2AA033B, 0x62992FC1,
    0x30BF3847, 0xAD93481B, 0x4BAE4A77, 0x85D068E9,
    0x8EE0D535, 0x16A85F0F, 0x5851F42D, 0x4C957F2D,
    0xF767814F, 0x2127599B,
)


def _fmix(h: jax.Array, m1: int, m2: int) -> jax.Array:
    """murmur3 fmix32 avalanche (uint32)."""
    h = h ^ (h >> jnp.uint32(16))
    h = h * jnp.uint32(m1)
    h = h ^ (h >> jnp.uint32(13))
    h = h * jnp.uint32(m2)
    h = h ^ (h >> jnp.uint32(16))
    return h


def mix_cols(cols: Sequence[jax.Array]) -> tuple[jax.Array, jax.Array]:
    """64-bit mixing hash of per-lane uint32 columns (lsb lane first).

    Returns (mix_lo, mix_hi) uint32 [P] columns.  Deterministic function of
    the key only — equal keys always agree across batches/hosts (required
    for sharded routing).  Elementwise ops only.
    """
    if len(cols) > len(_LANE_MULT_A):
        raise ValueError(f"mix_cols supports up to {len(_LANE_MULT_A)} lanes")
    h1 = jnp.uint32(0x9E3779B9 ^ (len(cols) * 0x85EBCA6B) & 0xFFFFFFFF)
    h2 = jnp.uint32(0xC2B2AE35 ^ (len(cols) * 0x27D4EB2F) & 0xFFFFFFFF)
    for i, c in enumerate(cols):
        c = c.astype(jnp.uint32)
        ka = c * jnp.uint32(_LANE_MULT_A[i])
        ka = ka ^ (ka >> jnp.uint32(15))
        kb = c * jnp.uint32(_LANE_MULT_B[i])
        kb = kb ^ (kb >> jnp.uint32(17))
        h1 = (h1 ^ ka) * jnp.uint32(5) + jnp.uint32(0xE6546B64)
        h2 = (h2 ^ kb) * jnp.uint32(5) + jnp.uint32(0x38495AB5)
    # cross-coupled final avalanche: every input lane influences both words
    h1 = h1 ^ (h2 * jnp.uint32(0x9E3779B1))
    lo = _fmix(h1, 0x85EBCA6B, 0xC2B2AE35)
    hi = _fmix(h2 ^ lo, 0xCC9E2D51, 0x1B873593)
    return lo, hi


def _fmix_np(h: np.ndarray, m1: int, m2: int) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(m1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(m2)
    h = h ^ (h >> np.uint32(16))
    return h


def mix_cols_host(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy mirror of mix_cols over stacked (N, lanes) uint32 keys —
    host-side query preparation and tests (bit-identical to the device)."""
    n, lanes = keys.shape
    with np.errstate(over="ignore"):
        h1 = np.full(n, 0x9E3779B9 ^ ((lanes * 0x85EBCA6B) & 0xFFFFFFFF),
                     np.uint32)
        h2 = np.full(n, 0xC2B2AE35 ^ ((lanes * 0x27D4EB2F) & 0xFFFFFFFF),
                     np.uint32)
        for i in range(lanes):
            c = keys[:, i].astype(np.uint32)
            ka = c * np.uint32(_LANE_MULT_A[i])
            ka = ka ^ (ka >> np.uint32(15))
            kb = c * np.uint32(_LANE_MULT_B[i])
            kb = kb ^ (kb >> np.uint32(17))
            h1 = (h1 ^ ka) * np.uint32(5) + np.uint32(0xE6546B64)
            h2 = (h2 ^ kb) * np.uint32(5) + np.uint32(0x38495AB5)
        h1 = h1 ^ (h2 * np.uint32(0x9E3779B1))
        lo = _fmix_np(h1, 0x85EBCA6B, 0xC2B2AE35)
        hi = _fmix_np(h2 ^ lo, 0xCC9E2D51, 0x1B873593)
    return lo, hi


def extend_keys_host(keys: np.ndarray) -> np.ndarray:
    """(N, lanes) raw keys -> (N, lanes+2) extended keys (numpy)."""
    lo, hi = mix_cols_host(keys)
    return np.concatenate(
        [keys, lo[:, None], hi[:, None]], axis=1
    ).astype(np.uint32)


def extend_cols(cols: Sequence[jax.Array]) -> list[jax.Array]:
    """Raw lane columns -> extended key columns [lanes..., mix_lo, mix_hi]."""
    lo, hi = mix_cols(cols)
    return list(cols) + [lo, hi]


def extend_keys(keys: jax.Array) -> jax.Array:
    """(P, lanes) raw keys -> (P, lanes+2) extended keys."""
    cols = [keys[..., j] for j in range(keys.shape[-1])]
    lo, hi = mix_cols(cols)
    return jnp.concatenate(
        [keys, lo[..., None], hi[..., None]], axis=-1
    )


def strip_mix(keys_ext) -> jax.Array:
    """(N, lanes+2) extended keys -> (N, lanes) raw keys (mix dropped)."""
    return keys_ext[..., :-MIX_LANES]


# --- lane-mix bijection -----------------------------------------------------
#
# The second use of cheap ARX mixing: a BIJECTION of the 2k-bit key space
# (not just a prefix), built as an unbalanced XOR-Feistel over the uint32
# lanes.  This is a drop-in replacement for GF2Hash in the hash-first path:
# stores hold the image, exports invert on host, the dedupe sort compares
# only the top 64 image bits — but "apply" is ~30 elementwise ops per lane
# instead of a per-position bit-unpack -> matmul -> bit-pack.
#
# Bijectivity: XOR-Feistel rounds hi ^= F(lo); lo ^= G(hi); hi ^= F2(lo)
# invert by replaying in reverse order.  The top lane's F output is masked
# to spec.top_lane_mask, so the map permutes exactly the 2k-bit space.
# Single-lane keys use multiply/xorshift rounds mod 2^bits instead.


def _fmix_g(h, xp):
    h = h ^ (h >> xp.uint32(16))
    h = h * xp.uint32(0x85EBCA6B)
    h = h ^ (h >> xp.uint32(13))
    h = h * xp.uint32(0xC2B2AE35)
    h = h ^ (h >> xp.uint32(16))
    return h


def _f_outputs(cols, n_out, salt, xp):
    """n_out well-mixed uint32 streams from `cols` (two shared
    accumulators + per-output finalizers).  Works for xp = jnp or np."""
    h1 = xp.uint32(0x9E3779B9 ^ ((salt * 0x7FEB352D) & 0xFFFFFFFF))
    h2 = xp.uint32(0xC2B2AE35 ^ ((salt * 0x846CA68B) & 0xFFFFFFFF))
    for i, c in enumerate(cols):
        ka = c * xp.uint32(_LANE_MULT_A[(i + salt) % len(_LANE_MULT_A)])
        ka = ka ^ (ka >> xp.uint32(15))
        kb = c * xp.uint32(_LANE_MULT_B[(i + salt) % len(_LANE_MULT_B)])
        kb = kb ^ (kb >> xp.uint32(17))
        h1 = (h1 ^ ka) * xp.uint32(5) + xp.uint32(0xE6546B64)
        h2 = (h2 ^ kb) * xp.uint32(5) + xp.uint32(0x38495AB5)
    outs = []
    for j in range(n_out):
        v = h1 ^ (h2 * xp.uint32(
            _LANE_MULT_A[(j + 7 * salt) % len(_LANE_MULT_A)]
        ))
        v = _fmix_g(
            v + xp.uint32(_LANE_MULT_B[(j + 5 * salt) % len(_LANE_MULT_B)]),
            xp,
        )
        outs.append(v)
    return outs


def _unxorshift(y, s: int, bits: int, xp):
    """Invert x ^= x >> s on a `bits`-bit value."""
    x = y
    steps = -(-bits // s) - 1
    for _ in range(max(0, steps)):
        x = y ^ (x >> xp.uint32(s))
    return x


class LaneMixBijection:
    """Invertible ARX lane mix over (N, lanes) uint32 keys.

    Same interface as ops/gf2.py GF2Hash (apply / inv_apply + _host
    mirrors + apply_cols for the column hot path); identity is False.
    Capability analog of the reference's IBijectiveFunction
    (src/tsxcount/IBijectiveFunction.h:26-34) with a hardware-matched
    construction instead of the GF(2) matrix.
    """

    identity = False

    def __init__(self, spec: KmerSpec):
        self.spec = spec
        b = spec.top_lane_bits
        # single-lane parameters: odd multipliers invertible mod 2^b
        self._odd1 = 0x9E3779B1 & ((1 << b) - 1) | 1
        self._odd2 = 0x85EBCA77 & ((1 << b) - 1) | 1
        self._inv1 = pow(self._odd1, -1, 1 << b)
        self._inv2 = pow(self._odd2, -1, 1 << b)
        self._shift = max(1, b // 2)

    # -- single lane: multiply/xorshift permutation mod 2^bits
    def _apply1(self, x, xp, inverse: bool):
        b = self.spec.top_lane_bits
        mask = xp.uint32(self.spec.top_lane_mask)
        s = self._shift
        if not inverse:
            x = (x * xp.uint32(self._odd1)) & mask
            x = x ^ (x >> xp.uint32(s))
            x = (x * xp.uint32(self._odd2)) & mask
            x = x ^ (x >> xp.uint32(s))
            return x
        x = _unxorshift(x, s, b, xp)
        x = (x * xp.uint32(self._inv2)) & mask
        x = _unxorshift(x, s, b, xp)
        x = (x * xp.uint32(self._inv1)) & mask
        return x

    def _apply_cols(self, cols: list, xp, inverse: bool) -> list:
        spec = self.spec
        lanes = spec.lanes
        if lanes == 1:
            return [self._apply1(cols[0], xp, inverse)]
        h = lanes // 2
        lo, hi = list(cols[:h]), list(cols[h:])
        top_mask = xp.uint32(spec.top_lane_mask)

        def xor_hi(salt):
            outs = _f_outputs(lo, len(hi), salt, xp)
            for j in range(len(hi)):
                o = outs[j]
                if j == len(hi) - 1:
                    o = o & top_mask
                hi[j] = hi[j] ^ o

        def xor_lo(salt):
            outs = _f_outputs(hi, len(lo), salt, xp)
            for j in range(len(lo)):
                lo[j] = lo[j] ^ outs[j]

        if not inverse:
            xor_hi(1)
            xor_lo(2)
            xor_hi(3)
        else:
            xor_hi(3)
            xor_lo(2)
            xor_hi(1)
        return lo + hi

    # -- device (jnp) ------------------------------------------------------
    def apply_cols(self, cols) -> list[jax.Array]:
        """Per-lane columns (lsb first) -> image columns; the dedupe hot
        path (no stacked [P, lanes] materialization)."""
        return self._apply_cols(list(cols), jnp, inverse=False)

    def apply(self, keys: jax.Array) -> jax.Array:
        cols = [keys[..., j] for j in range(keys.shape[-1])]
        return jnp.stack(self._apply_cols(cols, jnp, False), axis=-1)

    def inv_apply(self, hashes: jax.Array) -> jax.Array:
        cols = [hashes[..., j] for j in range(hashes.shape[-1])]
        return jnp.stack(self._apply_cols(cols, jnp, True), axis=-1)

    # -- host (numpy) ------------------------------------------------------
    def _host(self, keys: np.ndarray, inverse: bool) -> np.ndarray:
        with np.errstate(over="ignore"):
            cols = [keys[..., j].astype(np.uint32)
                    for j in range(keys.shape[-1])]
            out = self._apply_cols(cols, np, inverse)
        return np.stack(out, axis=-1).astype(np.uint32)

    def apply_host(self, keys: np.ndarray) -> np.ndarray:
        return self._host(keys, False)

    def inv_apply_host(self, hashes: np.ndarray) -> np.ndarray:
        return self._host(hashes, True)


def make_ext_spec(spec: KmerSpec) -> KmerSpec:
    """The KmerSpec whose lane geometry matches the extended key.

    bits = 32*(lanes+2) => top_lane_bits == 32, so pack_flag_key emits the
    invalid flag as a standalone msb column (mix_hi uses all 32 bits) and
    the uniform-prefix sort comparator is exactly (flag, mix_hi, mix_lo).
    """
    ext_lanes = spec.lanes + MIX_LANES
    if ext_lanes * 16 > 256:
        raise ValueError(
            f"mix-prefix extended keys support k <= 224 (k={spec.k} needs "
            f"{ext_lanes} lanes > the 256-base spec ceiling); use the "
            "full-comparator sort for wider keys"
        )
    return KmerSpec(ext_lanes * WORD_BITS // 2)
