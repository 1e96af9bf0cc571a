"""Multi-lane (stacked uint32) key arithmetic.

The vectorized replacement for the reference's UBigInt bit machinery
(shift/and/or/compare over uint8 fields, reference src/tsxutils/UBigInt.h:
932-1004 shifts, 545-567 compare): a wide key is `(..., lanes)` uint32,
little-endian, and every op is a vectorized lane expression — no loops over
bits, no allocation (the reference needed SBIGINT precisely because malloc
aborts TSX transactions; under jit everything is pre-shaped instead).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def unpack_bits(keys: jax.Array, nbits: int, dtype=jnp.int8) -> jax.Array:
    """(..., lanes) uint32 -> (..., nbits) bit planes (LSB-first)."""
    sh = jnp.arange(32, dtype=jnp.uint32)
    bits = (keys[..., :, None] >> sh) & jnp.uint32(1)   # (..., lanes, 32)
    flat = bits.reshape(*keys.shape[:-1], keys.shape[-1] * 32)
    return flat[..., :nbits].astype(dtype)


def pack_bits(bits: jax.Array, lanes: int) -> jax.Array:
    """(..., nbits) 0/1 values -> (..., lanes) uint32 keys (LSB-first)."""
    nbits = bits.shape[-1]
    pad = lanes * 32 - nbits
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros((*bits.shape[:-1], pad), bits.dtype)], axis=-1
        )
    b = bits.reshape(*bits.shape[:-1], lanes, 32).astype(jnp.uint32)
    sh = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << sh, axis=-1, dtype=jnp.uint32)


def shift_right_const(keys: jax.Array, n: int) -> jax.Array:
    """Logical right shift of a (..., lanes) key by a static n bits."""
    lanes = keys.shape[-1]
    words, bits = divmod(n, 32)
    if words:
        zero = jnp.zeros((*keys.shape[:-1], words), keys.dtype)
        keys = jnp.concatenate([keys[..., words:], zero], axis=-1)
    if bits:
        lo = keys >> jnp.uint32(bits)
        hi = jnp.concatenate(
            [keys[..., 1:], jnp.zeros((*keys.shape[:-1], 1), keys.dtype)], axis=-1
        )
        keys = lo | ((hi << jnp.uint32(31 - bits)) << jnp.uint32(1))
    return keys


def shift_left_const(keys: jax.Array, n: int) -> jax.Array:
    """Logical left shift of a (..., lanes) key by a static n bits."""
    lanes = keys.shape[-1]
    words, bits = divmod(n, 32)
    if words:
        zero = jnp.zeros((*keys.shape[:-1], words), keys.dtype)
        keys = jnp.concatenate([zero, keys[..., : lanes - words]], axis=-1)
    if bits:
        hi = keys << jnp.uint32(bits)
        lo = jnp.concatenate(
            [jnp.zeros((*keys.shape[:-1], 1), keys.dtype), keys[..., :-1]], axis=-1
        )
        keys = hi | ((lo >> jnp.uint32(31 - bits)) >> jnp.uint32(1))
    return keys


def low_bits(keys: jax.Array, n: int) -> jax.Array:
    """Extract the low n (< 32) bits of a multi-lane key as uint32."""
    if not 0 < n < 32:
        raise ValueError("low_bits supports 0 < n < 32")
    return keys[..., 0] & jnp.uint32((1 << n) - 1)


def keys_equal(a: jax.Array, b: jax.Array) -> jax.Array:
    """Lane-wise equality reduced over the lane axis."""
    return jnp.all(a == b, axis=-1)


def keys_less(a: jax.Array, b: jax.Array) -> jax.Array:
    """Lexicographic unsigned a < b over little-endian lanes."""
    lt = jnp.zeros(a.shape[:-1], jnp.bool_)
    eq = jnp.ones(a.shape[:-1], jnp.bool_)
    for j in reversed(range(a.shape[-1])):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


# --- host-side (numpy) mirrors for tests/tools ---

def np_lanes_to_int(keys: np.ndarray) -> np.ndarray:
    """(..., lanes) uint32 -> python-int array (object dtype) for checking."""
    out = np.zeros(keys.shape[:-1], dtype=object)
    for j in reversed(range(keys.shape[-1])):
        out = (out << 32) | keys[..., j].astype(object)
    return out


def np_int_to_lanes(vals, lanes: int) -> np.ndarray:
    """Iterable of python ints -> (N, lanes) uint32."""
    vals = list(vals)
    out = np.zeros((len(vals), lanes), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(lanes):
            out[i, j] = (v >> (32 * j)) & 0xFFFFFFFF
    return out
