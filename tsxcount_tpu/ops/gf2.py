"""Bijective GF(2) matrix hash — the batched re-design of BijectiveKMapping.

The reference hashes a 2k-bit k-mer by multiplying it with a random
invertible 2k x 2k binary matrix: per output bit, AND a matrix row with the
key and take popcount parity (reference src/tsxcount/BijectiveKMapping.h:
81-99 construction, 202-225 apply); the inverse matrix (LU decomposition over
GF(2), BijectiveKMapping.h:643-766) lets the table reconstruct k-mers from
slots (TSXHashMap.h:660-722).

Batched formulation: over GF(2), parity(row AND key) == (row . key) mod 2 with
bits as elements — so hashing a *batch* of keys is one int8 matmul: bits[N, 2k] @ A^T[2k, 2k] & 1.  The matrix is generated host-side with
seeded numpy (deterministic by default, unlike the reference's
srand(time(NULL)) at BijectiveKMapping.h:84) and its invertibility is
guaranteed by Gauss-Jordan over GF(2) with retry.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from tsxcount_tpu.config import KmerSpec
from tsxcount_tpu.ops.lanes import pack_bits, unpack_bits

DEFAULT_SEED = 0x7C5C


class BijectiveFunction:
    """Interface of a bijective key hash (reference IBijectiveFunction,
    src/tsxcount/IBijectiveFunction.h:26-34): apply / inv_apply over
    (N, lanes) uint32 key batches."""

    def apply(self, keys):  # pragma: no cover - interface
        raise NotImplementedError

    def inv_apply(self, hashes):  # pragma: no cover - interface
        raise NotImplementedError


def _gf2_invert(a: np.ndarray) -> np.ndarray | None:
    """Invert a binary matrix over GF(2) (Gauss-Jordan); None if singular."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.uint8) & 1, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        pivots = np.nonzero(aug[col:, col])[0]
        if pivots.size == 0:
            return None
        piv = col + int(pivots[0])
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        rows = np.nonzero(aug[:, col])[0]
        rows = rows[rows != col]
        aug[rows] ^= aug[col]
    return aug[:, n:]


def random_invertible_gf2(bits: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Sample a random invertible GF(2) matrix and its inverse."""
    rng = np.random.default_rng(seed)
    while True:
        a = rng.integers(0, 2, size=(bits, bits), dtype=np.uint8)
        ai = _gf2_invert(a)
        if ai is not None:
            return a, ai


class GF2Hash(BijectiveFunction):
    """Batched bijective hash over (N, lanes) uint32 keys."""

    def __init__(self, spec: KmerSpec, seed: int = DEFAULT_SEED,
                 identity: bool = False):
        self.spec = spec
        self.bits = spec.bits
        self.identity = identity
        if identity:
            self.matrix = np.eye(self.bits, dtype=np.uint8)
            self.inverse = np.eye(self.bits, dtype=np.uint8)
        else:
            self.matrix, self.inverse = random_invertible_gf2(self.bits, seed)
        # transposed int8 copies for the matmul (bits @ A^T)
        self._mat_t = jnp.asarray(self.matrix.T, dtype=jnp.int8)
        self._inv_t = jnp.asarray(self.inverse.T, dtype=jnp.int8)

    def _apply(self, keys: jax.Array, mat_t: jax.Array) -> jax.Array:
        if self.identity:
            return keys
        bits = unpack_bits(keys, self.bits, dtype=jnp.int8)
        hbits = (
            jnp.dot(bits, mat_t, preferred_element_type=jnp.int32)
            & jnp.int32(1)
        )
        return pack_bits(hbits, self.spec.lanes)

    def apply(self, keys: jax.Array) -> jax.Array:
        """kmer lanes -> hash lanes (device)."""
        return self._apply(keys, self._mat_t)

    def inv_apply(self, hashes: jax.Array) -> jax.Array:
        """hash lanes -> kmer lanes (device); proves bijectivity."""
        return self._apply(hashes, self._inv_t)

    # host mirrors (numpy, for tests/tools)
    def _apply_host(self, keys: np.ndarray, mat: np.ndarray) -> np.ndarray:
        n, lanes = keys.shape
        sh = np.arange(32, dtype=np.uint32)
        bits = ((keys[:, :, None] >> sh) & 1).reshape(n, lanes * 32)[:, : self.bits]
        # float64 products are exact here (sums <= 2k < 2^53) and run
        # through BLAS; an integer matmul is orders of magnitude slower
        hbits = (
            bits.astype(np.float64) @ mat.T.astype(np.float64)
        ).astype(np.int64) & 1
        pad = lanes * 32 - self.bits
        hb = np.concatenate([hbits, np.zeros((n, pad), np.int64)], axis=1)
        hb = hb.reshape(n, lanes, 32).astype(np.uint32)
        return np.bitwise_or.reduce(hb << sh, axis=2).astype(np.uint32)

    def apply_host(self, keys: np.ndarray) -> np.ndarray:
        return self._apply_host(keys, self.matrix)

    def inv_apply_host(self, hashes: np.ndarray) -> np.ndarray:
        return self._apply_host(hashes, self.inverse)
