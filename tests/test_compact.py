"""Stream compaction (ops/count.py compact_rows) vs numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tsxcount_tpu.ops.count import compact_rows


def _check(flag, cols):
    pos, out = jax.jit(compact_rows)(
        jnp.asarray(flag), [jnp.asarray(c) for c in cols]
    )
    pos, out = np.asarray(pos), [np.asarray(c) for c in out]
    n = int(flag.sum())
    want_pos = np.flatnonzero(flag)
    np.testing.assert_array_equal(pos[:n], want_pos)
    assert (pos[n:] == flag.shape[0]).all()
    for got, col in zip(out, cols):
        np.testing.assert_array_equal(got[:n], col[flag])
        assert not got[n:].any()


@pytest.mark.parametrize("n_cols", [1, 4])
@pytest.mark.parametrize("total,density,seed", [
    (1024, 0.5, 0),
    (4096, 0.1, 1),
    (4096, 0.9, 2),
    (8192, 0.0, 3),
    (8192, 1.0, 4),
])
def test_compact_matches_numpy(total, density, seed, n_cols):
    rng = np.random.default_rng(seed)
    flag = rng.random(total) < density
    cols = [rng.integers(0, 2**31, size=total, dtype=np.int32)] + [
        rng.integers(0, 2**32, size=total, dtype=np.uint32)
        for _ in range(n_cols - 1)
    ]
    _check(flag, cols)


def test_compact_irregular_blocks():
    # irregular flag counts per 1024-row block: every destination offset
    # residue occurs across blocks
    rng = np.random.default_rng(9)
    block = 1024
    total = 16 * block
    flag = np.zeros(total, bool)
    for t in range(16):
        c = int(rng.integers(0, block))
        flag[rng.choice(block, size=c, replace=False) + t * block] = True
    _check(flag, [np.arange(total, dtype=np.int32)])
