"""Analytic device-memory footprint model (utils/hbm.py) — ordering, the
collision-fallback doubling, and the preflight messages."""

import pytest

from tsxcount_tpu.utils.hbm import estimate_hbm, preflight_check

SMALL_MB = 12 * 1024  # a 12 GiB device


def test_known_good_configs_fit():
    for kw in (
        dict(k=14, l=24, batch_words=602112),
        dict(k=31, l=24, batch_words=602112),
        dict(k=63, l=25, batch_words=602112),
        dict(k=127, l=25, batch_words=602112),
        dict(k=14, l=26, batch_words=602112, backend="table"),
    ):
        est = estimate_hbm(**kw)
        assert preflight_check(est, capacity_mb=SMALL_MB) is None, kw


def test_r3_oom_case_predicted():
    """k=127 l=25 hash-first with the compiled cond fallback does not fit
    a 12 GiB device; the model must flag it, and must rank the flag-mode
    replacement below it."""
    cond = estimate_hbm(k=127, l=25, batch_words=602112, hash_first=True,
                        collide_mode="cond")
    assert preflight_check(cond, capacity_mb=SMALL_MB) is not None
    flag = estimate_hbm(k=127, l=25, batch_words=602112, hash_first=True,
                        collide_mode="flag")
    assert flag.total_mb < cond.total_mb


def test_monotonic_in_l_and_k():
    base = estimate_hbm(k=31, l=22, batch_words=602112).total_mb
    assert estimate_hbm(k=31, l=26, batch_words=602112).total_mb > base
    assert estimate_hbm(k=63, l=22, batch_words=602112).total_mb > base
    assert estimate_hbm(
        k=31, l=22, batch_words=602112 * 2
    ).total_mb > base


def test_sharded_models_per_device_state():
    one = estimate_hbm(k=31, l=26, batch_words=602112, n_shards=1)
    eight = estimate_hbm(k=31, l=26, batch_words=602112, n_shards=8)
    assert eight.state_mb < one.state_mb  # the table splits across shards


@pytest.mark.parametrize("capacity_mb", [None, 80 * 1024.0])
def test_preflight_unknown_or_large_device(capacity_mb, monkeypatch):
    """An unknown device size skips the check (and says so) instead of
    assuming one; an 80 GB device fits the default configuration."""
    from tsxcount_tpu.utils import hbm

    monkeypatch.setattr(hbm, "device_hbm_capacity_mb", lambda: capacity_mb)
    msg = preflight_check(estimate_hbm(k=31, l=28, batch_words=602112))
    if capacity_mb is None:
        assert "skipped" in msg
    else:
        assert msg is None
