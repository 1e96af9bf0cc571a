"""The one compile-cache rule (tsxcount_tpu/utils/cache.py)."""

import jax
import pytest

from tsxcount_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    old = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    yield
    jax.config.update("jax_compilation_cache_dir", old)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old_min)


def test_env_dir_wins_and_nothing_is_set(monkeypatch, tmp_path,
                                         restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_uses_fixed_checkout_path(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == str(cache.CHECKOUT / ".jax_cache")
    assert (cache.CHECKOUT / "tsxcount_tpu").is_dir()
    assert jax.config.jax_compilation_cache_dir == path
    assert "/tmp" not in path
