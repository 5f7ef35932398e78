"""Where the entry points keep JAX's persistent compilation cache."""

import jax
import pytest

from femcy_tpu.utils import cache


def test_env_var_wins():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/where"}
    assert cache.compile_cache_dir(env) == "/some/where"


def test_default_is_the_repo_cache():
    path = cache.compile_cache_dir({})
    assert path == str(cache.REPO_CACHE)
    assert cache.REPO_CACHE.name == ".jax_cache"
    assert (cache.REPO_CACHE.parent / "femcy_tpu").is_dir()


@pytest.mark.parametrize("env_set", [True, False])
def test_configure_sets_jax_only_without_the_env_var(monkeypatch, tmp_path,
                                                     env_set):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = cache.configure_compile_cache()
        if env_set:
            assert path == str(tmp_path)
            # JAX reads the variable itself; nothing else is configured
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert path == str(cache.REPO_CACHE)
            assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_compile_floor_overrides():
    """The library leaves JAX's persistent-cache floors at their defaults."""
    import femcy_tpu  # noqa: F401

    assert jax.config.jax_persistent_cache_min_compile_time_secs == 1.0
    assert jax.config.jax_persistent_cache_min_entry_size_bytes == 0
