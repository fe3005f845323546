"""Runtime substrate tests: the persistent compile-cache contract.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it and the program
sets nothing; otherwise the cache lives at the fixed <repo>/.jax_cache
(the directory is part of the cache key, so it must not move between
runs — a temporary directory would never hit).
"""
import pathlib
import tempfile

import jax
import pytest

from picha_tpu.runtime import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_config():
    """Restore jax's cache directory after a test changes it."""
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured_and_nothing_set(monkeypatch, tmp_path,
                                            cache_config):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cc"))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable() == tmp_path / "cc"
    assert compile_cache.cache_dir() == tmp_path / "cc"
    assert jax.config.jax_compilation_cache_dir is None  # JAX reads env


def test_fixed_default_path_is_used(monkeypatch, cache_config):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable() == REPO / ".jax_cache"
    assert jax.config.jax_compilation_cache_dir == str(REPO / ".jax_cache")
    assert compile_cache.cache_dir() == REPO / ".jax_cache"


def test_default_cache_is_not_in_a_temporary_path():
    tmp = pathlib.Path(tempfile.gettempdir()).resolve()
    default = compile_cache.DEFAULT_DIR.resolve()
    assert tmp not in default.parents and default != tmp
    assert default.parent == REPO


def test_application_cache_dir_is_kept(monkeypatch, tmp_path, cache_config):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "app"))
    assert compile_cache.enable() == tmp_path / "app"
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "app")


def test_race_file_lives_in_the_cache_dir_in_use(monkeypatch, tmp_path,
                                                cache_config):
    from picha_tpu.pipeline import serving

    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "cc"))
    assert serving._race_cache_path() == tmp_path / "cc" / "stream_best.json"
