"""The compile-cache helper: JAX_COMPILATION_CACHE_DIR wins untouched;
otherwise one fixed directory, never a temporary or per-run one."""

import os

import jax

from openpose_plus.utils import compile_cache


def test_env_var_is_honoured(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache("/elsewhere") == str(
        tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_default_path_is_fixed(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        a = compile_cache.configure_compile_cache()
        b = compile_cache.configure_compile_cache()
        assert a == b == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == a
        assert os.path.isfile(os.path.join(compile_cache.CHECKOUT,
                                           "chip_smoke.py"))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_explicit_default_dir(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        assert compile_cache.configure_compile_cache(str(tmp_path)) == str(
            tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
