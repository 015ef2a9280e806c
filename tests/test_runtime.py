"""Runtime helpers: the compile-cache location and the device peak table."""

import os

import pytest

from clearsky_tpu.utils import compile_cache
from clearsky_tpu.utils.profiling import DEVICE_PEAKS, device_peaks


def test_cache_dir_follows_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.cache_dir() == os.path.join(root, ".jax_cache")


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_peak_table_knows_the_h100():
    flops, bw = device_peaks("NVIDIA H100 80GB HBM3")
    assert (flops, bw) == DEVICE_PEAKS["NVIDIA H100 80GB HBM3"]
    assert bw == 3.35e12


def test_peak_table_rejects_unknown_kinds():
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks("cpu")
