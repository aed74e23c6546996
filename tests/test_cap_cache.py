"""Persistent capacity cache (ops/packed_bitap._PersistentCaps) and the
compile cache directory both caches live in (utils/hostmem.cache_dir).

Converged device-buffer capacities survive the process so a fresh process
(a bench run, a production warm-start) compiles each kernel once at the
converged size instead of once at the guess plus once after the ratchet.
The cache is purely a performance hint: a wrong or missing entry only
re-enters the existing overflow/ratchet retry loop.
"""

import os

import pytest

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu.ops.packed_bitap import (
    _cap_cache,
    _caps_dir,
    _engine_fingerprint,
)


def _engine(words=("hello", "world"), edits=1):
    return (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(edits))
        .case_insensitive(True)
        .build(list(words))
    )


def test_caps_roundtrip_across_engine_instances(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    eng = _engine()
    caps = _cap_cache(eng)
    caps[("many-KH", 12345, True)] = 5632
    caps[("dp-KH", 99, False)] = 1 << 14

    # A separately-built identical engine (fresh process analog) sees the
    # converged values.
    eng2 = _engine()
    caps2 = _cap_cache(eng2)
    assert caps2.get(("many-KH", 12345, True)) == 5632
    assert caps2.get(("dp-KH", 99, False)) == 1 << 14


def test_fingerprint_separates_configs(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fp1 = _engine_fingerprint(_engine())
    assert fp1 == _engine_fingerprint(_engine())  # deterministic
    assert fp1 != _engine_fingerprint(_engine(edits=2))
    assert fp1 != _engine_fingerprint(_engine(words=("hello", "worlds")))

    caps = _cap_cache(_engine(edits=2))
    caps[("many-KH", 1, True)] = 7
    assert _cap_cache(_engine()).get(("many-KH", 1, True)) is None


def test_caps_disabled_and_io_failure_degrade_gracefully(tmp_path, monkeypatch):
    # Unwritable cache dir: the cache is disabled and degrades to in-memory
    # without raising.
    blocked = tmp_path / "file_not_dir"
    blocked.write_text("x")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(blocked / "sub"))
    eng = _engine()
    caps = _cap_cache(eng)
    caps[("k", 1)] = 2  # no path -> stays in-memory, no error
    assert caps[("k", 1)] == 2
    assert _cap_cache(_engine()).get(("k", 1)) is None


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(tmp_path, monkeypatch, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the program uses it and sets no
    other directory; unset, both caches land in <checkout>/.jax_cache."""
    import jax

    from fuzzy_aho_corasick_tpu.utils import hostmem

    before = jax.config.jax_compilation_cache_dir
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            jax.config.update("jax_compilation_cache_dir", str(tmp_path))
            hostmem.enable_compile_cache()
            want = str(tmp_path)
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
            hostmem.enable_compile_cache()
            want = os.path.join(checkout, ".jax_cache")
        assert hostmem.cache_dir() == want
        assert jax.config.jax_compilation_cache_dir == want
        assert _caps_dir() == os.path.join(want, "caps")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_corrupt_cache_file_ignored(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    eng = _engine(words=("corrupt", "case"))
    os.makedirs(tmp_path / "caps", exist_ok=True)
    path = os.path.join(str(tmp_path), "caps", f"{_engine_fingerprint(eng)}.json")
    with open(path, "w") as f:
        f.write("{not json")
    caps = _cap_cache(eng)
    assert len(caps) == 0
    caps[("fresh", 1)] = 4
    assert _cap_cache(_engine(words=("corrupt", "case"))).get(("fresh", 1)) == 4
