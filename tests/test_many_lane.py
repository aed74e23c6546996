"""Large-dictionary chunked lane (ops/many): oracle parity.

The reference serves thousands of patterns from one monomorphized loop
(src/search.rs:418-1119; benches/benchmark.rs:45-76 search_many_patterns).
The device analog chunks the dictionary across reusable uniform-shape kernels;
these tests check chunking engages (single-kernel packing declines) and the
merged result is oracle-identical.
"""

import numpy as np
import pytest

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits, oracle
from fuzzy_aho_corasick_tpu.ops.many import fuzzy_search_many, many_spec_of
from fuzzy_aho_corasick_tpu.ops.packed_bitap import packed_fuzzy_of
from fuzzy_aho_corasick_tpu.utils.graphemes import view_of


def _key(m):
    return (m.pattern_index, m.start, m.end, float(m.similarity))


def _dictionary(n_pat: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    alphabet = "abcdefghijklmnopqrstuvwxyz"
    return sorted({
        "".join(alphabet[i] for i in rng.integers(0, 26, size=int(m)))
        for m in rng.integers(6, 12, size=n_pat)
    })


def _corpus(dictionary, size: int, seed: int = 11) -> str:
    rng = np.random.default_rng(seed)
    words = ["lorem", "ipsum", "dolor", "sit", "amet"]
    parts, total = [], 0
    while total < size:
        w = words[int(rng.integers(len(words)))]
        if rng.integers(13) == 0:
            w = dictionary[int(rng.integers(len(dictionary)))]
            if rng.integers(2) == 0 and len(w) > 3:
                i = int(rng.integers(1, len(w) - 1))
                w = w[:i] + ("q" if w[i] != "q" else "z") + w[i + 1:]
        parts.append(w)
        total += len(w) + 1
    return " ".join(parts)


def test_many_lane_matches_oracle(monkeypatch):
    # Pin the narrow limb budget so a 120-pattern dictionary still spans
    # multiple chunks (the default budget is wide enough to hold it in one),
    # and disable the folded layout so the multi-chunk path is what runs.
    from fuzzy_aho_corasick_tpu.ops import many as many_mod

    monkeypatch.setattr(many_mod, "MANY_LIMBS", 8)
    monkeypatch.setenv("FAC_MANY_FOLD", "0")
    many = _dictionary(120)
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    # The whole point: the single-kernel packing cannot hold this dictionary.
    assert packed_fuzzy_of(engine) is None
    spec = many_spec_of(engine)
    assert spec is not None and len(spec.chunks) >= 2

    hay = _corpus(many, 30_000)
    view = view_of(hay, True)
    res = fuzzy_search_many(engine, hay, 0.82, view, len(view))
    assert res is not None
    assert engine.last_stats["backend"] == "device-fuzzy-many"
    assert engine.last_stats["chunks"] == len(spec.chunks)
    orc = oracle.search_raw(engine, hay, 0.82)
    assert sorted(map(_key, res)) == sorted(map(_key, orc))
    assert len(res) > 50  # the corpus really contains planted needles


def test_many_lane_wide_chunks_damerau_parity(monkeypatch):
    """The default (wide-limb) chunking with the traced Damerau recurrence
    (swap = 1 bitap error) stays oracle-identical on a swap-heavy corpus."""
    from fuzzy_aho_corasick_tpu.ops import many as many_mod

    many = _dictionary(90, seed=13)
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    assert packed_fuzzy_of(engine) is None
    rng = np.random.default_rng(17)
    parts = []
    for w in many[:40]:
        if len(w) > 4:
            i = int(rng.integers(1, len(w) - 2))
            parts.append(w[:i] + w[i + 1] + w[i] + w[i + 2:])  # one swap
        parts.append("filler")
    hay = " ".join(parts)
    view = view_of(hay, True)
    res = fuzzy_search_many(engine, hay, 0.8, view, len(view))
    assert res is not None
    assert engine.last_stats.get("damerau") is True
    orc = oracle.search_raw(engine, hay, 0.8)
    assert sorted(map(_key, res)) == sorted(map(_key, orc))
    assert len(res) > 20  # the swapped needles really matched

    # FAC_NO_DAMERAU reverts to the plain (swap-costs-2) budgets with the
    # same results.
    monkeypatch.setenv("FAC_NO_DAMERAU", "1")
    eng2 = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    res2 = fuzzy_search_many(eng2, hay, 0.8, view, len(view))
    assert res2 is not None and eng2.last_stats.get("damerau") is False
    assert sorted(map(_key, res2)) == sorted(map(_key, res))


@pytest.mark.slow
def test_many_lane_shared_suffix_fields(monkeypatch):
    """Patterns that are suffixes of others share verify fields across
    chunks; duplicate emissions must collapse to the oracle's result."""
    from fuzzy_aho_corasick_tpu.ops import many as many_mod

    monkeypatch.setattr(many_mod, "MANY_LIMBS", 8)
    many = _dictionary(90, seed=3)
    # plant suffix pairs far apart so they land in different chunks
    many = sorted(set(many) | {w[2:] for w in many[:10] if len(w) > 7})
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    if packed_fuzzy_of(engine) is not None:
        pytest.skip("dictionary fit a single kernel; chunking not engaged")
    hay = _corpus(many, 20_000, seed=5)
    view = view_of(hay, True)
    res = fuzzy_search_many(engine, hay, 0.8, view, len(view))
    assert res is not None
    orc = oracle.search_raw(engine, hay, 0.8)
    assert sorted(map(_key, res)) == sorted(map(_key, orc))


def test_folded_lane_matches_oracle():
    """Stratified-folded single-pass layout (superimposed bit lanes) stays
    oracle-identical on a corpus with planted substitutions, swaps and
    indels — folding adds scan false-positives only; the banded DP kills
    them (ops/many._fold_assign)."""
    from fuzzy_aho_corasick_tpu.ops import many as many_mod

    many = _dictionary(400, seed=29)
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    assert packed_fuzzy_of(engine) is None
    spec_f = many_spec_of(engine, fold=True)
    spec_p = many_spec_of(engine)
    assert spec_f is not None and spec_f.folded
    assert len(spec_f.chunks) < len(spec_p.chunks)

    rng = np.random.default_rng(31)
    parts = []
    for w in many[:60]:
        i = int(rng.integers(1, len(w) - 2))
        mode = int(rng.integers(4))
        if mode == 0:    # substitution
            parts.append(w[:i] + ("q" if w[i] != "q" else "z") + w[i + 1:])
        elif mode == 1:  # swap
            parts.append(w[:i] + w[i + 1] + w[i] + w[i + 2:])
        elif mode == 2:  # deletion
            parts.append(w[:i] + w[i + 1:])
        else:            # insertion
            parts.append(w[:i] + "x" + w[i:])
        parts.append("filler")
    hay = " ".join(parts)
    view = view_of(hay, True)
    res = fuzzy_search_many(engine, hay, 0.8, view, len(view))
    assert res is not None
    assert engine.last_stats.get("folded") is True
    assert engine.last_stats["chunks"] == len(spec_f.chunks)
    orc = oracle.search_raw(engine, hay, 0.8)
    assert sorted(map(_key, res)) == sorted(map(_key, orc))
    assert len(res) > 30  # the planted edits really matched

    # The plain (unsuperimposed) chunking returns the identical set.
    engine._many_fold_off = True
    res2 = fuzzy_search_many(engine, hay, 0.8, view, len(view))
    assert res2 is not None and engine.last_stats.get("folded") is False
    assert sorted(map(_key, res2)) == sorted(map(_key, res))


@pytest.mark.slow
def test_folded_lane_overflow_falls_back(monkeypatch):
    """A corpus that is wall-to-wall needles blows the folded hit ceiling;
    the lane must transparently re-run with the plain chunking (and pin the
    engine off the folded layout) instead of failing or growing without
    bound. The ceiling floor is patched down so a small corpus triggers it."""
    from fuzzy_aho_corasick_tpu.ops import many as many_mod

    monkeypatch.setattr(many_mod, "FOLD_HIT_CEIL_MIN", 64)
    many = _dictionary(400, seed=37)
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(many)
    )
    spec_f = many_spec_of(engine, fold=True)
    if spec_f is None:
        pytest.skip("fold layout declined for this dictionary")
    # Needle-dense corpus: every word is a dictionary pattern.
    rng = np.random.default_rng(41)
    hay = " ".join(many[int(rng.integers(len(many)))] for _ in range(300))
    view = view_of(hay, True)
    res = fuzzy_search_many(engine, hay, 0.82, view, len(view))
    assert res is not None
    assert engine._many_fold_off is True
    assert engine.last_stats.get("folded") is False
    orc = oracle.search_raw(engine, hay, 0.82)
    assert sorted(map(_key, res)) == sorted(map(_key, orc))
