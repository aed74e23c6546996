"""Device lane for multi-char mappings: differential vs the oracle.

The reference serves mappings inside its one hot loop
(src/search.rs:883-923, precompute src/builder.rs:383-442); the device build
serves them as static arrivals in the banded DP (ops/verify_dp.MappedSpec).
These tests force ``backend = "device"`` and assert byte-identical match
tuples against the pure-host oracle — the same differential pattern as the
reference's prefilter fuzz (src/prefilter.rs:437-562).
"""

import numpy as np
import pytest

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits


def _build(patterns, mappings, edits=1, scored=None, ci=True):
    b = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(edits))
    if ci:
        b = b.case_insensitive(True)
    for a, bb in mappings:
        b = b.mapping(a, bb)
    for a, bb, s in scored or []:
        b = b.mapping_scored(a, bb, s)
    return b.build(patterns)


def _key(ms):
    return sorted(
        (m.start, m.end, m.pattern_index, float(m.similarity)) for m in ms
    )


def _diff(engine, hay, thr):
    engine.backend = "device"
    dv = engine.search_raw(hay, thr)
    engine.backend = "oracle"
    orc = engine.search_raw(hay, thr)
    engine.backend = "auto"
    assert _key(dv) == _key(orc), (hay[:80], thr)
    return dv


def test_mapped_lane_selected():
    eng = _build(["strasse"], [("ß", "ss")])
    from fuzzy_aho_corasick_tpu.ops.verify_dp import mapped_spec_of

    spec = mapped_spec_of(eng)
    assert spec is not None
    assert spec.k == 2  # E=1 x max(2, max(pb, ha)) = 1 x 2
    eng.backend = "device"
    eng.search_raw("filler " * 40 + "straße", 0.5)
    assert eng.last_stats["backend"] == "device-fuzzy-dp-mapped"


def test_eszett_both_directions():
    # Pattern side ASCII digraph, haystack side one non-ASCII char.
    eng = _build(["strasse"], [("ß", "ss")])
    hay = ("pad " * 50) + "straße weiter strasse und strase ende"
    ms = _diff(eng, hay, 0.5)
    texts = sorted(m.text for m in ms if float(m.similarity) > 0.99)
    assert "straße" in texts and "strasse" in texts


def test_mapping_exact_similarity_via_device():
    # A mapping consumes an edit at penalty 0 (score 1.0): similarity 1.0,
    # substitutions 1 (reference tests.rs:919-1056 semantics).
    eng = _build(["encyclopaedia"], [("æ", "ae")])
    hay = ("x " * 60) + "encyclopædia"
    ms = _diff(eng, hay, 0.9)
    best = max(ms, key=lambda m: float(m.similarity))
    assert float(best.similarity) == 1.0
    assert best.substitutions == 1 and best.edits == 1


def test_scored_mapping_penalty():
    eng = _build(["color"], [], scored=[("ou", "o", 0.6)])
    # "colour" <- pattern "color" via mapping o->ou?? direction: pattern
    # side walks "o", haystack side "ou"? mapping(a, b) is bidirectional:
    # both (a->b) and (b->a) directions exist where one side must appear
    # in the trie. Here pattern "color" contains "o": haystack "colour"
    # should match with the scored penalty.
    hay = ("pad " * 50) + "colour and color"
    _diff(eng, hay, 0.5)


def test_multibyte_edge_engines_decline():
    # Pattern containing a multi-byte char -> trie edge not single-byte ->
    # the lane declines statically and the oracle serves (results intact).
    eng = _build(["encyclopædia"], [("æ", "ae")])
    from fuzzy_aho_corasick_tpu.ops.verify_dp import mapped_spec_of

    assert mapped_spec_of(eng) is None
    dev = eng._device_engine()
    assert not dev.supports("x" * 100)
    ms = eng.search_raw(("x " * 40) + "encyclopaedia", 0.9)
    assert len(ms) == 1


def test_combining_mark_haystack_falls_back():
    # Haystack with a multi-code-point grapheme: the lane's class-identity
    # model doesn't hold, so the device path must internally serve it via
    # the oracle with identical results.
    eng = _build(["cafe"], [("é", "e")])
    hay = ("pad " * 40) + "café and cafe"  # 'é' as e + combining acute
    eng.backend = "device"
    dv = eng.search_raw(hay, 0.5)
    eng.backend = "oracle"
    orc = eng.search_raw(hay, 0.5)
    eng.backend = "auto"
    assert _key(dv) == _key(orc)


def test_mapped_differential_fuzz():
    rng = np.random.default_rng(1234)
    eng = _build(
        ["strasse", "weiss", "fussball", "aether"],
        [("ß", "ss"), ("æ", "ae")],
    )
    words = ["der", "die", "und", "mit", "straße", "strasse", "weiß",
             "wiess", "fußball", "æther", "aether", "wei", "ss", "ß"]
    for trial in range(12):
        n = int(rng.integers(40, 160))
        hay = " ".join(words[int(i)] for i in rng.integers(0, len(words), n))
        thr = float(rng.choice([0.45, 0.6, 0.75, 0.9]))
        _diff(eng, hay, thr)


def test_mapped_edits2_differential():
    eng = _build(["strasse", "grosse"], [("ß", "ss")], edits=2)
    hay = ("pad " * 50) + "straße grosze straze größe strasse"
    for thr in (0.4, 0.6, 0.8):
        _diff(eng, hay, thr)


def test_ascii_to_ascii_mapping():
    # Both sides ASCII (OCR confusion rn <-> m): pb=2/ha=1 and pb=1/ha=2.
    eng = _build(["modern"], [("rn", "m")])
    hay = ("pad " * 50) + "modem and modern and moderm"
    for thr in (0.5, 0.8):
        _diff(eng, hay, thr)
