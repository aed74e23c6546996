"""Device-path conformance: the device kernels must reproduce the host oracle
exactly (SURVEY §7 differential-gating; pattern of reference
src/prefilter.rs:437-529's differential fuzz, applied device-vs-oracle)."""

import numpy as np
import pytest

import fuzzy_aho_corasick_tpu.ops.fuzzy as fuzzy_mod
from fuzzy_aho_corasick_tpu import (
    FuzzyAhoCorasickBuilder,
    FuzzyLimits,
    FuzzyPenalties,
    Pattern,
    SearchOptions,
)

# Small dispatch chunks keep per-shape compiles fast in CI.
fuzzy_mod.NCHUNK = 512


class Rng:
    def __init__(self, seed):
        self.s = seed & 0xFFFFFFFFFFFFFFFF

    def next(self):
        x = self.s
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = x
        return x


def full_key(m):
    return (
        m.start, m.end, m.pattern_index, float(np.float32(m.similarity)),
        m.edits, m.insertions, m.deletions, m.substitutions, m.swaps,
    )


def span_key(m):
    """Tie-level edit breakdowns may differ between backends when two edit
    paths produce bit-equal similarity; the match tuple itself may not."""
    return (m.start, m.end, m.pattern_index, float(np.float32(m.similarity)))


def compare(engine, hay, thr, key=full_key):
    engine.backend = "oracle"
    a = sorted(map(key, engine.search_raw(hay, thr)))
    engine.backend = "device"
    assert engine._device_engine().supports(hay), "config should be device-eligible"
    b = sorted(map(key, engine.search_raw(hay, thr)))
    engine.backend = "auto"
    assert a == b, f"device/oracle mismatch thr={thr} hay={hay!r}\n  oracle={a}\n  device={b}"


def test_exact_device_parity():
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).build(
        ["hello", "world", "JOINT STOCK COMPANY", "STOCK", ("weighty", 0.4)]
    )
    for thr in [0.0, 0.39999, 0.4, 0.8, 1.0]:
        compare(engine, "hello WORLD the JOINT STOCK COMPANY of stock weighty", thr)


def test_exact_device_parity_unicode():
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).build(["café", "Ωμέγα"])
    compare(engine, "un CAFÉ et ωμέγα voilà", 0.5)


def test_fuzzy_device_parity_basic():
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(["hello", "world"])
    )
    for thr in [0.5, 0.8, 0.9]:
        compare(engine, "helllo wolrd and hxllo worl hello", thr)


def test_fuzzy_device_parity_e2():
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(2))
        .case_insensitive(True)
        .build(["saddam", "hussein"])
    )
    for thr in [0.5, 0.7]:
        compare(engine, "saddamhusein and sadammhussien", thr, key=span_key)


def test_fuzzy_device_weights_and_floor():
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .min_symbol_similarity(0.3)
        .build([("vestibulum", 1.0), ("lorem", 1.5)])
    )
    for thr in [0.4, 0.8]:
        compare(engine, "vxstibulum vestibulom l0rem lorem", thr)


def test_fuzzy_device_custom_penalties():
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(2))
        .penalties(FuzzyPenalties.default().with_insertion(0.3).with_deletion(0.6).with_swap(0.2))
        .build(["pattern", "matcher"])
    )
    compare(engine, "patern matcchr pattren", 0.5, key=span_key)


def test_fuzzy_device_fuzz():
    """Randomized differential device-vs-oracle (reduced-size CI variant)."""
    rng = Rng(0xFACADE)
    vocab = ["hello", "world", "help", "shell", "yellow", "cell"]
    filler = ["a", "b", "e", "h", "l", "o", " ", "0", "1"]
    # Single engine shape -> one kernel compile.
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(vocab)
    )
    for trial in range(15):
        length = 5 + rng.next() % 40
        hay = []
        for _ in range(length):
            if rng.next() % 6 == 0:
                hay.append(vocab[rng.next() % len(vocab)])
            else:
                hay.append(filler[rng.next() % len(filler)])
        hay = "".join(hay)
        thr = 0.5 + (rng.next() % 5) * 0.1
        compare(engine, hay, thr, key=span_key)


def test_device_eligibility_fallbacks():
    """Configs outside the kernel envelope must quietly use the oracle."""
    # Mapped engines with single-byte tries now take the mapped DP lane
    # (ops/verify_dp.MappedSpec); results stay oracle-identical.
    mapped = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .mapping("ae", "æ")
        .build(["caesar"])
    )
    assert mapped._device_engine()._mapped_ok
    assert mapped._device_engine().supports("caesar")
    assert len(mapped.search("cæsar", SearchOptions.new().with_threshold(0.9))) == 1
    # ... but a multi-byte trie edge (non-ASCII pattern char) declines.
    mapped_mb = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .mapping("ae", "æ")
        .build(["cæsar"])
    )
    assert not mapped_mb._device_engine().supports("caesar")
    assert len(mapped_mb.search("caesar", SearchOptions.new().with_threshold(0.9))) == 1

    # Per-type caps now take the typed device path (ops/verify_dp.TypedSpec)
    # rather than falling back to the oracle.
    per_type = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().substitutions(1))
        .build(["abc"])
    )
    assert per_type._device_engine()._typed_ok
    assert per_type._device_engine().supports("abc")

    # Beamed engines are now served by the exact DP lanes on the device
    # (beams bound the host frontier; the DP has none to bound).
    beamed = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .beam_width(10)
        .build(["abc"])
    )
    assert beamed._device_engine()._beamed
    assert beamed._device_engine().supports("abc")


def test_fuzzy_device_filtered_large_input():
    """Corpus above FILTER_MIN_N routes through the bitap anchor filter; the
    result set must be unchanged."""
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(["needle", "anchor"])
    )
    filler = "the quick brown fox jumps over the lazy dog "
    parts = []
    for i in range(500):
        parts.append(filler[: 20 + (i * 7) % 24])
        parts.append(["needle", "anchro", "nedle", "xxxxx"][i % 4])
    hay = " ".join(parts)
    assert len(hay) > fuzzy_mod.FILTER_MIN_N
    cand = fuzzy_mod._candidate_starts(
        engine, hay, None, len(engine.dense.transcode(hay)), np.float32(0.8)
    )
    assert 0 < len(cand) < len(hay), "filter should prune most anchors"
    compare(engine, hay, 0.8, key=span_key)


def test_fuzzy_device_seed_filter_1k_dictionary():
    """Large dictionaries route through the seed-partition filter; results
    must equal the oracle."""
    rng = Rng(0x5EED)
    alphabet = "abcdefghijklmnop"
    words = []
    for i in range(300):
        m = 6 + rng.next() % 6
        words.append("".join(alphabet[rng.next() % len(alphabet)] for _ in range(m)))
    words = sorted(set(words))
    assert len(words) > fuzzy_mod.FILTER_MAX_PATTERNS
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(words)
    )
    parts = []
    for i in range(1800):
        w = words[(i * 17) % len(words)]
        if i % 3 == 0:
            w = w[:2] + "z" + w[3:]  # one substitution
        parts.append(w)
        parts.append(" " * (1 + i % 3))
    hay = "".join(parts)
    assert len(hay) > fuzzy_mod.FILTER_MIN_N
    from fuzzy_aho_corasick_tpu.ops.seeds import SeedFilter

    sf = SeedFilter.build(engine)
    assert sf is not None
    cand = sf.candidate_starts(hay, len(hay))
    assert 0 < len(cand) <= len(hay)
    compare(engine, hay, 0.8, key=span_key)


def test_unicode_deadend_filter_parity():
    """Reference quirk (bug-for-bug parity): the last-edit dead-end filter
    credits only SINGLE-byte edges (src/structs.rs:471-476), so a one-edit
    'éllo' never matches 'héllo' — the multi-byte 'é' edge that would
    advance does not rescue the state (src/search.rs:839-847, 1050-1063).
    The device kernels must drop exactly the same states (ops/dense.py
    sb_edge); round 1 emitted extra Unicode matches here."""
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(["héllo", "wörld"])
    )
    filler = "àbçdé fgh íjk " * 11
    hay = ""
    for i in range(80):
        hay += filler[: 4 + (i * 13) % 100] + ("héllo" if i % 2 else "wörlt")
    # ASCII control: the same shape with single-byte edges DOES emit the
    # leading-deletion match.
    eng_a = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(["hello"])
    )
    eng_a.backend = "oracle"
    spans_a = {(m.start, m.end) for m in eng_a.search_raw("xx ello yy", 0.7)}
    assert (3, 7) in spans_a  # 'ello' via leading deletion
    engine.backend = "oracle"
    truth = engine.search_raw(hay, 0.7)
    assert all(m.text != "éllo" for m in truth)  # the reference quirk
    compare(engine, hay, 0.7, key=span_key)
