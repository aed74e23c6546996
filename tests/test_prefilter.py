"""Prefilter conformance: differential fuzz vs the full engine
(reference src/prefilter.rs:437-562), plus the chunked-vs-scalar bitap
equivalence the device kernel relies on."""

import numpy as np

from fuzzy_aho_corasick_tpu import (
    FuzzyAhoCorasickBuilder,
    FuzzyLimits,
    FuzzyPenalties,
    SearchOptions,
)
from fuzzy_aho_corasick_tpu.ops.bitap import bitap_windows, bitap_windows_chunked


class Rng:
    """Deterministic xorshift (reference src/prefilter.rs:442-452)."""

    def __init__(self, seed):
        self.s = seed & 0xFFFFFFFFFFFFFFFF

    def next(self):
        x = self.s
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self.s = x
        return x


def key(m):
    return (m.start, m.end, m.pattern_index, float(np.float32(m.similarity)), m.edits)


def differential(seed, vocab, filler, trials):
    """Assert the pre-filter reproduces the full search exactly across random
    configs and inputs (reference src/prefilter.rs:467-529)."""
    rng = Rng(seed)
    for trial in range(trials):
        npat = 1 + rng.next() % 3
        patterns = [vocab[rng.next() % len(vocab)] for _ in range(npat)]
        edits = rng.next() % 3
        case_insensitive = rng.next() & 1 == 0

        builder = FuzzyAhoCorasickBuilder.new().case_insensitive(case_insensitive)
        if edits > 0:
            builder = builder.fuzzy(FuzzyLimits.new().edits(edits))
        if trial % 5 == 0:
            builder = builder.penalties(
                FuzzyPenalties.default().with_swap(0.6).with_insertion(0.5).with_deletion(0.8)
            )
        engine = builder.build(patterns)
        pf = engine.with_prefilter()

        length = rng.next() % 40
        hay = []
        for _ in range(length):
            if rng.next() % 7 == 0:
                hay.append(patterns[rng.next() % len(patterns)])
                hay.append(" ")
            else:
                hay.append(filler[rng.next() % len(filler)])
        hay = "".join(hay)

        threshold = 0.6 + (rng.next() % 4) * 0.1
        opts = SearchOptions.new().with_threshold(threshold)
        expected = sorted(key(m) for m in engine.search(hay, opts))
        got = sorted(key(m) for m in pf.search(hay, opts))
        assert expected == got, (
            f"mismatch (trial {trial}): patterns={patterns} edits={edits} "
            f"ci={case_insensitive} threshold={threshold} hay={hay!r}"
        )


def test_prefilter_matches_full_search_ascii():
    vocab = ["hello", "world", "vestibulum", "abc", "lorem", "cell"]
    filler = ["a", "b", "c", "d", "e", " ", "1", "o", "0", "l"]
    differential(0x123456789ABCDEF1, vocab, filler, 250)


def test_prefilter_matches_full_search_unicode():
    vocab = ["café", "naïve", "Ωμέγα", "Москва", "señor", "école"]
    filler = ["a", "é", "ñ", "ω", "м", " ", "o", "0", "é"]
    differential(0xDEADBEEF0BADF00D, vocab, filler, 250)


def test_falls_back_when_not_reducible():
    engine = FuzzyAhoCorasickBuilder.new().mapping("ae", "æ").build(["caesar"])
    assert not engine.with_prefilter().is_active()

    engine = FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1)).build(["caesar"])
    assert engine.with_prefilter().is_active()


def test_chunked_bitap_equals_scalar():
    """The halo decomposition the device kernel uses must reproduce the scalar
    recurrence exactly: same candidate-window set for random streams."""
    rng = Rng(0xC0FFEE)
    for trial in range(40):
        m = 1 + rng.next() % 20
        k = rng.next() % 4
        alphabet = 1 + rng.next() % 6
        # Random mask: each pattern position assigned a random symbol.
        mask = np.zeros(alphabet + 1, dtype=np.uint64)
        for i in range(m):
            sym = 1 + rng.next() % alphabet
            mask[sym] |= np.uint64(1) << np.uint64(i)
        n = 500 + rng.next() % 3000
        ids = np.array([rng.next() % (alphabet + 1) for _ in range(n)], dtype=np.uint8)

        a, b = [], []
        bitap_windows(mask, m, k, ids, a)
        bitap_windows_chunked(mask, m, k, ids, b, chunk=256)
        assert sorted(set(a)) == sorted(set(b)), f"trial {trial}: m={m} k={k}"


def test_damerau_bitap_impls_agree():
    """Scalar, chunked, and native-C Damerau recurrences produce the same
    window set (the host analog of the packed kernel's pending-transposition
    rows)."""
    from fuzzy_aho_corasick_tpu.utils import native

    rng = Rng(0xFACADE)
    for trial in range(40):
        m = 2 + rng.next() % 19
        k = rng.next() % 3
        alphabet = 1 + rng.next() % 6
        mask = np.zeros(alphabet + 1, dtype=np.uint64)
        for i in range(m):
            sym = 1 + rng.next() % alphabet
            mask[sym] |= np.uint64(1) << np.uint64(i)
        n = 500 + rng.next() % 2000
        ids = np.array([rng.next() % (alphabet + 1) for _ in range(n)], dtype=np.uint8)

        a, b = [], []
        bitap_windows(mask, m, k, ids, a, damerau=True)
        bitap_windows_chunked(mask, m, k, ids, b, chunk=256, damerau=True)
        assert sorted(set(a)) == sorted(set(b)), f"trial {trial}: m={m} k={k}"
        hits = native.bitap_scan_hits(mask, m, k, ids, damerau=True)
        if hits is not None:
            span = m + k
            c = [(max(int(e) + 1 - span, 0), int(e) + 1) for e in np.nonzero(hits)[0]]
            assert sorted(set(a)) == sorted(set(c)), f"trial {trial} (native)"


def _damerau_distance(a: str, b: str) -> int:
    """Brute-force restricted Damerau-Levenshtein (optimal string alignment)."""
    la, lb = len(a), len(b)
    d = [[0] * (lb + 1) for _ in range(la + 1)]
    for i in range(la + 1):
        d[i][0] = i
    for j in range(lb + 1):
        d[0][j] = j
    for i in range(1, la + 1):
        for j in range(1, lb + 1):
            cost = 0 if a[i - 1] == b[j - 1] else 1
            d[i][j] = min(d[i - 1][j] + 1, d[i][j - 1] + 1, d[i - 1][j - 1] + cost)
            if i > 1 and j > 1 and a[i - 1] == b[j - 2] and a[i - 2] == b[j - 1]:
                d[i][j] = min(d[i][j], d[i - 2][j - 2] + 1)
    return d[la][lb]


def test_damerau_bitap_vs_bruteforce_dp():
    """Every substring within Damerau distance k of the pattern must produce
    a scan hit at its end position (soundness: the filter may over-admit,
    never under-admit) — the host analog of the bitap_prototype fuzz
    (reference examples/bitap_prototype.rs:97-120)."""
    rng = Rng(0xB17A9)
    for trial in range(120):
        m = 2 + rng.next() % 8
        k = rng.next() % 3
        alphabet = 2 + rng.next() % 3
        pat = "".join(chr(97 + rng.next() % alphabet) for _ in range(m))
        mask = np.zeros(alphabet + 1, dtype=np.uint64)
        for i, ch in enumerate(pat):
            mask[ord(ch) - 96] |= np.uint64(1) << np.uint64(i)
        n = 60 + rng.next() % 100
        text = "".join(chr(97 + rng.next() % alphabet) for _ in range(n))
        ids = np.array([ord(c) - 96 for c in text], dtype=np.uint8)

        out = []
        bitap_windows(mask, m, k, ids, out, damerau=True)
        hit_ends = {e for _, e in out}
        for end in range(1, n + 1):
            best = min(
                _damerau_distance(pat, text[s:end])
                for s in range(max(0, end - m - k), end + 1)
            )
            if best <= k:
                assert end in hit_ends, (
                    f"trial {trial}: pat={pat} k={k} end={end} "
                    f"window={text[max(0, end - m - k):end]!r} missed"
                )


def test_prefiltered_routes_to_device_on_large_inputs():
    """The Prefiltered fast lane IS the device pipeline when eligible: the
    packed shift-AND prefilter is fused into the kernels
    (reference prefilter.rs:304-374 -> ops/packed_bitap + ops/verify_dp)."""
    from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits, SearchOptions

    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(["needle", "pattern"])
    )
    hay = ("filler words here " * 40 + "nedle pattren ") * 60
    assert len(hay) >= engine.AUTO_DEVICE_MIN
    opts = SearchOptions.new().with_threshold(0.8).sorted().non_overlapping()
    pf = engine.with_prefilter()
    assert pf.is_active()
    got = [(m.start, m.end, m.pattern_index) for m in pf.search(hay, opts)]
    assert engine.last_stats["backend"].startswith("device"), engine.last_stats
    truth = [(m.start, m.end, m.pattern_index) for m in engine.search(hay, opts)]
    assert got == truth
    assert len(got) >= 60
