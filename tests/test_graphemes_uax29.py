"""The in-repo UAX #29 extended-grapheme segmenter (utils/graphemes) on
hand-written cases, and against the ``regex`` module's ``\\X`` (which the
property tables were generated from) over every code point."""

import pytest

from fuzzy_aho_corasick_tpu.utils import _grapheme_tables as gt
from fuzzy_aho_corasick_tpu.utils.graphemes import grapheme_len, graphemes

CASES = [
    ("a\r\nb", ["a", "\r\n", "b"]),                          # GB3
    ("\n\r", ["\n", "\r"]),                                  # GB4/GB5
    ("é̂x", ["é̂", "x"]),              # combining marks
    ("कि", ["कि"]),                      # SpacingMark
    ("؀a", ["؀a"]),                                # Prepend
    ("\U0001F468‍\U0001F469‍\U0001F467",            # ZWJ family
     ["\U0001F468‍\U0001F469‍\U0001F467"]),
    ("\U0001F44D\U0001F3FD!", ["\U0001F44D\U0001F3FD", "!"]),  # skin tone
    ("a‍\U0001F600", ["a‍", "\U0001F600"]),        # no GB11 base
    ("\U0001F1FA\U0001F1F8\U0001F1EB\U0001F1F7\U0001F1E9",   # RI pairs
     ["\U0001F1FA\U0001F1F8", "\U0001F1EB\U0001F1F7", "\U0001F1E9"]),
    ("각가", ["각", "가"]),  # Hangul
    ("각ᆨ", ["각ᆨ"]),                      # LVT x T
    ("क्ष", ["क्ष"]),          # Indic conjunct
    ("क्‍ष", ["क्‍ष"]),
    ("क़्षa", ["क़्ष", "a"]),
    ("कष", ["क", "ष"]),                  # no linker
    ("", []),
]


@pytest.mark.parametrize("text,want", CASES)
def test_hand_written_cases(text, want):
    assert graphemes(text) == want
    assert grapheme_len(text) == len(want)


def _samples():
    """Code points of every distinct property code (first and last of each
    code's ranges)."""
    by_code = {}
    for start, end, code in zip(gt.STARTS, gt.STARTS[1:] + (0x110000,), gt.CODES):
        lo_hi = by_code.setdefault(code, [start, end - 1])
        lo_hi[1] = end - 1
    return [chr(c) for pair in by_code.values() for c in pair]


def test_pairs_and_triples_of_property_classes_match_regex():
    regex = pytest.importorskip("regex")
    X = regex.compile(r"\X")
    s = _samples()
    for a in s:
        for b in s:
            assert graphemes(a + b) == X.findall(a + b), (a, b)
            for c in s[::3]:
                t = a + b + c
                assert graphemes(t) == X.findall(t), (a, b, c)


def test_every_code_point_matches_regex():
    """Each code point before and after each property class (one long string
    per class keeps the check to a few seconds)."""
    regex = pytest.importorskip("regex")
    X = regex.compile(r"\X")
    every = list(map(chr, range(0x110000)))
    for r in _samples()[::2]:
        text = r.join(every)
        assert graphemes(text) == X.findall(text), hex(ord(r))
