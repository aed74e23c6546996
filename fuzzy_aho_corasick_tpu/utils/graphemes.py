"""Grapheme segmentation, case folding, and transcoding (host side).

Counterpart of the reference's grapheme layer
(reference: src/grapheme.rs, src/search.rs:398-416, src/prefilter.rs:251-281).
The device only ever sees dense integer symbol streams produced here; all
Unicode handling stays on the host.

Two paths, mirroring the reference's monomorphized storage:

* **ASCII fast path** (reference src/grapheme.rs:76-125): every byte of an
  all-ASCII haystack is its own grapheme; case folding is ``byte | 0x20`` for
  letters. Transcoding is a single vectorized table lookup over the byte
  array — no segmentation, no hashing.
* **Unicode path** (reference src/search.rs:398-416): extended grapheme
  clusters by the UAX #29 rules (the same definition as the reference's
  ``unicode-segmentation`` crate), evaluated vectorized over the code
  points with the property tables of ``_grapheme_tables`` (generated by
  tools/gen_grapheme_tables.py); lowercased per grapheme when
  case-insensitive.
"""

from __future__ import annotations

import numpy as np

from . import _grapheme_tables as _gt

# Vectorized ASCII lower-case table: byte -> folded byte.
_ASCII_LOWER = np.arange(256, dtype=np.uint8)
_ASCII_LOWER[ord("A") : ord("Z") + 1] += 32

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L, _V,
 _T, _LV, _LVT) = range(len(_gt.GCB))
_INCB_CONSONANT, _INCB_EXTEND, _INCB_LINKER = 1, 2, 3

#: Dense property code per code point (uint8 [0x110000]), built on first use.
_PROPS = None


def _props() -> np.ndarray:
    global _PROPS
    if _PROPS is None:
        starts = np.asarray(_gt.STARTS + (0x110000,), dtype=np.int64)
        _PROPS = np.repeat(
            np.asarray(_gt.CODES, dtype=np.uint8), np.diff(starts)
        )
    return _PROPS


def _code_points(text: str) -> np.ndarray:
    return np.frombuffer(
        text.encode("utf-32-le", "surrogatepass"), dtype=np.uint32
    )


def _last_index_where(mask: np.ndarray) -> np.ndarray:
    """out[i] = the largest j <= i with mask[j], or -1."""
    idx = np.where(mask, np.arange(len(mask)), -1)
    return np.maximum.accumulate(idx) if len(idx) else idx


def _breaks(cps: np.ndarray) -> np.ndarray:
    """bool [n]: a cluster boundary before code point i (UAX #29 GB1-GB999;
    the boundary before i = 0 is always set)."""
    n = len(cps)
    out = np.ones(n, dtype=bool)
    if n < 2:
        return out
    code = _props()[cps]
    gcb = code & 15
    ep = (code & _gt.EP_BIT) != 0
    incb = code >> _gt.INCB_SHIFT
    p, c = gcb[:-1], gcb[1:]
    ctl = lambda g: (g == _CONTROL) | (g == _CR) | (g == _LF)
    keep = (
        ((p == _L) & ((c == _L) | (c == _V) | (c == _LV) | (c == _LVT)))  # GB6
        | (((p == _LV) | (p == _V)) & ((c == _V) | (c == _T)))           # GB7
        | (((p == _LVT) | (p == _T)) & (c == _T))                        # GB8
        | (c == _EXTEND) | (c == _ZWJ)                                   # GB9
        | (c == _SPACING)                                                # GB9a
        | (p == _PREPEND)                                                # GB9b
    )
    # GB9c: InCB=Consonant [Extend|Linker]* Linker [Extend|Linker]* x Consonant
    ext_link = (incb == _INCB_EXTEND) | (incb == _INCB_LINKER)
    head = _last_index_where(~ext_link)[:-1]       # run start before i, -1
    linkers = np.cumsum(incb == _INCB_LINKER)
    has_linker = linkers[:-1] - np.where(head >= 0, linkers[np.maximum(head, 0)], 0) > 0
    keep |= (
        (incb[1:] == _INCB_CONSONANT) & has_linker & (head >= 0)
        & (incb[np.maximum(head, 0)] == _INCB_CONSONANT)
    )
    # GB11: ExtPict Extend* ZWJ x ExtPict
    pict = _last_index_where(gcb != _EXTEND)       # before the ZWJ: i - 2
    q = np.concatenate([[-1], pict[:-2]])
    keep |= (p == _ZWJ) & ep[1:] & (q >= 0) & ep[np.maximum(q, 0)]
    # GB12/13: break between RIs only after an even-length run of them.
    run = np.arange(n) - _last_index_where(gcb != _RI)
    keep |= (p == _RI) & (c == _RI) & (run[:-1] % 2 == 1)
    brk = np.where(ctl(p) | ctl(c), True, ~keep)                 # GB4, GB5
    brk &= ~((p == _CR) & (c == _LF))                            # GB3
    out[1:] = brk
    return out


def graphemes(text: str) -> list[str]:
    """Split ``text`` into extended grapheme clusters (UAX #29).

    Matches the reference's ``UnicodeSegmentation::graphemes(s, true)``.
    """
    if not text:
        return []
    b = np.flatnonzero(_breaks(_code_points(text))).tolist()
    b.append(len(text))
    return [text[i:j] for i, j in zip(b, b[1:])]


def grapheme_len(text: str) -> int:
    """Number of extended grapheme clusters in ``text``."""
    if text.isascii():
        # The reference counts pattern graphemes with full segmentation even
        # for ASCII (CRLF is one cluster), so only pure single-byte counting
        # when no '\r' is present.
        if "\r" not in text:
            return len(text)
    if not text:
        return 0
    return int(_breaks(_code_points(text)).sum())


#: Grapheme_Cluster_Break values of "singleton" code points: one always forms
#: its own extended grapheme cluster next to any other singleton (no GB6-GB13
#: rule joins two of them; CR is excluded because CR+LF is one cluster).
_SINGLETON_GCB = np.ones(16, dtype=bool)
_SINGLETON_GCB[[_CR, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L, _V, _T]] = False


def _all_singletons(cps: "np.ndarray") -> bool:
    """True when every code point is a grapheme singleton (see above) — the
    whole string then segments as one cluster per code point and the
    vectorized view path applies (Cyrillic, Greek, CJK, kana ... — anything
    without combining marks, joiners, jamo or emoji sequences)."""
    return bool(_SINGLETON_GCB[_props()[cps] & 15].all())


def fold_graphemes(text: str, case_insensitive: bool) -> list[str]:
    """Case-fold (when requested) + grapheme-split, matching the builder's trie
    construction (reference src/builder.rs:195-205, src/prefilter.rs:377-385).
    """
    gs = graphemes(text)
    if case_insensitive:
        return [g.lower() for g in gs]
    return gs


def is_ascii(text: str) -> bool:
    return text.isascii()


_VIEW_LRU: "dict[tuple, object]" = {}
_VIEW_LRU_MAX = 4
# Total *weighted* cached bytes: a non-ASCII view materializes per-grapheme
# Python lists that run ~10x the corpus size, so Unicode entries are charged
# 8x their length. Keeps cycling through large Unicode corpora from pinning
# multiple GB of host memory.
_VIEW_LRU_MAX_BYTES = 256 << 20


def _view_cost(view: "HaystackView") -> int:
    return len(view.haystack) * (1 if view.ascii else 8)


#: Identity-keyed registry of pre-built views (streaming superwindows):
#: skips the content hash entirely — hash(str) of a fresh 48 MiB batch str is
#: ~40 ms on the critical path. Entries keep their str alive, so an id()
#: cannot be reused while its entry lives; the `is` check rejects impostors.
_VIEW_BY_ID: "dict[int, HaystackView]" = {}
_VIEW_BY_ID_MAX = 8
# Registered superwindow views pin their str plus (often) a same-size seeded
# _bytes; a count-only cap of 8 could hold ~768 MiB of 48 MiB batches on the
# small-host testbed. Evict by accumulated weight like _VIEW_LRU.
_VIEW_BY_ID_MAX_BYTES = 192 << 20


def _registered_cost(view: "HaystackView") -> int:
    c = _view_cost(view)
    if view._bytes is not None:
        c += len(view._bytes)
    return c


def register_view(view: "HaystackView") -> None:
    """Pre-register a view for identity-based lookup (producer threads build
    views ahead of the search; see stream._PrepProducer)."""
    _VIEW_BY_ID[id(view.haystack)] = view
    while len(_VIEW_BY_ID) > 1 and (
        len(_VIEW_BY_ID) > _VIEW_BY_ID_MAX
        or sum(_registered_cost(v) for v in _VIEW_BY_ID.values())
        > _VIEW_BY_ID_MAX_BYTES
    ):
        _VIEW_BY_ID.pop(next(iter(_VIEW_BY_ID)))


def clear_registered_views() -> None:
    """Drop all identity-registered views (streaming drivers call this when a
    stream completes so finished superwindow batches don't stay pinned)."""
    _VIEW_BY_ID.clear()


def view_of(haystack: str, case_insensitive: bool) -> "HaystackView":
    """Small content-keyed LRU cache of :class:`HaystackView` instances.

    The device deployment model searches the same resident corpus many times
    (utils/device_corpus); a fresh view per search re-pays ``str.encode`` of
    the whole haystack (~20 ms / 100 MB) in the match decode and, for Unicode,
    the full segmentation pass. Keyed like the device-corpus cache —
    ``hash(str)`` is cached inside the str object, equality guards collisions.
    """
    v = _VIEW_BY_ID.get(id(haystack))
    if v is not None and v.haystack is haystack \
            and v.case_insensitive == case_insensitive:
        return v
    key = (hash(haystack), len(haystack), case_insensitive)
    hit = _VIEW_LRU.get(key)
    if hit is not None and (hit.haystack is haystack or hit.haystack == haystack):
        # True LRU: refresh recency so hot views survive eviction.
        _VIEW_LRU.pop(key)
        _VIEW_LRU[key] = hit
        return hit
    view = HaystackView(haystack, case_insensitive)
    _VIEW_LRU[key] = view
    # Evict oldest entries past either cap (never the one just inserted).
    while len(_VIEW_LRU) > 1 and (
        len(_VIEW_LRU) > _VIEW_LRU_MAX
        or sum(_view_cost(v) for v in _VIEW_LRU.values()) > _VIEW_LRU_MAX_BYTES
    ):
        _VIEW_LRU.pop(next(iter(_VIEW_LRU)))
    return view


class HaystackView:
    """A segmented, optionally case-folded view of a haystack.

    Unifies the reference's two ``GraphemeStorage`` implementations
    (src/grapheme.rs:33-125): exposes per-grapheme byte offsets, folded text,
    and folded first chars, with a zero-copy ASCII fast path.
    """

    __slots__ = (
        "haystack", "ascii", "case_insensitive", "_texts", "_offsets",
        "_chars", "_offsets_np", "_bytes", "_folded", "_folded_cps",
    )

    def __init__(self, haystack: str, case_insensitive: bool):
        self.haystack = haystack
        self.case_insensitive = case_insensitive
        self.ascii = haystack.isascii()
        self._offsets_np = None
        self._bytes = None
        self._folded = None
        self._folded_cps = None
        if self.ascii:
            self._texts = None
            self._offsets = None
            self._chars = None
            return
        # Single-code-point fast path: when every code point is a grapheme
        # SINGLETON (see :func:`_all_singletons` — Latin below U+0300 passes
        # trivially, and so do Cyrillic, Greek, CJK, kana: any script
        # without combining marks, joiners, jamo or emoji sequences in the
        # actual text), every code point IS one extended grapheme cluster —
        # segmentation becomes vectorized arithmetic instead of a per-cluster
        # pass. Case folding must also be
        # length-preserving (e.g. U+0130 lowers to two code points — falls
        # back to the general path).
        cps = _code_points(haystack)
        mx = int(cps.max(initial=0))
        if (
            (mx < 0x300 and "\r" not in haystack)
            or (mx >= 0x300 and _all_singletons(cps))
        ):
            folded = haystack.lower() if case_insensitive else haystack
            if len(folded) == len(haystack):
                self._texts = None
                self._chars = None
                self._folded = folded
                # UTF-8 length per code point; exclusive prefix sum =
                # inclusive cumsum minus the element (cumsum into a strided
                # out= slice hits a ~30x numpy slow path).
                blen = (
                    1 + (cps >= 0x80) + (cps >= 0x800) + (cps >= 0x10000)
                ).astype(np.int64)
                cs = np.cumsum(blen)
                cs -= blen
                self._offsets = cs
                return
        texts: list[str] = []
        offsets: list[int] = []
        pos = 0
        for g in graphemes(haystack):
            offsets.append(pos)
            pos += len(g.encode("utf-8"))
            if case_insensitive and not (g.isascii() and not any("A" <= c <= "Z" for c in g)):
                texts.append(g.lower())
            else:
                texts.append(g)
        self._texts = texts
        self._offsets = offsets
        self._chars = [t[0] if t else "\0" for t in texts]

    def __len__(self) -> int:
        if self.ascii or self._folded is not None:
            return len(self.haystack)
        return len(self._texts)

    def hay_bytes(self) -> bytes:
        """UTF-8 bytes of the (unfolded) haystack, encoded once per view —
        re-encoding costs ~18 ms per 100 MB and showed up in every search."""
        if self._bytes is None:
            self._bytes = self.haystack.encode("utf-8")
        return self._bytes

    def byte_offset(self, idx: int) -> int:
        """Byte offset of grapheme ``idx`` (reference src/grapheme.rs:36,57,96)."""
        if self.ascii:
            return idx
        return int(self._offsets[idx])

    def offsets_array(self, total_bytes: int):
        """np.int64 [n+1] byte offsets with a ``total_bytes`` sentinel at n —
        vectorized grapheme->byte conversion for match decode. None for the
        ASCII path (offsets are the identity there)."""
        if self.ascii:
            return None
        if self._offsets_np is None:
            self._offsets_np = np.concatenate(
                [np.asarray(self._offsets, dtype=np.int64), [total_bytes]]
            )
        return self._offsets_np

    def text(self, idx: int) -> str:
        """The (folded) grapheme at ``idx`` (reference src/grapheme.rs:61,100)."""
        if self.ascii:
            ch = self.haystack[idx]
            return ch.lower() if self.case_insensitive else ch
        if self._folded is not None:
            return self._folded[idx]
        return self._texts[idx]

    def first_char(self, idx: int) -> str:
        """First char of the folded grapheme at ``idx`` (src/grapheme.rs:65,111)."""
        if self.ascii:
            ch = self.haystack[idx]
            return ch.lower() if self.case_insensitive else ch
        if self._folded is not None:
            return self._folded[idx]
        return self._chars[idx]

    def chars(self) -> list[str]:
        """All folded first-chars, mirroring the reference's per-search
        ``text_chars`` cache (src/search.rs:203)."""
        if self.ascii:
            h = self.haystack
            return list(h.lower() if self.case_insensitive else h)
        if self._folded is not None:
            return list(self._folded)
        return list(self._chars)


def map_singleton_chars(view: "HaystackView", char_map, dtype=np.uint8):
    """Vectorized grapheme->id transcode for singleton-fast-path views
    (``view._folded`` set): builds a code-point lookup from ``char_map``
    (ids for its single-char keys, 0 otherwise) and gathers — the numpy form
    of the per-grapheme ``dict.get`` loop, ~50x faster on multi-MB Unicode
    corpora. Returns None when the view is not on the fast path."""
    if view._folded is None:
        return None
    cps = view._folded_cps
    if cps is None:
        cps = np.frombuffer(
            view._folded.encode("utf-32-le"), dtype=np.uint32
        )
        view._folded_cps = cps
    mx = int(cps.max(initial=0))
    tab = np.zeros(mx + 2, dtype=np.int32)
    for ch, cid in char_map.items():
        if len(ch) == 1:
            o = ord(ch)
            if o <= mx:
                tab[o] = cid
    return tab[cps].astype(dtype)


def transcode_ascii(haystack: str, table: np.ndarray) -> np.ndarray:
    """Map an all-ASCII haystack to a symbol-id stream via a 256-entry table.

    Vectorized equivalent of the reference's byte fast path
    (src/prefilter.rs:253-259). ``table`` must already encode case folding.
    """
    raw = np.frombuffer(haystack.encode("ascii"), dtype=np.uint8)
    return table[raw]
