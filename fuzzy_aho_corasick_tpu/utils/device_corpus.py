"""Device-resident corpus cache.

The deployment model keeps the corpus in device memory and runs many
searches against it (different engines, thresholds, options) — the analog of
the reference keeping the haystack in RAM across calls, so a repeated search
ships nothing but its compacted results over the host link.

``resident`` maps (haystack, symbol-space) -> a device uint8/int32 array of
transcoded symbol ids, padded to a bucketed static length (so kernels compile
once per bucket, not per corpus size). Keyed by the haystack's *content*
(sampled for multi-MB strings — see ``_content_key``); a full string
equality check guards against key collisions. LRU-evicted by
total device bytes.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Tuple

import numpy as np

#: Device memory assumed where the backend reports no limit (the CPU
#: platform the test suite runs on).
HOST_DEVICE_BYTES = 8 << 30
#: Smallest bucketed length (keeps tiny corpora off the recompile treadmill).
MIN_BUCKET = 1 << 16
#: Guaranteed dead-symbol tail past ``n`` in every resident buffer, so
#: kernels may read fixed-width windows starting anywhere < n without
#: clamping (the DP verify kernel slices ``Lmax + E <= 69`` symbols ahead).
TAIL_MARGIN = 128

_lru: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (hay, dev, n)
_held_bytes = 0

#: Above this length the cache key samples the content instead of hashing
#: all of it — ``hash(str)`` runs at ~1.5 GB/s and a streaming layer that
#: rebuilds superwindow strings per batch would pay it per search. Hits are
#: still verified by full string equality, so a sample collision costs one
#: memcmp, never correctness.
_SAMPLED_HASH_MIN = 1 << 20


#: Last (query str, entry str) PAIR verified (by full equality) per content
#: key — the LRU's collision guard memcmps ``hit[0] == haystack`` per key,
#: and a streaming pass that rebuilds one superwindow str touches 8+ slice
#: keys: 8 x 48 MiB memcmps (~40 ms) for one logical verification. One
#: memcmp per (object, object) pair instead; bounded alongside the LRU.
#: The pair matters: vouching for the content KEY alone would trust any
#: sibling/replaced entry under a colliding sampled hash. Both strs are
#: immutable, so identity of BOTH endpoints implies the memcmp'd equality.
_VERIFIED: "OrderedDict[tuple, tuple]" = OrderedDict()
_VERIFIED_MAX = 32


def _hit_fresh(hkey: tuple, stored, haystack: str) -> bool:
    """Whether ``stored`` (the LRU entry's haystack) matches ``haystack`` —
    by identity, by this exact pair's prior verification, or by one memcmp."""
    if stored is haystack:
        return True
    v = _VERIFIED.get(hkey)
    if v is not None and v[0] is haystack and v[1] is stored:
        return True
    if stored == haystack:
        _VERIFIED[hkey] = (haystack, stored)
        _VERIFIED.move_to_end(hkey)
        while len(_VERIFIED) > _VERIFIED_MAX:
            _VERIFIED.popitem(last=False)
        return True
    return False


def device_bytes() -> int:
    """Memory of the default device that JAX may allocate
    (``memory_stats()["bytes_limit"]``: on a GPU, the share of the card the
    process reserved at start-up)."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return HOST_DEVICE_BYTES
    return int(stats["bytes_limit"])


def capacity_bytes() -> int:
    """Device bytes the cache may hold before LRU eviction: an eighth of the
    device, which leaves the scan pipelines' transients (~64 bytes per
    symbol of the largest resident corpus) the rest."""
    return device_bytes() // 8


def _evict_to_capacity() -> None:
    """LRU-evict until under :func:`capacity_bytes`. Entries hold either one
    device array or a (ids, w32) pair (sliced residency) — handle both."""
    global _held_bytes
    cap = capacity_bytes()
    while _held_bytes > cap and len(_lru) > 1:
        _, (_, old_dev, _old_n) = _lru.popitem(last=False)
        if isinstance(old_dev, tuple):
            _held_bytes -= sum(a.size * a.dtype.itemsize for a in old_dev)
        else:
            _held_bytes -= old_dev.size * old_dev.dtype.itemsize
        del old_dev


def _content_key(haystack: str) -> tuple:
    n = len(haystack)
    if n < _SAMPLED_HASH_MIN:
        return (hash(haystack), n)
    mid = n >> 1
    return (
        hash((haystack[:2048], haystack[mid : mid + 2048], haystack[-2048:])),
        n,
    )


def bucket_len(n: int) -> int:
    """Smallest static length >= n of the form (8..15)/8 * 2^k (<= 12.5%
    overshoot, 8 compiled shapes per octave — the scan kernels do work
    proportional to the bucket, so overshoot is directly wasted throughput;
    every bucket stays a multiple of 2^(k-3) >= 8192, so the lane layouts'
    power-of-two lane counts divide it)."""
    b = MIN_BUCKET
    while b < n:
        p = 1 << (b.bit_length() - 1)  # containing power of two
        b += p // 8 if b != p else b // 8
    return b


def resident(
    haystack: str,
    space: tuple,
    transcode: Callable[[str], np.ndarray],
) -> Tuple[object, int]:
    """Device array of ``transcode(haystack)`` padded with zeros to
    ``bucket_len(n)``; ships at most once per (haystack content, space).

    ``space`` must identify the symbol mapping (e.g. an engine's packed
    alphabet id); zero must be a dead symbol in that space (the pad tail).
    Returns (device_array, n).
    """
    import jax

    global _held_bytes
    hkey = _content_key(haystack)
    key = hkey + (space,)
    hit = _lru.get(key)
    if hit is not None and _hit_fresh(hkey, hit[0], haystack):
        if hit[0] is not haystack:  # skip the memcmp for the sibling lookups
            _lru[key] = (haystack,) + hit[1:]
        _lru.move_to_end(key)
        return hit[1], hit[2]

    ids = transcode(haystack)
    n = len(ids)
    nb = bucket_len(max(n, 1) + TAIL_MARGIN)
    pad = np.zeros(nb, dtype=ids.dtype)
    pad[:n] = ids
    dev = jax.device_put(pad)

    nbytes = nb * ids.dtype.itemsize
    _held_bytes += nbytes
    _lru[key] = (haystack, dev, n)
    _evict_to_capacity()
    return dev, n


_pack_w32 = None


def resident_words(
    haystack: str,
    space: tuple,
    transcode: Callable[[str], np.ndarray],
) -> Tuple[object, object, int]:
    """Like :func:`resident` (uint8 spaces only) but also returns the
    corpus's u32-packed word view ``[nb/32, 8]`` as a second device-resident
    buffer.

    The banded DP's window fetch reads the corpus as aligned 32-byte rows of
    u32 words; packing once per corpus residency and caching keeps the
    whole-corpus ``bitcast_convert_type(u8[n/4, 4]) -> u32`` out of every
    search.
    """
    import jax
    import jax.numpy as jnp

    global _held_bytes, _pack_w32
    ids, n = resident(haystack, space, transcode)
    hkey = _content_key(haystack)
    key = hkey + (("w32",) + space,)
    hit = _lru.get(key)
    if hit is not None and _hit_fresh(hkey, hit[0], haystack):
        if hit[0] is not haystack:
            _lru[key] = (haystack,) + hit[1:]
        _lru.move_to_end(key)
        return ids, hit[1], n

    if _pack_w32 is None:

        @jax.jit
        def _pack(i8):
            return jax.lax.bitcast_convert_type(
                i8.reshape(-1, 4), jnp.uint32
            ).reshape(-1, 8)

        _pack_w32 = _pack
    w32 = jax.block_until_ready(_pack_w32(ids))
    _held_bytes += w32.size * 4
    _lru[key] = (haystack, w32, n)
    _evict_to_capacity()
    return ids, w32, n


def resident_words_sliced(
    haystack: str,
    space: tuple,
    transcode: Callable[[str], np.ndarray],
    bounds: Tuple[Tuple[int, int], ...],
    pad_len: int,
    words: bool = True,
):
    """Overlapping corpus *slices* as device buffers (uint8 spaces only).

    ``bounds`` is a tuple of ``(base, local_n)`` grapheme ranges —
    ``ids[base : base + local_n]`` zero-padded to the common static
    ``pad_len`` (multiple of 32, so the u32 word view packs cleanly).
    Transcodes the whole haystack at most once per (content, space) miss and
    ships each slice at most once. Returns ``[(ids_dev, w32_dev), ...]``, or
    ``[ids_dev, ...]`` when ``words`` is False (a space only the scan reads).

    The sliced fuzzy pipeline (ops/verify_dp.fuzzy_search_dp) uses this to
    dispatch one kernel per slice with identical static shapes, overlapping
    slice *i*'s device compute with slice *i-1*'s result readback.
    """
    import jax

    global _held_bytes, _pack_w32
    res: list = [None] * len(bounds)
    missing = []
    hkey = _content_key(haystack)
    for i, (base, ln) in enumerate(bounds):
        key = hkey + (space, "sl", base, ln, pad_len, words)
        hit = _lru.get(key)
        if hit is not None and _hit_fresh(hkey, hit[0], haystack):
            if hit[0] is not haystack:
                _lru[key] = (haystack,) + hit[1:]
            _lru.move_to_end(key)
            res[i] = hit[1]
        else:
            missing.append(i)
    if not missing:
        return res

    if _pack_w32 is None:
        import jax.numpy as jnp

        @jax.jit
        def _pack(i8):
            return jax.lax.bitcast_convert_type(
                i8.reshape(-1, 4), jnp.uint32
            ).reshape(-1, 8)

        globals()["_pack_w32"] = _pack
        _pack_w32 = _pack

    ids_full = transcode(haystack)
    assert ids_full.dtype == np.uint8, "sliced residency is uint8-space only"
    for i in missing:
        base, ln = bounds[i]
        pad = np.zeros(pad_len, dtype=np.uint8)
        pad[:ln] = ids_full[base : base + ln]
        dev = jax.device_put(pad)
        entry = (dev, _pack_w32(dev)) if words else dev
        res[i] = entry
        _held_bytes += pad_len * (5 if words else 1)  # u8 ids (+ u32 view)
        _lru[hkey + (space, "sl", base, ln, pad_len, words)] = (haystack, entry, ln)
    _evict_to_capacity()
    return res


def clear() -> None:
    """Drop every cached device buffer (tests / memory pressure)."""
    global _held_bytes
    _lru.clear()
    _VERIFIED.clear()
    _held_bytes = 0
