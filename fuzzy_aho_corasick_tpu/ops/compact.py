"""Compile-light device compaction primitives.

These were written so that compaction compiles fast and avoids a serial
cumsum and a data-sized scatter (each scan pipeline has several, and
capacity retries recompile them). They use only matmuls, slices, and
gathers; whether XLA's own ``argwhere``/``cumsum`` do better on the GPU has
not been measured:

* :func:`cumsum_i32` — inclusive prefix sum as 128-wide blocked matmuls
  against a triangular ones matrix, with f32 accumulation kept exact by
  construction (every 128-block partial sum stays < 2^24 for flag-like
  inputs up to 2^28 elements; ``Precision.HIGHEST`` keeps the product out of
  TF32).
* :func:`compact_indices` — stream compaction (``argwhere`` equivalent) via
  ``searchsorted`` over the prefix sum: a binary-search *gather* per output
  slot instead of a data-sized scatter.
* :func:`dilate_any` — windowed any() (hit dilation) by logarithmic shifted
  ORs instead of a prefix-sum difference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_TRI = None
INT32_MAX_C = np.int32(2**31 - 1)


def _tri():
    """Upper-triangular ones U[k, j] = 1 for k <= j, so (x @ U) is an
    inclusive prefix sum along the row."""
    global _TRI
    if _TRI is None:
        _TRI = np.triu(np.ones((128, 128), np.float32))
    return jnp.asarray(_TRI)


def cumsum_i32(x: jax.Array) -> jax.Array:
    """Inclusive prefix sum of int32 flags (values 0/1; exact for any input
    whose every 128-block partial sum < 2^24). Supports n <= 2^28."""
    n = x.shape[0]
    if n <= 16384:
        return jnp.cumsum(x, dtype=jnp.int32)
    assert n <= (1 << 28), "cumsum_i32 supports at most 2^28 elements"
    pad = (-n) % 128
    y = jnp.pad(x, (0, pad)).reshape(-1, 128).astype(jnp.float32)
    intra = jnp.dot(y, _tri(), precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    rows = intra[:, -1]
    offs = cumsum_i32(rows)
    offs_excl = jnp.concatenate([jnp.zeros(1, jnp.int32), offs[:-1]])
    return (intra + offs_excl[:, None]).reshape(-1)[:n]


def _bsearch_left(c: jax.Array, q: jax.Array) -> jax.Array:
    """Leftmost index where ``c[idx] >= q`` for sorted (non-decreasing) int32
    ``c``, as a 128-ary block descent instead of a binary search.

    A binary search costs log2(n) *sequential* gather ops (21-26 at corpus
    sizes). Here each level gathers one aligned 128-wide row per query and
    counts ``row < q`` lanes, so an n-element search costs ceil(log128(n))
    ~= 2-4 row-gather ops total.

    Level tables hold the cumsum at each 128-block's END; the count of block
    ends ``< q`` is the index of the leftmost block whose end is ``>= q`` —
    exactly the block containing the leftmost answer."""
    n = c.shape[0]
    if n <= 128:
        pad = jnp.full((128 - n,), INT32_MAX_C, c.dtype)
        row = jnp.concatenate([c, pad])
        return (row[None, :] < q[:, None]).sum(axis=1, dtype=jnp.int32)

    # Build levels bottom-up: level[0] = c; level[k+1][i] = level[k][i*128+127].
    levels = [c]
    while levels[-1].shape[0] > 128:
        prev = levels[-1]
        m = prev.shape[0]
        nb = -(-m // 128)
        ends = jnp.pad(prev, (0, nb * 128 - m), constant_values=INT32_MAX_C)
        levels.append(ends.reshape(nb, 128)[:, -1])

    # Top level: broadcast compare (<= 128 entries).
    top = levels[-1]
    t = top.shape[0]
    top_p = jnp.pad(top, (0, 128 - t), constant_values=INT32_MAX_C)
    idx = (top_p[None, :] < q[:, None]).sum(axis=1, dtype=jnp.int32)

    # Descend: gather the 128-row of the chosen block, count lanes < q.
    for lvl in levels[-2::-1]:
        m = lvl.shape[0]
        nb = -(-m // 128)
        rows = jnp.pad(lvl, (0, nb * 128 - m), constant_values=INT32_MAX_C)
        rows = rows.reshape(nb, 128)
        picked = rows[jnp.minimum(idx, nb - 1)]                 # [K, 128]
        idx = idx * 128 + (picked < q[:, None]).sum(axis=1, dtype=jnp.int32)
    return jnp.minimum(idx, n)


def compact_indices(flags: jax.Array, K: int):
    """Positions of set flags, compacted into ``K`` slots.

    Returns ``(count, idx)`` where ``idx[j]`` is the position of the j-th set
    flag (ascending) and slots past ``count`` are -1. ``count`` may exceed
    ``K`` — the caller detects overflow and retries with a larger ``K``.
    """
    c = cumsum_i32(flags.astype(jnp.int32))
    count = c[-1]
    q = jnp.arange(1, K + 1, dtype=jnp.int32)
    pos = _bsearch_left(c, q)
    return count, jnp.where(q <= count, pos, -1)


def dilate_any(flags: jax.Array, span: int) -> jax.Array:
    """``out[i] = any(flags[i : i + span])`` for int32/bool flags (static span)."""
    if span <= 1:
        return flags
    f = flags
    d = 1
    while d < span:
        s = min(d, span - d)
        f = f | jnp.concatenate([f[s:], jnp.zeros((s,), f.dtype)])
        d += s
    return f
