"""Exact-match (edits = 0) anchored scan kernel — filter-first formulation.

The reference's per-start-position BFS degenerates, with no edit budget, to a
pure trie walk per start (reference src/search.rs:776-798: only the exact
transition fires). The device formulation exploits that almost every position
dies on the first symbol (the same observation behind the reference's 2-gram
window skip, src/search.rs:499-552):

1. **Root step as a one-hot matmul**: ``s1 = root_row[sym]`` over the ≤256
   char classes runs as a bf16 one-hot product with f32 accumulation (exact
   for byte planes; no gather) for every position, and it kills the ~95+%
   of positions with no pattern starting there. Whether a gather is faster
   on the GPU has not been measured.
2. **One compaction**: survivors are argwhere-compacted once per corpus row.
3. **Survivor walk**: only survivors run the remaining ``L-1`` goto-gather
   steps, so the slow XLA gather touches ~2-5% of the corpus.

The whole corpus ships in ONE dispatch as a ``[rows, CHUNK + L]`` uint8 tile
(per-row halo); ``lax.map`` walks rows on-device and each row emits compact
match tuples, so per-call host<->device round trips are O(1) per corpus.

Matches the oracle exactly, including the per-node prune ceiling
``0 > prune_len - prune_len_over_weight * thr`` which can drop a match whose
similarity ties the threshold (f32 rounding — reference src/search.rs:637-642);
the ceiling is evaluated host-side per (threshold, node) and shipped as an
alive-mask folded into the tables.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

#: Positions per row (rows are processed sequentially on-device).
CHUNK = 1 << 20
#: Default per-row survivor capacity (fraction of a row) and match capacity.
SURV_FRAC_DEFAULT = 8  # chunk // SURV_FRAC survivors
K_DEFAULT = 1 << 13


@functools.partial(jax.jit, static_argnames=("C", "L", "K", "S", "S2", "KG"))
def _exact_scan_rows(goto_flat, C, out_count, root_planes, ids_rows, L, K, S, S2, KG):
    """All rows in one dispatch, globally compacted output.

    ids_rows [R, N + L] -> (surv_counts [R, 2], counts [R], total, packed
    [KG, 3]) where a packed row is (global position, step t, node): the walk
    from global start ``pos`` reached output node ``node`` after consuming
    ``t + 1`` symbols. Only the KG-entry packed buffer crosses the host
    link.
    ``surv_counts[:, 0]`` > S / ``[:, 1]`` > S2 / ``total`` > KG signal
    capacity overflow.

    Two-stage filtering before the walk: the one-hot root step kills
    positions with no pattern first-symbol; survivors take one goto step and
    are re-compacted, so the L-step gather walk (the expensive part) runs on
    two-symbol-prefix survivors only — typically a few % even for dense
    dictionaries.

    ``root_planes`` [3, C] holds the root goto row split into uint8 planes
    (lo/mid/hi bytes of target+1, 0 = dead) so the one-hot matmuls stay exact
    in bf16 (8-bit mantissa) for any node id.
    """
    N = ids_rows.shape[1] - L

    def row_fn(ids_pad):
        ids_pad = ids_pad.astype(jnp.int32)
        sym0 = ids_pad[:N]

        # Stage 1: root step without gather — one-hot(sym) @ root_row, in
        # three exact byte planes.
        oh = jax.nn.one_hot(sym0, C, dtype=jnp.bfloat16)
        planes = jnp.einsum(
            "nc,pc->pn", oh, root_planes.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        ).astype(jnp.int32)
        enc = planes[0] | (planes[1] << 8) | (planes[2] << 16)
        s1 = enc - 1  # 0 = dead -> -1

        m1 = s1 >= 0
        c1 = m1.sum(dtype=jnp.int32)
        p1 = jnp.argwhere(m1, size=S, fill_value=-1).astype(jnp.int32)[:, 0]
        sp1 = jnp.maximum(p1, 0)
        st1 = jnp.where(p1 >= 0, s1[sp1], -1)

        # Emissions after one symbol (single-grapheme patterns).
        emit1 = jnp.where((st1 >= 0) & (out_count[jnp.maximum(st1, 0)] > 0), st1, -1)

        # Stage 2: one goto step on stage-1 survivors, then re-compact.
        sym1 = ids_pad[sp1 + 1]
        st2_all = goto_flat[jnp.maximum(st1, 0) * C + sym1]
        st2_all = jnp.where(st1 >= 0, st2_all, -1)
        m2 = st2_all >= 0
        c2 = m2.sum(dtype=jnp.int32)
        p2 = jnp.argwhere(m2, size=S2, fill_value=-1).astype(jnp.int32)[:, 0]
        sp2slot = jnp.maximum(p2, 0)
        sp2 = sp1[sp2slot]                      # row-local position
        st2 = jnp.where(p2 >= 0, st2_all[sp2slot], -1)

        def step(carry, t):
            st = carry
            emit = jnp.where((st >= 0) & (out_count[jnp.maximum(st, 0)] > 0), st, -1)
            sym = ids_pad[sp2 + t + 2]
            nxt = goto_flat[jnp.maximum(st, 0) * C + sym]
            nxt = jnp.where(st >= 0, nxt, -1)
            return nxt, emit

        # Walk covers spans 2..L (emit checked on entry).
        _last, emits = jax.lax.scan(step, st2, jnp.arange(L - 1, dtype=jnp.int32))
        mask = emits >= 0  # [L-1, S2]
        count = mask.sum(dtype=jnp.int32) + (emit1 >= 0).sum(dtype=jnp.int32)
        idx = jnp.argwhere(mask, size=K, fill_value=-1).astype(jnp.int32)
        nodes = jnp.where(
            idx[:, 0] >= 0,
            emits[jnp.maximum(idx[:, 0], 0), jnp.maximum(idx[:, 1], 0)],
            -1,
        )
        # Walk emissions at scan-step t correspond to overall step t+1
        # (span t+2); stage-1 emissions are step 0 (span 1).
        pos = jnp.where(idx[:, 1] >= 0, sp2[jnp.maximum(idx[:, 1], 0)], -1)
        step_no = jnp.where(idx[:, 0] >= 0, idx[:, 0] + 1, -1)
        # Append stage-1 emissions (compact separately; K1 shares K budget).
        e1idx = jnp.argwhere(emit1 >= 0, size=K, fill_value=-1).astype(jnp.int32)[:, 0]
        e1pos = jnp.where(e1idx >= 0, sp1[jnp.maximum(e1idx, 0)], -1)
        e1node = jnp.where(e1idx >= 0, emit1[jnp.maximum(e1idx, 0)], -1)
        packed = jnp.stack(
            [
                jnp.concatenate([step_no, jnp.where(e1pos >= 0, 0, -1)]),
                jnp.concatenate([pos, e1pos]),
            ],
            axis=1,
        )
        all_nodes = jnp.concatenate([nodes, e1node])
        return jnp.stack([c1, c2]), count, packed, all_nodes

    surv_counts, counts, idx_rows, node_rows = jax.lax.map(row_fn, ids_rows)

    # Global compaction: per-row padded buffers -> one tight [KG, 3] buffer
    # of (global_pos, t, node), so readback bytes track the real match count.
    R = ids_rows.shape[0]
    row_base = (jnp.arange(R, dtype=jnp.int32) * N)[:, None]
    gpos = jnp.where(idx_rows[:, :, 1] >= 0, row_base + idx_rows[:, :, 1], -1).reshape(-1)
    t_flat = idx_rows[:, :, 0].reshape(-1)
    node_flat = node_rows.reshape(-1)
    valid = gpos >= 0
    total = valid.sum(dtype=jnp.int32)
    take = jnp.argwhere(valid, size=KG, fill_value=-1).astype(jnp.int32)[:, 0]
    tk = jnp.maximum(take, 0)
    packed = jnp.stack(
        [
            jnp.where(take >= 0, gpos[tk], -1),
            jnp.where(take >= 0, t_flat[tk], -1),
            jnp.where(take >= 0, node_flat[tk], -1),
        ],
        axis=1,
    )
    return surv_counts, counts, total, packed


def _rows_of(ids: np.ndarray, chunk: int, halo: int, dtype) -> np.ndarray:
    """Cut [n] ids into [R, chunk + halo] overlapping rows (zero-padded)."""
    n = len(ids)
    rows = -(-n // chunk)
    out = np.zeros((rows, chunk + halo), dtype=dtype)
    for r in range(rows):
        src = ids[r * chunk : min(n, r * chunk + chunk + halo)]
        out[r, : len(src)] = src
    return out


def _packed_path_alive(engine, thr: np.float32):
    """Per packed field: whether every node on its trie path survives the
    per-node prune ceiling at zero penalty (reference src/search.rs:637-642).
    Returns None when the engine isn't packable."""
    from .packed_bitap import packed_exact_of

    pk = packed_exact_of(engine)
    if pk is None:
        return None
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    alive = ceil >= 0.0
    return pk, np.asarray(
        [bool(alive[0]) and all(alive[ni] for ni in path) for _, _, _, _, path in pk.fields]
    )


def exact_search_packed(engine, haystack: str, threshold: float, view) -> Optional[List["FuzzyMatch"]]:
    """Exact search via the packed multi-field shift-AND kernel
    (ops/packed_bitap.py) — one pass over the corpus regardless of dictionary
    size. None when the engine isn't packable (fallback: the goto-walk
    kernel below)."""
    from ..structs import FuzzyMatch
    from .packed_bitap import exact_hits_packed

    thr = np.float32(threshold)
    pa = _packed_path_alive(engine, thr)
    if pa is None:
        return None
    pk, field_alive = pa

    got = exact_hits_packed(engine, haystack, view)
    if got is None:
        return None
    ends, fidx = got

    hay_bytes = view.hay_bytes()
    is_ascii = view.ascii
    n = len(haystack) if is_ascii else len(view)
    dense = engine.dense
    engine.last_stats = {
        "backend": "device-exact-packed",
        "positions": int(n),
        "emissions": int(len(ends)),
    }

    # Vectorized emission: field hits -> per-output-pattern match columns
    # (reference emission src/search.rs:659-737; exact similarity is the
    # pattern weight). Object construction is deferred (structs.LazyMatchList).
    from ..structs import LazyMatchList

    keep = field_alive[fidx]
    ends = np.asarray(ends, dtype=np.int64)[keep]
    fidx = np.asarray(fidx, dtype=np.int64)[keep]
    depth_arr = np.asarray([d for _, d, _, _, _ in pk.fields], dtype=np.int64)
    node_arr = np.asarray([ni for ni, _, _, _, _ in pk.fields], dtype=np.int64)
    start_g = ends - depth_arr[fidx]
    node = node_arr[fidx]
    pats = dense.out_list[node]                                # [H, MO]
    cols_s, cols_e, cols_p = [], [], []
    for o in range(pats.shape[1]):
        p_o = pats[:, o].astype(np.int64)
        ok = (p_o >= 0) & (dense.pat_weight[np.maximum(p_o, 0)] >= thr)
        if ok.any():
            cols_s.append(start_g[ok])
            cols_e.append(ends[ok])
            cols_p.append(p_o[ok])
    if not cols_s:
        return []
    sg = np.concatenate(cols_s)
    eg = np.concatenate(cols_e)
    pat = np.concatenate(cols_p)
    sim = dense.pat_weight[pat].astype(np.float32)
    offs = view.offsets_array(len(hay_bytes))
    if offs is None:
        sb, eb = sg, eg
    else:
        sb, eb = offs[sg], offs[eg]
    return LazyMatchList(
        engine._patterns, hay_bytes, sb, eb, pat, sim,
        np.zeros(len(pat), dtype=np.int64),
    )


def exact_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device exact search: oracle-identical match list (unsorted)."""
    from ..structs import FuzzyMatch
    from ..utils.graphemes import view_of

    dense = engine.dense
    thr = np.float32(threshold)

    if view is None:
        view = view_of(haystack, engine.case_insensitive)

    packed = exact_search_packed(engine, haystack, threshold, view)
    if packed is not None:
        return packed

    ids = dense.transcode(haystack, view)
    n = len(ids)
    if n == 0:
        return []

    # Per-threshold node alive-mask (prune ceiling with zero penalty), folded
    # into the tables: a pruned node simply becomes unreachable.
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    alive = np.asarray(ceil >= 0.0, dtype=bool)
    if not alive[0]:
        return []
    goto = np.where((dense.goto >= 0) & alive[np.maximum(dense.goto, 0)], dense.goto, -1)
    goto[~alive, :] = -1
    # Root row encoded as target+1 (0 = dead) in three uint8 planes.
    enc = (goto[0] + 1).astype(np.int64)
    root_planes = np.stack(
        [enc & 0xFF, (enc >> 8) & 0xFF, (enc >> 16) & 0xFF]
    ).astype(np.float32)

    L = max(dense.max_depth, 1)
    chunk = min(CHUNK, 1 << max(10, (n - 1).bit_length()))
    dtype = np.uint8 if dense.num_classes <= 256 else np.int32
    ids_rows = _rows_of(ids, chunk, L, dtype)

    goto_flat = jax.device_put(goto.reshape(-1))
    out_count = jax.device_put(dense.out_count)
    root_planes_j = jax.device_put(root_planes)
    ids_dev = jax.device_put(ids_rows)
    C = dense.num_classes

    K = K_DEFAULT
    S = max(chunk // SURV_FRAC_DEFAULT, 1024)
    S2 = max(S // 8, 1024)
    KG = 1 << 13
    while True:
        surv, counts, total, packed = _exact_scan_rows(
            goto_flat, C, out_count, root_planes_j, ids_dev, L, K, S, S2, KG
        )
        surv = np.asarray(surv)
        counts = np.asarray(counts)
        smax = int(surv[:, 0].max(initial=0))
        s2max = int(surv[:, 1].max(initial=0))
        cmax = int(counts.max(initial=0))
        tot = int(total)
        if smax <= S and s2max <= S2 and cmax <= K and tot <= KG:
            break
        if smax > S:
            S = 1 << (smax - 1).bit_length()
        if s2max > S2:
            S2 = 1 << (s2max - 1).bit_length()
        if cmax > K:
            K = 1 << (cmax - 1).bit_length()
        if tot > KG:
            KG = 1 << (tot - 1).bit_length()
    packed = np.asarray(packed[:tot])

    hay_bytes = view.hay_bytes()
    is_ascii = view.ascii
    out_start = dense.out_start
    out_patterns = dense.out_patterns
    pat_weight = dense.pat_weight
    patterns = engine._patterns

    engine.last_stats = {
        "backend": "device-exact",
        "positions": int(n),
        "survivors_stage1": int(surv[:, 0].sum()),
        "survivors_stage2": int(surv[:, 1].sum()),
        "emissions": tot,
    }
    results: List[FuzzyMatch] = []
    for gpos, t, node in packed:
        start_g = int(gpos)
        # Per-row halo starts belong to the next row; global position is
        # base + local i, so halo duplicates appear as start >= n row overlap.
        row, local = divmod(start_g, chunk)
        if local >= min(chunk, n - row * chunk):
            continue
        end_g = start_g + int(t) + 1
        if start_g >= n or end_g > n:
            continue
        for p in out_patterns[out_start[node] : out_start[node + 1]]:
            sim = np.float32(pat_weight[p])
            if sim < thr:
                continue
            sb = start_g if is_ascii else view.byte_offset(start_g)
            eb = (
                end_g
                if is_ascii
                else (view.byte_offset(end_g) if end_g < n else len(hay_bytes))
            )
            results.append(
                FuzzyMatch(
                    insertions=0,
                    deletions=0,
                    substitutions=0,
                    swaps=0,
                    edits=0,
                    pattern_index=int(p),
                    pattern=patterns[p],
                    start=sb,
                    end=eb,
                    similarity=sim,
                    text=hay_bytes[sb:eb].decode("utf-8"),
                )
            )
    return results


def exact_scan_hits(engine, haystack: str, view=None):
    """Raw exact hits as numpy arrays (grapheme-indexed): (starts, pattern_ids).

    Threshold-0 variant of :func:`exact_search_device` used by the seed
    filter — no byte-offset mapping, no FuzzyMatch construction.
    """
    from ..utils.graphemes import view_of

    dense = engine.dense
    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    ids = dense.transcode(haystack, view)
    n = len(ids)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)

    # Packed shift-AND fast lane: one pass, any dictionary size.
    if dense.num_classes <= 256:
        from .packed_bitap import exact_hits_packed, packed_exact_of

        got = exact_hits_packed(engine, haystack, view)
        if got is not None:
            pk = packed_exact_of(engine)
            ends, fidx = got
            nodes = engine.nodes
            starts_l: list = []
            pids_l: list = []
            for e, fi in zip(ends, fidx):
                ni, depth, _lw, _fo, _path = pk.fields[fi]
                for p in nodes[ni].output:
                    starts_l.append(int(e) - depth)
                    pids_l.append(int(p))
            return (
                np.asarray(starts_l, dtype=np.int64),
                np.asarray(pids_l, dtype=np.int64),
            )

    goto = dense.goto
    enc = (goto[0] + 1).astype(np.int64)
    root_planes = np.stack(
        [enc & 0xFF, (enc >> 8) & 0xFF, (enc >> 16) & 0xFF]
    ).astype(np.float32)

    L = max(dense.max_depth, 1)
    chunk = min(CHUNK, 1 << max(10, (n - 1).bit_length()))
    dtype = np.uint8 if dense.num_classes <= 256 else np.int32
    ids_rows = _rows_of(ids, chunk, L, dtype)

    goto_flat = jax.device_put(goto.reshape(-1))
    out_count = jax.device_put(dense.out_count)
    root_planes_j = jax.device_put(root_planes)
    ids_dev = jax.device_put(ids_rows)
    C = dense.num_classes

    K, S, KG = K_DEFAULT, max(chunk // SURV_FRAC_DEFAULT, 1024), 1 << 14
    S2 = max(S // 8, 1024)
    while True:
        surv, counts, total, packed = _exact_scan_rows(
            goto_flat, C, out_count, root_planes_j, ids_dev, L, K, S, S2, KG
        )
        surv = np.asarray(surv)
        smax = int(surv[:, 0].max(initial=0))
        s2max = int(surv[:, 1].max(initial=0))
        cmax = int(np.asarray(counts).max(initial=0))
        tot = int(total)
        if smax <= S and s2max <= S2 and cmax <= K and tot <= KG:
            break
        if smax > S:
            S = 1 << (smax - 1).bit_length()
        if s2max > S2:
            S2 = 1 << (s2max - 1).bit_length()
        if cmax > K:
            K = 1 << (cmax - 1).bit_length()
        if tot > KG:
            KG = 1 << (tot - 1).bit_length()
    packed = np.asarray(packed[:tot]).astype(np.int64)

    if tot == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    gpos, _t, nodes = packed[:, 0], packed[:, 1], packed[:, 2]
    keep = gpos < n
    # Drop last-row padding starts (positions past n are zero-padded/dead).
    gpos, nodes = gpos[keep], nodes[keep]
    # Expand per-node output lists (usually singletons).
    out_start, out_patterns = dense.out_start, dense.out_patterns
    reps = (out_start[nodes + 1] - out_start[nodes]).astype(np.int64)
    starts = np.repeat(gpos, reps)
    pids = np.concatenate(
        [out_patterns[out_start[nd] : out_start[nd + 1]] for nd in nodes]
    ) if len(nodes) else np.zeros(0, np.int64)
    return starts, pids.astype(np.int64)
