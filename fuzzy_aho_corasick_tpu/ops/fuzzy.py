"""Fuzzy anchored-scan kernel: fixed-width beam frontier expansion.

Data-parallel reformulation of the reference's per-start-position BFS
(reference src/search.rs:418-1119, SURVEY §7): the frontier becomes a dense
``[N_starts, BEAM]`` state table advanced in lockstep *rounds*, with the
hash-map dedup replaced by a sort + segmented-min per round.

Why per-round dedup is exact: in a tree trie the node fixes its depth ``d``,
and every BFS path reaching state key ``(node, j, me, counts)`` has length
``rounds = d + insertions - swaps`` — a function of the key alone. So all
paths to equal keys collide in the *same* round, and a per-round
sort/min-penalty compaction reproduces the reference's visited-map semantics
(src/search.rs:31-50, 608-628) with no cross-round bookkeeping.

Semantics replicated per state and per round (FAST-path configuration: total
edit budget 1..=6, no per-pattern limits, no mappings, no explicit beams):

* exact / substitution / swap / insertion / deletion branches with their push
  guards and penalty arithmetic in f32 op order (src/search.rs:776-1089);
* the dominated-edge rule (substitution skips the exact target,
  src/search.rs:817-821);
* weakest-link similarity floor (src/search.rs:826-828);
* per-node prune ceilings and the global remaining-budget guards
  (src/search.rs:637-648);
* last-edit dead-end filters (src/search.rs:839-847, 1005-1007, 1050-1063) —
  on the device these use the ``sb_edge`` single-byte-edge table, which
  replicates the reference's ``has_matching_edge_char`` exactly: a
  multi-byte edge that WOULD advance deliberately does not rescue the state
  (results-relevant for Unicode patterns; see ops/dense.py sb_edge).

Exactness under the fixed beam: if a round's deduped frontier exceeds BEAM
slots, the start position is flagged and re-searched by the host oracle
(windowed to ``max_match_graphemes()`` graphemes) — overflow costs time,
never correctness.

Emission is deferred: the expanded beams of every round form a state history;
a post-pass masks output nodes, computes f32 similarities, thresholds, and
compacts (count + argwhere) so only match tuples leave the device. The
best-per-(start, end, pattern) reduction runs on the host over those sparse
tuples (reference src/search.rs:694-736).
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

#: Start positions per device dispatch.
NCHUNK = 1 << 13
INT32_MAX = np.int32(2**31 - 1)


def _expand(
    node, j, me, counts, pen,
    edge_target, edge_class, goto_flat, sb_flat, C, sim_flat,
    out_count, node_ceil,
    ids_pad, limit, iota_i,
    max_pen, p_sub, p_ins, p_del, p_swap, floor, E,
):
    """Expand a beam [N, Bc] into candidates [N, Bc*(2D+3)] (fields tuple).

    One reference BFS pop per live slot: generates the exact, substitution,
    swap, insertion and deletion pushes with all push-time guards applied.
    """
    N, Bc = node.shape
    D = edge_target.shape[1]
    npad = ids_pad.shape[0]

    alive = node >= 0
    safe_node = jnp.maximum(node, 0)
    ins_c = counts & 0xFF
    del_c = (counts >> 8) & 0xFF
    sub_c = (counts >> 16) & 0xFF
    swap_c = (counts >> 24) & 0xFF
    edits = ins_c + del_c + sub_c + swap_c
    can_edit = edits < E
    is_last = can_edit & (edits + 1 >= E)

    pos_j = iota_i[:, None] + j
    in_text = (pos_j < limit) & alive
    # ids_pad may be uint8 (resident corpora ship narrow); widen post-gather.
    sym_j = ids_pad[jnp.clip(pos_j, 0, npad - 1)].astype(jnp.int32)
    sym_j = jnp.where(in_text, sym_j, 0)
    pos_j1 = pos_j + 1
    in_text2 = (pos_j1 < limit) & alive
    sym_j1 = ids_pad[jnp.clip(pos_j1, 0, npad - 1)].astype(jnp.int32)
    sym_j1 = jnp.where(in_text2, sym_j1, 0)

    remaining = max_pen - pen

    # Exact transition (src/search.rs:776-798). Class 0 has no edges, so
    # padded symbols resolve to -1 naturally.
    exact_next = goto_flat[safe_node * C + sym_j]
    exact_next = jnp.where(in_text, exact_next, -1)

    # goto from a candidate target on the *next* symbol (real transitions:
    # the swap branch).
    def goto_of(nodes, syms, mask):
        g = goto_flat[jnp.maximum(nodes, 0) * C + syms]
        return jnp.where(mask & (nodes >= 0), g, -1)

    # Last-edit dead-end predicate: node has a SINGLE-byte edge matching the
    # symbol (reference has_matching_edge_char, src/structs.rs:471-476 —
    # multi-byte edges deliberately don't rescue the state; see
    # ops/dense.py sb_edge).
    def sb_of(nodes, syms, mask):
        v = sb_flat[jnp.maximum(nodes, 0) * C + syms]
        return mask & (nodes >= 0) & (v > 0)

    out0_self = out_count[safe_node] == 0

    fields = ([], [], [], [], [])  # node, j, me, counts, pen

    def push(valid, c_node, c_j, c_me, c_counts, c_pen):
        # Per-node prune ceiling at pop time (src/search.rs:637-642) — a
        # candidate that would be pruned next round is dropped now.
        valid = valid & (c_node >= 0) & ~(c_pen > node_ceil[jnp.maximum(c_node, 0)])
        fields[0].append(jnp.where(valid, c_node, -1))
        fields[1].append(c_j)
        fields[2].append(c_me)
        fields[3].append(c_counts)
        fields[4].append(c_pen)

    # 1) exact
    push(in_text, exact_next, j + 1, j + 1, counts, pen)

    # 2) substitutions over all edges (src/search.rs:803-874)
    et = edge_target[safe_node]          # [N, Bc, D]
    ec = edge_class[safe_node]           # [N, Bc, D]
    sim = sim_flat[ec * C + sym_j[..., None]]
    pnl = p_sub * (np.float32(1.0) - sim)
    sub_valid = (
        in_text[..., None]
        & can_edit[..., None]
        & (et >= 0)
        & (et != exact_next[..., None])
        & ~(sim < floor)
        & ~(pnl > remaining[..., None])
    )
    # Last-edit dead-end filter (src/search.rs:839-847): child must emit or
    # have a single-byte edge matching text[j+1].
    child_has_next = sb_of(et, sym_j1[..., None], in_text2[..., None])
    child_out = out_count[jnp.maximum(et, 0)] > 0
    sub_valid &= ~(is_last[..., None] & ~child_out & ~child_has_next)
    for d in range(D):
        push(
            sub_valid[..., d],
            et[..., d],
            j + 1,
            j + 1,
            counts + 0x1_0000,
            pen + pnl[..., d],
        )

    # 3) swap (src/search.rs:935-989)
    mid = goto_of(safe_node, sym_j1, in_text2 & alive)
    node2 = goto_of(mid, sym_j, mid >= 0)
    swap_valid = in_text2 & (p_swap <= remaining) & can_edit & (node2 >= 0)
    push(swap_valid, node2, j + 2, j + 2, counts + 0x100_0000, pen + p_swap)

    # 4) insertion (src/search.rs:994-1029)
    self_has_next = sb_of(safe_node, sym_j1, in_text2 & alive)
    ins_valid = (
        in_text
        & ((me != 0) | (j != 0))
        & (p_ins <= remaining)
        & can_edit
        & ~(is_last & out0_self & ~self_has_next)
    )
    push(ins_valid, node, j + 1, me, counts + 1, pen + p_ins)

    # 5) deletions over all edges (src/search.rs:1035-1089)
    del_child_next = sb_of(et, sym_j[..., None], in_text[..., None])
    del_valid = (
        alive[..., None]
        & can_edit[..., None]
        & (p_del <= remaining)[..., None]
        & (et >= 0)
        & ~(is_last[..., None] & ~child_out & ~del_child_next)
    )
    for d in range(D):
        push(
            del_valid[..., d],
            et[..., d],
            j,
            me,
            counts + 0x100,
            pen + p_del,
        )

    cat = lambda xs: jnp.concatenate([x.reshape(N, -1) for x in xs], axis=1)
    return cat(fields[0]), cat(fields[1]), cat(fields[2]), cat(fields[3]), cat(fields[4])


def _dedup_compact(c_node, c_j, c_me, c_counts, c_pen, B):
    """Sort-based dedup to the reference's visited-map semantics, compacted
    into B slots; returns new beam + per-row overflow flag."""
    N, M = c_node.shape
    k_node = jnp.where(c_node >= 0, c_node, INT32_MAX)
    k_jme = (c_j << 16) | c_me
    s_node, s_jme, s_counts, s_pen, s_j, s_me = jax.lax.sort(
        (k_node, k_jme, c_counts, c_pen, c_j, c_me), num_keys=4
    )
    alive = s_node != INT32_MAX
    first = jnp.concatenate(
        [
            jnp.ones((N, 1), dtype=bool),
            (s_node[:, 1:] != s_node[:, :-1])
            | (s_jme[:, 1:] != s_jme[:, :-1])
            | (s_counts[:, 1:] != s_counts[:, :-1]),
        ],
        axis=1,
    )
    keep = alive & first
    pos = jnp.cumsum(keep, axis=1) - 1
    overflow = (keep & (pos >= B)).any(axis=1)
    slot = jnp.where(keep & (pos < B), pos, B)

    def scatter_row(vals, slots, fill):
        return jnp.full((B,), fill, vals.dtype).at[slots].set(vals, mode="drop")

    scat = jax.vmap(scatter_row, in_axes=(0, 0, None))
    return (
        scat(s_node, slot, np.int32(-1)),
        scat(s_j, slot, np.int32(0)),
        scat(s_me, slot, np.int32(0)),
        scat(s_counts, slot, np.int32(0)),
        scat(s_pen, slot, np.float32(0.0)),
        overflow,
    )


@functools.partial(
    jax.jit,
    static_argnames=("B", "T", "E", "K", "KO", "C"),
)
def _fuzzy_scan_kernel(
    goto_flat,
    sb_flat,
    edge_target_full,
    edge_class_full,
    edge_target_deep,
    edge_class_deep,
    sim_flat,
    out_count,
    out_list,
    pat_len,
    pat_weight,
    node_ceil,
    ids_pad,
    starts,
    limit,
    max_pen,
    p_sub,
    p_ins,
    p_del,
    p_swap,
    floor,
    thr,
    C,
    B,
    T,
    E,
    K,
    KO,
):
    """One chunk of candidate start positions against the (device-resident)
    corpus: ``starts`` [N] are global grapheme indices (anchors); the corpus
    ``ids_pad`` carries an LSPAN zero tail so every anchor has full context."""
    N = starts.shape[0]
    iota_i = starts

    # Round 0: the root state (node 0, j=me=0) — the only round where the
    # root (with its large degree) is expanded, so it uses the full edge
    # width while later rounds use the non-root maximum.
    z = jnp.zeros((N, 1), dtype=jnp.int32)
    root_beam = (z, z, z, z, jnp.zeros((N, 1), dtype=jnp.float32))
    cands = _expand(
        *root_beam,
        edge_target_full, edge_class_full, goto_flat, sb_flat, C, sim_flat,
        out_count, node_ceil, ids_pad, limit, iota_i,
        max_pen, p_sub, p_ins, p_del, p_swap, floor, E,
    )
    beam = _dedup_compact(*cands, B)
    overflow0 = beam[5]
    beam = beam[:5]

    def round_body(carry, _):
        b_node, b_j, b_me, b_counts, b_pen = carry
        cands = _expand(
            b_node, b_j, b_me, b_counts, b_pen,
            edge_target_deep, edge_class_deep, goto_flat, sb_flat, C, sim_flat,
            out_count, node_ceil, ids_pad, limit, iota_i,
            max_pen, p_sub, p_ins, p_del, p_swap, floor, E,
        )
        nb = _dedup_compact(*cands, B)
        new_beam = nb[:5]
        return new_beam, (new_beam[0], new_beam[1], new_beam[2], new_beam[3], new_beam[4], nb[5])

    _, hist = jax.lax.scan(round_body, beam, None, length=T - 1)
    # Histories: prepend round-1 beam (from root expansion).
    h_node = jnp.concatenate([beam[0][None], hist[0]], axis=0)   # [T, N, B]
    h_j = jnp.concatenate([beam[1][None], hist[1]], axis=0)
    h_me = jnp.concatenate([beam[2][None], hist[2]], axis=0)
    h_counts = jnp.concatenate([beam[3][None], hist[3]], axis=0)
    h_pen = jnp.concatenate([beam[4][None], hist[4]], axis=0)
    overflow = overflow0 | hist[5].any(axis=0)                    # [N]

    # Emission post-pass (src/search.rs:659-737): states at output nodes.
    max_out = out_list.shape[1]
    e_alive = h_node >= 0
    safe = jnp.maximum(h_node, 0)
    pats = out_list[safe]                                         # [T, N, B, max_out]
    valid = e_alive[..., None] & (pats >= 0)
    total = pat_len[jnp.maximum(pats, 0)]
    weight = pat_weight[jnp.maximum(pats, 0)]
    # Slack threshold; exact f32 similarity recomputed host-side (see
    # _fuzzy1_scan_kernel).
    sim = ((total - h_pen[..., None]) / total) * weight
    valid &= sim >= thr - (np.float32(1e-4) + np.float32(1e-4) * jnp.abs(thr))

    count = valid.sum(dtype=jnp.int32)
    idx = jnp.argwhere(valid, size=K, fill_value=0).astype(jnp.int32)
    got = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
    in_range = jnp.arange(K) < count
    em_i = jnp.where(in_range, got[1], -1)
    em_me = h_me[got[0], got[1], got[2]]
    em_pat = pats[got[0], got[1], got[2], got[3]]
    em_pen = h_pen[got[0], got[1], got[2]]
    em_counts = h_counts[got[0], got[1], got[2]]

    ov_count = overflow.sum(dtype=jnp.int32)
    ov_idx = jnp.argwhere(overflow, size=KO, fill_value=-1).astype(jnp.int32)[:, 0]

    return count, em_i, em_me, em_pat, em_pen, em_counts, ov_count, ov_idx


def _fuzzy1_core(
    goto_flat,
    sb_flat,
    edge_target_full,
    edge_class_full,
    edge_target_deep,
    edge_class_deep,
    sim_flat,
    out_count,
    out_list,
    pat_len,
    pat_weight,
    node_ceil,
    ids_pad,
    starts,
    limit,
    max_pen,
    p_sub,
    p_ins,
    p_del,
    p_swap,
    floor,
    thr,
    C,
    T,
    K,
):
    """Sort-free specialization of the beam scan for a total edit budget of 1.

    With one edit, a state that has spent it can never branch again — only
    the exact transition fires (reference src/search.rs:776-798 is the sole
    push when ``can_edit`` is false). So the frontier is exactly:

    * ``s0``: the single 0-edit trie walk per anchor, and
    * an append-only *pool* of 1-edit walks, spawned from ``s0`` each round
      (<= 2D+2 spawns: D substitutions, D deletions, one swap, one insert),
      each advancing deterministically afterwards.

    No visited-map is needed: duplicate (node, j) pool entries cannot branch,
    so they merely re-emit the same (span, pattern, penalty) tuple, which the
    host best-per-span reduction collapses — reference semantics preserved
    without the per-round multi-operand ``lax.sort`` that dominated the
    general kernel's runtime (~50x the gather work). Capacity is structural
    (``P = S0 + (T-1) * Sd`` slots), so beam overflow cannot occur and no
    oracle rescue path is required.

    Returns the same tuple shape as :func:`_fuzzy_scan_kernel` with the
    overflow fields always empty.
    """
    from .compact import compact_indices

    N = starts.shape[0]
    Df = edge_target_full.shape[1]
    Dd = edge_target_deep.shape[1]
    S0 = 2 * Df + 2
    Sd = 2 * Dd + 2
    P = S0 + (T - 1) * Sd

    def expand(nodes, j, me, counts, pen, et, ec):
        return _expand(
            nodes, j, me, counts, pen, et, ec, goto_flat, sb_flat, C, sim_flat,
            out_count, node_ceil, ids_pad, limit, starts,
            max_pen, p_sub, p_ins, p_del, p_swap, floor, 1,
        )

    z = jnp.zeros((N, 1), dtype=jnp.int32)
    zf = jnp.zeros((N, 1), dtype=jnp.float32)

    # Round 0: root expansion (full edge width — the root never reappears).
    c_node, c_j, c_me, c_counts, c_pen = expand(
        z, z, z, z, zf, edge_target_full, edge_class_full
    )
    s0_node = c_node[:, 0]
    s0_j = c_j[:, 0]

    pool_node = jnp.full((N, P), -1, dtype=jnp.int32)
    pool_j = jnp.zeros((N, P), dtype=jnp.int32)
    pool_me = jnp.zeros((N, P), dtype=jnp.int32)
    pool_counts = jnp.zeros((N, P), dtype=jnp.int32)
    pool_pen = jnp.zeros((N, P), dtype=jnp.float32)
    pool_node = pool_node.at[:, :S0].set(c_node[:, 1:])
    pool_j = pool_j.at[:, :S0].set(c_j[:, 1:])
    pool_me = pool_me.at[:, :S0].set(c_me[:, 1:])
    pool_counts = pool_counts.at[:, :S0].set(c_counts[:, 1:])
    pool_pen = pool_pen.at[:, :S0].set(c_pen[:, 1:])

    def round_body(carry, r):
        s0_node, s0_j, pool_node, pool_j, pool_me, pool_pen, pool_counts = carry

        # 1) advance every live pool walk by its exact transition.
        alive = pool_node >= 0
        pos = starts[:, None] + pool_j
        in_text = (pos < limit) & alive
        sym = ids_pad[jnp.clip(pos, 0, ids_pad.shape[0] - 1)].astype(jnp.int32)
        nxt = goto_flat[jnp.maximum(pool_node, 0) * C + jnp.where(in_text, sym, 0)]
        nxt = jnp.where(in_text, nxt, -1)
        # Per-node prune ceiling at push time (src/search.rs:637-642).
        nxt = jnp.where(pool_pen > node_ceil[jnp.maximum(nxt, 0)], -1, nxt)
        pool_node = nxt
        pool_j = jnp.where(nxt >= 0, pool_j + 1, pool_j)
        pool_me = jnp.where(nxt >= 0, pool_j, pool_me)

        # 2) expand s0 (deep width) -> new s0 + fresh spawns.
        c_node, c_j, c_me, c_counts, c_pen = expand(
            s0_node[:, None], s0_j[:, None], s0_j[:, None],
            jnp.zeros((N, 1), jnp.int32), jnp.zeros((N, 1), jnp.float32),
            edge_target_deep, edge_class_deep,
        )
        new_s0 = c_node[:, 0]
        new_s0_j = c_j[:, 0]
        off = S0 + (r - 1) * Sd
        pool_node = jax.lax.dynamic_update_slice(pool_node, c_node[:, 1:], (0, off))
        pool_j = jax.lax.dynamic_update_slice(pool_j, c_j[:, 1:], (0, off))
        pool_me = jax.lax.dynamic_update_slice(pool_me, c_me[:, 1:], (0, off))
        pool_counts = jax.lax.dynamic_update_slice(pool_counts, c_counts[:, 1:], (0, off))
        pool_pen = jax.lax.dynamic_update_slice(pool_pen, c_pen[:, 1:], (0, off))

        carry = (new_s0, new_s0_j, pool_node, pool_j, pool_me, pool_pen, pool_counts)
        return carry, (new_s0, pool_node, pool_me)

    init = (s0_node, s0_j, pool_node, pool_j, pool_me, pool_pen, pool_counts)
    final, hist = jax.lax.scan(
        round_body, init, jnp.arange(1, T, dtype=jnp.int32), length=T - 1
    )
    pool_pen_f = final[5]
    pool_counts_f = final[6]

    # Histories: prepend round 0.
    h_s0 = jnp.concatenate([s0_node[None], hist[0]], axis=0)        # [T, N]
    h_pn = jnp.concatenate([pool_node[None], hist[1]], axis=0)      # [T, N, P]
    h_pme = jnp.concatenate([pool_me[None], hist[2]], axis=0)       # [T, N, P]

    # Emission post-pass over (pool slots + the s0 column).
    h_node = jnp.concatenate([h_pn, h_s0[:, :, None]], axis=2)      # [T, N, P+1]
    s0_me = (jnp.arange(T, dtype=jnp.int32) + 1)[:, None, None]
    h_me = jnp.concatenate(
        [h_pme, jnp.broadcast_to(s0_me, (T, N, 1))], axis=2
    )
    pen_all = jnp.concatenate([pool_pen_f, jnp.zeros((N, 1), jnp.float32)], axis=1)
    counts_all = jnp.concatenate([pool_counts_f, jnp.zeros((N, 1), jnp.int32)], axis=1)

    e_alive = h_node >= 0
    safe = jnp.maximum(h_node, 0)
    pats = out_list[safe]                                           # [T, N, P+1, MO]
    valid = e_alive[..., None] & (pats >= 0)
    total = pat_len[jnp.maximum(pats, 0)]
    weight = pat_weight[jnp.maximum(pats, 0)]
    # XLA lowers f32 division by reciprocal-multiply (1 ULP off IEEE), so the
    # in-kernel threshold keeps a slack margin and the host recomputes the
    # exact f32 similarity from the emitted penalty and refilters.
    sim = ((total - pen_all[None, :, :, None]) / total) * weight
    valid &= sim >= thr - (np.float32(1e-4) + np.float32(1e-4) * jnp.abs(thr))

    MO = pats.shape[3]
    count, idx = compact_indices(valid.reshape(-1), K)
    safe_idx = jnp.maximum(idx, 0)
    o = safe_idx % MO
    rest = safe_idx // MO
    p = rest % (P + 1)
    rest = rest // (P + 1)
    i = rest % N
    t = rest // N
    ok = idx >= 0
    em_i = jnp.where(ok, i, -1)
    em_me = h_me[t, i, p]
    em_pat = pats[t, i, p, o]
    em_pen = pen_all[i, p]
    em_counts = counts_all[i, p]
    return count, em_i, em_me, em_pat, em_pen, em_counts


@functools.partial(jax.jit, static_argnames=("C", "T", "K"))
def _fuzzy1_scan_kernel(*args, C, T, K):
    """Standalone-dispatch wrapper over :func:`_fuzzy1_core` (the fallback
    path when anchors come from the host-side filters; the packed-prefilter
    configurations use :func:`_fuzzy1_pipeline_jit` instead). Returns the same
    tuple shape as :func:`_fuzzy_scan_kernel` with empty overflow fields."""
    count, em_i, em_me, em_pat, em_pen, em_counts = _fuzzy1_core(*args, C=C, T=T, K=K)
    return count, em_i, em_me, em_pat, em_pen, em_counts, jnp.int32(0), jnp.full(
        (1,), -1, jnp.int32
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "NL", "chunkpf", "halo", "span",
        "KA", "NCH", "C", "T", "K_c", "KG",
    ),
)
def _fuzzy1_pipeline_jit(
    ids_pf, scan_tabs,
    goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
    out_count, out_list, pat_len, pat_weight, node_ceil,
    ids_dense, limit,
    max_pen, p_sub, p_ins, p_del, p_swap, floor, thr,
    NL, chunkpf, halo, span,
    KA, NCH, C, T, K_c, KG,
):
    """Whole fuzzy E=1 search as ONE dispatch: packed shift-AND anchors ->
    chunked beam scans -> globally compacted match tuples, all device-side.

    Every host round trip costs a fixed latency, so the per-chunk round
    trips of the unfused path (anchor readback, per-chunk uploads, per-field
    downloads) would add up. Here anchors stay on device, a ``while_loop`` with a *dynamic*
    trip count (`ceil(anchor_count / NCH)`) runs only the needed beam chunks,
    and the single int32 result buffer is:

    * row 0 header: ``[anchor_count, max_per_chunk_emissions, total, 0, 0, 0]``
      (the host checks these against the static capacities and regrows);
    * row 1+j: ``[start, me, pattern, penalty_bits, edit_counts, 0]`` per
      emission (penalty f32 bitcast into int32).
    """
    from .compact import compact_indices
    from .packed_bitap import anchor_covered_flags

    covered = anchor_covered_flags(ids_pf, scan_tabs, limit, NL, chunkpf, halo, span)
    count_a, aidx = compact_indices(covered, KA)
    # Dead anchor slots scan from position `limit` where in_text is false
    # everywhere — they emit nothing.
    anchors = jnp.where(aidx >= 0, aidx, limit)

    CH_MAX = KA // NCH
    n_chunks = jnp.minimum((jnp.minimum(count_a, KA) + NCH - 1) // NCH, CH_MAX)

    bufs0 = (
        jnp.full((CH_MAX, K_c), -1, jnp.int32),   # start
        jnp.zeros((CH_MAX, K_c), jnp.int32),      # me
        jnp.zeros((CH_MAX, K_c), jnp.int32),      # pattern
        jnp.zeros((CH_MAX, K_c), jnp.float32),    # penalty
        jnp.zeros((CH_MAX, K_c), jnp.int32),      # packed edit counts
    )

    def body(state):
        ci, bufs, mx = state
        starts_c = jax.lax.dynamic_slice(anchors, (ci * NCH,), (NCH,))
        cnt, em_i, em_me, em_pat, em_pen, em_counts = _fuzzy1_core(
            goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
            out_count, out_list, pat_len, pat_weight, node_ceil,
            ids_dense, starts_c, limit, max_pen,
            p_sub, p_ins, p_del, p_swap, floor, thr,
            C=C, T=T, K=K_c,
        )
        em_start = jnp.where(em_i >= 0, starts_c[jnp.maximum(em_i, 0)], -1)
        fields = (em_start, em_me, em_pat, em_pen, em_counts)
        new_bufs = tuple(
            jax.lax.dynamic_update_slice(b, f[None], (ci, 0))
            for b, f in zip(bufs, fields)
        )
        return ci + 1, new_bufs, jnp.maximum(mx, cnt)

    _, bufs, max_em = jax.lax.while_loop(
        lambda s: s[0] < n_chunks, body, (jnp.int32(0), bufs0, jnp.int32(0))
    )
    b_start, b_me, b_pat, b_pen, b_cnt = (b.reshape(-1) for b in bufs)

    valid = (b_start >= 0) & (b_start < limit)
    total, gidx = compact_indices(valid, KG)
    safe = jnp.maximum(gidx, 0)
    ok = gidx >= 0
    rows = jnp.stack(
        [
            jnp.where(ok, b_start[safe], -1),
            jnp.where(ok, b_me[safe], 0),
            jnp.where(ok, b_pat[safe], 0),
            jnp.where(ok, jax.lax.bitcast_convert_type(b_pen[safe], jnp.int32), 0),
            jnp.where(ok, b_cnt[safe], 0),
            jnp.zeros((KG,), jnp.int32),
        ],
        axis=1,
    )
    header = (
        jnp.zeros((1, 6), jnp.int32)
        .at[0, 0].set(count_a)
        .at[0, 1].set(max_em)
        .at[0, 2].set(total)
    )
    return jnp.concatenate([header, rows], axis=0)


def _fuzzy1_fused(engine, haystack: str, thr, view, n: int, T: int, max_pen, ceil):
    """Fused single-dispatch fuzzy E=1 search; None when the packed prefilter
    doesn't cover this engine/threshold (caller falls back to the chunked
    path)."""
    from ..utils import device_corpus
    from .packed_bitap import (
        _cap_cache,
        _dev_consts,
        _space_token,
        packed_fuzzy_of,
        resident_max,
        scan_layout,
        scan_tables,
    )

    if n > resident_max():
        return None
    pk = packed_fuzzy_of(engine)
    if pk is None:
        return None
    ks = []
    for bp in pk.filt.patterns:
        kq = pk.filt.k_for(bp, thr)
        if kq is None:
            return None
        ks.append(kq)
    match, init, k = pk.fuzzy_masks(ks)
    halo = pk.m_max + k
    span = halo

    dense = engine.dense
    pens = engine.penalties

    # Prefilter symbol stream + dense class stream, both device-resident.
    ids_pf, n_pf = device_corpus.resident(
        haystack,
        ("pk-fuzzy", _space_token(engine)),
        lambda h: np.ascontiguousarray(pk.filt.transcode(h)[0], dtype=np.uint8),
    )
    narrow = dense.num_classes <= 256
    ids_dense, n_d = device_corpus.resident(
        haystack,
        ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(
            dense.transcode(h, view), dtype=np.uint8 if narrow else np.int32
        ),
    )
    assert n_pf == n_d == n

    NL, chunkpf = scan_layout(ids_pf.size, halo)
    scan_tabs = _dev_consts(
        engine,
        ("anchor-consts", float(thr)),
        lambda: scan_tables(pk.word_tbl, pk.starts, match, init),
    )

    # Beam tables (shared with the chunked path's per-engine cache).
    deg = (dense.edge_target >= 0).sum(axis=1)
    d_deep = int(deg[1:].max()) if dense.num_nodes > 1 else 1
    d_deep = max(d_deep, 1)
    tabs = getattr(engine, "_fuzzy_dev_tables", None)
    if tabs is None or tabs[0] != d_deep:
        tabs = (
            d_deep,
            jax.device_put(dense.goto.reshape(-1)),
            jax.device_put(dense.sb_edge.reshape(-1)),
            jax.device_put(dense.edge_target),
            jax.device_put(dense.edge_class),
            jax.device_put(np.ascontiguousarray(dense.edge_target[:, :d_deep])),
            jax.device_put(np.ascontiguousarray(dense.edge_class[:, :d_deep])),
            jax.device_put(dense.sim.reshape(-1)),
            jax.device_put(dense.out_count),
            jax.device_put(dense.out_list),
            jax.device_put(dense.pat_len),
            jax.device_put(dense.pat_weight),
        )
        engine._fuzzy_dev_tables = tabs
    (_, goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
     out_count, out_list, pat_len, pat_weight) = tabs
    node_ceil = jax.device_put(ceil)

    nb = ids_pf.size
    NCH = NCHUNK
    width = (2 * d_deep + 2) * T
    while NCH > 1024 and NCH * (T + 1) * width * 24 > 512 * 1024 * 1024:
        NCH //= 2

    caps = _cap_cache(engine)
    ka_key = ("f1pipe-KA", nb, NCH)
    kc_key = ("f1pipe-Kc", nb, NCH)
    kg_key = ("f1pipe-KG", nb, NCH)
    KA = caps.get(ka_key, max(2 * NCH, (((nb >> 8) + NCH - 1) // NCH) * NCH))
    K_c = caps.get(kc_key, 4096)
    KG = caps.get(kg_key, 1 << 15)

    while True:
        buf = jax.device_get(
            _fuzzy1_pipeline_jit(
                ids_pf, scan_tabs,
                goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
                out_count, out_list, pat_len, pat_weight, node_ceil,
                ids_dense, np.int32(n),
                max_pen, pens.substitution, pens.insertion, pens.deletion,
                pens.swap, engine.min_symbol_similarity, thr,
                NL=NL, chunkpf=chunkpf, halo=halo, span=span,
                KA=KA, NCH=NCH, C=dense.num_classes, T=T, K_c=K_c, KG=KG,
            )
        )
        count_a, max_em, total = int(buf[0, 0]), int(buf[0, 1]), int(buf[0, 2])
        grew = False
        if count_a > KA:
            KA = (((count_a * 2) + NCH - 1) // NCH) * NCH
            grew = True
        if max_em > K_c:
            K_c = 1 << (max_em - 1).bit_length()
            grew = True
        if total > KG:
            KG = 1 << (total - 1).bit_length()
            grew = True
        if not grew:
            break
    caps[ka_key] = max(caps.get(ka_key, 0), KA)
    caps[kc_key] = max(caps.get(kc_key, 0), K_c)
    caps[kg_key] = max(caps.get(kg_key, 0), KG)

    rows = buf[1 : 1 + total]
    from .emit import decode_matches

    results = decode_matches(
        engine, view, haystack, n,
        rows[:, 0], rows[:, 1], rows[:, 2],
        rows[:, 3].copy().view(np.float32), rows[:, 4],
        thr,
    )
    engine.last_stats = {
        "backend": "device-fuzzy-fused",
        "anchors": count_a,
        "positions": int(n),
        "emissions": total,
        "matches": len(results),
    }
    return results


#: Below this corpus size the bitap pre-pass isn't worth its transcode.
FILTER_MIN_N = 1 << 14
#: The per-pattern bitap pre-pass is linear in pattern count; beyond this the
#: seed-partition filter (future stage) takes over and we scan all anchors.
FILTER_MAX_PATTERNS = 64


def _candidate_starts(engine, haystack, view, n, thr) -> np.ndarray:
    """Anchor positions that can possibly start a match, via the bit-parallel
    prefilter when reducible (conservative superset — identical final results;
    soundness argument at reference src/prefilter.rs:10-21). Falls back to
    every position."""
    every = np.arange(n, dtype=np.int32)
    if n < FILTER_MIN_N:
        return every

    # Preferred: the packed multi-pattern shift-AND kernel — one device pass
    # with per-pattern edit budgets derived from the threshold (far tighter
    # than the seed-partition pieces, so the beam kernel sees fewer anchors).
    from .packed_bitap import fuzzy_anchors_packed

    anchors = fuzzy_anchors_packed(engine, haystack, thr)
    if anchors is not None:
        return anchors

    # Next: the seed-partition filter — one exact-kernel device pass
    # regardless of dictionary size (the per-pattern bitap pass is linear in
    # pattern count and host-bound).
    from .seeds import SeedFilter

    sf = getattr(engine, "_seed_filter_cache", None)
    if sf is None:
        sf = SeedFilter.build(engine)
        engine._seed_filter_cache = sf if sf is not None else False
    if sf is not False and sf is not None:
        return sf.candidate_starts(haystack, n)
    if len(engine._patterns) > FILTER_MAX_PATTERNS:
        return every

    from ..prefilter import BitapFilter

    filt = getattr(engine, "_bitap_filter_cache", None)
    if filt is None:
        filt = BitapFilter.build(engine)
        engine._bitap_filter_cache = filt if filt is not None else False
    if filt is False or filt is None:
        return every

    ks = []
    for bp in filt.patterns:
        k = filt.k_for(bp, thr)
        if k is None:
            return every
        ks.append(k)

    from ..utils import native

    bids, _offsets = filt.transcode(haystack)
    flags = np.zeros(n + 1, dtype=np.int64)
    for bp, k in zip(filt.patterns, ks):
        hits = native.bitap_scan_hits(bp.mask, bp.m, k, bids)
        span = bp.m + k
        if hits is None:
            from .bitap import bitap_windows_chunked

            wins: list = []
            bitap_windows_chunked(bp.mask, bp.m, k, bids, wins)
            for s, e in wins:
                flags[s] += 1
                flags[min(e, n)] -= 1
        else:
            ends = np.nonzero(hits)[0] + 1
            starts_w = np.maximum(ends - span, 0)
            np.add.at(flags, starts_w, 1)
            np.add.at(flags, np.minimum(ends, n), -1)
    covered = np.cumsum(flags[:n]) > 0
    return np.nonzero(covered)[0].astype(np.int32)


def fuzzy_search_device(engine, haystack: str, threshold: float, view=None) -> List["FuzzyMatch"]:
    """Device fuzzy search (FAST-path configs): oracle-identical matches."""
    from ..structs import FuzzyMatch, f32
    from ..utils.graphemes import view_of
    from .. import oracle

    dense = engine.dense
    thr = np.float32(threshold)
    if view is None:
        view = view_of(haystack, engine.case_insensitive)
    n = len(view)  # grapheme count == transcoded length
    if n == 0:
        return []

    E = engine.max_edits_fast
    L_max = dense.max_depth
    LSPAN = L_max + E
    T = L_max + E  # rounds; states can exist at rounds 1..T

    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_pen = np.float32(ceil[0])
    if np.float32(0.0) > max_pen:
        return []

    # Banded-DP verify pipeline (hits -> per-field candidates -> Damerau DP,
    # one jit dispatch + one device_get) — the fast lane for packed-prefilter
    # engines at any fast-path edit budget. ~(2E+1) x depth cell updates per
    # candidate vs ~pool x rounds for the beam kernels below.
    # No minimum size gate: small searches share the smallest resident
    # bucket's compiled shape, and a ~5 ms DP dispatch beats the beam
    # kernels' padded NCHUNK start grid by orders of magnitude on tiny
    # forced-device inputs (the 'auto' backend serves those from the host).
    from .verify_dp import fuzzy_search_dp

    dp = fuzzy_search_dp(engine, haystack, threshold, view, n)
    if dp is not None:
        return dp

    # Large dictionaries: the single-kernel packing itself fails (total
    # pattern bits past the limb budget) -> the pattern-chunked lane,
    # whose compile cost is independent of dictionary size (ops/many).
    from .packed_bitap import packed_fuzzy_of

    if packed_fuzzy_of(engine) is None:
        from .many import fuzzy_search_many

        res = fuzzy_search_many(engine, haystack, threshold, view, n)
        if res is not None:
            return res

    # Fused single-dispatch pipeline (anchors + beam + compaction in one jit,
    # one device_get) for E=1 with the packed prefilter; everything else
    # takes the chunked path below.
    if E == 1 and n >= FILTER_MIN_N:
        fused = _fuzzy1_fused(engine, haystack, thr, view, n, L_max + E, max_pen, ceil)
        if fused is not None:
            return fused

    # Split edge tables: full width for the root round, non-root max for the
    # steady-state rounds (the root never reappears — no fail links).
    deg = (dense.edge_target >= 0).sum(axis=1)
    d_deep = int(deg[1:].max()) if dense.num_nodes > 1 else 1
    d_deep = max(d_deep, 1)

    # Beam width: generous for the edit budget; overflow falls back per start.
    # (E == 1 routes to the sort-free pool kernel: structural capacity, no
    # overflow possible.)
    B = 32 + 24 * E
    width = (2 * d_deep + 2) * T if E == 1 else B
    # Chunk size bounded so the round history stays comfortably in HBM.
    nchunk = NCHUNK
    while nchunk > 1024 and nchunk * (T + 1) * width * 24 > 512 * 1024 * 1024:
        nchunk //= 2

    # Device-resident automaton tables, cached per engine (re-shipping them
    # per search costs more than the kernel on small corpora).
    tabs = getattr(engine, "_fuzzy_dev_tables", None)
    if tabs is None or tabs[0] != d_deep:
        tabs = (
            d_deep,
            jax.device_put(dense.goto.reshape(-1)),
            jax.device_put(dense.sb_edge.reshape(-1)),
            jax.device_put(dense.edge_target),
            jax.device_put(dense.edge_class),
            jax.device_put(np.ascontiguousarray(dense.edge_target[:, :d_deep])),
            jax.device_put(np.ascontiguousarray(dense.edge_class[:, :d_deep])),
            jax.device_put(dense.sim.reshape(-1)),
            jax.device_put(dense.out_count),
            jax.device_put(dense.out_list),
            jax.device_put(dense.pat_len),
            jax.device_put(dense.pat_weight),
        )
        engine._fuzzy_dev_tables = tabs
    (_, goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
     out_count, out_list, pat_len, pat_weight) = tabs
    node_ceil = jax.device_put(ceil)
    pens = engine.penalties

    hay_bytes = view.hay_bytes()
    is_ascii = view.ascii
    patterns = engine._patterns

    best: dict = {}
    overflow_starts: list[int] = []

    # Candidate anchors: every position, or the bitap-filtered subset for
    # large corpora (identical results — the filter is a conservative
    # over-approximation, reference src/prefilter.rs:1-23).
    cand = _candidate_starts(engine, haystack, view, n, thr)

    # Corpus device-resident across searches (utils/device_corpus): dense
    # class ids, shipped once as uint8 when the alphabet fits. The bucketed
    # zero tail is dead (class 0 has no edges) and anchors stop at n, which
    # also covers the kernel's LSPAN lookahead reads.
    from ..utils import device_corpus
    from .packed_bitap import _space_token

    narrow = dense.num_classes <= 256
    ids_dev, n_ids = device_corpus.resident(
        haystack,
        ("dense", _space_token(engine)),
        lambda h: np.ascontiguousarray(
            dense.transcode(h, view), dtype=np.uint8 if narrow else np.int32
        ),
    )
    assert n_ids == n
    limit = np.int32(n)

    for c0 in range(0, len(cand), nchunk):
        starts_chunk = np.full(nchunk, n, dtype=np.int32)  # pad anchors = dead
        src = cand[c0 : c0 + nchunk]
        starts_chunk[: len(src)] = src

        K, KO = 4096, 256
        starts_dev = jax.device_put(starts_chunk)
        while True:
            if E == 1:
                out = _fuzzy1_scan_kernel(
                    goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
                    out_count, out_list, pat_len, pat_weight, node_ceil,
                    ids_dev, starts_dev, limit, max_pen,
                    pens.substitution, pens.insertion, pens.deletion, pens.swap,
                    engine.min_symbol_similarity, thr,
                    C=dense.num_classes, T=T, K=K,
                )
            else:
                out = _fuzzy_scan_kernel(
                    goto_flat, sb_flat, et_full, ec_full, et_deep, ec_deep, sim_flat,
                    out_count, out_list, pat_len, pat_weight, node_ceil,
                    ids_dev, starts_dev, limit, max_pen,
                    pens.substitution, pens.insertion, pens.deletion, pens.swap,
                    engine.min_symbol_similarity, thr,
                    dense.num_classes, B, T, E, K, KO,
                )
            count, ov_count = int(out[0]), int(out[6])
            if count <= K and ov_count <= KO:
                break
            if count > K:
                K = 1 << (count - 1).bit_length()
            if ov_count > KO:
                KO = 1 << (ov_count - 1).bit_length()
        _, em_i, em_me, em_pat, em_pen, em_counts, _, ov_idx = out
        em_i = np.asarray(em_i[:count])
        em_me = np.asarray(em_me[:count])
        em_pat = np.asarray(em_pat[:count])
        em_pen = np.asarray(em_pen[:count])
        em_counts = np.asarray(em_counts[:count])
        # Exact f32 similarity in the oracle's op order (the kernel's division
        # is reciprocal-multiply, 1 ULP off) + exact threshold refilter.
        pl = dense.pat_len[np.maximum(em_pat, 0)]
        pw = dense.pat_weight[np.maximum(em_pat, 0)]
        em_sim = np.float32(np.float32(np.float32(pl - em_pen) / pl) * pw)
        ov_local = set(
            int(x) for x in np.asarray(ov_idx[:ov_count]) if 0 <= int(x) < len(src)
        )

        for i, me, p, s, cnts in zip(em_i, em_me, em_pat, em_sim, em_counts):
            i = int(i)
            if i < 0 or i >= len(src) or i in ov_local:
                continue
            if s < thr:
                continue
            start_g = int(starts_chunk[i])
            if start_g >= n:
                continue
            end_g = start_g + int(me)
            sb = start_g if is_ascii else view.byte_offset(start_g)
            eb = (
                end_g
                if is_ascii
                else (view.byte_offset(end_g) if end_g < n else len(hay_bytes))
            )
            key = (sb, eb, int(p))
            s = np.float32(s)
            entry = best.get(key)
            if entry is None or s > entry[0]:
                best[key] = (s, int(cnts))
        overflow_starts.extend(int(starts_chunk[i]) for i in ov_local)

    # Oracle rescue for beam-overflowed starts (exactness guarantee).
    if overflow_starts:
        span = engine.max_match_graphemes() + 1
        for s_g in overflow_starts:
            sb0 = s_g if is_ascii else view.byte_offset(s_g)
            e_g = min(n, s_g + span)
            eb0 = e_g if is_ascii else (view.byte_offset(e_g) if e_g < n else len(hay_bytes))
            sub = hay_bytes[sb0:eb0].decode("utf-8")
            for m in oracle.search_raw(engine, sub, threshold, only_first_window=True):
                key = (sb0 + m.start, sb0 + m.end, m.pattern_index)
                cnts = (
                    m.insertions | (m.deletions << 8) | (m.substitutions << 16) | (m.swaps << 24)
                )
                entry = best.get(key)
                if entry is None or m.similarity > entry[0]:
                    best[key] = (np.float32(m.similarity), cnts)

    engine.last_stats = {
        "backend": "device-fuzzy",
        "anchors": int(len(cand)),
        "positions": int(n),
        "overflow_rescues": len(overflow_starts),
        "matches": len(best),
    }
    results: List[FuzzyMatch] = []
    for (sb, eb, p), (s, cnts) in best.items():
        ins_c = cnts & 0xFF
        del_c = (cnts >> 8) & 0xFF
        sub_c = (cnts >> 16) & 0xFF
        swap_c = (cnts >> 24) & 0xFF
        results.append(
            FuzzyMatch(
                insertions=ins_c,
                deletions=del_c,
                substitutions=sub_c,
                swaps=swap_c,
                edits=ins_c + del_c + sub_c + swap_c,
                pattern_index=p,
                pattern=patterns[p],
                start=sb,
                end=eb,
                similarity=s,
                text=hay_bytes[sb:eb].decode("utf-8"),
            )
        )
    return results
