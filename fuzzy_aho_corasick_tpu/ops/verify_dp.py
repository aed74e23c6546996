"""Banded Damerau DP verify kernel: the fast fuzzy path for packed engines.

Device replacement for frontier expansion on the hot path. The insight:
the trie is a *tree*, so a BFS state at node ``v`` with ``j`` haystack symbols
consumed is reachable only along ``v``'s unique root path — its minimum
penalty is exactly the banded weighted edit distance between ``path(v)`` and
``haystack[s : s+j]`` (substitution scaled by the similarity table, insertion/
deletion/swap at their configured penalties; reference edit branches
src/search.rs:776-1089). So instead of expanding a beam of trie states per
anchor (~P x T state updates), we:

1. run the packed multi-pattern shift-AND scan ONCE over the corpus with
   per-pattern error budgets (ops/packed_bitap.packed_hits) — every true
   match of pattern ``p`` fires p's bit at the match's exact end position
   (the same NFA-path soundness argument as the reference prefilter,
   src/prefilter.rs:10-21, with swaps counted as 2 unit errors);
2. expand each (pattern, end) hit into candidate (output-node field, start)
   pairs: a <=E-edit match of a depth-``d`` output node consumes ``d + net``
   haystack symbols with ``net`` in [-E, E], so ``start = end - d - delta`` —
   2E+1 candidates per (field, hit);
3. verify each candidate with a banded (2E+1 diagonals) Damerau DP over the
   field's path string, replicating the oracle's f32 penalty arithmetic,
   weakest-link floor, per-node prune ceilings and global budget guards —
   ~(2E+1) x depth cell updates per candidate vs ~P x T for the beam.

Emission semantics: the oracle's span end ``me`` is the column of the last
*consuming* move (exact/substitution/swap); insertions advance ``j`` without
advancing ``me`` and deletions advance neither (reference state updates
src/search.rs:776-1089). The DP therefore carries two channels per cell:

* ``pen``  — min penalty over ALL scripts (continuation channel: feeds the
  next row's transitions);
* ``pen_e`` — min penalty over scripts whose moves after the last consume are
  deletions only (emission channel): ``pen_e(i,j) = min(diag/swap arrivals,
  pen_e(i-1,j) + p_del)``. Emission at row ``d`` column ``e`` reads
  ``pen_e(d, e)`` — trailing insertions never emit (they would report a span
  the oracle attributes to an earlier ``me``).

Per-cell tie-breaking on equal penalty prefers fewer edits, then
exact/substitution > swap > insertion > deletion — the BFS push order
(src/search.rs:776-1089); states that tie on penalty but differ in edit-type
counts collapse to that winner (the oracle keeps both and reports the
first-popped; identical (span, pattern, similarity) tuples either way,
differentially tested).

Everything — hits, candidate expansion, DP, emission compaction — runs in ONE
jit dispatch with ONE device_get of a single int32 buffer (every transfer
pays a fixed host-link latency; format shared with
ops/fuzzy._fuzzy1_pipeline_jit).
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from .compact import compact_indices


class VerifyFields:
    """Host-side DP tables: one field per output-bearing trie node.

    Suffix patterns merged into a deeper node's output list (reference
    builder output-union src/builder.rs:239-276) emit with the full walked
    span, so the DP string is the *node path*, not the pattern — the same
    field model as ops/packed_bitap.PackedExact.
    """

    __slots__ = (
        "num_fields", "depth", "node", "path_cls", "path_node", "max_depth",
        "pat2field", "nf_max",
    )

    def __init__(self, num_fields, depth, node, path_cls, path_node, max_depth,
                 pat2field, nf_max):
        self.num_fields = num_fields
        self.depth = depth
        self.node = node
        self.path_cls = path_cls
        self.path_node = path_node
        self.max_depth = max_depth
        self.pat2field = pat2field
        self.nf_max = nf_max

    @staticmethod
    def build(engine) -> Optional["VerifyFields"]:
        dense = engine.dense
        nodes = engine.nodes
        if nodes[0].output:
            return None  # empty patterns keep oracle semantics

        fields: list = []  # (node_id, class path, node path)
        stack = [(0, [], [])]
        while stack:
            ni, cls_path, node_path = stack.pop()
            node = nodes[ni]
            if node.output and ni != 0:
                fields.append((ni, cls_path, node_path))
            for fc, nxt, _single in node.edges:
                cid = dense.char_class.get(fc, 0)
                stack.append((nxt, cls_path + [cid], node_path + [nxt]))
        if not fields:
            return None

        F = len(fields)
        max_depth = max(len(p) for _, p, _ in fields)
        depth = np.asarray([len(p) for _, p, _ in fields], dtype=np.int32)
        node_arr = np.asarray([ni for ni, _, _ in fields], dtype=np.int32)
        path_cls = np.zeros((F, max_depth), dtype=np.int32)
        path_node = np.zeros((F, max_depth), dtype=np.int32)
        for i, (_ni, cls, npath) in enumerate(fields):
            path_cls[i, : len(cls)] = cls
            path_node[i, : len(npath)] = npath

        # pattern -> fields whose node.output contains it (usually one).
        P = len(engine._patterns)
        lists: list[list[int]] = [[] for _ in range(P)]
        for i, (ni, _c, _n) in enumerate(fields):
            for p in nodes[ni].output:
                lists[p].append(i)
        nf_max = max(len(l) for l in lists)
        if nf_max == 0:
            return None
        pat2field = np.full((P, nf_max), -1, dtype=np.int32)
        for p, l in enumerate(lists):
            pat2field[p, : len(l)] = l
        return VerifyFields(F, depth, node_arr, path_cls, path_node, max_depth,
                            pat2field, nf_max)


def _fine_cap(n: int, lo: int = 4096) -> int:
    """Smallest capacity >= n of the form (8..15)/8 * 2^k (<= 12.5%
    overshoot): result buffers cross the host link and device work tracks
    the static capacities, so power-of-two growth would waste up to half."""
    b = lo
    while b < n:
        p = 1 << (b.bit_length() - 1)
        b += p // 8 if b != p else b // 8
    return b


def verify_fields_of(engine) -> Optional[VerifyFields]:
    vf = getattr(engine, "_verify_fields_cache", None)
    if vf is None:
        vf = VerifyFields.build(engine)
        engine._verify_fields_cache = vf if vf is not None else False
    return vf if vf is not False else None


# ---------------------------------------------------------------------------
# Mapped-engine support: static mapping-arrival tables for the banded DP
# ---------------------------------------------------------------------------

#: Deepest pattern-side mapping walk the DP history window supports.
MAPPED_PB_MAX = 3
#: Unrolled-DP row bound (mapping arrivals need static window indices).
MAPPED_LMAX = 24


class MappedSpec:
    """Static mapping-arrival tables for the banded DP (device lane for
    multi-char mappings — reference hot-loop branch src/search.rs:883-923,
    precompute src/builder.rs:383-442).

    A mapping at path offset ``i`` of a field consumes ``ha`` haystack
    symbols and ``pb`` pattern symbols at a fixed penalty, counting as one
    substitution-class edit. Because the trie is a tree, a
    ``MappingTransition`` at node ``u = node_at(i)`` whose ``next`` equals
    ``node_at(i + pb)`` applies to exactly that segment of the field's path
    — so every mapping the oracle can take along a root-to-output path
    becomes one static DP arrival ``(row i+pb, col j) <- (row i, col j-ha)``.

    ``maps`` is the static structure handed to ``_banded_dp``:
    a tuple of ``(i_to, pb, drift, hay_cls, penalty, fields)`` entries with
    ``drift = ha - pb`` (|drift| <= 1 keeps the band width at 2E+1).
    ``k`` is the packed-scan budget: every edit costs at most
    ``max(2, max(pb, ha))`` unit bitap errors (swap = 2, mapping =
    max(pb, ha): min(pb,ha) substitutions + |drift| indels), and the
    threshold-derived ``k_for`` is unsound here because a score-1.0 mapping
    has penalty 0 — so ``k = E * cmax`` from the edit budget alone.
    """

    __slots__ = ("maps", "k", "ph")

    def __init__(self, maps, k, ph):
        self.maps = maps
        self.k = k
        self.ph = ph

    @staticmethod
    def build(engine) -> Optional["MappedSpec"]:
        from .packed_bitap import packed_fuzzy_of

        if not engine.mappings:
            return None
        E = engine.max_edits_fast
        if not 1 <= E <= 6:
            return None
        dense = engine.dense
        if dense.has_multibyte_edges:
            # Exact transitions under mappings follow single-byte edges only
            # on the ASCII path / full-grapheme equality otherwise
            # (src/structs.rs:499-519); the class model matches the oracle
            # only when every edge is a single ASCII char.
            return None
        vf = verify_fields_of(engine)
        if vf is None or vf.max_depth > MAPPED_LMAX:
            return None
        pk = packed_fuzzy_of(engine)
        if pk is None:
            return None

        nodes = engine.nodes
        cmax = 2  # swap costs 2 unit bitap errors (reference prefilter.rs:174-183)
        grouped: dict[tuple, list] = {}
        for fi in range(vf.num_fields):
            d = int(vf.depth[fi])
            path_node = vf.path_node[fi]

            def node_at(i: int) -> int:
                return 0 if i == 0 else int(path_node[i - 1])

            for i in range(d):
                mts = engine.mappings.get(node_at(i))
                if not mts:
                    continue
                for mt in mts:
                    pb = nodes[mt.next].depth - nodes[node_at(i)].depth
                    if pb < 1 or i + pb > d or node_at(i + pb) != mt.next:
                        continue
                    if any(len(g) != 1 for g in mt.haystack):
                        # Multi-char haystack graphemes can never occur under
                        # the lane's haystack gate (all graphemes 1 code
                        # point) — the entry is statically unmatchable.
                        continue
                    ha = len(mt.haystack)
                    drift = ha - pb
                    if pb > MAPPED_PB_MAX or abs(drift) > 1:
                        return None  # whole engine declines -> oracle
                    hay_cls = tuple(dense.char_class.get(g, 0) for g in mt.haystack)
                    if 0 in hay_cls:
                        return None  # defensive: dense must class every hay char
                    key = (i + pb, pb, drift, hay_cls, float(np.float32(mt.penalty)))
                    grouped.setdefault(key, []).append(fi)
        maps = tuple(
            (i_to, pb, drift, hay_cls, pen, tuple(sorted(set(fields))))
            for (i_to, pb, drift, hay_cls, pen), fields in sorted(grouped.items())
        )
        k = E * max(cmax, max(
            (max(pb, pb + drift) for _t, pb, drift, _h, _p, _f in maps),
            default=1,
        ))
        from ..prefilter import MAX_USEFUL_K

        if k > MAX_USEFUL_K:
            return None
        ph = max([2] + [pb for _t, pb, _d, _h, _p, _f in maps])
        return MappedSpec(maps, k, ph)


def mapped_spec_of(engine) -> Optional[MappedSpec]:
    ms = getattr(engine, "_mapped_spec_cache", None)
    if ms is None:
        ms = MappedSpec.build(engine)
        engine._mapped_spec_cache = ms if ms is not None else False
    return ms if ms is not False else None


# ---------------------------------------------------------------------------
# DP core (traceable)
# ---------------------------------------------------------------------------

def _banded_dp(
    cand_field, cand_start,
    path_cls_flat, path_node_flat, depth_arr,
    ids_pad, limit, sim_flat, node_ceil,
    max_pen, p_sub, p_ins, p_del, p_swap, floor,
    E, Lmax, C,
    ids_w32=None,
    lo=None,
    deadend=False,
    sb_edge_flat=None,
    out_count_arr=None,
    MAPS=None,
    FORBID=None,
):
    """Banded Damerau DP over candidates.

    ``lo`` (traced scalar, default 0) marks haystack positions below it as
    out-of-text — the sharded path uses it so a shard's left-halo region
    reads as before-stream-start on shard 0.

    ``deadend`` (static) enables the reference's last-edit dead-end filter
    (src/search.rs:839-847, 994-1007, 1050-1063): an edit move that spends
    the final budget unit is dropped unless the resulting node has output or
    a SINGLE-byte edge matching the next text char (``sb_edge_flat``,
    ``out_count_arr``; see ops/dense.py sb_edge). For single-byte-only tries
    the filter provably never changes results (a filtered state cannot
    advance at all), so callers gate it on ``dense.has_multibyte_edges`` and
    ASCII dictionaries pay nothing.

    cand_field/cand_start: [M] (field index, anchor start; field -1 = dead
    slot). Returns (emit_pen [M, B, E+1], emit_cnt [M, B, E+1]) — the
    emission channel at each candidate's row ``depth``, column
    ``j = depth + (b - E)``, per exact edit count; dead cells carry +inf.

    Each cell keeps one state PER EDIT COUNT — a Pareto front over
    (penalty, edits). A plain min-penalty cell is wrong: the cheapest script
    can exhaust the edit budget while a costlier script with fewer edits
    still completes (the oracle's visited key includes the edit counts,
    src/search.rs:31-50, so such states coexist there too). Within one
    (cell, edits) channel the packed per-type counts of the min-penalty
    script are kept for reporting.

    Layout: the haystack window is fetched with a handful of packed-u32
    word gathers, per-candidate path/ceiling/similarity tables come from
    small-table row gathers, the similarity band is materialized by
    class-count selects (bit-exact f32 — no arithmetic), and every loop
    array is laid out with the candidate axis LAST ([rows, M], [Lmax, B, M]).
    The scan body uses only static-width dynamic slices along the leading
    row axis. (This layout was chosen for an earlier accelerator's gather
    and tiling costs; it has not been re-tuned for the GPU.)
    """
    M = cand_field.shape[0]
    B = 2 * E + 1
    NE = E + 1
    F = depth_arr.shape[0]
    npad = ids_pad.shape[0]
    INF = jnp.float32(np.inf)

    # Forbidden edit types (static): configs like edits(2).swaps(0) — a
    # total budget with some per-type caps at 0 and the rest unlimited —
    # ride this cheap count-channel DP with the forbidden arrivals compiled
    # out, instead of the ~3x-heavier type-vector-channel DP (counts of a
    # disabled type are identically 0, so the oracle's per-type emission
    # checks hold for free; reference limit semantics src/search.rs:87-169).
    f_ins, f_del, f_sub, f_swap = FORBID if FORBID is not None else (
        False, False, False, False
    )

    # Mapping arrivals (static, unrolled path only — see MappedSpec): row
    # history depth PH covers the deepest pattern-side walk. MAPS entries
    # grouped by target row for O(1) lookup per unrolled row.
    PH = 2
    maps_by_row: dict = {}
    if MAPS:
        for (i_to, pb, drift, hay_cls, mpen, fields) in MAPS:
            PH = max(PH, pb)
            maps_by_row.setdefault(i_to, []).append(
                (pb, drift, hay_cls, mpen, fields)
            )
        assert Lmax <= 24, "mapped DP requires the unrolled path"

    f = jnp.maximum(cand_field, 0)
    alive_c = cand_field >= 0
    # The dead-end filter reads one text char past the band's last column.
    WLEN = Lmax + 2 * E + 1 + (1 if deadend else 0)
    if lo is None:
        lo = jnp.int32(0)

    # --- one-time pre-gather (per candidate) -----------------------------
    # Random reads cost ~0.9 ms per gather OP on this target (latency-bound,
    # nearly independent of bytes/read), while ALIGNED row gathers pull 32+
    # bytes for the same price — so every per-candidate lookup below is
    # batched into as few row gathers as possible. optimization_barrier
    # forces the gather+transpose results to MATERIALIZE in [rows, M]
    # layout: without it XLA fuses the lazy transpose into every consumer,
    # re-running the per-candidate gather once per consuming op (700+
    # consumers).
    path_cls2d = path_cls_flat.reshape(F, Lmax)
    path_node2d = path_node_flat.reshape(F, Lmax)
    ceil_tab = node_ceil[path_node2d]                         # [F, Lmax]
    # depth rides as an extra column of the class-path row gather; per-row
    # output flags ride with the ceiling gather when the dead-end filter is
    # on (both are per-(field, row) scalars).
    pc_d = jnp.concatenate([path_cls2d, depth_arr[:, None]], axis=1)
    if deadend:
        out_tab = (out_count_arr[path_node2d] > 0).astype(jnp.float32)
        ceil_tab = jnp.concatenate([ceil_tab, out_tab], axis=1)
    pcd_T, ceil_o_T = jax.lax.optimization_barrier(
        (pc_d[f].T, ceil_tab[f].T)                # [Lmax+1, M], [Lmax(+Lmax), M]
    )
    ceil_T = ceil_o_T[:Lmax]
    out_T = (ceil_o_T[Lmax:] > 0.5) if deadend else None      # [Lmax, M]
    pcls_T = pcd_T[:Lmax]
    dpth = jnp.where(alive_c, pcd_T[Lmax], 0)

    # Haystack window: row o <-> hay(cand_start + o - E - 1), o in [0, WLEN)
    # (rows 0..E are the lookback). Fetched as TWO aligned 32-byte row
    # gathers per candidate from a [npad/32, 8]-u32 view, then per-column
    # word selects + shifts (pure VPU) — vs one ~0.9 ms gather per word in
    # the element-gather form. Resident buffers guarantee a >= 128
    # dead-symbol tail (device_corpus.TAIL_MARGIN) so row reads never clamp
    # for live candidates.
    base_abs = cand_start - (E + 1)               # >= -(E+1)
    win_rows = []
    if ids_pad.dtype == jnp.uint8 and npad % 32 == 0 and WLEN <= 60:
        if ids_w32 is None or ids_w32.shape[0] == 0:
            # Fallback pack (callers pass the resident pre-packed view — an
            # in-graph bitcast costs ~45 ms per 100 MB, see
            # utils/device_corpus.resident_words; a size-0 sentinel stands
            # for None through jit boundaries).
            ids_w32 = jax.lax.bitcast_convert_type(
                ids_pad.reshape(-1, 4), jnp.uint32
            ).reshape(-1, 8)                       # [npad/32, 8]
        nrows_mat = ids_w32.shape[0]
        rb = jnp.maximum(base_abs, 0) >> 5
        fetch = jnp.concatenate(
            [
                ids_w32[jnp.minimum(rb + t, nrows_mat - 1)]
                for t in range(2)
            ],
            axis=1,
        )                                          # [M, 16] u32
        fetT = jax.lax.optimization_barrier(fetch.T)          # [16, M]
        d0 = base_abs - (rb << 5)                  # byte offset, [-(E+1), 31]
        for o in range(WLEN):
            q = d0 + o                             # fetch byte index
            q_c = jnp.maximum(q, 0)
            wi = q_c >> 2
            sh = ((q_c & 3) * 8).astype(jnp.uint32)
            lo_w = max(0, (o - (E + 1)) >> 2)
            hi_w = min(15, (o + 31) >> 2)
            word = fetT[lo_w]
            for s in range(lo_w + 1, hi_w + 1):
                word = jnp.where(wi == s, fetT[s], word)
            sym = ((word >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)
            abs_i = base_abs + o
            win_rows.append(
                jnp.where((abs_i >= lo) & (abs_i >= 0) & (abs_i < limit), sym, -1)
            )
    else:
        for o in range(WLEN):
            idx = base_abs + o
            sym = ids_pad[jnp.clip(idx, 0, npad - 1)].astype(jnp.int32)
            win_rows.append(
                jnp.where((idx >= lo) & (idx >= 0) & (idx < limit), sym, -1)
            )
        win_rows = list(jax.lax.optimization_barrier(tuple(win_rows)))

    # Similarity band: simband[l, b, m] = sim(path_cls[f, l], win[l+1+b, m]),
    # bit-exact f32. For small alphabets: free row-gather of the per-field
    # path similarity rows + one select per class (pure data movement, no
    # float arithmetic). For large alphabets: one flat-key gather per (l, b).
    sim2d = sim_flat.reshape(C, C)
    if C <= 64:
        sp_tab = sim2d[path_cls2d].reshape(F, Lmax * C)        # [F, Lmax*C]
        spg_T = jax.lax.optimization_barrier(sp_tab[f].T)      # [Lmax*C, M]
        sb_rows = []
        for l in range(Lmax):
            for b in range(B):
                hc = win_rows[l + 1 + b]
                acc = jnp.zeros((M,), jnp.float32)
                for c in range(C):
                    acc = jnp.where(hc == c, spg_T[l * C + c], acc)
                sb_rows.append(acc)
    else:
        # Fallback for huge alphabets (> 64 classes after the dense-table
        # column compression — rare). Gathers from small tables run at only
        # ~10^8 indices/s on this target whether batched or not, so this
        # branch is the slow lane; the compressed class space keeps normal
        # engines on the select-chain branch above.
        pcg = path_cls2d[f]                                    # [M, Lmax]
        sb_rows = []
        for l in range(Lmax):
            pc_l = pcg[:, l]
            for b in range(B):
                hc = win_rows[l + 1 + b]
                key = pc_l * C + jnp.maximum(hc, 0)
                sb_rows.append(sim_flat[key])

    # Dead-end band: okd[l, b] = node at row l+1 has output OR a single-byte
    # edge matching text[j] (win index l + b + 2) — the rescue predicate for
    # edit moves into the last edit level. Out-of-text chars read as -1 ->
    # class 0 -> no single-byte edge, reproducing the reference's
    # ``next_ch_opt is None`` output-only case.
    okd_rows = None
    if deadend:
        sb2d = sb_edge_flat.reshape(-1, C)
        okd_rows = []
        if C <= 64:
            sbp_tab = sb2d[path_node2d].reshape(F, Lmax * C)
            sbg_T = jax.lax.optimization_barrier(sbp_tab[f].T)  # [Lmax*C, M]
            for l in range(Lmax):
                for b in range(B):
                    hc = win_rows[l + b + 2]
                    acc = jnp.zeros((M,), jnp.bool_)
                    for c in range(C):
                        acc = jnp.where(hc == c, sbg_T[l * C + c] > 0, acc)
                    okd_rows.append(out_T[l] | acc)
        else:
            png = path_node2d[f]                               # [M, Lmax]
            for l in range(Lmax):
                pn_l = png[:, l]
                for b in range(B):
                    hc = win_rows[l + b + 2]
                    key = pn_l * C + jnp.maximum(hc, 0)
                    okd_rows.append(out_T[l] | (sb_edge_flat[key] > 0))

    def grid_init():
        pen = [[jnp.full((M,), INF, jnp.float32) for _ in range(NE)] for _ in range(B)]
        cnt = [[jnp.zeros((M,), jnp.int32) for _ in range(NE)] for _ in range(B)]
        return pen, cnt

    zero_or_inf = jnp.where(alive_c, jnp.float32(0.0), INF)
    pen0, cnt0 = grid_init()
    pen0[E][0] = zero_or_inf
    pen_m1, cnt_m1 = grid_init()  # row -1 (the swap's i-2 lookback)
    pen_e0, cnt_e0 = grid_init()  # emission channel row 0 (empty prefix)
    pen_e0[E][0] = zero_or_inf

    def merge(bp, bc, op, oc, ok):
        """Pick (op, oc) over (bp, bc) when strictly lower penalty; the
        earlier argument wins ties (BFS push order)."""
        op = jnp.where(ok, op, INF)
        take = op < bp
        return jnp.where(take, op, bp), jnp.where(take, oc, bc)

    def step_body(carry, i, pc, pc_prev, ceil_i, winrow, simrow, okrow=None,
                  maps_row=()):
        """One DP row. ``i`` may be a python int (unrolled) or a traced
        scalar (lax.scan); ``winrow``/``simrow``/``okrow`` index like
        sequences. ``okrow[b]`` (when the dead-end filter is on) rescues an
        edit move into the final edit level at band ``b``. ``maps_row``
        (static; unrolled path only) lists the mapping arrivals targeting
        this row — see :class:`MappedSpec`."""
        (hist, preve_pen, preve_cnt, emit_pen, emit_cnt) = carry
        prev_pen, prev_cnt = hist[0]      # row i-1
        prev2_pen, prev2_cnt = hist[1]    # row i-2
        row_live = alive_c & (i <= dpth)

        cons_pen, cons_cnt = grid_init()   # consuming arrivals (diag/swap)
        new_pen, new_cnt = grid_init()     # full continuation channel
        hcs = []
        for b in range(B):
            j = i + (b - E)  # haystack symbols consumed at this cell
            hc = winrow[b + 1]
            hcs.append(hc)
            hc_jm1 = winrow[b]
            sim = simrow[b]
            spen = jnp.float32(p_sub * (np.float32(1.0) - sim))
            j_ok = j >= 1
            for e in range(NE):
                # exact: (i-1, b, e) — no edit (src/search.rs:776-798)
                p_pen = prev_pen[b][e]
                bp = jnp.where(
                    jnp.isfinite(p_pen) & j_ok & (hc == pc), p_pen, INF
                )
                bc = prev_cnt[b][e]
                if e >= 1 and not f_sub:
                    # substitution: (i-1, b, e-1) (src/search.rs:803-874)
                    q_pen = prev_pen[b][e - 1]
                    q_cnt = prev_cnt[b][e - 1]
                    ok_s = (
                        jnp.isfinite(q_pen) & j_ok & (hc >= 0) & (hc != pc)
                        & ~(sim < floor)
                        & ~(spen > (max_pen - q_pen))
                    )
                    if okrow is not None and e == NE - 1:
                        ok_s &= okrow[b]
                    bp, bc = merge(bp, bc, q_pen + spen, q_cnt + 0x1_0000, ok_s)
                if e >= 1 and not f_swap:
                    # swap: (i-2, b, e-1) (src/search.rs:935-989)
                    s_pen = prev2_pen[b][e - 1]
                    s_cnt = prev2_cnt[b][e - 1]
                    ok_sw = (
                        jnp.isfinite(s_pen) & (i >= 2) & (j >= 2)
                        & ~(p_swap > (max_pen - s_pen))
                        & (hc >= 0) & (hc_jm1 >= 0)
                        & (hc == pc_prev) & (hc_jm1 == pc)
                    )
                    bp, bc = merge(bp, bc, s_pen + p_swap, s_cnt + 0x100_0000, ok_sw)
                cons_pen[b][e] = bp
                cons_cnt[b][e] = bc
                # deletion: (i-1, b+1, e-1) — consume pc only
                # (src/search.rs:1035-1089; column j is band b+1 on row i-1)
                if e >= 1 and b + 1 < B and not f_del:
                    d_pen = prev_pen[b + 1][e - 1]
                    d_cnt = prev_cnt[b + 1][e - 1]
                    ok_del = jnp.isfinite(d_pen) & ~(p_del > (max_pen - d_pen))
                    if okrow is not None and e == NE - 1:
                        ok_del &= okrow[b]
                    bp, bc = merge(bp, bc, d_pen + p_del, d_cnt + 0x100, ok_del)
                new_pen[b][e] = bp
                new_cnt[b][e] = bc

        # Mapping arrivals (src/search.rs:883-923): (row i-pb, col j-ha) ->
        # (row i, col j) consuming ``ha`` haystack symbols that must equal
        # the mapping's haystack classes (dedicated classes = char identity,
        # ops/dense.py), at a fixed penalty, counting one substitution-class
        # edit. Consuming move: merges into BOTH the continuation channel
        # (so insertions/deletions can follow) and the emission channel.
        # Guard matches the oracle: new_pen > max_penalties at push time.
        for (pb, drift, hay_cls, mpen, fields) in maps_row:
            if i - pb < 0:
                continue
            src_pen_g, src_cnt_g = hist[pb - 1]   # row i - pb
            ha = len(hay_cls)
            fm = jnp.zeros((M,), jnp.bool_)
            for fid in fields:
                fm = fm | (cand_field == fid)
            mp = jnp.float32(mpen)
            for b in range(B):
                b_src = b - drift
                if not 0 <= b_src < B:
                    continue
                j = i + (b - E)
                if j < ha:
                    continue  # would consume symbols before the match start
                ok_m = fm
                for t in range(ha):
                    # symbol consumed at column j-ha+1+t -> window offset
                    # i + b + 1 - ha + t (out-of-text reads -1, never a
                    # dedicated class >= 1).
                    ok_m = ok_m & (
                        win_rows[i + b + 1 - ha + t] == jnp.int32(hay_cls[t])
                    )
                for e in range(NE - 1, 0, -1):
                    q_pen = src_pen_g[b_src][e - 1]
                    ok_e = (
                        ok_m & jnp.isfinite(q_pen)
                        & ~((q_pen + mp) > max_pen)
                    )
                    val = q_pen + mp
                    cntv = src_cnt_g[b_src][e - 1] + 0x1_0000
                    cons_pen[b][e], cons_cnt[b][e] = merge(
                        cons_pen[b][e], cons_cnt[b][e], val, cntv, ok_e
                    )
                    new_pen[b][e], new_cnt[b][e] = merge(
                        new_pen[b][e], new_cnt[b][e], val, cntv, ok_e
                    )

        # insertion: same row, (b-1, e-1) -> b — consume hc only, ascending b
        # (src/search.rs:994-1029). Forbidden from cells with zero hay
        # consumed (the nothing-matched-yet rule): source col j-1 >= 1.
        for b in range(1, B) if not f_ins else ():
            j = i + (b - E)
            hc = hcs[b]
            for e in range(1, NE):
                ip = new_pen[b - 1][e - 1]
                ic = new_cnt[b - 1][e - 1]
                ok_ins = (
                    jnp.isfinite(ip)
                    & ~(p_ins > (max_pen - ip))
                    & (hc >= 0)
                    & (j >= 2)
                )
                if okrow is not None and e == NE - 1:
                    ok_ins &= okrow[b]
                new_pen[b][e], new_cnt[b][e] = merge(
                    new_pen[b][e], new_cnt[b][e], ip + p_ins, ic + 1, ok_ins
                )

        # Per-node prune ceiling + row liveness (src/search.rs:637-642), and
        # the emission channel: min(consuming arrival, trailing deletion from
        # the emission channel one row up — column j is band b+1 there).
        newe_pen, newe_cnt = grid_init()
        for b in range(B):
            for e in range(NE):
                dead = ~row_live | (new_pen[b][e] > ceil_i)
                new_pen[b][e] = jnp.where(dead, INF, new_pen[b][e])

                ep = cons_pen[b][e]
                ec = cons_cnt[b][e]
                if e >= 1 and b + 1 < B and not f_del:
                    t_pen = preve_pen[b + 1][e - 1]
                    t_cnt = preve_cnt[b + 1][e - 1]
                    ok_t = jnp.isfinite(t_pen) & ~(p_del > (max_pen - t_pen))
                    if okrow is not None and e == NE - 1:
                        ok_t &= okrow[b]
                    ep, ec = merge(ep, ec, t_pen + p_del, t_cnt + 0x100, ok_t)
                edead = ~row_live | (ep > ceil_i)
                newe_pen[b][e] = jnp.where(edead, INF, ep)
                newe_cnt[b][e] = ec

        # Latch the emission row where i == depth. Kept as B x NE lists of
        # [M] vectors, candidate axis last (the layout this DP was shaped
        # for; see _banded_dp's docstring).
        emit_here = row_live & (i == dpth)
        for b in range(B):
            for e in range(NE):
                emit_pen[b][e] = jnp.where(emit_here, newe_pen[b][e], emit_pen[b][e])
                emit_cnt[b][e] = jnp.where(emit_here, newe_cnt[b][e], emit_cnt[b][e])
        hist_new = ((new_pen, new_cnt),) + hist[: PH - 1]
        return (hist_new, newe_pen, newe_cnt, emit_pen, emit_cnt)

    epen0, ecnt0 = grid_init()
    # History: hist[0] = previous row, ..., hist[PH-1] = PH rows back.
    # Row 0 is the DP origin; negative rows are all-dead.
    hist0 = ((pen0, cnt0), (pen_m1, cnt_m1))
    while len(hist0) < PH:
        dead_p, dead_c = grid_init()
        hist0 = hist0 + ((dead_p, dead_c),)
    init = (hist0, pen_e0, cnt_e0, epen0, ecnt0)
    if Lmax <= 24:
        # Unrolled: static row indexing, and XLA fuses across DP rows —
        # a lax.scan body dispatches its fused kernels once per row, and
        # per-dispatch overhead (not bandwidth) dominates at [M] sizes.
        carry = init
        for i in range(1, Lmax + 1):
            winrow = [win_rows[i - 1 + t] for t in range(B + 1)]
            simrow = [sb_rows[(i - 1) * B + b] for b in range(B)]
            okrow = (
                [okd_rows[(i - 1) * B + b] for b in range(B)]
                if okd_rows is not None else None
            )
            carry = step_body(
                carry, i, pcls_T[i - 1], pcls_T[max(i - 2, 0)],
                ceil_T[i - 1], winrow, simrow, okrow,
                maps_row=tuple(maps_by_row.get(i, ())),
            )
    else:
        win = jnp.stack(win_rows, axis=0)                      # [WLEN, M]
        simband = jnp.stack(sb_rows, axis=0).reshape(Lmax, B, M)
        okband = (
            jnp.stack(okd_rows, axis=0).reshape(Lmax, B, M)
            if okd_rows is not None else None
        )

        def step(carry, i):
            pc = jax.lax.dynamic_slice_in_dim(pcls_T, i - 1, 1, axis=0)[0]
            pc_prev = jax.lax.dynamic_slice_in_dim(
                pcls_T, jnp.maximum(i - 2, 0), 1, axis=0
            )[0]
            ceil_i = jax.lax.dynamic_slice_in_dim(ceil_T, i - 1, 1, axis=0)[0]
            winrow = jax.lax.dynamic_slice_in_dim(win, i - 1, B + 1, axis=0)
            simrow = jax.lax.dynamic_slice(simband, (i - 1, 0, 0), (1, B, M))[0]
            okrow = (
                jax.lax.dynamic_slice(okband, (i - 1, 0, 0), (1, B, M))[0]
                if okband is not None else None
            )
            return step_body(carry, i, pc, pc_prev, ceil_i, winrow, simrow, okrow), None

        carry, _ = jax.lax.scan(step, init, jnp.arange(1, Lmax + 1, dtype=jnp.int32))
    emit_pen, emit_cnt = carry[3], carry[4]
    # [B*NE, M] (candidate axis last; callers index rows b * NE + e).
    pen_flat = jnp.stack([emit_pen[b][e] for b in range(B) for e in range(NE)])
    cnt_flat = jnp.stack([emit_cnt[b][e] for b in range(B) for e in range(NE)])
    return pen_flat, cnt_flat


# ---------------------------------------------------------------------------
# Fused pipeline: hits -> candidates -> DP -> compacted matches
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Typed-limits DP: channels are edit-type VECTORS, not counts
# ---------------------------------------------------------------------------

_CAP_BIG = 255
#: Most type-vector channels the typed DP compiles (E=4 all-free needs 70;
#: tighter per-type caps keep higher budgets under this too).
MAX_TYPED_CHANNELS = 96


def _caps_of(lim) -> tuple:
    """(cap_edits, cap_ins, cap_del, cap_subs, cap_swaps) with None -> BIG
    (finalized limits: either ``edits_`` set with per-type None = unlimited
    within the total, or ``edits_`` None with every per-type cap set —
    reference src/structs.rs:317-335)."""
    if lim is None:
        return (0, 0, 0, 0, 0)
    g = lambda v: _CAP_BIG if v is None else int(v)
    return (g(lim.edits_), g(lim.insertions_), g(lim.deletions_),
            g(lim.substitutions_), g(lim.swaps_))


def _total_of(lim) -> int:
    if lim is None:
        return 0
    if lim.edits_ is not None:
        return int(lim.edits_)
    return int((lim.insertions_ or 0) + (lim.deletions_ or 0)
               + (lim.substitutions_ or 0) + (lim.swaps_ or 0))


class TypedSpec:
    """Static channel spec for per-type / per-pattern limit configurations.

    The uniform DP keeps one state per (cell, edit COUNT); with per-type
    caps two equal-penalty scripts with different type mixes are no longer
    interchangeable, so channels become the feasible type VECTORS
    (i, d, s, w) — exactly the oracle's visited-key granularity
    (src/search.rs:31-50). Per-node caps (reference get_node_limits,
    src/search.rs:60-71 + ahead-checks 87-169) mask moves per path row;
    per-pattern emission limits (src/search.rs:151-169) mask channels per
    limits-class at emission.
    """

    __slots__ = (
        "vecs", "E", "sub_src", "ins_src", "del_src", "swap_src", "cnts",
        "node_caps", "root_caps", "limcls", "adm", "n_limcls",
    )

    @staticmethod
    def build(engine) -> Optional["TypedSpec"]:
        pats = engine._patterns
        lims = [p.limits if p.limits is not None else engine.limits for p in pats]
        if all(l is None for l in lims):
            return None
        totals = [_total_of(l) for l in lims]
        E = max(totals)
        if not (1 <= E <= 6):
            return None  # matches the FAST-path ceiling; beyond, oracle serves
        caps = [_caps_of(l) for l in lims]
        loose = tuple(max(c[i] for c in caps) for i in range(5))
        # Feasible vectors under the loosest applicable caps. The channel
        # count grows ~E^4 unconstrained (E=4 all-free -> 70, E=6 -> 210);
        # per-type caps prune it (edits(6).substitutions(1).swaps(0) -> 49),
        # and MAX_TYPED_CHANNELS bounds kernel size — past it the oracle
        # serves (reference general path src/search.rs:87-169 has no such
        # bound, but also no exhaustive-channel representation).
        vecs = []
        for i in range(min(E, loose[1]) + 1):
            for d in range(min(E, loose[2]) + 1):
                for su in range(min(E, loose[3]) + 1):
                    for w in range(min(E, loose[4]) + 1):
                        if i + d + su + w <= min(E, loose[0]):
                            vecs.append((i, d, su, w))
        if len(vecs) > MAX_TYPED_CHANNELS:
            return None
        vecs.sort(key=lambda v: (sum(v), v))
        index = {v: c for c, v in enumerate(vecs)}
        spec = TypedSpec()
        spec.vecs = tuple(vecs)
        spec.E = E
        spec.sub_src = tuple(
            index.get((v[0], v[1], v[2] - 1, v[3]), -1) for v in vecs
        )
        spec.ins_src = tuple(
            index.get((v[0] - 1, v[1], v[2], v[3]), -1) for v in vecs
        )
        spec.del_src = tuple(
            index.get((v[0], v[1] - 1, v[2], v[3]), -1) for v in vecs
        )
        spec.swap_src = tuple(
            index.get((v[0], v[1], v[2], v[3] - 1), -1) for v in vecs
        )
        spec.cnts = tuple(
            v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24) for v in vecs
        )

        # Per-node caps (pattern_index -> its limits, else the global).
        nodes = engine.nodes
        nc = np.zeros((len(nodes), 5), dtype=np.int32)
        gcaps = _caps_of(engine.limits)
        for ni, node in enumerate(nodes):
            pi = node.pattern_index
            if pi is not None and pats[pi].limits is not None:
                nc[ni] = _caps_of(pats[pi].limits)
            else:
                nc[ni] = gcaps
        spec.node_caps = nc
        spec.root_caps = tuple(int(x) for x in nc[0])

        # Emission admissibility per limits-class (src/search.rs:151-169).
        sig_ids: dict = {}
        limcls = np.zeros(len(pats), dtype=np.int32)
        adm = []
        for pi, l in enumerate(lims):
            cs = _caps_of(l)
            lc = sig_ids.get(cs)
            if lc is None:
                lc = len(adm)
                sig_ids[cs] = lc
                adm.append(tuple(
                    int(sum(v) <= cs[0] and v[0] <= cs[1] and v[1] <= cs[2]
                        and v[2] <= cs[3] and v[3] <= cs[4])
                    for v in vecs
                ))
            limcls[pi] = lc
        spec.limcls = limcls
        spec.adm = tuple(adm)
        spec.n_limcls = len(adm)
        return spec


def forbid_spec_of(engine) -> Optional[tuple]:
    """(E, no_ins, no_del, no_sub, no_swap) for configurations that are a
    total edit budget with some edit types simply FORBIDDEN (cap 0) and the
    rest unlimited within the total — e.g. ``edits(2).swaps(0)``. These ride
    the cheap count-channel DP with the forbidden arrivals compiled out
    (counts of a disabled type are identically 0, so the per-type emission
    checks hold for free) instead of the type-vector-channel DP."""
    if engine.has_pattern_limits or engine.mappings:
        return None
    lim = engine.limits
    if lim is None or lim.edits_ is None or not 1 <= lim.edits_ <= 6:
        return None
    caps = (lim.insertions_, lim.deletions_, lim.substitutions_, lim.swaps_)
    if any(c not in (None, 0) for c in caps):
        return None
    if all(c is None for c in caps):
        return None  # plain FAST config; served without this routing
    return (int(lim.edits_),) + tuple(c == 0 for c in caps)


def typed_spec_of(engine) -> Optional[TypedSpec]:
    sp = getattr(engine, "_typed_spec_cache", None)
    if sp is None:
        sp = TypedSpec.build(engine)
        engine._typed_spec_cache = sp if sp is not None else False
    return sp if sp is not False else None


def _banded_dp_typed(
    cand_field, cand_start,
    path_cls_flat, path_node_flat, depth_arr, node_caps_flat,
    ids_pad, limit, sim_flat, node_ceil,
    max_pen, p_sub, p_ins, p_del, p_swap, floor,
    E, Lmax, C,
    TYPED,
    ids_w32=None,
    lo=None,
):
    """Banded Damerau DP with typed channels (see :class:`TypedSpec`).

    Same window/sim-band machinery and cell recurrences as
    :func:`_banded_dp` (general-path semantics: MEF=255, so NO last-edit
    dead-end filters and no window skip — reference src/search.rs:204-393
    monomorphization), plus:

    * channels indexed by type vector; per-channel counts are static;
    * ahead-check masks from the SOURCE row's node caps (substitution/
      insertion/deletion use the popped state's node limits, swap the
      TARGET node's — src/search.rs:87-169, 318-321 in the oracle).

    Returns (emit_pen [B*NCH, M],) — counts are static per channel.
    """
    VECS, SUB_SRC, INS_SRC, DEL_SRC, SWAP_SRC, ROOT_CAPS = TYPED
    NCH = len(VECS)
    M = cand_field.shape[0]
    B = 2 * E + 1
    F = depth_arr.shape[0]
    npad = ids_pad.shape[0]
    INF = jnp.float32(np.inf)

    f = jnp.maximum(cand_field, 0)
    alive_c = cand_field >= 0
    WLEN = Lmax + 2 * E + 1
    if lo is None:
        lo = jnp.int32(0)

    # Pre-gather: class path + depth in one row gather; ceiling + the five
    # per-row cap columns in another (see _banded_dp's layout notes).
    path_cls2d = path_cls_flat.reshape(F, Lmax)
    path_node2d = path_node_flat.reshape(F, Lmax)
    ceil_tab = node_ceil[path_node2d]                         # [F, Lmax]
    caps_tab = node_caps_flat.reshape(-1, 5)[path_node2d]     # [F, Lmax, 5]
    ceil_caps = jnp.concatenate(
        [ceil_tab] + [caps_tab[:, :, q].astype(jnp.float32) for q in range(5)],
        axis=1,
    )                                                          # [F, 6*Lmax]
    pc_d = jnp.concatenate([path_cls2d, depth_arr[:, None]], axis=1)
    pcd_T, cc_T = jax.lax.optimization_barrier(
        (pc_d[f].T, ceil_caps[f].T)               # [Lmax+1, M], [6*Lmax, M]
    )
    pcls_T = pcd_T[:Lmax]
    dpth = jnp.where(alive_c, pcd_T[Lmax], 0)
    ceil_T = cc_T[:Lmax]
    caps_T = [cc_T[(1 + q) * Lmax : (2 + q) * Lmax] for q in range(5)]

    def cap_row(q: int, row):
        """Cap ``q`` at path row ``row`` (1-based; row 0 = root/global)."""
        if isinstance(row, int) and row == 0:
            return jnp.full((M,), np.float32(ROOT_CAPS[q]), jnp.float32)
        return caps_T[q][row - 1]

    # Haystack window (same two-aligned-row fetch as _banded_dp).
    base_abs = cand_start - (E + 1)
    win_rows = []
    if ids_pad.dtype == jnp.uint8 and npad % 32 == 0 and WLEN <= 60:
        if ids_w32 is None or ids_w32.shape[0] == 0:
            ids_w32 = jax.lax.bitcast_convert_type(
                ids_pad.reshape(-1, 4), jnp.uint32
            ).reshape(-1, 8)
        nrows_mat = ids_w32.shape[0]
        rb = jnp.maximum(base_abs, 0) >> 5
        fetch = jnp.concatenate(
            [ids_w32[jnp.minimum(rb + t, nrows_mat - 1)] for t in range(2)],
            axis=1,
        )
        fetT = jax.lax.optimization_barrier(fetch.T)
        d0 = base_abs - (rb << 5)
        for o in range(WLEN):
            q = d0 + o
            q_c = jnp.maximum(q, 0)
            wi = q_c >> 2
            sh = ((q_c & 3) * 8).astype(jnp.uint32)
            lo_w = max(0, (o - (E + 1)) >> 2)
            hi_w = min(15, (o + 31) >> 2)
            word = fetT[lo_w]
            for t in range(lo_w + 1, hi_w + 1):
                word = jnp.where(wi == t, fetT[t], word)
            sym = ((word >> sh) & jnp.uint32(0xFF)).astype(jnp.int32)
            abs_i = base_abs + o
            win_rows.append(
                jnp.where((abs_i >= lo) & (abs_i >= 0) & (abs_i < limit), sym, -1)
            )
    else:
        for o in range(WLEN):
            idx = base_abs + o
            sym = ids_pad[jnp.clip(idx, 0, npad - 1)].astype(jnp.int32)
            win_rows.append(
                jnp.where((idx >= lo) & (idx >= 0) & (idx < limit), sym, -1)
            )
        win_rows = list(jax.lax.optimization_barrier(tuple(win_rows)))

    # Similarity band (same select-chain / gather split as _banded_dp).
    sim2d = sim_flat.reshape(C, C)
    if C <= 64:
        sp_tab = sim2d[path_cls2d].reshape(F, Lmax * C)
        spg_T = jax.lax.optimization_barrier(sp_tab[f].T)
        sb_rows = []
        for l in range(Lmax):
            for b in range(B):
                hc = win_rows[l + 1 + b]
                acc = jnp.zeros((M,), jnp.float32)
                for c in range(C):
                    acc = jnp.where(hc == c, spg_T[l * C + c], acc)
                sb_rows.append(acc)
    else:
        pcg = path_cls2d[f]
        sb_rows = []
        for l in range(Lmax):
            pc_l = pcg[:, l]
            for b in range(B):
                hc = win_rows[l + 1 + b]
                key = pc_l * C + jnp.maximum(hc, 0)
                sb_rows.append(sim_flat[key])

    def grid_init():
        return [
            [jnp.full((M,), INF, jnp.float32) for _ in range(NCH)]
            for _ in range(B)
        ]

    zero_or_inf = jnp.where(alive_c, jnp.float32(0.0), INF)
    pen0 = grid_init()
    pen0[E][0] = zero_or_inf        # channel 0 = zero vector (vecs sorted)
    pen_m1 = grid_init()
    pen_e0 = grid_init()
    pen_e0[E][0] = zero_or_inf

    def merge(bp, op, ok):
        op = jnp.where(ok, op, INF)
        return jnp.where(op < bp, op, bp)

    VSUM = tuple(sum(v) for v in VECS)

    def step_body(carry, i, pc, pc_prev, ceil_i, caps_im1, caps_i, winrow, simrow):
        prev2_pen, prev_pen, preve_pen, emit_pen = carry
        row_live = alive_c & (i <= dpth)
        # caps_im1 = 5 cap rows of the SOURCE row i-1; caps_i = of row i.
        ce_1, ci_1, cd_1, cs_1, cw_1 = caps_im1
        ce_0, ci_0, cd_0, cs_0, cw_0 = caps_i

        cons_pen = grid_init()
        new_pen = grid_init()
        hcs = []
        for b in range(B):
            j = i + (b - E)
            hc = winrow[b + 1]
            hcs.append(hc)
            hc_jm1 = winrow[b]
            sim = simrow[b]
            spen = jnp.float32(p_sub * (np.float32(1.0) - sim))
            j_ok = j >= 1
            for ch in range(NCH):
                p_pen = prev_pen[b][ch]
                bp = jnp.where(
                    jnp.isfinite(p_pen) & j_ok & (hc == pc), p_pen, INF
                )
                src = SUB_SRC[ch]
                if src >= 0:
                    # substitution ahead-check vs SOURCE row caps
                    # (src/search.rs:134-146): edits < cap_e, subs < cap_s.
                    q_pen = prev_pen[b][src]
                    vs = VECS[src]
                    ok_s = (
                        jnp.isfinite(q_pen) & j_ok & (hc >= 0) & (hc != pc)
                        & ~(sim < floor)
                        & ~(spen > (max_pen - q_pen))
                        & (np.float32(VSUM[src]) < ce_1)
                        & (np.float32(vs[2]) < cs_1)
                    )
                    bp = merge(bp, q_pen + spen, ok_s)
                src = SWAP_SRC[ch]
                if src >= 0:
                    # swap: caps of the TARGET node (row i) — oracle line
                    # _within_ahead(_node_limits(node2), ..., swaps).
                    s_pen = prev2_pen[b][src]
                    vs = VECS[src]
                    ok_sw = (
                        jnp.isfinite(s_pen) & (i >= 2) & (j >= 2)
                        & ~(p_swap > (max_pen - s_pen))
                        & (hc >= 0) & (hc_jm1 >= 0)
                        & (hc == pc_prev) & (hc_jm1 == pc)
                        & (np.float32(VSUM[src]) < ce_0)
                        & (np.float32(vs[3]) < cw_0)
                    )
                    bp = merge(bp, s_pen + p_swap, ok_sw)
                cons_pen[b][ch] = bp
                src = DEL_SRC[ch]
                if src >= 0 and b + 1 < B:
                    d_pen = prev_pen[b + 1][src]
                    vs = VECS[src]
                    ok_del = (
                        jnp.isfinite(d_pen) & ~(p_del > (max_pen - d_pen))
                        & (np.float32(VSUM[src]) < ce_1)
                        & (np.float32(vs[1]) < cd_1)
                    )
                    bp = merge(bp, d_pen + p_del, ok_del)
                new_pen[b][ch] = bp

        for b in range(1, B):
            j = i + (b - E)
            hc = hcs[b]
            for ch in range(NCH):
                src = INS_SRC[ch]
                if src < 0:
                    continue
                ip = new_pen[b - 1][src]
                vs = VECS[src]
                ok_ins = (
                    jnp.isfinite(ip)
                    & ~(p_ins > (max_pen - ip))
                    & (hc >= 0)
                    & (j >= 2)
                    & (np.float32(VSUM[src]) < ce_0)
                    & (np.float32(vs[0]) < ci_0)
                )
                new_pen[b][ch] = merge(new_pen[b][ch], ip + p_ins, ok_ins)

        newe_pen = grid_init()
        for b in range(B):
            for ch in range(NCH):
                dead = ~row_live | (new_pen[b][ch] > ceil_i)
                new_pen[b][ch] = jnp.where(dead, INF, new_pen[b][ch])

                ep = cons_pen[b][ch]
                src = DEL_SRC[ch]
                if src >= 0 and b + 1 < B:
                    t_pen = preve_pen[b + 1][src]
                    vs = VECS[src]
                    ok_t = (
                        jnp.isfinite(t_pen) & ~(p_del > (max_pen - t_pen))
                        & (np.float32(VSUM[src]) < ce_1)
                        & (np.float32(vs[1]) < cd_1)
                    )
                    ep = merge(ep, t_pen + p_del, ok_t)
                edead = ~row_live | (ep > ceil_i)
                newe_pen[b][ch] = jnp.where(edead, INF, ep)

        emit_here = row_live & (i == dpth)
        for b in range(B):
            for ch in range(NCH):
                emit_pen[b][ch] = jnp.where(
                    emit_here, newe_pen[b][ch], emit_pen[b][ch]
                )
        return (prev_pen, new_pen, newe_pen, emit_pen)

    epen0 = grid_init()
    carry = (pen_m1, pen0, pen_e0, epen0)
    for i in range(1, Lmax + 1):
        winrow = [win_rows[i - 1 + t] for t in range(B + 1)]
        simrow = [sb_rows[(i - 1) * B + b] for b in range(B)]
        caps_im1 = tuple(cap_row(q, i - 1) for q in range(5))
        caps_i = tuple(cap_row(q, i) for q in range(5))
        carry = step_body(
            carry, i, pcls_T[i - 1], pcls_T[max(i - 2, 0)],
            ceil_T[i - 1], caps_im1, caps_i, winrow, simrow,
        )
    emit_pen = carry[3]
    pen_flat = jnp.stack([emit_pen[b][ch] for b in range(B) for ch in range(NCH)])
    return pen_flat


def _emit_rows_typed(
    pen_flat, cand_field, cand_start,
    depth_arr, node_arr, out_list, pat_len, pat_weight, limcls_arr,
    limit, thr, E, MO, CAND, KG,
    TYPED_EMIT,
):
    """Typed-channel emission: fold channels to the best ADMISSIBLE one per
    (band, limits-class), then per output slot select by the pattern's
    limits-class (reference emission-time check src/search.rs:151-169)."""
    VECS, CNTS, ADM = TYPED_EMIT
    NCH = len(VECS)
    B = 2 * E + 1
    INF = jnp.float32(np.inf)
    alive = cand_field >= 0
    fsafe = jnp.maximum(cand_field, 0)
    d = depth_arr[fsafe]
    node = node_arr[fsafe]
    pats = out_list[node]                          # [CAND, MO]
    slack = np.float32(1e-4) + np.float32(1e-4) * jnp.abs(thr)
    NLC = len(ADM)

    ok_rows = []
    pen_lc_rows = []                               # [B*NLC] of [M]
    cnt_lc_rows = []
    patcls = limcls_arr[jnp.maximum(pats, 0)]      # [CAND, MO]
    for b in range(B):
        ends_b = cand_start + d + (b - E)
        span_ok = alive & (ends_b <= limit) & (ends_b >= cand_start)
        for lc in range(NLC):
            pen_b = jnp.full(pen_flat.shape[1:], INF, jnp.float32)
            cnt_b = jnp.zeros(pen_flat.shape[1:], jnp.int32)
            for ch in range(NCH):
                if not ADM[lc][ch]:
                    continue
                cand_p = pen_flat[b * NCH + ch]
                take = cand_p < pen_b
                pen_b = jnp.where(take, cand_p, pen_b)
                cnt_b = jnp.where(take, np.int32(CNTS[ch]), cnt_b)
            pen_lc_rows.append(pen_b)
            cnt_lc_rows.append(cnt_b)
        for o in range(MO):
            p_o = pats[:, o]
            lc_o = patcls[:, o]
            pen_sel = pen_lc_rows[b * NLC]
            for lc in range(1, NLC):
                pen_sel = jnp.where(lc_o == lc, pen_lc_rows[b * NLC + lc], pen_sel)
            fin = jnp.isfinite(pen_sel)
            pen_s = jnp.where(fin, pen_sel, 0.0)
            pl = pat_len[jnp.maximum(p_o, 0)]
            sim = ((pl - pen_s) / pl) * pat_weight[jnp.maximum(p_o, 0)]
            ok_rows.append(span_ok & fin & (p_o >= 0) & (sim >= thr - slack))
    e_ok = jnp.stack(ok_rows, axis=0)              # [B*MO, M]
    pen_lc = jnp.stack(pen_lc_rows, axis=0)        # [B*NLC, M]
    cnt_lc = jnp.stack(cnt_lc_rows, axis=0)

    total, gidx = compact_indices(e_ok.reshape(-1), KG)
    gsafe = jnp.maximum(gidx, 0)
    m = gsafe % CAND
    chan = gsafe // CAND
    o = chan % MO
    b = chan // MO
    ok = gidx >= 0
    sd_tab = jnp.stack([cand_start, d], axis=1)
    sd = sd_tab[m]
    pat_row = pats[m]                              # [KG, MO]
    lc_row = patcls[m]
    pat_sel = pat_row[:, 0]
    lc_sel = lc_row[:, 0]
    for oo in range(1, MO):
        pat_sel = jnp.where(o == oo, pat_row[:, oo], pat_sel)
        lc_sel = jnp.where(o == oo, lc_row[:, oo], lc_sel)
    pc_tab = jnp.stack(
        [jax.lax.bitcast_convert_type(pen_lc, jnp.int32), cnt_lc], axis=2
    ).reshape(-1, 2)                               # row (b*NLC + lc)*CAND + m
    pc = pc_tab[(b * NLC + lc_sel) * CAND + m]
    me = sd[:, 1] + (b - E)
    rows = _pack_rows(ok, sd[:, 0], pc[:, 0], me, pat_sel, pc[:, 1])
    return total, rows


@functools.partial(
    jax.jit,
    static_argnames=(
        "NL", "chunkpf", "halo",
        "KH", "CAND", "KG", "E", "Lmax", "C", "MO",
        "BITS", "P2F", "DEPTHS", "DEADEND", "TYPED", "STAGE",
        "MAPS", "FORBID",
    ),
)
def _dp_pipeline_jit(
    ids_pf, scan_tabs,
    depth_arr, node_arr, path_cls_flat, path_node_flat,
    out_list, pat_len, pat_weight,
    ids_dense, ids_dense_w32, limit, start_lo, start_hi,
    sim_flat, node_ceil, sb_edge_flat, out_count_arr,
    node_caps_flat, limcls_arr,
    max_pen, p_sub, p_ins, p_del, p_swap, floor, thr,
    NL, chunkpf, halo,
    KH, CAND, KG, E, Lmax, C, MO,
    BITS,      # tuple of (word column, shift) per pattern
    P2F,       # tuple of field-index tuples per pattern
    DEPTHS,    # tuple of field depths
    DEADEND=False,
    TYPED=None,
    STAGE=3,
    MAPS=None,
    FORBID=None,
):
    """Whole DP-verified fuzzy search as one dispatch; single int32 result
    buffer, 12 bytes per emission (see :func:`_pack_rows`):

    * row 0: ``[hit_count, cand_count, total_emissions]``
    * row 1+j: ``[start, penalty_bits, me<<24 | pattern<<12 | counts]``

    ``start_lo``/``start_hi`` (traced) bound the candidate *start* positions
    this dispatch owns — the sliced pipeline (see :func:`fuzzy_search_dp`)
    scans overlapping corpus slices and keeps each match exactly once by its
    start (reference stream-window ownership rule src/stream.rs:262-297);
    the whole-corpus path passes (0, limit).

    ``STAGE`` truncates the pipeline for profiling (0 = packed hits only,
    1 = + candidate expansion, 2 = + banded DP, 3 = full); truncated stages
    return a zero-padded buffer of the full shape.
    """
    from .packed_bitap import packed_hits

    def _early(count_h, cand_count, checksum):
        # checksum in the first body row keeps the truncated stages from
        # being dead-code-eliminated without corrupting the cap-retry fields.
        header = (
            jnp.zeros((1, 3), jnp.int32)
            .at[0, 0].set(count_h)
            .at[0, 1].set(cand_count)
        )
        body = jnp.zeros((KG, 3), jnp.int32).at[0, 0].set(checksum)
        return jnp.concatenate([header, body], axis=0)

    count_h, pos, words = packed_hits(ids_pf, scan_tabs, NL, chunkpf, halo, KH)
    if STAGE == 0:
        return _early(count_h, jnp.int32(0), words.astype(jnp.int32).sum())
    cand_count, cand_field, cand_start = _expand_candidates(
        pos, words, start_lo, start_hi, limit, E, CAND, BITS, P2F, DEPTHS
    )
    if STAGE == 1:
        return _early(count_h, cand_count, cand_start.sum())

    if TYPED is None:
        pen_flat, cnt_flat = _banded_dp(
            cand_field, cand_start,
            path_cls_flat, path_node_flat, depth_arr,
            ids_dense, limit, sim_flat, node_ceil,
            max_pen, p_sub, p_ins, p_del, p_swap, floor,
            E, Lmax, C,
            ids_w32=ids_dense_w32,
            deadend=DEADEND,
            sb_edge_flat=sb_edge_flat,
            out_count_arr=out_count_arr,
            MAPS=MAPS,
            FORBID=FORBID,
        )                                         # [B*NE, M] each
        if STAGE == 2:
            return _early(
                count_h, cand_count,
                jnp.isfinite(pen_flat).astype(jnp.int32).sum()
                + cnt_flat.sum(),
            )

        total, rows = _emit_rows(
            pen_flat, cnt_flat, cand_field, cand_start,
            depth_arr, node_arr, out_list, pat_len, pat_weight,
            limit, thr, E, MO, CAND, KG,
        )
    else:
        VECS, SUBS, INSS, DELS, SWAPS, ROOTC, CNTS, ADM = TYPED
        pen_flat = _banded_dp_typed(
            cand_field, cand_start,
            path_cls_flat, path_node_flat, depth_arr, node_caps_flat,
            ids_dense, limit, sim_flat, node_ceil,
            max_pen, p_sub, p_ins, p_del, p_swap, floor,
            E, Lmax, C,
            TYPED=(VECS, SUBS, INSS, DELS, SWAPS, ROOTC),
            ids_w32=ids_dense_w32,
        )
        total, rows = _emit_rows_typed(
            pen_flat, cand_field, cand_start,
            depth_arr, node_arr, out_list, pat_len, pat_weight, limcls_arr,
            limit, thr, E, MO, CAND, KG,
            TYPED_EMIT=(VECS, CNTS, ADM),
        )
    header = (
        jnp.zeros((1, 3), jnp.int32)
        .at[0, 0].set(count_h)
        .at[0, 1].set(cand_count)
        .at[0, 2].set(total)
    )
    return jnp.concatenate([header, rows], axis=0)


def _expand_candidates(pos, words, start_lo, start_hi, pos_hi, E, CAND, BITS, P2F, DEPTHS):
    """Hit (pos, words) -> compacted candidate (field, start) pairs with
    ``start_lo <= start < start_hi`` and hit position ``< pos_hi`` (traced
    scalars — the sharded path restricts starts to the shard's owned region
    while hits may land in the right halo; reference ownership rule
    src/stream.rs:262-297). All loops are static: field ids and depths are
    python ints, so no gathers.

    Run dedup: a hit run at consecutive ends e-1, e for the same pattern
    generates the same (field, start) from (e, b) and (e-1, b-1) — the DP
    for equal (field, start) is identical, so only the b == 0 copy (or the
    run's first end) is kept. True fuzzy matches fire several adjacent
    ends, so this cuts the candidate set ~2-3x before the DP.
    """
    B = 2 * E + 1
    hit_ok = (pos >= 0) & (pos < pos_hi)
    ends = pos + 1  # end-exclusive stream position of each hit
    prev_same = jnp.concatenate(
        [jnp.zeros((1,), bool), pos[1:] == pos[:-1] + 1]
    )
    words_prev = jnp.concatenate(
        [jnp.zeros((1, words.shape[1]), words.dtype), words[:-1]], axis=0
    )
    cf_list, cs_list, ok_list = [], [], []
    for p, (col, sh) in enumerate(BITS):
        bit = (words[:, col].astype(jnp.uint32) >> jnp.uint32(sh)) & jnp.uint32(1)
        fired = hit_ok & (bit == 1)
        bit_prev = (words_prev[:, col].astype(jnp.uint32) >> jnp.uint32(sh)) & jnp.uint32(1)
        dup = prev_same & (bit_prev == 1)
        for fld in P2F[p]:
            d = DEPTHS[fld]
            for b in range(B):
                start = ends - (d + (b - E))
                ok = fired & (start >= start_lo) & (start < start_hi)
                if b > 0:
                    ok = ok & ~dup
                cf_list.append(jnp.where(ok, fld, -1))
                cs_list.append(jnp.where(ok, start, 0))
                ok_list.append(ok)
    # (field, start) pairs interleaved so compaction needs ONE row gather
    # (random reads are ~0.9 ms per gather op regardless of width).
    cfs_all = jnp.stack(
        [jnp.concatenate(cf_list), jnp.concatenate(cs_list)], axis=1
    )                                              # [n_all, 2]
    ok_all = jnp.concatenate(ok_list)
    cand_count, cidx = compact_indices(ok_all, CAND)
    csafe = jnp.maximum(cidx, 0)
    pair = cfs_all[csafe]                          # [CAND, 2]
    cand_field = jnp.where(cidx >= 0, pair[:, 0], -1)
    cand_start = jnp.where(cidx >= 0, pair[:, 1], 0)
    return cand_count, cand_field, cand_start


def _pack_rows(ok, start, pen_bits, me, pat, cnt):
    """Emission rows packed to 12 bytes: [start, penalty f32 bits,
    me<<24 | pattern<<12 | counts(4 x 3b)]; result bytes cross the host
    link on every search. Ranges are guaranteed
    on the packed path: me <= Lmax + E < 128, pattern id < 4096 (the limb
    budget caps total pattern graphemes at 512), per-type counts <= E <= 6."""
    c12 = (
        (cnt & 7)
        | (((cnt >> 8) & 7) << 3)
        | (((cnt >> 16) & 7) << 6)
        | (((cnt >> 24) & 7) << 9)
    )
    col2 = (me << 24) | (pat << 12) | c12
    return jnp.stack(
        [
            jnp.where(ok, start, -1),
            jnp.where(ok, pen_bits, 0),
            jnp.where(ok, col2, 0),
        ],
        axis=1,
    )


def _emit_rows(
    pen_flat, cnt_flat, cand_field, cand_start,
    depth_arr, node_arr, out_list, pat_len, pat_weight,
    limit, thr, E, MO, CAND, KG,
):
    """DP emission channels -> compacted 4-column match rows.

    Emission: channel-major (band, output-pattern) x candidate — all [M]
    vectors, candidate axis last. The NE
    edit-count channels of one (candidate, band) all map to the SAME
    (pattern, start, end) tuple, and the host keeps only the max
    similarity, so they are pre-minimized HERE (strict <, so the lowest
    edit count wins penalty ties — the former emission-order tie-break):
    halves the emission count and therefore the result-buffer bytes that
    cross the host link.
    """
    B = 2 * E + 1
    NE = E + 1
    alive = cand_field >= 0
    fsafe = jnp.maximum(cand_field, 0)
    d = depth_arr[fsafe]
    node = node_arr[fsafe]
    pats = out_list[node]                         # [CAND, MO]
    slack = np.float32(1e-4) + np.float32(1e-4) * jnp.abs(thr)
    ok_rows = []
    pen_best_rows, cnt_best_rows = [], []
    for b in range(B):
        ends_b = cand_start + d + (b - E)
        span_ok = alive & (ends_b <= limit) & (ends_b >= cand_start)
        pen_b = pen_flat[b * NE]
        cnt_b = cnt_flat[b * NE]
        for e in range(1, NE):
            cand_p = pen_flat[b * NE + e]
            take = cand_p < pen_b
            pen_b = jnp.where(take, cand_p, pen_b)
            cnt_b = jnp.where(take, cnt_flat[b * NE + e], cnt_b)
        pen_best_rows.append(pen_b)
        cnt_best_rows.append(cnt_b)
        fin = jnp.isfinite(pen_b)
        pen_s = jnp.where(fin, pen_b, 0.0)
        for o in range(MO):
            p_o = pats[:, o]
            pl = pat_len[jnp.maximum(p_o, 0)]
            sim = ((pl - pen_s) / pl) * pat_weight[jnp.maximum(p_o, 0)]
            ok_rows.append(
                span_ok & fin & (p_o >= 0) & (sim >= thr - slack)
            )
    e_ok = jnp.stack(ok_rows, axis=0)             # [B*MO, M]
    pen_best = jnp.stack(pen_best_rows, axis=0)   # [B, M]
    cnt_best = jnp.stack(cnt_best_rows, axis=0)

    total, gidx = compact_indices(e_ok.reshape(-1), KG)
    gsafe = jnp.maximum(gidx, 0)
    m = gsafe % CAND
    chan = gsafe // CAND
    o = chan % MO
    b = chan // MO
    ok = gidx >= 0
    # Compact 4-column rows (buffer bytes = link time): [start, pen_bits,
    # me << 24 | pattern, packed edit counts]. me = matched grapheme span
    # <= 64 + E < 256; pattern ids on this path are bounded by the packed
    # field budget (<= 512 fields x MO), far under 2^24. Per-emission
    # lookups are batched into three row gathers: (start, depth) pairs,
    # (pen, cnt) pairs, and the candidate's output-pattern row.
    sd_tab = jnp.stack([cand_start, d], axis=1)                # [CAND, 2]
    pc_tab = jnp.stack(
        [jax.lax.bitcast_convert_type(pen_best, jnp.int32), cnt_best], axis=2
    ).reshape(B * CAND, 2)                                      # [(b,m), 2]
    sd = sd_tab[m]                                              # [KG, 2]
    pc = pc_tab[b * CAND + m]                                   # [KG, 2]
    pat_row = pats[m]                                           # [KG, MO]
    pat_sel = pat_row[:, 0]
    for oo in range(1, MO):
        pat_sel = jnp.where(o == oo, pat_row[:, oo], pat_sel)
    me = sd[:, 1] + (b - E)
    rows = _pack_rows(ok, sd[:, 0], pc[:, 0], me, pat_sel, pc[:, 1])
    return total, rows


def fuzzy_search_dp(engine, haystack: str, threshold, view, n: int,
                    typed: Optional["TypedSpec"] = None,
                    maps: Optional["MappedSpec"] = None,
                    forbid: Optional[tuple] = None) -> Optional[List]:
    """DP-verified fuzzy search (packed-prefilter eligible); None when not
    applicable — the caller falls back (beam kernels for FAST configs, the
    oracle for typed ones). Oracle-identical matches. ``typed`` switches the
    DP to type-vector channels for per-type / per-pattern limit configs
    (see :class:`TypedSpec`); ``maps`` adds mapping arrivals for mapped
    engines (see :class:`MappedSpec` — mutually exclusive with ``typed``)."""
    from ..structs import FuzzyMatch
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

    thr = np.float32(threshold)
    if n > resident_max():
        return None
    pk = packed_fuzzy_of(engine)
    if pk is None:
        return None
    vf = verify_fields_of(engine)
    if vf is None:
        return None
    if maps is not None:
        # Edit-count-based uniform budget: the threshold-derived k_for is
        # unsound for mapped engines (a score-1.0 mapping has penalty 0 but
        # costs up to max(pb, ha) unit bitap errors) — see MappedSpec.
        ks = [maps.k] * len(pk.filt.patterns)
        dam = False
    else:
        # Damerau-aware scan budgets: the scan's native transposition
        # transition prices a swap at 1 bitap error instead of 2 (reference
        # prefilter.rs:174-183 doubles k because plain bitap has no swap
        # move), so swap-permitting configs scan with half the error rows
        # AND a far more selective filter. Falls back to the plain model
        # when it wins nothing (swaps forbidden) or FAC_NO_DAMERAU=1.
        import os as _os_k

        ks_p, ks_d = [], []
        for bp in pk.filt.patterns:
            ks_p.append(pk.filt.k_for(bp, thr))
            ks_d.append(pk.filt.k_for(bp, thr, damerau=True))
        dam = (
            _os_k.environ.get("FAC_NO_DAMERAU") != "1"
            and None not in ks_d
            and (None in ks_p or max(ks_d) < max(ks_p))
        )
        ks = ks_d if dam else ks_p
        if None in ks:
            return None
    match, init, k = pk.fuzzy_masks(ks)
    halo = pk.m_max + k

    dense = engine.dense
    pens = engine.penalties
    if forbid is not None:
        E = forbid[0]
    else:
        E = engine.max_edits_fast if typed is None else typed.E
    # Candidate-stage work budget: the expansion materializes
    # (fields x bands) x KH slots. Loose budgets (k approaching the pattern
    # length — e.g. total-edit configs where a swap costs 2 bitap errors,
    # reference prefilter.rs:174-183) make the scan unselective on random
    # text; past this budget the DP lane declines and the caller falls back
    # rather than burning HBM on candidates the verify will reject.
    n_combo = int((vf.pat2field >= 0).sum()) * (2 * E + 1)
    MAX_EXPAND = 1 << 27
    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_pen = np.float32(ceil[0])
    if np.float32(0.0) > max_pen:
        return []

    # --- corpus residency: whole-corpus, or overlapped slices --------------
    # Large corpora are cut into S overlapping slices dispatched as S
    # independent pipeline calls (identical static shapes -> one compiled
    # kernel). Slice i owns match *starts* in its core range; its buffer
    # carries a left scan warm-up halo (pattern limb length + error budget,
    # same fixpoint as the in-kernel lane halos) and a right completion halo
    # (max depth + E) so owned matches end in-buffer. Ownership-by-start is
    # the reference's stream-window rule (src/stream.rs:262-297). The payoff
    # is pipelining: slice i+1's device compute overlaps slice i's result
    # readback.
    narrow = dense.num_classes <= 256
    tok = _space_token(engine)
    import os as _os_sl

    # Test override: tests force tiny slices to exercise the boundary
    # ownership/halo logic on corpora that fit CPU runs.
    SLICE_SYMS = int(_os_sl.environ.get("FAC_SLICE_SYMS", str(16 << 20)))
    R_halo = vf.max_depth + E
    use_slices = narrow and n >= SLICE_SYMS + (SLICE_SYMS >> 1)
    if use_slices:
        S = max(2, -(-n // SLICE_SYMS))
        Q = -(-n // S)
        bounds, meta = [], []
        for si in range(S):
            g0 = si * Q
            g1 = min(n, g0 + Q)
            base = max(0, g0 - halo)
            end = min(n, g1 + R_halo)
            bounds.append((base, end - base))
            meta.append((base, g0 - base, g1 - base, end - base))
        pad_len = device_corpus.bucket_len(
            max(ln for _, ln in bounds) + device_corpus.TAIL_MARGIN
        )
        import os as _os_t
        import time as _time_t

        _res_t0 = _time_t.perf_counter() if _os_t.environ.get("FAC_TIME") == "1" else None
        pf_slices = device_corpus.resident_words_sliced(
            haystack, ("pk-fuzzy", tok),
            lambda h: np.ascontiguousarray(
                pk.filt.transcode(
                    h, hay_bytes=view.hay_bytes() if view.ascii else None
                )[0],
                dtype=np.uint8,
            ),
            tuple(bounds), pad_len, words=False,
        )
        de_slices = device_corpus.resident_words_sliced(
            haystack, ("dense", tok),
            lambda h: np.ascontiguousarray(dense.transcode(h, view), dtype=np.uint8),
            tuple(bounds), pad_len,
        )
        if _res_t0 is not None:
            import sys as _sys_t

            print(
                f"[FAC_TIME dp] residency={( _time_t.perf_counter() - _res_t0) * 1e3:.1f}ms "
                f"slices={len(bounds)} pad_len={pad_len}",
                file=_sys_t.stderr,
            )
        # (ids_pf, ids_dense, dense_w32, local_n, lo, hi, base)
        parts = [
            (pf, de[0], de[1], m[3], m[1], m[2], m[0])
            for pf, de, m in zip(pf_slices, de_slices, meta)
        ]
        nb = pad_len
    else:
        ids_pf, n_pf = device_corpus.resident(
            haystack,
            ("pk-fuzzy", tok),
            lambda h: np.ascontiguousarray(
                pk.filt.transcode(
                    h, hay_bytes=view.hay_bytes() if view.ascii else None
                )[0],
                dtype=np.uint8,
            ),
        )
        if narrow:
            ids_dense, ids_dense_w32, n_d = device_corpus.resident_words(
                haystack,
                ("dense", tok),
                lambda h: np.ascontiguousarray(dense.transcode(h, view), dtype=np.uint8),
            )
        else:
            ids_dense, n_d = device_corpus.resident(
                haystack,
                ("dense", tok),
                lambda h: np.ascontiguousarray(dense.transcode(h, view), dtype=np.int32),
            )
            import jax.numpy as _jnp

            ids_dense_w32 = _jnp.zeros((0, 8), _jnp.uint32)
        assert n_pf == n_d == n
        parts = [(ids_pf, ids_dense, ids_dense_w32, n, 0, n, 0)]
        nb = ids_pf.size

    NL, chunkpf = scan_layout(nb, halo)
    scan_tabs = _dev_consts(
        engine,
        ("dp-scan", float(thr), dam),
        lambda: scan_tables(
            pk.word_tbl, pk.starts, match, init,
            notlast=pk.notlast() if dam else None,
        ),
    )

    # Static candidate-expansion tables (python ints — no device gathers).
    statics = getattr(engine, "_dp_statics", None)
    if statics is None:
        bits = tuple(
            (2 * lw + ((lo + m_p - 1) >> 5), (lo + m_p - 1) & 31)
            for (lw, lo), m_p in zip(pk.offsets, pk.ms)
        )
        p2f = tuple(
            tuple(int(fi) for fi in row if fi >= 0) for row in vf.pat2field
        )
        depths = tuple(int(dd) for dd in vf.depth)
        statics = (bits, p2f, depths)
        engine._dp_statics = statics
    BITS, P2F, DEPTHS = statics

    dtabs = getattr(engine, "_dp_dev_tables", None)
    if dtabs is None:
        dtabs = (
            jax.device_put(vf.depth),
            jax.device_put(vf.node),
            jax.device_put(vf.path_cls.reshape(-1)),
            jax.device_put(vf.path_node.reshape(-1)),
            jax.device_put(dense.out_list),
            jax.device_put(dense.pat_len),
            jax.device_put(dense.pat_weight),
            jax.device_put(dense.sim.reshape(-1)),
            jax.device_put(dense.sb_edge.reshape(-1)),
            jax.device_put(dense.out_count),
        )
        engine._dp_dev_tables = dtabs
    (dep_d, node_d, pcls_d, pnode_d, olist_d, plen_d, pw_d, sim_d,
     sbe_d, ocnt_d) = dtabs
    # Per-threshold cache: a device_put is a host-link round trip, which
    # small/medium searches would pay per call (streaming superwindows repeat
    # one threshold thousands of times).
    node_ceil = _dev_consts(
        engine, ("node-ceil", float(thr)), lambda: jax.device_put(ceil)
    )

    if typed is None:
        TYPED = None
        ncaps_d = jnp.zeros((0,), jnp.int32)
        limcls_d = jnp.zeros((0,), jnp.int32)
    else:
        ttabs = getattr(engine, "_dp_typed_tables", None)
        if ttabs is None:
            ttabs = (
                jax.device_put(np.ascontiguousarray(typed.node_caps.reshape(-1))),
                jax.device_put(typed.limcls),
            )
            engine._dp_typed_tables = ttabs
        ncaps_d, limcls_d = ttabs
        TYPED = (
            typed.vecs, typed.sub_src, typed.ins_src, typed.del_src,
            typed.swap_src, typed.root_caps, typed.cnts, typed.adm,
        )

    caps = _cap_cache(engine)
    kh_key = ("dp-KH", nb)
    ca_key = ("dp-CAND", nb)
    kg_key = ("dp-KG", nb)
    # KG is shipped bytes (12 B/emission over the host link) — start low
    # and let the warm search's retry find the real level; KH/CAND only
    # shape on-device work, so they start at corpus-scaled guesses.
    KH = caps.get(kh_key, _fine_cap(max(1 << 13, nb >> 10)))
    CAND = caps.get(ca_key, _fine_cap(max(1 << 14, nb >> 9)))
    KG = caps.get(kg_key, _fine_cap(max(1 << 15, nb >> 11)))
    if KH * n_combo > MAX_EXPAND:
        return None

    import os as _os
    import time as _time

    _timing = _os.environ.get("FAC_TIME") == "1"
    # Stage truncation (profiling knob) is only honored alongside FAC_TIME:
    # a stale exported FAC_DP_STAGE would otherwise silently zero production
    # results (and the ratchet-down below would then shrink cached caps to
    # the floor based on the truncated counts).
    _stage = int(_os.environ.get("FAC_DP_STAGE", "3")) if _timing else 3

    def _launch(part, KH_, CAND_, KG_):
        p_pf, p_de, p_dew, ln, lo, hi, _base = part
        return _dp_pipeline_jit(
            p_pf, scan_tabs,
            dep_d, node_d, pcls_d, pnode_d,
            olist_d, plen_d, pw_d,
            p_de, p_dew, np.int32(ln), np.int32(lo), np.int32(hi),
            sim_d, node_ceil, sbe_d, ocnt_d,
            ncaps_d, limcls_d,
            max_pen, pens.substitution, pens.insertion, pens.deletion,
            pens.swap, engine.min_symbol_similarity, thr,
            NL=NL, chunkpf=chunkpf, halo=halo,
            KH=KH_, CAND=CAND_, KG=KG_, E=E, Lmax=vf.max_depth,
            C=dense.num_classes, MO=dense.max_out,
            BITS=BITS, P2F=P2F, DEPTHS=DEPTHS,
            # Last-edit dead-end filters are FAST-path oracle semantics
            # (src/search.rs:204-393 monomorphization); typed and
            # forbid configs run the general path, which has none.
            DEADEND=dense.has_multibyte_edges and typed is None
            and forbid is None,
            TYPED=TYPED,
            STAGE=_stage,
            MAPS=maps.maps if maps is not None else None,
            FORBID=None if forbid is None else tuple(forbid[1:]),
        )

    # Dispatch every slice back-to-back (async), then start each result's
    # host copy as soon as it is enqueued: the device computes slice i+1
    # while slice i's buffer crosses the link. A slice that overflowed its
    # capacities is re-dispatched alone with grown caps (its buffer header
    # carries the true counts); later slices launched with the old caps
    # re-check against the caps they were BUILT with.
    _t0 = _time.perf_counter()
    pend = []
    for part in parts:
        o = _launch(part, KH, CAND, KG)
        try:
            o.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        pend.append((o, (KH, CAND, KG)))
    if _timing:
        jax.block_until_ready(pend[-1][0])
        _t1 = _time.perf_counter()

    bufs = []
    mx_h = mx_c = mx_g = 0
    sum_h = sum_c = 0
    for pi, part in enumerate(parts):
        out_dev, (KH_u, CAND_u, KG_u) = pend[pi]
        buf = jax.device_get(out_dev)
        while True:
            count_h, cand_count, total = (
                int(buf[0, 0]), int(buf[0, 1]), int(buf[0, 2])
            )
            grew = False
            if count_h > KH_u:
                KH = KH_u = _fine_cap(count_h)
                if KH * n_combo > MAX_EXPAND:
                    return None  # unselective scan: decline, caller falls back
                grew = True
            if cand_count > CAND_u:
                CAND = CAND_u = _fine_cap(cand_count)
                grew = True
            if total > KG_u:
                KG = KG_u = _fine_cap(total)
                grew = True
            if not grew:
                break
            buf = jax.device_get(_launch(part, KH_u, CAND_u, KG_u))
        mx_h, mx_c, mx_g = max(mx_h, count_h), max(mx_c, cand_count), max(mx_g, total)
        sum_h += count_h
        sum_c += cand_count
        bufs.append((buf, total))
    _t2 = _time.perf_counter()
    if _timing:
        import sys as _sys

        print(
            f"[FAC_TIME dp] dispatch={(_t1 - _t0) * 1e3:.1f}ms "
            f"readback={(_t2 - _t1) * 1e3:.1f}ms "
            f"buf={sum(b.nbytes for b, _ in bufs) >> 10}KiB "
            f"slices={len(parts)} KH={KH} CAND={CAND} KG={KG}",
            file=_sys.stderr,
        )
    caps[kh_key] = max(caps.get(kh_key, 0), KH)
    caps[ca_key] = max(caps.get(ca_key, 0), CAND)
    caps[kg_key] = max(caps.get(kg_key, 0), KG)
    # Ratchet DOWN oversized caps (with hysteresis) so steady-state searches
    # run at <= ~1.5x the real counts: kernel work is proportional to the
    # static capacities, and the corpus-scaled initial guesses above can
    # overshoot the real hit rate by 2x+. The next search recompiles once at
    # the tight shape (persistent-cache-friendly) and every search after
    # that keeps it; a hotter corpus just re-enters the grow loop. Sliced
    # runs ratchet to the max count over slices (one shape serves them all).
    if _stage == 3:  # truncated profiling runs must not shrink cached caps
        for key_, cap_, actual_ in (
            (kh_key, KH, mx_h),
            (ca_key, CAND, mx_c),
            (kg_key, KG, mx_g),
        ):
            tight = _fine_cap(actual_)
            if 3 * tight <= 2 * cap_:
                caps[key_] = tight

    row_parts = []
    for (buf, total), part in zip(bufs, parts):
        rows = buf[1 : 1 + total]
        base = part[6]
        if base and total:
            rows = rows.copy()
            rows[:, 0] += base  # slice-local starts -> global graphemes
        row_parts.append(rows)
    rows = row_parts[0] if len(row_parts) == 1 else np.concatenate(row_parts)
    total = sum(t for _, t in bufs)
    from .emit import decode_matches

    _t3 = _time.perf_counter()
    col2 = rows[:, 2].astype(np.int64)
    c12 = col2 & 0xFFF
    counts = (
        (c12 & 7) | ((c12 >> 3) & 7) << 8 | ((c12 >> 6) & 7) << 16
        | ((c12 >> 9) & 7) << 24
    )
    results = decode_matches(
        engine, view, haystack, n,
        rows[:, 0],
        (col2 >> 24).astype(np.int32),                           # me
        ((col2 >> 12) & 0xFFF).astype(np.int32),                 # pattern
        rows[:, 1].copy().view(np.float32),                      # penalty
        counts,
        thr,
    )
    if _timing:
        import sys as _sys

        print(
            f"[FAC_TIME dp] decode={( _time.perf_counter() - _t3) * 1e3:.1f}ms "
            f"emissions={total} matches={len(results)}",
            file=_sys.stderr,
        )
    engine.last_stats = {
        "backend": (
            "device-fuzzy-dp-typed" if typed is not None
            else "device-fuzzy-dp-mapped" if maps is not None
            else "device-fuzzy-dp-forbid" if forbid is not None
            else "device-fuzzy-dp"
        ),
        "hits": sum_h,
        "candidates": sum_c,
        "positions": int(n),
        "emissions": total,
        "matches": len(results),
        "slices": len(parts),
    }
    if _timing:
        engine.last_stats.update(
            dispatch_ms=round((_t1 - _t0) * 1e3, 1),
            readback_ms=round((_t2 - _t1) * 1e3, 1),
            decode_ms=round((_time.perf_counter() - _t3) * 1e3, 1),
            result_buf_kib=sum(b.nbytes for b, _ in bufs) >> 10,
        )
    return results


def fuzzy_search_typed_device(engine, haystack: str, threshold) -> List:
    """Device search for per-type / per-pattern limit configurations (the
    reference serves these from its monomorphized general path,
    src/search.rs:204-393 + 87-169); falls back to the host oracle when the
    packed model declines at this threshold (k past MAX_USEFUL_K)."""
    from .. import oracle
    from ..utils.graphemes import view_of

    spec = typed_spec_of(engine)
    assert spec is not None, "caller must gate on typed_spec_of"
    view = view_of(haystack, engine.case_insensitive)
    n = len(view)
    if n == 0:
        return []
    forb = forbid_spec_of(engine)
    if forb is not None:
        res = fuzzy_search_dp(engine, haystack, threshold, view, n, forbid=forb)
    else:
        res = fuzzy_search_dp(engine, haystack, threshold, view, n, typed=spec)
    if res is None:
        return oracle.search_raw(engine, haystack, threshold)
    return res


def fuzzy_search_mapped_device(engine, haystack: str, threshold) -> List:
    """Device search for mapped engines (the reference serves mappings
    inside its hot loop, src/search.rs:883-923); falls back to the host
    oracle when the packed model declines (unselective scan, oversized
    corpus) or the haystack contains multi-code-point graphemes (the class
    model's identity guarantee needs 1-code-point graphemes — see
    MappedSpec)."""
    from .. import oracle
    from ..utils.graphemes import view_of

    spec = mapped_spec_of(engine)
    assert spec is not None, "caller must gate on mapped_spec_of"
    view = view_of(haystack, engine.case_insensitive)
    n = len(view)
    if n == 0:
        return []
    # Haystack gate: every grapheme one code point (ASCII is trivially so);
    # grapheme count == code-point count is an O(1) exact test.
    if not haystack.isascii() and n != len(haystack):
        return oracle.search_raw(engine, haystack, threshold)
    res = fuzzy_search_dp(engine, haystack, threshold, view, n, maps=spec)
    if res is None:
        return oracle.search_raw(engine, haystack, threshold)
    return res
