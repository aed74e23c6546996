"""Large-dictionary fuzzy lane: pattern-chunked DP pipeline.

The single-dispatch DP pipeline (ops/verify_dp) bakes the packed shift-AND
tables and the per-pattern candidate-expansion maps into the kernel as
compile-time constants — unbeatable for headline-sized dictionaries (tens of
patterns), but compile time grows with pattern count and the u64 limb budget
caps one kernel at ``MAX_LIMBS`` words (512 pattern-bits). The reference has
no such cliff: its automaton serves thousands of patterns from the same
monomorphized loop (reference src/search.rs:418-1119; the search_many_patterns
bench, benches/benchmark.rs:45-76).

This lane restores that capability device-side with compile time *independent of
pattern count*:

* the PRIMARY layout is stratified-folded (:func:`_fold_assign`): patterns
  of the same length share aligned bit lanes (symbol masks OR'd), so the
  whole dictionary scans in one (or few) wide passes; a cheap containment
  pre-verify plus the banded DP kill the superposition's false fires. A
  runtime hit ceiling falls back to the plain unsuperimposed chunking on
  corpora too match-dense for superposition (engine-pinned);
* the fallback splits the dictionary into chunks of consecutive patterns,
  each fitting the limb budget; every per-chunk table (shift-AND word
  table, start/match/init masks, candidate-expansion maps) is a *traced
  device array* of one uniform shape — so ONE compiled kernel serves every
  chunk;
* the banded-DP verify tables are the parent engine's (fields are global
  verify-field ids), so the corpus is transcoded and device-resident ONCE,
  shared by all chunks;
* chunks are dispatched back-to-back and read back in order — the device
  computes chunk i+1 while chunk i's (sparse) result buffer crosses the
  host link, the same overlap scheme as the sliced headline pipeline.

Scan cost is ~linear in total limb count (ops/packed_bitap._scan_flags
gathers 2W words per symbol), so the folded layout's whole point is to
shrink that count ~4-5x.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .compact import compact_indices

import os as _os_ml

#: Uniform u64 limb budget per PLAIN (unsuperimposed) chunk. At narrow W
#: per-pass fixed work (flag transpose, compaction, replay) dominates, so
#: wide chunks beat many narrow ones; at wide W the scan's per-symbol word
#: work takes over — which is why the folded layout, not wider plain
#: chunks, is the large-dictionary lane's primary form (see _fold_assign).
MANY_LIMBS = int(_os_ml.environ.get("FAC_MANY_LIMBS", "32"))
#: Pattern-id field in the packed emission rows is 12 bits.
MANY_MAX_PATTERNS = 4095

#: Folded-layout tuning (see ``_fold_assign``): total false-fire budget per
#: corpus position (split across length strata), the superposition cap per
#: bit lane, and the per-chunk limb budget for folded chunks (wider than the
#: plain MANY_LIMBS — the whole point is fewer, wider passes). At 1/16 a
#: 1k-word dictionary folds to W=31 in one pass; tighter budgets widen W for
#: no fire-rate benefit on real text, looser ones cross the runtime hit
#: ceiling and fall back. Not yet re-tuned on the GPU.
FOLD_EPS = float(_os_ml.environ.get("FAC_MANY_FOLD_EPS", str(1.0 / 16.0)))
FOLD_MAX_F = 8.0
FOLD_CHUNK_LIMBS = 64
#: Floor of the folded lane's runtime hit ceiling (tests patch this down to
#: exercise the plain-chunking fallback on small corpora).
FOLD_HIT_CEIL_MIN = 1 << 14


def _fold_assign(pats, A: int, E: int):
    """Stratified-folded (limb, bit) assignment: one aligned bit lane serves
    up to ``f`` patterns of the same length (their symbol masks OR'd).

    The scan cost of the chunked lane is ~``A x total_limbs`` selects per
    corpus position — invariant under chunk width — so the only way to scan
    a large dictionary faster is to put MORE patterns per bit. Superimposing
    f same-length patterns on one aligned lane raises the per-step advance
    probability from ~1/A to ~f/A, i.e. the lane's false-fire rate grows as
    (f/A)^(m-k): long patterns tolerate exponentially more fold. Shallow
    strata stay at f=1; deep strata fold 3-8x, shrinking total limbs ~4x and
    with them the number of scan passes. Every fired candidate is verified
    by the banded DP (exact), so folding trades verify work for scan work —
    false positives only, never false negatives: all scan masks are bitwise
    ORs of the per-pattern masks and the kernel recurrence is monotone in
    every mask bit (shift/AND/OR only, packed_bitap._step).

    Aligned lanes (same lo, same m) keep the mask algebra trivial: last
    bits coincide, so the Damerau ``notlast`` guard never clears an interior
    bit of a co-resident pattern.

    Returns a list of (pattern index, (limb, lo)) in limb order, or None
    when some pattern exceeds 64 graphemes.
    """
    strata: dict = {}
    for i, bp in enumerate(pats):
        if bp.m < 1 or bp.m > 64:
            return None
        strata.setdefault(bp.m, []).append(i)
    A_h = max(2, A - 1)
    eps_m = FOLD_EPS / len(strata)
    out = []
    base = 0
    for m in sorted(strata):
        idxs = strata[m]
        g = 64 // m
        kk = min(E, max(0, m - 1))
        # Solve (f/A)^(m-k) * (m+1)^k * count <= eps_m for the fold factor.
        denom = float((m + 1) ** kk * len(idxs))
        q = (eps_m / denom) ** (1.0 / max(1, m - kk))
        f = max(1.0, min(FOLD_MAX_F, q * A_h))
        per_limb = max(g, min(len(idxs), int(f * g)))
        n_limbs = -(-len(idxs) // per_limb)
        for j, p in enumerate(idxs):
            limb = base + j // per_limb
            slot = (j % per_limb) % g
            out.append((p, (limb, slot * m)))
        base += n_limbs
    return out


class ManyPackSpec:
    """Per-engine chunked packing: host numpy tables, one entry per chunk.

    ``chunks`` entries hold (pidx, offsets, ms, word_tbl, cr_*) where
    ``pidx`` are the chunk's pattern indices (engine order), ``offsets`` the
    (limb, bit) per pattern — folded layouts assign several patterns to one
    aligned bit lane — and ``cr_field``/``cr_shift``/``cr_depth`` [2W, R]
    the per-u32-column expansion rows (the verify fields whose match bit
    lives in that column, padded with field -1). ``W``/``A``/``R`` are the
    uniform static shapes; ``m_max`` the global longest pattern (the scan
    halo length).
    """

    __slots__ = ("filt", "chunks", "W", "A", "R", "m_max", "n_pat", "folded",
                 "rd_min", "rd_max")

    def __init__(self, filt, chunks, W, A, R, m_max, n_pat, folded=False,
                 rd_min=1, rd_max=1):
        self.filt = filt
        self.chunks = chunks
        self.W = W
        self.A = A
        self.R = R
        self.m_max = m_max
        self.n_pat = n_pat
        self.folded = folded
        self.rd_min = rd_min
        self.rd_max = rd_max

    @staticmethod
    def build(engine, fold: bool = False) -> Optional["ManyPackSpec"]:
        from ..prefilter import BitapFilter
        from .packed_bitap import (
            MAX_ALPHABET_PACKED, _pack_fields, _word_table,
        )
        from .verify_dp import verify_fields_of

        filt = getattr(engine, "_bitap_filter_cache", None)
        if filt is None:
            filt = BitapFilter.build(engine, allow_mappings=True)
            engine._bitap_filter_cache = filt if filt is not None else False
        if filt is False or filt is None:
            return None
        vf = verify_fields_of(engine)
        if vf is None:
            return None
        pats = filt.patterns
        if len(pats) > MANY_MAX_PATTERNS:
            return None
        A = len(filt.symbol_ids) + 1
        if A > MAX_ALPHABET_PACKED:
            return None

        # ranges: list of (pidx ndarray, offsets list) per chunk.
        ranges = []
        if fold:
            assign = _fold_assign(pats, A, engine.max_edits_fast)
            if assign is None:
                return None
            # Split the folded layout at FOLD_CHUNK_LIMBS limb boundaries,
            # rebasing limb indices per chunk (patterns arrive limb-ordered).
            cur_p, cur_o, cur_c = [], [], 0
            for p, (lw, lo) in assign:
                c = lw // FOLD_CHUNK_LIMBS
                if c != cur_c and cur_p:
                    ranges.append((np.asarray(cur_p), cur_o))
                    cur_p, cur_o = [], []
                cur_c = c
                cur_p.append(p)
                cur_o.append((lw - c * FOLD_CHUNK_LIMBS, lo))
            if cur_p:
                ranges.append((np.asarray(cur_p), cur_o))
            # Fold pays off only when it actually cuts the pass count.
            offs_plain = _pack_fields([bp.m for bp in pats])
            if offs_plain is None:
                return None
            plain_chunks = -(-(max(w for w, _ in offs_plain) + 1) // MANY_LIMBS)
            if len(ranges) >= plain_chunks:
                return None
        else:
            # Greedy consecutive chunking under the limb budget.
            p0 = 0
            while p0 < len(pats):
                p1 = p0 + 1
                while p1 <= len(pats):
                    offs = _pack_fields([bp.m for bp in pats[p0:p1]])
                    if offs is None:
                        return None  # some pattern > 64 graphemes
                    if max(w for w, _ in offs) + 1 > MANY_LIMBS:
                        break
                    p1 += 1
                p1 -= 1
                if p1 <= p0:
                    return None  # single pattern exceeds the limb budget
                ranges.append(
                    (np.arange(p0, p1),
                     _pack_fields([bp.m for bp in pats[p0:p1]]))
                )
                p0 = p1

        # Static expansion-table maps, grouped by u32 column: the sparse
        # expansion looks up a fired word's rows directly (one bit lane's
        # co-resident patterns all live in the same column).
        chunks = []
        W = 1
        R = 1
        for (pidx, offsets) in ranges:
            ms = [pats[p].m for p in pidx]
            w_c = max(w for w, _ in offsets) + 1
            W = max(W, w_c)
            by_col: dict = {}
            for p, (lw, lo), m_p in zip(pidx, offsets, ms):
                bit = lo + m_p - 1
                col, sh = 2 * lw + (bit >> 5), bit & 31
                for fld in vf.pat2field[p]:
                    if fld < 0:
                        continue
                    row = (int(fld), sh, int(vf.depth[fld]))
                    by_col.setdefault(col, [])
                    if row not in by_col[col]:
                        by_col[col].append(row)
            R = max([R] + [len(v) for v in by_col.values()])
            chunks.append((pidx, offsets, ms, by_col))
        rd_all = [
            d for (_pi, _o, _m, bc) in chunks
            for rows_ in bc.values() for (_f, _s, d) in rows_
        ]
        rd_min = min(rd_all) if rd_all else 1
        rd_max = max(rd_all) if rd_all else 1

        # Uniform-shape numpy tables (padded to the global W / R).
        out_chunks = []
        for (pidx, offsets, ms, by_col) in chunks:
            limb = np.zeros((A, W), dtype=np.uint64)
            for p, (lw, lo) in zip(pidx, offsets):
                bp = pats[p]
                limb[: len(bp.mask), lw] |= bp.mask << np.uint64(lo)
            word_tbl = _word_table(limb, A, W)            # [A, 2W] i32
            cr_field = np.full((2 * W, R), -1, dtype=np.int32)
            cr_shift = np.zeros((2 * W, R), dtype=np.int32)
            cr_depth = np.zeros((2 * W, R), dtype=np.int32)
            # First-4 path classes per row (containment pre-verify); -1 pads
            # never equal a corpus class.
            cr_pc = np.full((2 * W, R, 4), -1, dtype=np.int32)
            for col, rows in by_col.items():
                for i, (fld, sh, d) in enumerate(rows):
                    cr_field[col, i] = fld
                    cr_shift[col, i] = sh
                    cr_depth[col, i] = d
                    jj = min(4, d)
                    cr_pc[col, i, :jj] = vf.path_cls[fld, :jj]
            out_chunks.append(
                (pidx, offsets, ms, word_tbl, cr_field, cr_shift, cr_depth,
                 cr_pc)
            )
        m_max = max(bp.m for bp in pats)
        return ManyPackSpec(
            filt, out_chunks, W, A, R, m_max, len(pats), folded=fold,
            rd_min=rd_min, rd_max=rd_max,
        )

    def masks_for(self, ks: List[int], k: int):
        """Per-chunk (starts [2W], match [k+1, 2W], init [k+1, 2W], notlast
        [2W]) u32 at the given per-pattern budgets (reference fresh-start
        state src/prefilter.rs:414-418); ``k`` is the uniform row count.
        ``notlast`` clears every field's LAST bit — the Damerau
        recurrence's bc_next guard (packed_bitap._step). Folded
        layouts OR the masks of co-resident patterns; their last bits
        coincide (aligned lanes), so notlast never clears an interior bit."""
        from .packed_bitap import _last_bit_mask, _starts_mask

        out = []
        for (pidx, offsets, ms, *_rest) in self.chunks:
            starts = _starts_mask(offsets, self.W)
            match = _last_bit_mask(
                offsets, ms, k + 1, lambda i: ks[pidx[i]], self.W
            )
            init = np.zeros((k + 1, 2 * self.W), dtype=np.uint32)
            for (lw, lo), m in zip(offsets, ms):
                for d in range(1, k + 1):
                    word = np.uint64((1 << min(d, m)) - 1) << np.uint64(lo)
                    init[d, 2 * lw] |= np.uint32(word & np.uint64(0xFFFFFFFF))
                    init[d, 2 * lw + 1] |= np.uint32(word >> np.uint64(32))
            notlast = (
                np.uint32(0xFFFFFFFF)
                ^ _last_bit_mask(offsets, ms, 1, lambda i: 0, self.W)[0]
            )
            out.append((starts, match, init, notlast))
        return out


def many_spec_of(engine, fold: bool = False) -> Optional[ManyPackSpec]:
    key = "_many_spec_cache_fold" if fold else "_many_spec_cache"
    sp = getattr(engine, key, None)
    if sp is None:
        sp = ManyPackSpec.build(engine, fold=fold)
        setattr(engine, key, sp if sp is not None else False)
    return sp if sp is not False else None


def _expand_candidates_sparse(
    pos, words, start_lo, start_hi, pos_hi, E, CAND, KH2,
    cr_field, cr_shift, cr_depth,
    ids_dense=None, cr_pc=None, k=0, rd_min=1, rd_max=1,
):
    """Two-level sparse form of the candidate expansion: first compact the
    nonzero (hit, u32-word) pairs out of ``words`` [KH, 2W] (almost every
    hit fires bits in exactly one word), then expand ONLY the rows mapped
    to that word (``cr_*`` [2W, R]: the (verify_field, shift, depth) rows
    whose match bit lives in that u32 column). The dense form walked
    KH x F x B cells and its prefix-sum compaction dominated the folded
    single-pass pipeline; this walks KH2 x R x B with R ~ 30-60.

    Same semantics as the dense form, including the hit-run dedup: band
    b > 0 candidates are suppressed when the same bit fired at pos - 1 —
    the pos - 1 expansion already covers those starts (fields are a
    function of the bit alone, so this holds for superimposed lanes too).
    """
    B = 2 * E + 1
    KH, W2 = words.shape
    hit_ok = (pos >= 0) & (pos < pos_hi)
    nz = (words != 0) & hit_ok[:, None]                       # [KH, 2W]
    pair_count, pidx = compact_indices(nz.reshape(-1), KH2)   # [KH2]
    psafe = jnp.maximum(pidx, 0)
    h = psafe // W2
    c = psafe % W2
    alive_p = pidx >= 0
    w = words[h, c].astype(jnp.uint32)                        # [KH2]
    ends = pos[h] + 1
    # prev-hit adjacency (hit rows are position-ordered within a lane; the
    # dense form used the same neighbour test).
    hprev = jnp.maximum(h - 1, 0)
    prev_same = alive_p & (h > 0) & (pos[hprev] + 1 == pos[h])
    wprev = jnp.where(prev_same, words[hprev, c], 0).astype(jnp.uint32)

    rf = cr_field[c]                                          # [KH2, R]
    rs = cr_shift[c].astype(jnp.uint32)
    rd = cr_depth[c]
    bits = (w[:, None] >> rs) & jnp.uint32(1)
    fired = alive_p[:, None] & (rf >= 0) & (bits == 1)
    bits_p = (wprev[:, None] >> rs) & jnp.uint32(1)
    dup = prev_same[:, None] & (bits_p == 1)

    if ids_dense is not None and cr_pc is not None and rd_max >= 4:
        # Containment pre-verify: of a row's first J=4 field-path chars, at
        # least J - k must appear SOMEWHERE in the corpus window
        # [s0 - 2k, s0 + 3 + 2k] (s0 = the band-center start = end - depth).
        # Sound under any script of <= k edits: a deletion removes at most
        # k chars entirely, every surviving char stays within +-2k of its
        # nominal position (<= k start slack + <= k indel drift). On a
        # folded layout it kills the ~90+% of rows that name a co-resident
        # pattern other than the one that actually fired the lane, so the
        # candidate buffer (and the CAND-proportional banded-DP cost
        # downstream) shrinks ~5-10x.
        #
        # Cost shape: the path chars are a STATIC [2W, R, 4] table (one row
        # take, no per-row gather) and ONE corpus window of width
        # WP = WJ + (rd_max - rd_min) is gathered per PAIR — each row's
        # [s0 - 2k, s0 + WJ) sub-window is selected arithmetically. The
        # first cut of this filter gathered [KH2, R, 8] windows and its
        # gathers cost ~3x what the banded DP saved.
        J = 4
        WJ = J + 4 * k
        WP = WJ + (rd_max - rd_min)
        pc = cr_pc[c]                                         # [KH2, R, J]
        lo_r = ends[:, None] - rd - 2 * k                     # [KH2, R]
        lo_p = ends - rd_max - 2 * k                          # [KH2]
        wlo = jnp.clip(lo_p, 0, jnp.maximum(start_hi - WP, 0))
        t_abs = wlo[:, None] + jnp.arange(WP, dtype=jnp.int32)
        win = ids_dense[t_abs].astype(jnp.int32)              # [KH2, WP]
        valid = (
            (t_abs[:, None, :] >= lo_r[..., None])
            & (t_abs[:, None, :] < (lo_r + WJ)[..., None])
        )                                                     # [KH2, R, WP]
        eq = (pc[..., :, None] == win[:, None, None, :]) & valid[..., None, :]
        cnt = eq.any(-1).sum(-1)                              # [KH2, R]
        fired = fired & ((rd < J) | (cnt >= J - k))

    ok_list, cf_list, cs_list = [], [], []
    for b in range(B):
        start = ends[:, None] - (rd + (b - E))
        ok = fired & (start >= start_lo) & (start < start_hi)
        if b > 0:
            ok = ok & ~dup
        ok_list.append(ok.reshape(-1))
        cf_list.append(jnp.where(ok, rf, -1).reshape(-1))
        cs_list.append(jnp.where(ok, start, 0).reshape(-1))
    cfs_all = jnp.stack(
        [jnp.concatenate(cf_list), jnp.concatenate(cs_list)], axis=1
    )
    ok_all = jnp.concatenate(ok_list)
    cand_count, cidx = compact_indices(ok_all, CAND)
    csafe = jnp.maximum(cidx, 0)
    pair = cfs_all[csafe]
    cand_field = jnp.where(cidx >= 0, pair[:, 0], -1)
    cand_start = jnp.where(cidx >= 0, pair[:, 1], 0)
    return pair_count, cand_count, cand_field, cand_start


@functools.partial(
    jax.jit,
    static_argnames=(
        "NL", "chunkpf", "halo", "k",
        "KH", "KH2", "CAND", "KG", "E", "Lmax", "C", "MO", "RDMN", "RDMX",
        "DEADEND",
    ),
)
def _many_pipeline_jit(
    ids_pf, scan_tabs,
    cr_field, cr_shift, cr_depth, cr_pc,
    depth_arr, node_arr, path_cls_flat, path_node_flat,
    out_list, pat_len, pat_weight,
    ids_dense, ids_dense_w32, limit, start_lo, start_hi,
    sim_flat, node_ceil, sb_edge_flat, out_count_arr,
    max_pen, p_sub, p_ins, p_del, p_swap, floor, thr,
    NL, chunkpf, halo, k,
    KH, KH2, CAND, KG, E, Lmax, C, MO, RDMN=1, RDMX=1,
    DEADEND=False,
):
    """One pattern-chunk's full search: scan -> expand -> banded DP -> emit.
    Result layout: TWO header rows ((hits, candidates, emissions) and
    (nonzero hit-word pairs, 0, 0)) followed by the 12-byte emission rows;
    per-chunk tables are traced inputs (``scan_tabs``: see
    packed_bitap.scan_tables; a notlast mask selects the Damerau recurrence
    — swap = 1 bitap error, so swap-permitting budgets scan with k = edits).
    ``k`` is the scan's error-row count (the containment pre-verify's slack)."""
    from .packed_bitap import packed_hits
    from .verify_dp import _banded_dp, _emit_rows

    count_h, pos, words = packed_hits(ids_pf, scan_tabs, NL, chunkpf, halo, KH)
    pair_count, cand_count, cand_field, cand_start = _expand_candidates_sparse(
        pos, words, start_lo, start_hi, limit, E, CAND, KH2,
        cr_field, cr_shift, cr_depth,
        ids_dense=ids_dense, cr_pc=cr_pc, k=k, rd_min=RDMN, rd_max=RDMX,
    )
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
    )
    total, rows = _emit_rows(
        pen_flat, cnt_flat, cand_field, cand_start,
        depth_arr, node_arr, out_list, pat_len, pat_weight,
        limit, thr, E, MO, CAND, KG,
    )
    header = (
        jnp.zeros((2, 3), jnp.int32)
        .at[0, 0].set(count_h)
        .at[0, 1].set(cand_count)
        .at[0, 2].set(total)
        .at[1, 0].set(pair_count)
    )
    return jnp.concatenate([header, rows], axis=0)


#: Sentinel: the folded scan fired past its hit ceiling (degenerate corpus
#: for the superimposed layout) — the caller re-runs with the plain chunks.
_FOLD_OVERFLOW = object()


def fuzzy_search_many(engine, haystack: str, threshold, view, n: int) -> Optional[List]:
    """Chunked large-dictionary fuzzy search; None when not applicable (the
    caller falls back to the beam kernels / oracle). Oracle-identical
    matches. FAST-path configurations only (global total-edit budget, no
    mappings, no per-pattern limits — the DeviceEngine gate).

    Tries the stratified-folded single-pass layout first (``_fold_assign``);
    if the superimposed scan fires past its hit ceiling on this corpus, the
    engine permanently falls back to the plain (unsuperimposed) chunking.
    """
    import os as _os_f

    use_fold = (
        _os_f.environ.get("FAC_MANY_FOLD") != "0"
        and not getattr(engine, "_many_fold_off", False)
    )
    if use_fold:
        spec = many_spec_of(engine, fold=True)
        if spec is not None:
            res = _many_search_spec(engine, spec, haystack, threshold, view, n)
            if res is not _FOLD_OVERFLOW:
                return res
            engine._many_fold_off = True
    spec = many_spec_of(engine)
    if spec is None:
        return None
    res = _many_search_spec(engine, spec, haystack, threshold, view, n)
    return None if res is _FOLD_OVERFLOW else res


def _many_search_spec(
    engine, spec, haystack: str, threshold, view, n: int
):
    from ..utils import device_corpus
    from .packed_bitap import (
        _cap_cache, _dev_consts, _space_token, resident_max, scan_layout,
        scan_tables,
    )
    from .verify_dp import _fine_cap, verify_fields_of

    thr = np.float32(threshold)
    if n > resident_max():
        return None
    vf = verify_fields_of(engine)
    if vf is None:
        return None
    dense = engine.dense
    if dense.num_classes > 256:
        return None
    pens = engine.penalties
    E = engine.max_edits_fast

    # Damerau-aware budgets (swap = 1 bitap error) when they shrink k — the
    # scan's pending-transposition rows make this sound (same model as the
    # headline lane, ops/verify_dp.fuzzy_search_dp).
    import os as _os_k

    # Per-pattern budgets are threshold-pure; the 2x1000 k_for python loop
    # costs ~2-3 ms per call otherwise (~3% of a warm folded search).
    ks_cache = getattr(engine, "_many_ks_cache", None)
    if ks_cache is None:
        ks_cache = engine._many_ks_cache = {}
    ck = (float(thr), _os_k.environ.get("FAC_NO_DAMERAU") == "1")
    got = ks_cache.get(ck)
    if got is None:
        ks_p = [spec.filt.k_for(bp, thr) for bp in spec.filt.patterns]
        ks_d = [
            spec.filt.k_for(bp, thr, damerau=True)
            for bp in spec.filt.patterns
        ]
        dam = (
            not ck[1]
            and None not in ks_d
            and (None in ks_p or max(ks_d) < max(ks_p))
        )
        got = ks_cache[ck] = (ks_d if dam else ks_p, dam)
    ks, dam = got
    if None in ks:
        return None
    k = max(ks)
    halo = spec.m_max + k

    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_pen = np.float32(ceil[0])
    if np.float32(0.0) > max_pen:
        return []

    tok = _space_token(engine)
    ids_pf, n_pf = device_corpus.resident(
        haystack,
        ("pk-fuzzy", tok),
        lambda h: np.ascontiguousarray(spec.filt.transcode(h)[0], dtype=np.uint8),
    )
    ids_dense, ids_dense_w32, n_d = device_corpus.resident_words(
        haystack,
        ("dense", tok),
        lambda h: np.ascontiguousarray(dense.transcode(h, view), dtype=np.uint8),
    )
    assert n_pf == n_d == n
    nb = ids_pf.size
    NL, chunkpf = scan_layout(nb, halo)

    # Per-chunk device tables, shipped once per (engine, threshold).
    def _ship():
        masks = spec.masks_for(ks, k)
        out = []
        for ci, ((_pidx, _offs, _ms, word_tbl, cr_field, cr_shift,
                  cr_depth, cr_pc), (starts, match, init, notlast)) in enumerate(
            zip(spec.chunks, masks)
        ):
            out.append((
                scan_tables(word_tbl, starts, match, init,
                            notlast=notlast if dam else None),
                jax.device_put(cr_field),
                jax.device_put(cr_shift),
                jax.device_put(cr_depth),
                jax.device_put(cr_pc),
            ))
        return tuple(out)

    chunk_tabs = _dev_consts(
        engine, ("many-consts", float(thr), dam, spec.folded), _ship
    )

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
    node_ceil = _dev_consts(
        engine, ("node-ceil", float(thr)), lambda: jax.device_put(ceil)
    )

    caps = _cap_cache(engine)
    kh_key = ("many-KH", nb, spec.folded)
    k2_key = ("many-KH2", nb, spec.folded)
    ca_key = ("many-CAND", nb, spec.folded)
    kg_key = ("many-KG", nb, spec.folded)
    KH = caps.get(kh_key, _fine_cap(max(1 << 13, nb >> 10)))
    KH2 = caps.get(k2_key, _fine_cap(max(1 << 13, nb >> 10)))
    CAND = caps.get(ca_key, _fine_cap(max(1 << 14, nb >> 9)))
    KG = caps.get(kg_key, _fine_cap(max(1 << 15, nb >> 11)))
    MAX_EXPAND = 1 << 27
    if KH2 * spec.R * (2 * E + 1) > MAX_EXPAND:
        return None
    # Folded layouts verify every superimposed fire with the (cheap) DP, but
    # a degenerate corpus can still swamp the hit buffer; past this ceiling
    # the plain chunking is the better program.
    HIT_CEIL = max(FOLD_HIT_CEIL_MIN, nb >> 8) if spec.folded else None

    import os as _os
    import time as _time

    _timing = _os.environ.get("FAC_TIME") == "1"

    def _launch(ci, KH_, KH2_, CAND_, KG_):
        (scan_tabs, cr_f, cr_s, cr_d, cr_p) = chunk_tabs[ci]
        return _many_pipeline_jit(
            ids_pf, scan_tabs,
            cr_f, cr_s, cr_d, cr_p,
            dep_d, node_d, pcls_d, pnode_d,
            olist_d, plen_d, pw_d,
            ids_dense, ids_dense_w32, np.int32(n), np.int32(0), np.int32(n),
            sim_d, node_ceil, sbe_d, ocnt_d,
            max_pen, pens.substitution, pens.insertion, pens.deletion,
            pens.swap, engine.min_symbol_similarity, thr,
            NL=NL, chunkpf=chunkpf, halo=halo, k=k,
            KH=KH_, KH2=KH2_, CAND=CAND_, KG=KG_, E=E, Lmax=vf.max_depth,
            C=dense.num_classes, MO=dense.max_out,
            RDMN=spec.rd_min, RDMX=spec.rd_max,
            DEADEND=dense.has_multibyte_edges,
        )

    _t0 = _time.perf_counter()
    pend = []
    for ci in range(len(chunk_tabs)):
        o = _launch(ci, KH, KH2, CAND, KG)
        try:
            o.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        pend.append((o, (KH, KH2, CAND, KG)))
    if _timing:
        jax.block_until_ready(pend[-1][0])
        _t1 = _time.perf_counter()

    bufs = []
    mx_h = mx_c = mx_g = mx_2 = 0
    sum_h = sum_c = 0
    for ci in range(len(chunk_tabs)):
        out_dev, (KH_u, KH2_u, CAND_u, KG_u) = pend[ci]
        buf = jax.device_get(out_dev)
        while True:
            count_h, cand_count, total = (
                int(buf[0, 0]), int(buf[0, 1]), int(buf[0, 2])
            )
            pair_count = int(buf[1, 0])
            if HIT_CEIL is not None and count_h > HIT_CEIL:
                return _FOLD_OVERFLOW
            grew = False
            if count_h > KH_u:
                KH = KH_u = _fine_cap(count_h)
                grew = True
            if pair_count > KH2_u:
                KH2 = KH2_u = _fine_cap(pair_count)
                if KH2 * spec.R * (2 * E + 1) > MAX_EXPAND:
                    return _FOLD_OVERFLOW if spec.folded else None
                grew = True
            if cand_count > CAND_u:
                CAND = CAND_u = _fine_cap(cand_count)
                grew = True
            if total > KG_u:
                KG = KG_u = _fine_cap(total)
                grew = True
            if not grew:
                break
            buf = jax.device_get(_launch(ci, KH_u, KH2_u, CAND_u, KG_u))
        mx_h, mx_c, mx_g = max(mx_h, count_h), max(mx_c, cand_count), max(mx_g, total)
        mx_2 = max(mx_2, pair_count)
        sum_h += count_h
        sum_c += cand_count
        bufs.append((buf, total))
    _t2 = _time.perf_counter()
    caps[kh_key] = max(caps.get(kh_key, 0), KH)
    caps[k2_key] = max(caps.get(k2_key, 0), KH2)
    caps[ca_key] = max(caps.get(ca_key, 0), CAND)
    caps[kg_key] = max(caps.get(kg_key, 0), KG)
    for key_, cap_, actual_ in (
        (kh_key, KH, mx_h), (k2_key, KH2, mx_2), (ca_key, CAND, mx_c),
        (kg_key, KG, mx_g)
    ):
        tight = _fine_cap(actual_)
        if 3 * tight <= 2 * cap_:
            caps[key_] = tight

    # One merged decode over all chunks: decode_matches lexsorts globally by
    # (pattern, start, end), so the result order is canonical regardless of
    # chunk order; duplicate emissions (a verify field shared by patterns in
    # two chunks) collapse in its best-per-span pass with identical values.
    rows = np.concatenate([buf[2 : 2 + total] for buf, total in bufs])
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
        (col2 >> 24).astype(np.int32),
        ((col2 >> 12) & 0xFFF).astype(np.int32),
        rows[:, 1].copy().view(np.float32),
        counts,
        thr,
    )
    engine.last_stats = {
        "backend": "device-fuzzy-many",
        "hits": sum_h,
        "candidates": sum_c,
        "positions": int(n),
        "emissions": total,
        "matches": len(results),
        "chunks": len(chunk_tabs),
        "damerau": dam,
        "folded": spec.folded,
    }
    if _timing:
        import sys as _sys

        engine.last_stats.update(
            dispatch_ms=round((_t1 - _t0) * 1e3, 1),
            readback_ms=round((_t2 - _t1) * 1e3, 1),
            decode_ms=round((_time.perf_counter() - _t3) * 1e3, 1),
            result_buf_kib=sum(b.nbytes for b, _ in bufs) >> 10,
        )
        print(
            f"[FAC_TIME many] dispatch={(_t1 - _t0) * 1e3:.1f}ms "
            f"readback={(_t2 - _t1) * 1e3:.1f}ms chunks={len(chunk_tabs)} "
            f"KH={KH} CAND={CAND} KG={KG}",
            file=_sys.stderr,
        )
    return results
