"""Data-parallel corpus sharding across a device mesh with halo overlap.

Device equivalent of the reference's window/thread parallelism
(reference src/stream.rs:378-429; SURVEY §2 parallelism inventory): the
haystack's symbol stream is sharded over a 1-D ``data`` mesh axis, each shard
fetches a halo of ``max_match_graphemes()`` symbols from its right neighbor
(``ppermute`` — the boundary-most shard receives zeros, i.e. dead
symbols), and every shard owns exactly the matches starting in its own region
(the reference's ``start < commit`` ownership rule, src/stream.rs:262-297),
so emission is exactly-once with no dedup collective.

Automaton tables are replicated to every device (they are the "weights");
only the corpus shards. Match counts reduce with ``psum``; match tuples are
fixed-capacity per-shard buffers gathered back to host.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D data mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("data",))


def make_sharded_exact_step(dense, mesh: Mesh, shard_len: int, halo: int, k_cap: int):
    """Build a jitted shard_map exact-search step over ``mesh``.

    Input: ids [n_dev * shard_len] int32 sharded over 'data'.
    Output (per shard, stacked on the data axis):
      counts [n_dev] int32, idx [n_dev, K, 2] (step, local pos), nodes [n_dev, K],
      total [] int32 (psum over shards — the collective reduction).
    """
    L = max(dense.max_depth, 1)
    halo = max(halo, L)
    n_dev = mesh.devices.size
    goto_flat = jnp.asarray(dense.goto.reshape(-1))
    out_count = jnp.asarray(dense.out_count)
    C = dense.num_classes

    def shard_body(alive, ids_local):
        # Fetch the halo from the right neighbor; the last shard
        # receives zeros (class 0 = dead), matching the stream-EOF window.
        head = jax.lax.ppermute(
            ids_local[:halo],
            "data",
            perm=[(i + 1, i) for i in range(n_dev - 1)],
        )
        ids_ext = jnp.concatenate([ids_local, head])
        N = shard_len

        def step(states, t):
            sym = jax.lax.dynamic_slice(ids_ext, (t,), (N,))
            safe = jnp.maximum(states, 0)
            nxt = goto_flat[safe * C + sym]
            nxt = jnp.where(states >= 0, nxt, -1)
            nxt = jnp.where(alive[jnp.maximum(nxt, 0)], nxt, -1)
            emit = jnp.where((nxt >= 0) & (out_count[jnp.maximum(nxt, 0)] > 0), nxt, -1)
            return nxt, emit

        # The carry must be marked device-varying inside shard_map.
        init = jnp.zeros((N,), dtype=jnp.int32) + ids_local[0] * 0
        _, emits = jax.lax.scan(step, init, jnp.arange(L, dtype=jnp.int32))
        mask = emits >= 0
        count = mask.sum(dtype=jnp.int32)
        idx = jnp.argwhere(mask, size=k_cap, fill_value=-1).astype(jnp.int32)
        nodes = jnp.where(
            idx[:, 0] >= 0,
            emits[jnp.maximum(idx[:, 0], 0), jnp.maximum(idx[:, 1], 0)],
            -1,
        )
        total = jax.lax.psum(count, "data")
        return count[None], idx[None], nodes[None], total[None]

    shard_fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P("data")),
        out_specs=(P("data"), P("data"), P("data"), P()),
    )
    return jax.jit(shard_fn)


def sharded_exact_search(engine, haystack: str, threshold: float, mesh: Optional[Mesh] = None):
    """Multi-device exact search: identical matches to the single-device path.

    Shards the transcoded corpus over the mesh, runs the halo'd exact kernel
    per shard, and merges per-shard emissions on the host (rebasing local
    positions by the shard offset).
    """
    from ..structs import FuzzyMatch
    from ..utils.graphemes import HaystackView

    if mesh is None:
        mesh = default_mesh()
    n_dev = mesh.devices.size
    dense = engine.dense
    thr = np.float32(threshold)

    view = HaystackView(haystack, engine.case_insensitive)
    ids = dense.transcode(haystack, view)
    n = len(ids)
    if n == 0:
        return []

    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    alive = np.asarray(ceil >= 0.0, dtype=bool)
    if not alive[0]:
        return []

    L = max(dense.max_depth, 1)
    shard_len = -(-n // n_dev)
    # Round shard length up for layout friendliness.
    shard_len = max(128, -(-shard_len // 128) * 128)
    padded = np.zeros(n_dev * shard_len, dtype=np.int32)
    padded[:n] = ids

    ids_dev = jax.device_put(
        padded.reshape(n_dev * shard_len), NamedSharding(mesh, P("data"))
    )
    # Regrow-and-retry on per-shard capacity overflow (the same policy as
    # every single-device kernel path, e.g. ops/packed_bitap._run_exact_kernel
    # — correctness never depends on the initial guess).
    k_cap = getattr(engine, "_shard_exact_cap", 1 << 14)
    while True:
        step = make_sharded_exact_step(dense, mesh, shard_len, L, k_cap)
        counts, idx, nodes, total = step(jnp.asarray(alive), ids_dev)
        counts = np.asarray(counts)
        cmax = int(counts.max(initial=0))
        if cmax <= k_cap:
            break
        k_cap = 1 << (cmax - 1).bit_length()
    engine._shard_exact_cap = max(getattr(engine, "_shard_exact_cap", 0), k_cap)
    idx = np.asarray(idx)
    nodes = np.asarray(nodes)

    hay_bytes = view.hay_bytes()
    is_ascii = view.ascii
    out_start, out_patterns = dense.out_start, dense.out_patterns
    pat_weight = dense.pat_weight
    patterns = engine._patterns
    results: List[FuzzyMatch] = []
    for d in range(n_dev):
        base = d * shard_len
        for k in range(int(counts[d])):
            t, i = idx[d, k]
            node = nodes[d, k]
            start_g = base + int(i)
            end_g = start_g + int(t) + 1
            if start_g >= n or end_g > n:
                continue
            for p in out_patterns[out_start[node] : out_start[node + 1]]:
                sim = np.float32(pat_weight[p])
                if sim < thr:
                    continue
                sb = start_g if is_ascii else view.byte_offset(start_g)
                eb = end_g if is_ascii else (view.byte_offset(end_g) if end_g < n else len(hay_bytes))
                results.append(
                    FuzzyMatch(
                        insertions=0, deletions=0, substitutions=0, swaps=0, edits=0,
                        pattern_index=int(p), pattern=patterns[p],
                        start=sb, end=eb, similarity=sim,
                        text=hay_bytes[sb:eb].decode("utf-8"),
                    )
                )
    return results


# ---------------------------------------------------------------------------
# Sharded fuzzy search: packed shift-AND -> candidates -> banded DP per shard
# ---------------------------------------------------------------------------

def make_sharded_fuzzy_step(
    engine, mesh: Mesh, shard_len: int, n: int, threshold,
    KH: int, CAND: int, KG: int,
    typed=None, maps=None, forbid=None,
):
    """Build a jitted shard_map fuzzy DP-search step over ``mesh``.

    The per-shard body is the single-device DP pipeline
    (ops/verify_dp._dp_pipeline_jit) re-based onto shard-extended streams:
    each shard receives its left halo (scan warm-up, ``max_pattern + k``
    symbols) from the left neighbor and a right margin (span lookahead) from
    the right neighbor (``ppermute``); ownership is the reference's
    ``start < commit`` rule (src/stream.rs:262-297) — a shard keeps exactly
    the candidates whose start lies in its own region, so emission is
    exactly-once with no dedup collective. Per-shard match counts reduce
    with ``psum`` (observability); match rows come back as fixed-capacity
    per-shard buffers.

    Inputs: ids_pf / ids_dn [n_dev * shard_len] sharded over 'data'
    (prefilter symbols u8; dense classes u8/int32).
    Output: int32 [n_dev, 1 + KG, 4]; per shard row 0 is the header
    ``[hit_count, cand_count, emit_total, psum_total]``, rows 1+ are
    ``[start_ext, pen_bits, me << 24 | pattern, counts]``.
    """
    import jax.numpy as jnp

    from ..ops.packed_bitap import (
        packed_fuzzy_of, packed_hits, scan_layout, scan_tables,
    )
    from ..ops.verify_dp import (
        _banded_dp,
        _banded_dp_typed,
        _emit_rows,
        _emit_rows_typed,
        _expand_candidates,
        verify_fields_of,
    )

    thr = np.float32(threshold)
    pk = packed_fuzzy_of(engine)
    vf = verify_fields_of(engine)
    dense = engine.dense
    pens = engine.penalties
    if forbid is not None:
        E = forbid[0]
    else:
        E = engine.max_edits_fast if typed is None else typed.E
    if maps is not None:
        # Edit-count-based scan budget (see ops/verify_dp.MappedSpec).
        ks = [maps.k] * len(pk.filt.patterns)
        dam = False
    else:
        # Damerau-aware budgets (swap = 1 bitap error) when they shrink k —
        # the scan's pending-transposition rows make this sound (same
        # selection as ops/verify_dp.fuzzy_search_dp).
        import os as _os_k

        ks_p = [pk.filt.k_for(bp, thr) for bp in pk.filt.patterns]
        ks_d = [pk.filt.k_for(bp, thr, damerau=True) for bp in pk.filt.patterns]
        dam = (
            _os_k.environ.get("FAC_NO_DAMERAU") != "1"
            and None not in ks_d
            and (None in ks_p or max(ks_d) < max(ks_p))
        )
        ks = ks_d if dam else ks_p
    match, init, k = pk.fuzzy_masks(ks)
    halo = pk.m_max + k
    Lmax = vf.max_depth
    margin = max(halo, Lmax + 2 * E + 2)
    n_dev = mesh.devices.size

    # Per-shard extended stream [left halo | local | right margin | zero
    # pad] of padded length NL * chunk (zero pad = dead symbols).
    NL, chunk = scan_layout(halo + shard_len + margin, halo)
    EXT = NL * chunk

    # Static candidate-expansion tables (python ints — no device gathers).
    bits = tuple(
        (2 * lw + ((lo + m_p - 1) >> 5), (lo + m_p - 1) & 31)
        for (lw, lo), m_p in zip(pk.offsets, pk.ms)
    )
    p2f = tuple(tuple(int(fi) for fi in row if fi >= 0) for row in vf.pat2field)
    depths = tuple(int(dd) for dd in vf.depth)

    ceil = engine.prune_len_arr - np.float32(engine.prune_len_over_weight_arr * thr)
    max_pen = np.float32(ceil[0])

    # Replicated device constants (the automaton is the "weights").
    scan_tabs = scan_tables(
        pk.word_tbl, pk.starts, match, init,
        notlast=pk.notlast() if dam else None,
    )
    dep_d = jnp.asarray(vf.depth)
    node_d = jnp.asarray(vf.node)
    pcls_d = jnp.asarray(vf.path_cls.reshape(-1))
    pnode_d = jnp.asarray(vf.path_node.reshape(-1))
    olist_d = jnp.asarray(dense.out_list)
    plen_d = jnp.asarray(dense.pat_len)
    pw_d = jnp.asarray(dense.pat_weight)
    sim_d = jnp.asarray(dense.sim.reshape(-1))
    ceil_d = jnp.asarray(ceil)
    sbe_d = jnp.asarray(dense.sb_edge.reshape(-1))
    ocnt_d = jnp.asarray(dense.out_count)
    if typed is not None:
        ncaps_d = jnp.asarray(np.ascontiguousarray(typed.node_caps.reshape(-1)))
        limcls_d = jnp.asarray(typed.limcls)

    def shard_body(ids_pf_local, ids_dn_local):
        axi = jax.lax.axis_index("data")
        base = axi.astype(jnp.int32) * shard_len  # global pos of local 0

        def with_halos(local):
            left = jax.lax.ppermute(
                local[shard_len - halo :], "data",
                perm=[(i, i + 1) for i in range(n_dev - 1)],
            )
            right = jax.lax.ppermute(
                local[:margin], "data",
                perm=[(i + 1, i) for i in range(n_dev - 1)],
            )
            pad = jnp.zeros((EXT - halo - shard_len - margin,), local.dtype)
            return jnp.concatenate([left, local, right, pad])

        ids_pf_ext = with_halos(ids_pf_local)
        ids_dn_ext = with_halos(ids_dn_local)

        # Ext position p <-> global g = base - halo + p; text-valid iff
        # 0 <= g < n, i.e. lo_ext <= p < limit_ext.
        limit_ext = jnp.clip(jnp.int32(n) - base + halo, 0, EXT)
        lo_ext = jnp.maximum(halo - base, 0)

        count_h, pos, words = packed_hits(ids_pf_ext, scan_tabs, NL, chunk, halo, KH)
        start_lo = jnp.int32(halo)
        start_hi = jnp.minimum(jnp.int32(halo + shard_len), limit_ext)
        cand_count, cand_field, cand_start = _expand_candidates(
            pos, words, start_lo, start_hi, limit_ext,
            E, CAND, bits, p2f, depths,
        )
        if typed is None:
            pen_flat, cnt_flat = _banded_dp(
                cand_field, cand_start, pcls_d, pnode_d, dep_d,
                ids_dn_ext, limit_ext, sim_d, ceil_d,
                max_pen, pens.substitution, pens.insertion, pens.deletion,
                pens.swap, engine.min_symbol_similarity,
                E, Lmax, dense.num_classes,
                lo=lo_ext,
                deadend=dense.has_multibyte_edges and forbid is None,
                sb_edge_flat=sbe_d,
                out_count_arr=ocnt_d,
                MAPS=maps.maps if maps is not None else None,
                FORBID=None if forbid is None else tuple(forbid[1:]),
            )
            total, rows = _emit_rows(
                pen_flat, cnt_flat, cand_field, cand_start,
                dep_d, node_d, olist_d, plen_d, pw_d,
                limit_ext, thr, E, dense.max_out, CAND, KG,
            )
        else:
            pen_flat = _banded_dp_typed(
                cand_field, cand_start, pcls_d, pnode_d, dep_d, ncaps_d,
                ids_dn_ext, limit_ext, sim_d, ceil_d,
                max_pen, pens.substitution, pens.insertion, pens.deletion,
                pens.swap, engine.min_symbol_similarity,
                E, Lmax, dense.num_classes,
                TYPED=(typed.vecs, typed.sub_src, typed.ins_src,
                       typed.del_src, typed.swap_src, typed.root_caps),
                lo=lo_ext,
            )
            total, rows = _emit_rows_typed(
                pen_flat, cand_field, cand_start,
                dep_d, node_d, olist_d, plen_d, pw_d, limcls_d,
                limit_ext, thr, E, dense.max_out, CAND, KG,
                TYPED_EMIT=(typed.vecs, typed.cnts, typed.adm),
            )
        gtotal = jax.lax.psum(total, "data")
        # Two 3-wide header rows (emission rows are 12-byte packed,
        # ops/verify_dp._pack_rows): [count_h, cand_count, total] then
        # [gtotal (psum observability), 0, 0].
        header = (
            jnp.zeros((2, 3), jnp.int32)
            .at[0, 0].set(count_h)
            .at[0, 1].set(cand_count)
            .at[0, 2].set(total)
            .at[1, 0].set(gtotal)
        )
        return jnp.concatenate([header, rows], axis=0)[None]

    shard_fn = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=P("data"),
        # pallas_call's output avals carry no varying-mesh-axes annotation;
        # every output here is explicitly P("data")-stacked anyway.
        check_vma=False,
    )
    return jax.jit(shard_fn), halo


def sharded_fuzzy_search(
    engine, haystack: str, threshold: float, mesh: Optional[Mesh] = None
):
    """Multi-device fuzzy search (DP pipeline sharded over the mesh with halo
    overlap): identical matches to the single-device path and the host
    oracle. Returns None when the engine isn't packed-prefilter eligible —
    the caller falls back (reference parallel fuzzy windows:
    src/stream.rs:378-429)."""
    from ..ops.emit import decode_matches
    from ..ops.packed_bitap import packed_fuzzy_of
    from ..ops.verify_dp import (
        _fine_cap,
        forbid_spec_of,
        mapped_spec_of,
        typed_spec_of,
        verify_fields_of,
    )
    from ..utils.graphemes import HaystackView

    if mesh is None:
        mesh = default_mesh()
    n_dev = mesh.devices.size
    thr = np.float32(threshold)

    pk = packed_fuzzy_of(engine)
    vf = verify_fields_of(engine)
    if pk is None or vf is None:
        return None
    typed = None
    maps = None
    forbid = None
    if 1 <= engine.max_edits_fast <= 6:
        if engine.mappings:
            maps = mapped_spec_of(engine)
            if maps is None:
                return None
            # Haystack gate (see fuzzy_search_mapped_device): every grapheme
            # one code point, so class identity == char identity.
            if not haystack.isascii() and len(
                HaystackView(haystack, engine.case_insensitive)
            ) != len(haystack):
                return None
    else:
        if engine.mappings:
            return None
        forbid = forbid_spec_of(engine)
        if forbid is None:
            typed = typed_spec_of(engine)
            if typed is None:
                return None
    if maps is None:
        import os as _os_k

        allow_dam = _os_k.environ.get("FAC_NO_DAMERAU") != "1"
        for bp in pk.filt.patterns:
            # Usable under either budget model (the step builder picks the
            # Damerau one when it is smaller — make_sharded_fuzzy_step).
            if pk.filt.k_for(bp, thr) is None and not (
                allow_dam and pk.filt.k_for(bp, thr, damerau=True) is not None
            ):
                return None

    ceil0 = engine.prune_len_arr[0] - np.float32(
        engine.prune_len_over_weight_arr[0] * thr
    )
    if np.float32(0.0) > np.float32(ceil0):
        return []

    view = HaystackView(haystack, engine.case_insensitive)
    n = len(view)
    if n == 0:
        return []

    ids_pf = np.ascontiguousarray(pk.filt.transcode(haystack)[0], dtype=np.uint8)
    dense = engine.dense
    narrow = dense.num_classes <= 256
    ids_dn = np.ascontiguousarray(
        dense.transcode(haystack, view), dtype=np.uint8 if narrow else np.int32
    )
    assert len(ids_pf) == len(ids_dn) == n

    shard_len = max(128, -(-(-(-n // n_dev)) // 128) * 128)
    pf_pad = np.zeros(n_dev * shard_len, dtype=ids_pf.dtype)
    pf_pad[:n] = ids_pf
    dn_pad = np.zeros(n_dev * shard_len, dtype=ids_dn.dtype)
    dn_pad[:n] = ids_dn
    sharding = NamedSharding(mesh, P("data"))
    pf_dev = jax.device_put(pf_pad, sharding)
    dn_dev = jax.device_put(dn_pad, sharding)

    caps = getattr(engine, "_shard_fuzzy_caps", None)
    if caps is None:
        caps = {}
        engine._shard_fuzzy_caps = caps
    ck = (n_dev, shard_len)
    KH = caps.get(("KH",) + ck, _fine_cap(max(1 << 12, shard_len >> 10)))
    CAND = caps.get(("CAND",) + ck, _fine_cap(max(1 << 13, shard_len >> 9)))
    KG = caps.get(("KG",) + ck, _fine_cap(max(1 << 13, shard_len >> 11)))

    steps = getattr(engine, "_shard_fuzzy_steps", None)
    if steps is None:
        steps = {}
        engine._shard_fuzzy_steps = steps
    while True:
        sk = (
            tuple(d.id for d in mesh.devices.flat), shard_len, n, float(thr),
            KH, CAND, KG, typed is not None, maps is not None, forbid,
        )
        hit = steps.get(sk)
        if hit is None:
            hit = make_sharded_fuzzy_step(
                engine, mesh, shard_len, n, thr, KH, CAND, KG,
                typed=typed, maps=maps, forbid=forbid,
            )
            steps[sk] = hit
        step, halo = hit
        buf = np.asarray(step(pf_dev, dn_dev))          # [n_dev, 2+KG, 3]
        heads = buf[:, 0, :]
        grew = False
        mx = int(heads[:, 0].max(initial=0))
        if mx > KH:
            KH = _fine_cap(mx)
            grew = True
        mx = int(heads[:, 1].max(initial=0))
        if mx > CAND:
            CAND = _fine_cap(mx)
            grew = True
        mx = int(heads[:, 2].max(initial=0))
        if mx > KG:
            KG = _fine_cap(mx)
            grew = True
        if not grew:
            break
    caps[("KH",) + ck] = max(caps.get(("KH",) + ck, 0), KH)
    caps[("CAND",) + ck] = max(caps.get(("CAND",) + ck, 0), CAND)
    caps[("KG",) + ck] = max(caps.get(("KG",) + ck, 0), KG)

    # Rebase ext starts to global grapheme positions and decode once.
    starts_all, pens_all, mepat_all = [], [], []
    for d in range(n_dev):
        total = int(heads[d, 2])
        rows = buf[d, 2 : 2 + total]
        if total == 0:
            continue
        starts_all.append(rows[:, 0] - halo + d * shard_len)
        pens_all.append(rows[:, 1])
        mepat_all.append(rows[:, 2])
    if not starts_all:
        engine.last_stats = {
            "backend": "device-fuzzy-sharded", "shards": n_dev, "matches": 0,
        }
        return []
    starts = np.concatenate(starts_all)
    col2 = np.concatenate(mepat_all).astype(np.int64)
    c12 = col2 & 0xFFF
    counts = (
        (c12 & 7) | ((c12 >> 3) & 7) << 8 | ((c12 >> 6) & 7) << 16
        | ((c12 >> 9) & 7) << 24
    )
    results = decode_matches(
        engine, view, haystack, n,
        starts,
        (col2 >> 24).astype(np.int32),
        ((col2 >> 12) & 0xFFF).astype(np.int32),
        np.concatenate(pens_all).view(np.float32),
        counts,
        thr,
    )
    engine.last_stats = {
        "backend": "device-fuzzy-sharded",
        "shards": n_dev,
        "hits": int(heads[:, 0].sum()),
        "candidates": int(heads[:, 1].sum()),
        "positions": int(n),
        "emissions": int(heads[:, 2].sum()),
        "matches": len(results),
    }
    return results
