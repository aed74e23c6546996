"""Multi-host execution skeleton: jax.distributed + host-sharded corpus IO.

The reference's concurrency ceiling is one process (std::thread pool over
mpsc channels, src/stream.rs:378-429). The scale-out story layers
two levels (SURVEY §5 "distributed communication backend"):

* **Within a host**: the corpus shards over the devices of a mesh with
  ppermute halos and psum reductions (parallel/shard_search) — collectives
  ride the host's device interconnect (NVLink on an H100 host).
* **Across hosts**: each process owns a byte range of the input (this
  module's :class:`HostShardPlan` — the WindowReader ownership rule lifted
  to host granularity), runs the sharded search on its local chips, and
  match tuples concatenate by construction (absolute offsets; the
  ``start < commit`` rule makes per-host emission exactly-once, so the only
  cross-host traffic is the final result gather over DCN).

On a real pod slice, call :func:`initialize` first (one process per host);
``jax.devices()`` then spans every host and a mesh built from it routes
neighbor ``ppermute`` across the DCN boundary automatically. This repo's
test environment has a single process, so the unit tests exercise the plan
+ per-host search loop with N logical hosts on the virtual CPU mesh — the
same code path a real multi-process launch takes per process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialize the JAX multi-process runtime (no-op when single-process).

    Returns this process's id. Mirrors ``jax.distributed.initialize``; on
    GPU hosts nothing announces the cluster, so pass all three arguments.
    """
    import jax

    if num_processes is None or num_processes <= 1:
        return 0
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return jax.process_index()


@dataclass
class HostShard:
    """One host's byte assignment: it reads [read_start, read_end) and owns
    matches whose start byte is in [own_start, own_end)."""

    host: int
    read_start: int
    read_end: int
    own_start: int
    own_end: int


class HostShardPlan:
    """Partition ``total_bytes`` across ``n_hosts`` with a right halo.

    The halo is ``overlap_bytes`` (callers pass
    ``engine.stream_overlap() * 4`` — 4 bytes/grapheme upper bound for the
    halo purpose; UTF-8 boundaries are then re-aligned against the actual
    data by :func:`align_utf8`). Ownership is exactly the stream/window rule
    (reference src/stream.rs:262-297): host ``h`` owns starts in its own
    range, so no match is emitted twice and none is missed (a match
    starting in ``h`` lies entirely inside ``h``'s read range because the
    halo exceeds the longest possible match).
    """

    def __init__(self, total_bytes: int, n_hosts: int, overlap_bytes: int):
        self.total = total_bytes
        self.n = max(1, n_hosts)
        self.overlap = overlap_bytes
        self.span = -(-total_bytes // self.n)

    def shard(self, h: int) -> HostShard:
        own_start = min(h * self.span, self.total)
        own_end = min(own_start + self.span, self.total)
        read_end = min(own_end + self.overlap, self.total)
        return HostShard(h, own_start, read_end, own_start, own_end)

    def shards(self) -> List[HostShard]:
        return [self.shard(h) for h in range(self.n)]


def align_utf8(data: bytes, pos: int) -> int:
    """Smallest offset >= pos that starts a UTF-8 code point."""
    n = len(data)
    while pos < n and (data[pos] & 0xC0) == 0x80:
        pos += 1
    return pos


def search_host_shard(
    engine, data: bytes, shard: HostShard, threshold: float, mesh=None
):
    """One host's work: sharded device search over its byte slice, owned
    matches rebased to absolute offsets.

    ``data`` is the host's read slice ``bytes[read_start:read_end]`` (e.g.
    from a per-host file pread). Returns StreamMatch-like FuzzyMatch tuples
    with absolute byte offsets.
    """
    from ..structs import FuzzyMatch
    from .shard_search import sharded_exact_search, sharded_fuzzy_search

    lo = align_utf8(data, 0)
    body = data[lo:]
    try:
        text = body.decode("utf-8")
    except UnicodeDecodeError as e:
        # The halo's tail may cut a code point; a halo match never needs it.
        text = body[: e.start].decode("utf-8")
    base = shard.read_start + lo

    import jax

    n_local = (
        int(mesh.devices.size) if mesh is not None else len(jax.local_devices())
    )
    matches = None
    if n_local > 1:
        # Multi-chip host: shard the slice over the local mesh.
        if engine.max_edits_fast >= 1:
            matches = sharded_fuzzy_search(engine, text, threshold, mesh)
        if matches is None and engine.max_edits_fast == 0:
            matches = sharded_exact_search(engine, text, threshold, mesh)
    if matches is None:
        # Single local device: the regular pipeline's compact ratcheted
        # result buffers beat the mesh lane's fixed-capacity readback, with
        # nothing to shard over anyway.
        matches = engine.search_raw(text, threshold)

    out: List[FuzzyMatch] = []
    import dataclasses

    for m in matches:
        start = base + m.start
        if shard.own_start <= start < shard.own_end:
            out.append(dataclasses.replace(m, start=start, end=base + m.end))
    return out


#: Gathered match row layout: [start, end, pattern_index, sim_bits, counts].
_ROW_COLS = 5


def _encode_matches(matches) -> np.ndarray:
    rows = np.zeros((len(matches), _ROW_COLS), dtype=np.int64)
    for i, m in enumerate(matches):
        counts = (
            (m.insertions & 0xFF)
            | ((m.deletions & 0xFF) << 8)
            | ((m.substitutions & 0xFF) << 16)
            | ((m.swaps & 0xFF) << 24)
        )
        rows[i] = (
            m.start,
            m.end,
            m.pattern_index,
            int(np.float32(m.similarity).view(np.int32)),
            counts,
        )
    return rows


def _decode_matches(engine, corpus: Optional[bytes], rows: np.ndarray):
    from ..structs import FuzzyMatch

    out = []
    for start, end, p, sim_bits, counts in rows:
        start, end, p = int(start), int(end), int(p)
        text = ""
        if corpus is not None and 0 <= start <= end <= len(corpus):
            text = corpus[start:end].decode("utf-8", errors="replace")
        ins = int(counts) & 0xFF
        dels = (int(counts) >> 8) & 0xFF
        subs = (int(counts) >> 16) & 0xFF
        swaps = (int(counts) >> 24) & 0xFF
        out.append(
            FuzzyMatch(
                insertions=ins, deletions=dels, substitutions=subs,
                swaps=swaps, edits=ins + dels + subs + swaps,
                pattern_index=p, pattern=engine._patterns[p],
                start=start, end=end,
                similarity=np.int32(int(sim_bits)).view(np.float32),
                text=text,
            )
        )
    return out


def _allgather_rows(rows: np.ndarray) -> np.ndarray:
    """All-gather variable-length match rows across processes over the
    distributed runtime (DCN on a pod; TCP on the CPU test fixture). Counts
    gather first, then rows padded to the max — the ordered fan-in that
    mirrors the reference's seq-tagged reassembly (src/stream.rs:603-630)."""
    import jax
    from jax.experimental import multihost_utils

    counts = np.asarray(
        multihost_utils.process_allgather(np.asarray([rows.shape[0]], np.int64))
    ).reshape(-1)
    cap = max(1, int(counts.max()))
    padded = np.zeros((cap, _ROW_COLS), dtype=np.int64)
    padded[: rows.shape[0]] = rows
    gathered = np.asarray(multihost_utils.process_allgather(padded))
    gathered = gathered.reshape(jax.process_count(), cap, _ROW_COLS)
    return np.concatenate(
        [gathered[h, : int(counts[h])] for h in range(gathered.shape[0])], axis=0
    )


def search_multihost(
    engine, corpus: bytes, threshold: float, n_hosts: Optional[int] = None,
    mesh=None,
):
    """Multi-host search driver.

    Under an initialized multi-process runtime (:func:`initialize`,
    ``jax.process_count() > 1``) each process searches ONLY its own host
    shard and the per-host match rows all-gather over the distributed
    backend — every process returns the identical, complete, sorted match
    list. Single-process, it iterates the logical host shards sequentially
    (the same per-shard code path a real launch takes per process).

    ``corpus``: this process's view of the input. The gather needs only the
    local slice to *search*; spans outside it decode with ``text = ""``
    when the full corpus bytes aren't locally available.
    """
    import jax

    overlap = (engine.stream_overlap() + 1) * 4
    nproc = jax.process_count()
    if nproc > 1:
        if mesh is None:
            # Per-host device mesh: this process's ADDRESSABLE devices only —
            # collectives inside the shard search stay within the host; the
            # only cross-host traffic is the result gather below.
            from jax.sharding import Mesh

            mesh = Mesh(np.asarray(jax.local_devices()), ("data",))
        plan = HostShardPlan(len(corpus), nproc, overlap)
        shard = plan.shard(jax.process_index())
        local: List = []
        if shard.own_start < shard.own_end:
            data = corpus[shard.read_start : shard.read_end]
            local = search_host_shard(engine, data, shard, threshold, mesh)
        rows = _allgather_rows(_encode_matches(local))
        out = _decode_matches(engine, corpus, rows)
        out.sort(key=lambda m: (m.start, m.end, m.pattern_index))
        return out

    plan = HostShardPlan(len(corpus), n_hosts if n_hosts else 1, overlap)
    out = []
    for shard in plan.shards():
        if shard.own_start >= shard.own_end:
            continue
        data = corpus[shard.read_start : shard.read_end]
        out.extend(search_host_shard(engine, data, shard, threshold, mesh))
    out.sort(key=lambda m: (m.start, m.end, m.pattern_index))
    return out


# ---------------------------------------------------------------------------
# Multi-host streaming replace (reference src/stream.rs:533-638: parallel
# search + in-stream-order reassembly, lifted to host granularity)
# ---------------------------------------------------------------------------


def _selected_replace_matches(engine, corpus: bytes, matches):
    """Global deterministic replacement selection: the ``segmented`` upgrade
    (Default rank + greedy non-overlap — reference src/query.rs:46-64,
    src/matches.rs:24-38, 86-112) applied to the gathered match set, then
    position order. Every host computes the identical list, so boundary
    decisions need no extra communication round."""
    from ..matches import FuzzyMatches
    from ..options import Order, Overlap

    fm = FuzzyMatches(corpus.decode("utf-8"), list(matches))
    fm.apply(Order.Default, Overlap.NonOverlapping)
    sel = sorted(fm, key=lambda m: (m.start, m.end, m.pattern_index))
    return sel


def _emit_host_segment(engine, corpus: bytes, sel, own_start: int, own_end: int,
                       callback) -> bytes:
    """Bytes host ``h`` contributes to the replaced stream: its owned range
    with selected matches spliced, honouring the cross-host cursor rule — a
    match STARTING in an earlier host's range but overrunning into this one
    was emitted there, so emission here starts at its end (the host-level
    form of the reference's ReplaceCursor hand-off, src/stream.rs:644-705).
    Concatenating every host's segment in host order reproduces the
    single-host replace byte-for-byte."""
    cur = own_start
    for m in sel:
        if m.start < own_start and m.end > own_start:
            cur = max(cur, m.end)  # previous host emitted this replacement
    parts = []
    for m in sel:
        if not (own_start <= m.start < own_end):
            continue
        if m.start < cur:
            continue  # overlapped by the boundary overrun
        if cur < m.start:
            parts.append(corpus[cur : m.start])
        rep = callback(m)
        parts.append(corpus[m.start : m.end] if rep is None
                     else rep.encode("utf-8") if isinstance(rep, str) else rep)
        cur = m.end
    if cur < own_end:
        parts.append(corpus[cur:own_end])
    return b"".join(parts)


def _as_callback(callback):
    """Accept the FuzzyReplacer-style table (list of replacements indexed by
    pattern) or a callable, like stream.replace_stream*."""
    if callable(callback):
        return callback
    table = list(callback)
    return lambda m: (
        table[m.pattern_index] if m.pattern_index < len(table) else None
    )


def replace_multihost(
    engine, corpus: bytes, threshold: float, callback,
    n_hosts: Optional[int] = None, mesh=None, writer=None,
):
    """Multi-host find-and-replace over a host-sharded corpus (BASELINE
    config 5; reference src/stream.rs:533-638's ordered reassembly at host
    granularity).

    Each host searches ONLY its owned byte range (sharded device search over
    its local chips, halo'd reads — :func:`search_host_shard`), the match
    rows all-gather over DCN, every host applies the identical global
    selection, and host ``h`` emits the replaced bytes of exactly its owned
    range. Under a multi-process runtime the local segment is returned (and
    written to ``writer`` when given) — concatenating segments in process
    order is the full replaced stream, byte-identical to the single-host
    :func:`fuzzy_aho_corasick_tpu.stream.replace_stream` selection on
    unambiguous corpora. Single-process, iterates the logical host shards
    and returns the assembled whole output.

    ``callback``: a ``match -> Optional[str|bytes]`` callable or a
    pattern-indexed replacement table (the FuzzyReplacer form).
    """
    import jax

    cb = _as_callback(callback)
    overlap = (engine.stream_overlap() + 1) * 4
    nproc = jax.process_count()
    if nproc > 1:
        if mesh is None:
            from jax.sharding import Mesh

            mesh = Mesh(np.asarray(jax.local_devices()), ("data",))
        plan = HostShardPlan(len(corpus), nproc, overlap)
        shard = plan.shard(jax.process_index())
        local: List = []
        if shard.own_start < shard.own_end:
            data = corpus[shard.read_start : shard.read_end]
            local = search_host_shard(engine, data, shard, threshold, mesh)
        rows = _allgather_rows(_encode_matches(local))
        sel = _selected_replace_matches(
            engine, corpus, _decode_matches(engine, corpus, rows)
        )
        seg = _emit_host_segment(
            engine, corpus, sel, shard.own_start, shard.own_end, cb
        )
        if writer is not None:
            writer.write(seg)
        return seg

    plan = HostShardPlan(len(corpus), n_hosts if n_hosts else 1, overlap)
    all_matches: List = []
    for shard in plan.shards():
        if shard.own_start >= shard.own_end:
            continue
        data = corpus[shard.read_start : shard.read_end]
        all_matches.extend(search_host_shard(engine, data, shard, threshold, mesh))
    sel = _selected_replace_matches(engine, corpus, all_matches)
    segs = [
        _emit_host_segment(engine, corpus, sel, s.own_start, s.own_end, cb)
        for s in plan.shards()
        if s.own_start < s.own_end
    ]
    out = b"".join(segs)
    if writer is not None:
        writer.write(out)
    return out
