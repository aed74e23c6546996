"""Smoke run of the search and replace paths on the GPU, at real sizes.

    python chip_smoke.py          # one card: kernel parity, then every lane
    python chip_smoke.py --four   # four cards: the sharded search path only

Every phase drives the public entry points (``search_raw``,
``replace_stream_parallel``, the sharded searches) with ``backend="device"``,
checks the lane that served it, and compares the result with an independent
reference: the plain ``lax`` scan for the kernels, the pure-Python oracle on a
slice, the native C BFS lane on a larger span, and exact substring counts.
Each phase prints one line; its wall time is cold (compiles included), not a
rate. The last line is ``{"ok": true, "device": {...}}``; it is printed only
when every phase passed. Without a GPU the script exits non-zero at once.
"""

import argparse
import io
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

MIB = 1 << 20
#: Corpus sizes (bytes). The kernel parity phase scans 64 MiB of symbols.
FULL = 96 * MIB
PART = 24 * MIB
PARITY = 64 * MIB
#: Oracle slices, sized so the pure-Python oracle finishes in well under a
#: minute (typed E=2 and the 1k-pattern dictionary are its slowest configs).
ORACLE_SLICE = 256 << 10
ORACLE_SLICE_SLOW = 48 << 10
NATIVE_SPAN = 8 * MIB

FILLER = ["lorem", "ipsum", "dolor", "sit", "amet", "consectetur",
          "adipiscing", "elit", "vestibulum", "eros", "commodo", "accumsan",
          "porta", "orci"]
NEEDLES = ["tincidunt", "phaetra", "sollicitudin"]
DICT16 = ["tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
          "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
          "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
          "parturient"]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def make_corpus(nbytes: int, seed: int):
    """Space-separated filler words with a needle in place of ~1 word in 997
    (the bench corpus's recipe), generated vectorized. Returns (text,
    [(start, end, needle index)])."""
    rng = np.random.default_rng(seed)
    words = FILLER + NEEDLES
    enc = [np.frombuffer((w + " ").encode(), np.uint8) for w in words]
    width = max(len(e) for e in enc)
    table = np.zeros((len(enc), width), np.uint8)
    lens = np.array([len(e) for e in enc])
    for i, e in enumerate(enc):
        table[i, : len(e)] = e
    n_words = nbytes // 5 + 64
    pick = rng.integers(len(FILLER), size=n_words)
    hit = rng.integers(997, size=n_words) == 0
    pick[hit] = len(FILLER) + rng.integers(len(NEEDLES), size=int(hit.sum()))
    starts = np.concatenate([[0], np.cumsum(lens[pick])[:-1]])
    rows = table[pick]
    text = rows[np.arange(width)[None, :] < lens[pick][:, None]][:nbytes]
    needles = [
        (int(s), int(s) + len(words[p]), int(p) - len(FILLER))
        for s, p in zip(starts[hit], pick[hit])
        if s + len(words[p]) <= nbytes
    ]
    return text.tobytes().decode(), needles


def key(m):
    return (m.pattern_index, m.start, m.end, float(np.float32(m.similarity)),
            m.insertions, m.deletions, m.substitutions, m.swaps)


def same(a, b) -> bool:
    return sorted(map(key, a)) == sorted(map(key, b))


class Smoke:
    def __init__(self, jax):
        self.jax = jax
        self.failed = []

    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            info = fn()
            status = "ok"
        except Exception:
            traceback.print_exc()
            info, status = "", "FAILED"
            self.failed.append(name)
        stats = self.jax.devices()[0].memory_stats() or {}
        print(
            f"[{name}] {status}: {info} | cold wall {time.perf_counter() - t0:.1f} s "
            f"incl. compile | peak_bytes_in_use {stats.get('peak_bytes_in_use')}",
            flush=True,
        )


def device_search(engine, text, thr, lane):
    engine.backend = "device"
    got = engine.search_raw(text, thr)
    backend = engine.last_stats["backend"]
    if not backend.startswith(lane):
        raise AssertionError(f"served by {backend}, expected {lane}")
    return got, backend


def check_slices(engine, text, thr, oracle_len, native=True):
    """Device == oracle on the corpus end; device == native C BFS on a larger
    span where the configuration fits that lane. Returns a report."""
    from fuzzy_aho_corasick_tpu.ops import native_bfs

    tail = text[-oracle_len:]
    dev, _ = device_search(engine, tail, thr, "device")
    engine.backend = "oracle"
    ref = engine.search_raw(tail, thr)
    if not same(dev, ref):
        raise AssertionError(f"device != oracle on the last {len(tail)} bytes")
    out = f"== oracle on last {len(tail)} B ({len(ref)} matches)"
    if native:
        span = text[-NATIVE_SPAN:]
        nat = native_bfs.search_raw(engine, span, thr)
        if nat is None:
            out += "; native BFS lane n/a for this config"
        else:
            dev, _ = device_search(engine, span, thr, "device")
            if not same(dev, nat):
                raise AssertionError(f"device != native BFS on {len(span)} bytes")
            out += f"; == native BFS on last {len(span)} B ({len(nat)} matches)"
    return out


def builder(edits=None, swaps=None):
    from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits

    b = FuzzyAhoCorasickBuilder.new().case_insensitive(True)
    if edits is not None:
        lim = FuzzyLimits.new().edits(edits)
        if swaps is not None:
            lim = lim.swaps(swaps)
        b = b.fuzzy(lim)
    return b


def many_words(seed=7):
    rng = np.random.default_rng(seed)
    alpha = "abcdefghijklmnopqrstuvwxyz"
    return sorted({
        "".join(alpha[i] for i in rng.integers(0, 26, size=int(m)))
        for m in rng.integers(6, 12, size=1000)
    })


def plant_typos(text, words, count):
    """One-substitution typos of the longer words (the bench's many1k
    recipe), so the expand and verify stages do real work."""
    long_w = [w for w in words if len(w) >= 9]
    buf = bytearray(text.encode())
    step = max(1, len(buf) // count)
    for j in range(count):
        w = long_w[j % len(long_w)]
        t = (" " + w[:2] + ("x" if w[2] != "x" else "y") + w[3:] + " ").encode()
        pos = 100 + j * step
        if pos + len(t) < len(buf):
            buf[pos : pos + len(t)] = t
    return buf.decode()


def plant_modem(text):
    """Every 50th "commodo" becomes "modem" (pattern "modern" through the
    rn -> m mapping at similarity 1.0)."""
    import re

    n = [0]

    def sub(mo):
        n[0] += 1
        return "modem" if n[0] % 50 == 0 else mo.group(0)

    return re.sub(r"\bcommodo\b", sub, text)


# ---------------------------------------------------------------------------
# Phases (one card)
# ---------------------------------------------------------------------------

def random_tables(pb, W, k, damerau, A, seed):
    """Random patterns packed into exactly W limbs, per-pattern budgets <= k.
    Returns (device tables, halo, patterns)."""
    rng = np.random.default_rng(seed)
    ms = []
    while True:
        m = int(rng.integers(3, 24))
        if max(w for w, _ in pb._pack_fields(ms + [m])) + 1 > W:
            if max(w for w, _ in pb._pack_fields(ms)) + 1 == W:
                break
            continue
        ms.append(m)
    offsets = pb._pack_fields(ms)
    pats = [rng.integers(1, A, size=m) for m in ms]
    limb = np.zeros((A, W), dtype=np.uint64)
    for p, (lw, lo) in zip(pats, offsets):
        for i, c in enumerate(p):
            limb[c, lw] |= np.uint64(1) << np.uint64(lo + i)
    pk = pb.PackedFuzzy(None, W, A, offsets, ms, pb._word_table(limb, A, W),
                        pb._starts_mask(offsets, W), max(ms))
    ks = [int(rng.integers(0, k + 1)) for _ in ms]
    ks[0] = k
    match, init, _ = pk.fuzzy_masks(ks)
    tables = pb.scan_tables(pk.word_tbl, pk.starts, match, init,
                            notlast=pk.notlast() if damerau else None)
    return tables, pk.m_max + k, pats


def folded_tables(pb, k, damerau):
    """The 1k-pattern dictionary's folded layout (the many lane's widest
    scan) at a uniform budget k."""
    from fuzzy_aho_corasick_tpu.ops.many import many_spec_of

    spec = many_spec_of(builder(edits=1).build(many_words()), fold=True)
    ks = [k] * spec.n_pat
    starts, match, init, notlast = spec.masks_for(ks, k)[0]
    tables = pb.scan_tables(spec.chunks[0][3], starts, match, init,
                            notlast=notlast if damerau else None)
    return tables, spec.m_max + k, spec.A


def kernel_parity(jax):
    """Scan and replay kernels as compiled for the card against their plain
    lax forms, bit for bit, on 64 MiB of seeded symbols."""
    import jax.numpy as jnp

    from fuzzy_aho_corasick_tpu.ops import packed_bitap as pb

    A = 27
    rng = np.random.default_rng(1)
    base = rng.integers(1, A, size=PARITY).astype(np.uint8)
    lines = []
    for W in (1, 8, "folded"):
        for k in (0, 1, 2):
            for damerau in ((False,) if k == 0 else (False, True)):
                if W == "folded":
                    tables, halo, _ = folded_tables(pb, k, damerau)
                    ids = base
                else:
                    tables, halo, pats = random_tables(pb, W, k, damerau, A, 10 * W + k)
                    ids = base.copy()
                    for j in range(0, PARITY - 64, PARITY // 4096):
                        p = pats[j % len(pats)]
                        ids[j : j + len(p)] = p
                NL, chunk = pb.scan_layout(PARITY, halo)
                ids_d = jax.device_put(ids)
                kern = jax.jit(lambda i, t: pb._stream_flags(i, t, NL, chunk, halo))
                ref = jax.jit(lambda i, t: pb.scan_flags_reference(
                    pb._lanes_of(i, NL, chunk, halo), t, halo).T.reshape(-1))
                mem = kern.lower(ids_d, tables).compile().memory_analysis()
                got = np.asarray(kern(ids_d, tables))
                want = np.asarray(ref(ids_d, tables))
                if not np.array_equal(got, want):
                    raise AssertionError(f"scan W={W} k={k} damerau={damerau}: "
                                         f"{int((got != want).sum())} flags differ")
                pos = np.flatnonzero(got)[: 1 << 18].astype(np.int32)
                pos_d = jnp.asarray(np.concatenate([pos, [-1]]).astype(np.int32))
                rk = jax.jit(lambda i, p, t: pb._replay_words(i, p, t, halo))
                rr = jax.jit(lambda i, p, t: pb.replay_words_reference(i, p, t, halo))
                if not np.array_equal(np.asarray(rk(ids_d, pos_d, tables)),
                                      np.asarray(rr(ids_d, pos_d, tables))):
                    raise AssertionError(f"replay W={W} k={k} damerau={damerau}")
                Wn = tables[1].shape[0] // 2
                lines.append(
                    f"W={Wn} k={k} dam={int(damerau)} hits={len(np.flatnonzero(got))} "
                    f"temp={mem.temp_size_in_bytes}"
                )
    return (f"lane packed_scan+packed_replay, {PARITY} B, flags and words "
            f"bit-exact vs lax in {len(lines)} configs; scan memory_analysis: "
            + "; ".join(lines))


def exact_phase(corpus):
    engine = builder().build(DICT16)
    got, lane = device_search(engine, corpus, 0.5, "device-exact")
    low = corpus.lower()
    counts = np.zeros(len(DICT16), np.int64)
    for m in got:
        counts[m.pattern_index] += 1
    for i, w in enumerate(DICT16):
        n, at = 0, low.find(w)
        while at >= 0:
            n += 1
            at = low.find(w, at + 1)
        if n != counts[i]:
            raise AssertionError(f"{w}: device {counts[i]} != substring count {n}")
    rep = check_slices(engine, corpus, 0.5, ORACLE_SLICE)
    return (f"lane {lane}, {len(corpus)} B, {len(got)} matches == per-word "
            f"substring counts; {rep}")


def fuzzy1_phase(corpus, needles):
    engine = builder(edits=1).build(DICT16)
    got, lane = device_search(engine, corpus, 0.8, "device-fuzzy-dp")
    exact_hits = {(m.pattern_index, m.start, m.end) for m in got
                  if np.float32(m.similarity) == np.float32(1.0)}
    missing = [n for n in needles
               if (DICT16.index(NEEDLES[n[2]]), n[0], n[1]) not in exact_hits]
    if missing:
        raise AssertionError(f"{len(missing)} planted needles not found at 1.0")
    rep = check_slices(engine, corpus, 0.8, ORACLE_SLICE)
    return (f"lane {lane}, {len(corpus)} B, {len(got)} matches, all "
            f"{len(needles)} planted needles at similarity 1.0; {rep}")


def typed_phase(corpus):
    engine = builder(edits=2, swaps=0).build(DICT16)
    got, lane = device_search(engine, corpus, 0.62, "device-fuzzy-dp")
    rep = check_slices(engine, corpus, 0.62, ORACLE_SLICE_SLOW, native=False)
    return f"lane {lane}, {len(corpus)} B, {len(got)} matches; {rep}"


def mapped_phase(corpus):
    engine = builder(edits=1).mapping("rn", "m").build(DICT16 + ["modern"])
    text = plant_modem(corpus)
    got, lane = device_search(engine, text, 0.8, "device-fuzzy-dp-mapped")
    modern = len(DICT16)
    n_modem = text.count("modem")
    found = sum(1 for m in got if m.pattern_index == modern
                and np.float32(m.similarity) == np.float32(1.0))
    if found < n_modem:
        raise AssertionError(f"{found} of {n_modem} 'modem' found at 1.0")
    rep = check_slices(engine, text, 0.8, ORACLE_SLICE, native=False)
    return (f"lane {lane}, {len(text)} B, {len(got)} matches, {found} "
            f"'modem'->'modern' at 1.0; {rep}")


def many_phase(corpus):
    words = many_words()
    engine = builder(edits=1).build(words)
    text = plant_typos(corpus, words, 4000)
    got, lane = device_search(engine, text, 0.82, "device-fuzzy-many")
    if engine.last_stats.get("folded") is not True:
        raise AssertionError("many lane did not run its folded layout")
    rep = check_slices(engine, text, 0.82, ORACLE_SLICE_SLOW)
    return (f"lane {lane} (folded), {len(words)} patterns, {len(text)} B, "
            f"{len(got)} matches; {rep}")


def replace_phase(corpus):
    from fuzzy_aho_corasick_tpu import SearchOptions

    engine = builder(edits=1).build(DICT16)
    table = ["<x>"] * len(DICT16)
    src = corpus.encode()
    out = io.BytesIO()
    engine.backend = "device"
    n = engine.replace_stream_parallel(io.BytesIO(src), out, 64, 0.8, table)
    lane = engine.last_stats["backend"]  # the lane of the last batch
    if not lane.startswith("device-fuzzy-dp"):
        raise AssertionError(f"batches served by {lane}")
    whole = engine.replace(corpus, SearchOptions.new().with_threshold(0.8),
                           lambda m: "<x>")
    if out.getvalue() != whole.encode() or n != len(out.getvalue()):
        raise AssertionError("streamed replace != whole-input replace")
    tail = src[-ORACLE_SLICE:]
    t_out = io.BytesIO()
    engine.replace_stream_parallel(io.BytesIO(tail), t_out, 64, 0.8, table)
    engine.backend = "oracle"
    ref = engine.replace(tail.decode(), SearchOptions.new().with_threshold(0.8),
                         lambda m: "<x>")
    if t_out.getvalue() != ref.encode():
        raise AssertionError("streamed replace != oracle replace on the tail")
    return (f"replace_stream_parallel over lane {lane}, {len(src)} B in, "
            f"{n} B out == whole-input device "
            f"replace ({whole.count('<x>')} replacements); == oracle replace "
            f"on last {len(tail)} B")


def one_card(jax, smoke):
    corpus, needles = make_corpus(FULL, seed=42)
    part = corpus[:PART]
    smoke.phase("kernel parity", lambda: kernel_parity(jax))
    smoke.phase("exact 16 words", lambda: exact_phase(corpus))
    smoke.phase("fuzzy E=1 Damerau", lambda: fuzzy1_phase(corpus, needles))
    smoke.phase("typed E=2 swaps(0)", lambda: typed_phase(part))
    smoke.phase("mapped rn->m", lambda: mapped_phase(part))
    smoke.phase("many1k folded", lambda: many_phase(part))
    smoke.phase("replace_stream_parallel", lambda: replace_phase(corpus))


# ---------------------------------------------------------------------------
# Four cards: the sharded path against the single-device result
# ---------------------------------------------------------------------------

def four_cards(jax, smoke):
    from fuzzy_aho_corasick_tpu.parallel.shard_search import (
        default_mesh, sharded_exact_search, sharded_fuzzy_search,
    )

    if len(jax.devices()) != 4:
        raise SystemExit(f"--four needs 4 GPUs, found {len(jax.devices())}")
    mesh = default_mesh(4)
    corpus, _ = make_corpus(4 * PART, seed=42)

    def compare(engine, text, thr, sharded, single_lane):
        got = sharded(engine, text, thr, mesh)
        if got is None:
            raise AssertionError("sharded path declined the configuration")
        one, lane = device_search(engine, text, thr, single_lane)
        if not same(got, one):
            raise AssertionError(f"sharded ({len(got)}) != single device ({len(one)})")
        return (f"4 x {len(text) // 4} B, {len(got)} matches == single-device "
                f"{lane}")

    smoke.phase("sharded exact", lambda: compare(
        builder().build(DICT16), corpus, 0.5, sharded_exact_search, "device-exact"))
    smoke.phase("sharded fuzzy E=1", lambda: compare(
        builder(edits=1).build(DICT16), corpus, 0.8, sharded_fuzzy_search,
        "device-fuzzy-dp"))
    smoke.phase("sharded typed E=2 swaps(0)", lambda: compare(
        builder(edits=2, swaps=0).build(DICT16), corpus, 0.62,
        sharded_fuzzy_search, "device-fuzzy-dp"))
    smoke.phase("sharded mapped rn->m", lambda: compare(
        builder(edits=1).mapping("rn", "m").build(DICT16 + ["modern"]),
        plant_modem(corpus), 0.8, sharded_fuzzy_search, "device-fuzzy-dp-mapped"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args()
    os.environ.pop("FAC_INTERPRET", None)  # kernels run as compiled

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import fuzzy_aho_corasick_tpu  # noqa: F401  (fails outside the repo)

    print(f"card: {card_line()}", flush=True)
    smoke = Smoke(jax)
    (four_cards if args.four else one_card)(jax, smoke)
    if smoke.failed:
        print(f"chip_smoke: failed phases: {', '.join(smoke.failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
