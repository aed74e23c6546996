"""The packed shift-AND scan (ops/packed_bitap): the Triton kernel (here in
Pallas interpret mode) against its plain ``lax`` reference, the hit replay
against a whole-stream run of the recurrence, the lane layout's invariants,
and the device lanes' refusal to run without a GPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu.ops import packed_bitap as pb


def _tables(seed, W, k, damerau, A=12):
    """Random patterns packed into exactly W limbs, with per-pattern budgets
    <= k; returns (device tables, patterns, numpy match mask)."""
    rng = np.random.default_rng(seed)
    ms = []
    while True:
        m = int(rng.integers(2, 24))
        offs = pb._pack_fields(ms + [m])
        if max(w for w, _ in offs) + 1 > W:
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
    match, init, kk = pk.fuzzy_masks(ks)
    assert kk == k
    tabs = pb.scan_tables(pk.word_tbl, pk.starts, match, init,
                          notlast=pk.notlast() if damerau else None)
    return tabs, pats, pk.m_max + k


def _corpus(seed, n, pats, A=12):
    """Random symbols with planted (possibly mutated) patterns."""
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, A, size=n).astype(np.uint8)
    for _ in range(max(1, n // 40)):
        p = pats[int(rng.integers(len(pats)))].astype(np.uint8).copy()
        if rng.random() < 0.5 and len(p) > 2:
            j = int(rng.integers(len(p) - 1))
            p[j], p[j + 1] = p[j + 1], p[j]
        at = int(rng.integers(0, max(1, n - len(p))))
        ids[at : at + len(p)] = p[: n - at]
    return ids


@pytest.mark.parametrize(
    "W,k,damerau,n",
    [
        (1, 0, False, 3000),
        (1, 1, True, 3000),
        (1, 2, False, 2500),
        (2, 1, False, 2900),
        (3, 2, True, 2000),
        (8, 1, True, 1500),     # 8 limbs x 3 rows: two limb groups
        (1, 1, True, 37),       # corpus shorter than one lane block
        (2, 0, False, 1237),    # n not a multiple of the lane block
    ],
)
def test_scan_kernel_matches_reference(W, k, damerau, n):
    tabs, pats, halo = _tables(W * 31 + k, W, k, damerau)
    NL, chunk = pb.scan_layout(n, halo)
    ids = np.zeros(NL * chunk, np.uint8)
    ids[:n] = _corpus(W + k, n, pats)
    lanes = pb._lanes_of(jnp.asarray(ids), NL, chunk, halo)
    got = np.asarray(pb._scan_flags(lanes, tabs, halo))
    want = np.asarray(pb.scan_flags_reference(lanes, tabs, halo))
    assert got.shape == want.shape == (chunk, NL)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0  # the planted patterns fire


def _words_whole_stream(ids, tabs):
    """Match words at every position from one sequential run over the whole
    stream (no halo truncation): [n, 2W] u32."""
    tbl, starts, match, init, notlast = tabs
    W = starts.shape[0] // 2
    k = match.shape[0] - 1
    dam = notlast is not None and k >= 1
    st, mt, it, nl = pb._table_scalars(
        starts, match, init, notlast if dam else None, k, 2 * W
    )

    def body(rows, sym):
        bc = tbl[sym.astype(jnp.int32)]
        new = pb._step(rows, [bc[i] for i in range(2 * W)], st, nl, k, W)
        return new, jnp.stack(pb._match_words(new, mt, k, W))

    _, words = jax.lax.scan(body, pb._init_rows(it, k, W, dam, ()), jnp.asarray(ids))
    return np.asarray(words)


@pytest.mark.parametrize("replay", ["kernel", "reference"])
@pytest.mark.parametrize("W,k,damerau", [(1, 0, False), (1, 1, True), (2, 2, False)])
def test_replay_matches_whole_stream_words(W, k, damerau, replay):
    fn = pb._replay_words if replay == "kernel" else pb.replay_words_reference
    tabs, pats, halo = _tables(100 + W + k, W, k, damerau)
    ids = _corpus(7, 1200, pats)
    truth = _words_whole_stream(ids, tabs)
    hits = np.flatnonzero(truth.any(axis=1))
    assert len(hits) > 0
    pos = np.concatenate([hits, [-1, -1]]).astype(np.int32)
    got = np.asarray(fn(jnp.asarray(ids), jnp.asarray(pos), tabs, halo))
    np.testing.assert_array_equal(got[: len(hits)], truth[hits])
    assert not got[len(hits):].any()  # dead slots carry zero words


def test_packed_hits_positions_are_the_flagged_stream_positions():
    tabs, pats, halo = _tables(5, 1, 1, True)
    ids = _corpus(5, 2000, pats)
    truth = _words_whole_stream(ids, tabs)
    NL, chunk = pb.scan_layout(len(ids), halo)
    pad = np.zeros(NL * chunk, np.uint8)
    pad[: len(ids)] = ids
    count, pos, words = pb.packed_hits(jnp.asarray(pad), tabs, NL, chunk, halo, 4096)
    hits = np.flatnonzero(truth.any(axis=1))
    assert int(count) == len(hits)
    np.testing.assert_array_equal(np.asarray(pos)[: len(hits)], hits)
    np.testing.assert_array_equal(np.asarray(words)[: len(hits)], truth[hits])


def test_exact_scan_flags_equal_substring_ends():
    """k = 0 flags are exactly the end positions of pattern occurrences."""
    engine = FuzzyAhoCorasickBuilder.new().build(["abc", "bcd", "cabd"])
    pk = pb.packed_exact_of(engine)
    rng = np.random.default_rng(3)
    text = "".join(rng.choice(list("abcd"), size=3000))
    ids = pk.ascii_tbl[np.frombuffer(text.encode(), np.uint8)]
    tabs = pb.scan_tables(pk.word_tbl, pk.starts, pk.match_mask(),
                          np.zeros((1, 2 * pk.W), np.uint32))
    NL, chunk = pb.scan_layout(len(ids), pk.m_max)
    pad = np.zeros(NL * chunk, np.uint8)
    pad[: len(ids)] = ids
    flags = np.asarray(pb._stream_flags(jnp.asarray(pad), tabs, NL, chunk, pk.m_max))
    want = np.zeros(NL * chunk, np.int8)
    for p in ("abc", "bcd", "cabd"):
        i = text.find(p)
        while i >= 0:
            want[i + len(p) - 1] = 1
            i = text.find(p, i + 1)
    np.testing.assert_array_equal(flags, want)


@pytest.mark.parametrize("halo", [1, 9, 40, 70])
def test_scan_layout_invariants(halo):
    from fuzzy_aho_corasick_tpu.utils.device_corpus import bucket_len

    for n in [1, 7, 100, 1000, 4097, 65536, 100_003, 3 << 20, 96 << 20]:
        NL, chunk = pb.scan_layout(n, halo)
        assert NL & (NL - 1) == 0 and 1 <= NL <= pb.LANES_MAX
        assert chunk >= max(halo, 8)
        assert NL * chunk >= n
        # The most lanes that keep chunk >= halo.
        assert NL == pb.LANES_MAX or -(-n // (2 * NL)) < max(halo, 8)
        nb = bucket_len(n + 128)
        NLb, chunkb = pb.scan_layout(nb, halo)
        assert NLb * chunkb == nb  # resident buckets need no padding
    assert pb.scan_layout(96 << 20, 20)[0] == pb.LANES_MAX


@pytest.mark.parametrize("W,k,damerau", [(1, 0, False), (8, 1, True), (64, 1, True), (64, 6, True)])
def test_limb_groups_fit_registers(W, k, damerau):
    G, NG = pb._limb_groups(W, k, damerau)
    rows = (k + 1) + (k if damerau else 0)
    assert G * NG >= W and (NG - 1) * G < W
    assert G == 1 or 2 * G * rows <= pb.STATE_WORDS


def test_device_lane_without_gpu_raises(monkeypatch):
    engine = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
              .build(["hello", "world"]))
    hay = "hello wrold " * 2000
    monkeypatch.delenv("FAC_INTERPRET")
    assert not pb.device_available()
    engine.backend = "device"
    with pytest.raises(pb.DeviceUnavailable):
        engine.search_raw(hay, 0.8)
    # 'auto' keeps to the host path instead.
    engine.backend = "auto"
    got = engine.search_raw(hay, 0.8)
    engine.backend = "oracle"
    key = lambda m: (m.start, m.end, m.pattern_index)
    assert sorted(map(key, got)) == sorted(map(key, engine.search_raw(hay, 0.8)))


@pytest.mark.gpu
@pytest.mark.parametrize("W,k,damerau", [(1, 0, False), (2, 1, True), (8, 2, True)])
def test_kernels_compiled_on_card_match_reference(gpu, W, k, damerau):
    """Scan and replay as Triton compiles them for the card, at a real lane
    count."""
    tabs, pats, halo = _tables(11 + W, W, k, damerau)
    NL, chunk = pb.scan_layout(1 << 22, halo)
    ids = jnp.asarray(_corpus(11, NL * chunk, pats))
    lanes = pb._lanes_of(ids, NL, chunk, halo)
    flags = np.asarray(jax.jit(pb._scan_flags, static_argnums=2)(lanes, tabs, halo))
    want = jax.jit(pb.scan_flags_reference, static_argnums=2)(lanes, tabs, halo)
    np.testing.assert_array_equal(flags, np.asarray(want))
    pos = jnp.asarray(np.flatnonzero(flags.T.reshape(-1))[: 1 << 16].astype(np.int32))
    got = jax.jit(pb._replay_words, static_argnums=3)(ids, pos, tabs, halo)
    ref = jax.jit(pb.replay_words_reference, static_argnums=3)(ids, pos, tabs, halo)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
