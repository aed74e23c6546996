"""Benchmark: exact + edits=1 fuzzy scan throughput on the GPU.

Prints the headline JSON line `{"metric": ..., "value": N, "unit": ...}`
IMMEDIATELY after the two headline measurements (exact +
fuzzy-E1) and flushes it, so the driver always records a number even if a
later secondary bench hits a cold multi-minute kernel compile (that is what
zeroed round 2: rc=124 with the JSON still unprinted).  Secondary benches
(reference benches/benchmark.rs:139-257 analogs) then run under a wall-clock
budget, log only to stderr, and a final merged JSON line (same metric, extras
folded into "detail") is printed last — whichever line the driver parses,
the headline number is present.

Headline metric is bytes/s/chip of the end-to-end device search (native-C
transcode on host + anchored scan kernels on device) over an ASCII corpus
seeded with needles, per BASELINE.json's "bytes/s/chip (exact + edits=1
fuzzy scan)": combined = total bytes / (exact time + fuzzy time). The
reference itself publishes no absolute numbers (BASELINE.md). Every result
names the device it ran on; without a GPU the script fails instead of timing
the CPU.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_T_START = time.time()
# Wall-clock budget for the WHOLE process. The driver window killed round 2's
# run (rc=124); the headline now prints long before this matters, and each
# secondary bench checks the remaining budget before starting.
_BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "480"))


def _elapsed() -> float:
    return time.time() - _T_START


def _log(msg: str) -> None:
    print(f"[bench +{_elapsed():.0f}s] {msg}", file=sys.stderr, flush=True)


def build_corpus(size_bytes: int) -> str:
    # Disk-cached: the pure-Python generation loop costs ~50 s per 96 MiB
    # and delays the headline measurement; the corpus is deterministic per
    # size, so later runs (including the driver's) load it in ~1 s.
    cache = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        ".jax_cache", f"bench_corpus_{size_bytes}.txt",
    )
    try:
        if os.path.exists(cache) and os.path.getsize(cache) >= size_bytes:
            with open(cache, "r") as f:
                return f.read()
    except OSError:
        pass
    rng = np.random.default_rng(42)
    filler_words = [
        "lorem", "ipsum", "dolor", "sit", "amet", "consectetur", "adipiscing",
        "elit", "vestibulum", "eros", "commodo", "accumsan", "porta", "orci",
    ]
    needles = ["tincidunt", "phaetra", "sollicitudin"]
    parts = []
    size = 0
    while size < size_bytes:
        w = filler_words[int(rng.integers(len(filler_words)))]
        if rng.integers(997) == 0:
            w = needles[int(rng.integers(len(needles)))]
        parts.append(w)
        size += len(w) + 1
    corpus = " ".join(parts)
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        with open(cache, "w") as f:
            f.write(corpus)
    except OSError:
        pass
    return corpus


def run_extras(detail, corpus, fengine, dictionary):
    """Secondary benches (fuzzy E2/E3, 1k patterns, parallel replace, build).

    Each entry checks the remaining wall-clock budget first; a cold kernel
    compile in any one of them must never cost the headline number (it
    already printed). Logs to stderr only.
    """
    from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits

    sub = corpus[: 24 << 20]
    sn = len(sub)

    def budget_ok(name: str, need_s: float = 60.0) -> bool:
        if _elapsed() + need_s > _BUDGET_S:
            _log(f"skipping {name}: {_elapsed():.0f}s elapsed, budget {_BUDGET_S:.0f}s")
            detail[f"{name}_skipped"] = "budget"
            return False
        return True

    # Builder throughput (reference benches/benchmark.rs:200-220
    # build_automaton): patterns/s for a 10k-pattern dictionary build.
    if budget_ok("build_automaton", 30.0):
        try:
            rng = np.random.default_rng(11)
            alphabet = "abcdefghijklmnopqrstuvwxyz"
            pats = sorted({
                "".join(alphabet[i] for i in rng.integers(0, 26, size=int(m)))
                for m in rng.integers(5, 14, size=10_000)
            })
            t0 = time.time()
            FuzzyAhoCorasickBuilder.new().fuzzy(
                FuzzyLimits.new().edits(1)
            ).build(pats)
            dt = time.time() - t0
            detail["build_automaton_patterns_per_s"] = round(len(pats) / dt)
            detail["build_automaton_patterns"] = len(pats)
            _log(f"build_automaton: {len(pats)} patterns in {dt:.2f}s")
        except Exception as e:  # pragma: no cover - bench resilience
            detail["build_automaton_error"] = repr(e)

    # Small-string search latency (reference benches/benchmark.rs
    # search_basic): tiny haystacks route to the host oracle by design
    # (AUTO_DEVICE_MIN) — this measures that path's per-call latency.
    if budget_ok("search_basic", 15.0):
        try:
            basic = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
                .build(["hello", "world", "help"])
            )
            hay = "why hello there, wrold of helpful words"
            basic.search_raw(hay, 0.7)  # warm imports
            reps = 300
            t0 = time.time()
            for _ in range(reps):
                basic.search_raw(hay, 0.7)
            detail["search_basic_us"] = round((time.time() - t0) / reps * 1e6)
            _log(f"search_basic: {detail['search_basic_us']} us/call")
        except Exception as e:  # pragma: no cover - bench resilience
            detail["search_basic_error"] = repr(e)

    # Beam configs (reference benches/benchmark.rs beam_search group:
    # {none, 500, 100}): on the device, beamed engines ride the exact DP
    # lanes (docs/performance.md "Beams on the device") and REUSE the headline
    # engine's kernel shapes — no extra compile; the numbers demonstrate
    # beams cost nothing device-side.
    for bname, builder in (
        ("beam500", lambda b: b.beam_width(500)),
        ("autobeam", lambda b: b.auto_beam(100_000, 100)),
    ):
        if not budget_ok(bname, 30.0):
            continue
        try:
            eng = builder(
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
            ).build(dictionary)
            eng.backend = "device"
            eng.search_raw(corpus, 0.8)  # warm (kernel shared with fuzzy1)
            t0 = time.time()
            ms = eng.search_raw(corpus, 0.8)
            dt = time.time() - t0
            detail[f"{bname}_bps"] = round(len(corpus) / dt)
            detail[f"{bname}_matches"] = len(ms)
            _log(f"{bname}: {len(corpus) / dt / 1e6:.0f} MB/s")
            del eng, ms  # release device consts before the next extra
        except Exception as e:  # pragma: no cover - bench resilience
            detail[f"{bname}_error"] = repr(e)

    # 1k-pattern dictionary scan (pattern-chunked lane, ops/many): ONE
    # uniform-shape kernel compile serves every chunk, so the old >35 min
    # per-dictionary AOT cliff is gone. Runs BEFORE fuzzy2/3/mapped: those
    # have landed driver numbers since r03; this one must land now.
    if budget_ok("many1k", 120.0):
        try:
            rng = np.random.default_rng(7)
            alphabet = "abcdefghijklmnopqrstuvwxyz"
            many = sorted({
                "".join(alphabet[i] for i in rng.integers(0, 26, size=int(m)))
                for m in rng.integers(6, 12, size=1000)
            })
            # Plant ~4k one-substitution typos of the longer patterns so the
            # expand/verify stages do real work (random patterns never occur
            # in the lorem corpus; a 0-match scan would only time the
            # prefilter). len >= 9 keeps sim ~0.87+ above the 0.82 threshold.
            long_pats = [p for p in many if len(p) >= 9]
            buf = bytearray(sub.encode())
            step = max(1, len(buf) // 4000)
            for j in range(4000):
                p = long_pats[j % len(long_pats)]
                w = (" " + p[:2] + ("x" if p[2] != "x" else "y") + p[3:]
                     + " ").encode()
                pos = 100 + j * step
                if pos + len(w) >= len(buf):
                    break
                buf[pos : pos + len(w)] = w
            msub_many = buf.decode()
            meng = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
                .build(many)
            )
            meng.backend = "device"
            meng.search_raw(msub_many, 0.82)  # warm
            meng.search_raw(msub_many, 0.82)  # cap ratchet-down may recompile
            dt = float("inf")
            for _ in range(3):  # best-of-3 against run-to-run variance
                t0 = time.time()
                ms = meng.search_raw(msub_many, 0.82)
                dt = min(dt, time.time() - t0)
            detail["many1k_bps"] = round(len(msub_many) / dt)
            detail["many1k_patterns"] = len(many)
            detail["many1k_matches"] = len(ms)
            detail["many1k_backend"] = meng.last_stats.get("backend")
            _log(f"many1k: {len(msub_many) / dt / 1e6:.0f} MB/s, {len(ms)} matches")
            del meng, ms, buf, msub_many  # release device consts + corpus
        except Exception as e:  # pragma: no cover - bench resilience
            detail["many1k_error"] = repr(e)

    # Mixed-script Unicode corpus (BASELINE config 3): Cyrillic/Greek filler
    # with planted one-substitution typos and ss<->ß mapping needles. Rides
    # the vectorized singleton segmentation path (utils/graphemes) into the
    # mapped DP lane — the first driver-recorded number for the non-ASCII
    # transcode story (reference src/grapheme.rs runs all scripts at native
    # speed).
    if budget_ok("unicode", 75.0):
        try:
            rng = np.random.default_rng(23)
            filler_u = [
                "страница", "пример", "текст", "поиск", "система", "данные",
                "παράδειγμα", "κείμενο", "αναζήτηση", "lorem", "ipsum",
            ]
            # BASELINE config 3: ss <-> ß and ae <-> æ mappings. Patterns
            # stay ASCII (the mapped DP lane's trie model is single-ASCII
            # edges; the mapping HAYSTACK side is the non-ASCII char), the
            # corpus is mixed-script — Cyrillic/Greek filler rides the
            # vectorized singleton segmentation + transcode path.
            parts = []
            size = 0
            while size < (16 << 20):
                w = filler_u[int(rng.integers(len(filler_u)))]
                if rng.integers(211) == 0:
                    w = ["straße", "cæsar", "strase", "caesr"][int(rng.integers(4))]
                parts.append(w)
                size += len(w.encode()) + 1
            ucorpus = " ".join(parts)
            un = len(ucorpus.encode())
            ueng = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
                .mapping("ß", "ss")
                .mapping("æ", "ae")
                .build(["strasse", "caesar"])
            )
            ueng.backend = "device"
            ueng.search_raw(ucorpus, 0.8)  # warm
            ueng.search_raw(ucorpus, 0.8)  # cap ratchet-down may recompile
            t0 = time.time()
            ms = ueng.search_raw(ucorpus, 0.8)
            dt = time.time() - t0
            detail["unicode_bps"] = round(un / dt)
            detail["unicode_bytes"] = un
            detail["unicode_matches"] = len(ms)
            detail["unicode_backend"] = ueng.last_stats.get("backend")
            _log(f"unicode: {un / dt / 1e6:.0f} MB/s, {len(ms)} matches "
                 f"({ueng.last_stats.get('backend')})")
            del ueng, ms, ucorpus, parts
        except Exception as e:  # pragma: no cover - bench resilience
            detail["unicode_error"] = repr(e)

    # Adversarial bounded-frontier corpus (BASELINE config 4): near-duplicate
    # dictionary (shared prefixes, pairwise within 1-2 edits) + densely
    # planted near-miss needles, auto_beam + min_symbol_similarity. Records
    # throughput plus the lane's pressure stats (hits/candidates, oracle
    # rescues when the beam lane serves it) — the worst-case-boundedness
    # evidence (reference src/search.rs:578-589, 1096-1103).
    if budget_ok("adversarial", 75.0):
        try:
            adv_dict = [
                "tincidunt", "tincidumt", "tincidenx", "tincidant",
                "sollicitudin", "sollicitudim", "sollicitudan",
                "vestibulum", "vestibulom", "vestibulam",
            ]
            buf = bytearray(sub[: 12 << 20].encode())
            # ~6k planted near-misses (each fires several near-duplicate
            # patterns): dense frontier pressure without the match list
            # itself becoming the workload.
            step = max(1, len(buf) // 6000)
            vars_a = [b" tincidXnt ", b" solliciXudin ", b" vestibXlum ",
                      b" tincidun ", b" estibulum "]
            for j in range(6000):
                w = vars_a[j % len(vars_a)]
                pos = 50 + j * step
                if pos + len(w) >= len(buf):
                    break
                buf[pos : pos + len(w)] = w[: len(w)]
            acorpus = buf.decode()
            an = len(acorpus.encode())
            aeng = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
                .min_symbol_similarity(0.4)
                .auto_beam(100_000, 64)
                .build(adv_dict)
            )
            aeng.backend = "device"
            aeng.search_raw(acorpus, 0.6)  # warm
            aeng.search_raw(acorpus, 0.6)  # cap ratchet-down may recompile
            t0 = time.time()
            ms = aeng.search_raw(acorpus, 0.6)
            dt = time.time() - t0
            st = dict(aeng.last_stats)
            detail["adversarial_bps"] = round(an / dt)
            detail["adversarial_matches"] = len(ms)
            detail["adversarial_backend"] = st.get("backend")
            for k in ("hits", "candidates", "anchors", "overflow_rescues",
                      "emissions"):
                if k in st:
                    detail[f"adversarial_{k}"] = st[k]
            _log(f"adversarial: {an / dt / 1e6:.0f} MB/s, {len(ms)} matches "
                 f"({st.get('backend')}, rescues={st.get('overflow_rescues', 0)})")
            del aeng, ms, acorpus, buf
        except Exception as e:  # pragma: no cover - bench resilience
            detail["adversarial_error"] = repr(e)

    # DEFAULT (swap-permitting) fuzzy E=2 — the config the swaps(0) entries
    # below deliberately avoid. The Damerau-aware scan prices a swap at one
    # bitap error, so k = 2 instead of 4 and the packed prefilter stays
    # selective on natural text (VERDICT r4 weak item 3: prove the default
    # config scans, or bound it).
    if budget_ok("fuzzy2_default", 90.0):
        try:
            eng = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(2))
                .case_insensitive(True)
                .build(dictionary)
            )
            eng.backend = "device"
            thr = 0.62
            from fuzzy_aho_corasick_tpu.ops.verify_dp import (
                fuzzy_search_dp, typed_spec_of,
            )
            from fuzzy_aho_corasick_tpu.utils.graphemes import HaystackView

            probe_text = sub[: 1 << 20]
            pv = HaystackView(probe_text, True)
            probe = fuzzy_search_dp(
                eng, probe_text, thr, pv, len(pv), typed=typed_spec_of(eng)
            )
            if probe is None:
                detail["fuzzy2_default_bps"] = 0
                detail["fuzzy2_default_note"] = "dp lane declined (unselective)"
            else:
                eng.search_raw(sub, thr)  # warm
                eng.search_raw(sub, thr)  # cap ratchet-down may recompile
                t0 = time.time()
                ms = eng.search_raw(sub, thr)
                dt = time.time() - t0
                detail["fuzzy2_default_bps"] = round(sn / dt)
                detail["fuzzy2_default_matches"] = len(ms)
                detail["fuzzy2_default_backend"] = eng.last_stats.get("backend")
                _log(f"fuzzy2_default: {sn / dt / 1e6:.0f} MB/s, "
                     f"{len(ms)} matches")
                del ms
            del eng, probe, pv
        except Exception as e:  # pragma: no cover - bench resilience
            detail["fuzzy2_default_error"] = repr(e)

    # Parallel streaming replace throughput (reference replace_bench.rs):
    # the FuzzyReplacer form — a pattern-indexed replacement table — which
    # rides the vectorized no-objects emit lane. Streams the full corpus so
    # the producer/search/emit pipeline reaches steady state.
    if budget_ok("replace_stream_parallel", 100.0):
        try:
            import io

            table = ["<x>"] * 16
            src = corpus.encode()
            n_src = len(src)
            # Two full warm passes: the first compiles every superwindow
            # shape the stream produces, the second lands the capacity
            # ratchet-down recompiles — the timed pass then measures steady
            # state.
            for _ in range(2):
                fengine.replace_stream_parallel(
                    io.BytesIO(src), io.BytesIO(), 64, 0.8, table
                )
            best = float("inf")
            for _ in range(3):
                t0 = time.time()
                out = io.BytesIO()
                fengine.replace_stream_parallel(
                    io.BytesIO(src), out, 64, 0.8, table
                )
                best = min(best, time.time() - t0)
            detail["replace_stream_parallel_bps"] = round(n_src / best)
            _log(f"replace_stream_parallel: {n_src / best / 1e6:.0f} MB/s")
            # Stage breakdown into the bench record (VERDICT r4 item 7): one
            # FAC_TIME pass records where the calling thread's time goes —
            # wait (blocked on the search worker: device dispatch + prep),
            # post (SoA ranking/non-overlap), emit (byte assembly + write).
            # Drop the measured passes' ~100 MiB output buffers first: their
            # allocator pressure once inflated the instrumented emit ~20x.
            del out
            import gc as _gc

            _gc.collect()
            try:
                os.environ["FAC_TIME"] = "1"
                fengine.replace_stream_parallel(
                    io.BytesIO(src), io.BytesIO(), 64, 0.8, table
                )
                st = dict(getattr(fengine, "last_stats", {}) or {})
                if st.get("backend") == "replace-stream-parallel":
                    detail["replace_stage_breakdown"] = {
                        k: st[k] for k in ("wait_ms", "post_ms", "emit_ms")
                        if k in st
                    }
                    _log(f"replace stages: {detail['replace_stage_breakdown']}")
            finally:
                os.environ.pop("FAC_TIME", None)
        except Exception as e:  # pragma: no cover - bench resilience
            detail["replace_stream_parallel_error"] = repr(e)

    # swaps(0) keeps the bitap budget k == edits. (Historical note: before
    # the Damerau-aware scan, swap-permitting budgets doubled k — reference
    # prefilter.rs:174-183 — and stopped pruning on random text; the
    # headline fuzzy1 entry above now measures the swap-permitting default
    # via the Damerau recurrence, while these stay swaps(0) for
    # round-over-round comparability.) These configs also exercise the
    # typed-limits DP lane.
    for edits in (2, 3):
        name = f"fuzzy{edits}"
        if not budget_ok(name, 90.0):
            continue
        try:
            eng = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(edits).swaps(0))
                .case_insensitive(True)
                .build(dictionary)
            )
            eng.backend = "device"
            thr = 0.62 if edits == 2 else 0.5
            # Probe the DP lane on a 1 MiB slice first: if the packed scan
            # is unselective at this budget the lane declines and the full
            # run would fall back to the (hours-slow) oracle — skip instead.
            from fuzzy_aho_corasick_tpu.ops.verify_dp import (
                fuzzy_search_dp, typed_spec_of,
            )
            from fuzzy_aho_corasick_tpu.utils.graphemes import HaystackView

            probe_text = sub[: 1 << 20]
            pv = HaystackView(probe_text, True)
            probe = fuzzy_search_dp(
                eng, probe_text, thr, pv, len(pv), typed=typed_spec_of(eng)
            )
            if probe is None:
                detail[f"{name}_bps"] = 0
                detail[f"{name}_note"] = "dp lane declined (unselective)"
                continue
            eng.search_raw(sub, thr)  # warm (grows capacity levels)
            eng.search_raw(sub, thr)  # cap ratchet-down may recompile once
            t0 = time.time()
            ms = eng.search_raw(sub, thr)
            dt = time.time() - t0
            detail[f"{name}_bps"] = round(sn / dt)
            detail[f"{name}_matches"] = len(ms)
            _log(f"{name}: {sn / dt / 1e6:.0f} MB/s, {len(ms)} matches")
            # Stage budget into the record (VERDICT r4 weak 4: where does
            # the E1->E2 drop beyond the 2E+1 band-growth theory go?).
            try:
                os.environ["FAC_TIME"] = "1"
                eng.search_raw(sub, thr)
                st = dict(getattr(eng, "last_stats", {}) or {})
                detail[f"{name}_stages"] = {
                    k: st[k] for k in (
                        "dispatch_ms", "readback_ms", "decode_ms",
                        "hits", "candidates", "emissions", "backend",
                    ) if k in st
                }
                _log(f"{name} stages: {detail[f'{name}_stages']}")
            finally:
                os.environ.pop("FAC_TIME", None)
            del eng, ms, probe, pv  # release device consts
        except Exception as e:  # pragma: no cover - bench resilience
            detail[f"{name}_error"] = repr(e)

    # Mapped-corpus device search (the mapped DP lane, ops/verify_dp
    # MappedSpec): 24 MiB with multi-char mapping needles sprinkled in.
    if budget_ok("mapped", 90.0):
        try:
            import re as _re

            # ASCII OCR-style mapping (rn <-> m): "modem" matches pattern
            # "modern" at similarity 1.0 through the mapped DP lane while
            # the corpus keeps the ASCII fast transcode path. Every ~50th
            # occurrence only — needle density comparable to the headline.
            _ctr = [0]

            def _sparse(mo):
                _ctr[0] += 1
                return "modem" if _ctr[0] % 50 == 0 else mo.group(0)

            msub = _re.sub(r"\bcommodo\b", _sparse, sub)
            sn_m = len(msub.encode())
            meng2 = (
                FuzzyAhoCorasickBuilder.new()
                .fuzzy(FuzzyLimits.new().edits(1))
                .case_insensitive(True)
                .mapping("rn", "m")
                .build(dictionary + ["modern"])
            )
            meng2.backend = "device"
            meng2.search_raw(msub, 0.8)  # warm
            meng2.search_raw(msub, 0.8)  # cap ratchet-down may recompile once
            t0 = time.time()
            ms = meng2.search_raw(msub, 0.8)
            dt = time.time() - t0
            detail["mapped_bps"] = round(sn_m / dt)
            detail["mapped_matches"] = len(ms)
            detail["mapped_backend"] = meng2.last_stats.get("backend")
            _log(f"mapped: {sn_m / dt / 1e6:.0f} MB/s, {len(ms)} matches "
                 f"({meng2.last_stats.get('backend')})")
            del meng2, ms, msub
        except Exception as e:  # pragma: no cover - bench resilience
            detail["mapped_error"] = repr(e)

    # Multi-host streaming replace (BASELINE config 5): the host-sharded
    # find-and-replace driver over 2 logical host shards (single-process
    # form — each shard's owned byte range is searched via the sharded
    # device lane, matches allgather, and owned segments concatenate in
    # host order; byte-identity vs replace_stream is a test,
    # tests/test_multihost.py). The bench records the assembled-bytes rate.
    if budget_ok("replace_multihost", 70.0):
        try:
            from fuzzy_aho_corasick_tpu.parallel.multihost import (
                replace_multihost,
            )

            table = [w.upper() for w in dictionary[:8]]
            sub_mh = corpus[: 24 << 20]
            replace_multihost(fengine, sub_mh.encode(), 0.8, table, 2)  # warm
            best = float("inf")
            for _ in range(2):
                t0 = time.time()
                outb = replace_multihost(fengine, sub_mh.encode(), 0.8, table, 2)
                best = min(best, time.time() - t0)
            detail["replace_multihost_bps"] = round(len(sub_mh) / best)
            detail["replace_multihost_bytes_out"] = len(outb)
            _log(f"replace_multihost: {len(sub_mh) / best / 1e6:.0f} MB/s "
                 f"(2 host shards, single-process)")
        except Exception as e:  # pragma: no cover - bench resilience
            detail["replace_multihost_error"] = repr(e)


def main():
    import jax

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits

    dictionary = [
        "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
        "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
        "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
        "parturient",
    ]

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU (JAX platform {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    # 96 MiB default: large enough that per-dispatch fixed costs stop
    # dominating, small enough that transcode + compile stay short.
    # Override with BENCH_MB.
    corpus_mb = int(os.environ.get("BENCH_MB", "96"))
    corpus = build_corpus(corpus_mb << 20)
    nbytes = len(corpus)

    detail = {
        "corpus_bytes": nbytes,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }

    # --- exact scan -------------------------------------------------------
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).build(dictionary)
    engine.backend = "device"
    t0 = time.time()
    m1 = engine.search_raw(corpus, 0.5)  # includes compile
    engine.search_raw(corpus, 0.5)  # capacity ratchet-down may recompile once
    detail["exact_compile_s"] = round(time.time() - t0, 1)
    # Best-of-3 (the Criterion-style move) against run-to-run variance.
    exact_s = float("inf")
    for _ in range(3):
        t0 = time.time()
        m1 = engine.search_raw(corpus, 0.5)
        exact_s = min(exact_s, time.time() - t0)
    detail["exact_bps"] = round(nbytes / exact_s)
    detail["exact_matches"] = len(m1)
    _log(f"exact: {nbytes / exact_s / 1e6:.0f} MB/s, {len(m1)} matches")

    # --- fuzzy edits=1 scan -----------------------------------------------
    fengine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(dictionary)
    )
    fengine.backend = "device"
    t0 = time.time()
    m2 = fengine.search_raw(corpus, 0.8)
    fengine.search_raw(corpus, 0.8)  # capacity ratchet-down may recompile once
    detail["fuzzy_compile_s"] = round(time.time() - t0, 1)
    fuzzy_s = float("inf")
    for _ in range(3):
        t0 = time.time()
        m2 = fengine.search_raw(corpus, 0.8)
        fuzzy_s = min(fuzzy_s, time.time() - t0)
    detail["fuzzy_bps"] = round(nbytes / fuzzy_s)
    detail["fuzzy_matches"] = len(m2)
    _log(f"fuzzy1: {nbytes / fuzzy_s / 1e6:.0f} MB/s, {len(m2)} matches")

    # Stage budget (VERDICT r2 item 2): one extra FAC_TIME-instrumented
    # search records dispatch (scan+expand+DP on device) / readback / decode
    # into last_stats; stderr-only prints, headline timing unaffected.
    try:
        os.environ["FAC_TIME"] = "1"
        fengine.search_raw(corpus, 0.8)
        st = dict(fengine.last_stats)
        for key in ("dispatch_ms", "readback_ms", "decode_ms", "result_buf_kib"):
            if key in st:
                detail[f"fuzzy_{key}"] = st[key]
        _log(f"fuzzy1 stages: {({k: st.get(k) for k in ('dispatch_ms', 'readback_ms', 'decode_ms')})}")
    finally:
        os.environ.pop("FAC_TIME", None)

    combined = 2 * nbytes / (exact_s + fuzzy_s)
    result = {
        "metric": "scan_bytes_per_s_per_chip_exact_plus_fuzzy1",
        "value": round(combined),
        "unit": "bytes/s",
        "detail": dict(detail),
    }
    # HEADLINE: print + flush NOW, before any secondary bench can stall the
    # process past the driver window (round-2 failure mode).
    print(json.dumps(result), flush=True)

    # --- secondary benches, budgeted, stderr-only -------------------------
    if os.environ.get("BENCH_EXTRAS", "1") != "0":
        try:
            run_extras(detail, corpus, fengine, dictionary)
        except Exception as e:  # pragma: no cover - bench resilience
            detail["extras_error"] = repr(e)

        result["detail"] = detail
        # Final merged line (same headline metric/value, extras in detail):
        # last stdout line if everything finished, else the early headline
        # line is the last one — either way the driver parses a number.
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
