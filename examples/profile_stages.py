"""End-to-end stage timing of the warm fuzzy DP search (FAC_TIME=1)."""

import os
import sys
import time

os.environ["FAC_TIME"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import build_corpus  # noqa: E402

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits  # noqa: E402


def main():
    mb = int(sys.argv[1]) if len(sys.argv) > 1 else 96
    corpus = build_corpus(mb << 20)
    n = len(corpus)
    dictionary = [
        "tincidunt", "phaetra", "sollicitudin", "venenatis", "fringilla",
        "ullamcorper", "pellentesque", "sagittis", "condimentum", "habitasse",
        "malesuada", "scelerisque", "imperdiet", "vulputate", "ridiculus",
        "parturient",
    ]
    engine = (
        FuzzyAhoCorasickBuilder.new()
        .fuzzy(FuzzyLimits.new().edits(1))
        .case_insensitive(True)
        .build(dictionary)
    )
    engine.backend = "device"
    print("--- warm (compile + caps discovery) ---")
    t0 = time.perf_counter()
    engine.search_raw(corpus, 0.8)
    engine.search_raw(corpus, 0.8)  # cap ratchet-down recompile
    print(f"warm total {(time.perf_counter() - t0):.1f}s")
    for stage in ("0", "1", "2", "3"):
        os.environ["FAC_DP_STAGE"] = stage
        engine.search_raw(corpus, 0.8)  # compile this stage variant
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            m = engine.search_raw(corpus, 0.8)
            best = min(best, time.perf_counter() - t0)
        print(
            f"STAGE={stage}: total {best * 1e3:.1f}ms  "
            f"{n / best / 1e6:.0f} MB/s  matches={len(m)}"
        )
    print(engine.last_stats)


if __name__ == "__main__":
    main()
