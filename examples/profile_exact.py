"""End-to-end stage timing of the warm exact device search (FAC_TIME=1)."""

import os
import sys
import time

os.environ["FAC_TIME"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench import build_corpus  # noqa: E402

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder  # noqa: E402


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
    engine = FuzzyAhoCorasickBuilder.new().case_insensitive(True).build(dictionary)
    engine.backend = "device"
    print("--- warm ---")
    t0 = time.perf_counter()
    engine.search_raw(corpus, 0.5)
    engine.search_raw(corpus, 0.5)
    print(f"warm total {(time.perf_counter() - t0):.1f}s")
    for rep in range(3):
        t0 = time.perf_counter()
        m = engine.search_raw(corpus, 0.5)
        dt = time.perf_counter() - t0
        print(f"total {dt * 1e3:.1f}ms  {n / dt / 1e6:.0f} MB/s  matches={len(m)}")
    print(engine.last_stats)


if __name__ == "__main__":
    main()
