"""Stage timing of the 1k-pattern chunked lane (many1k bench config)."""
import os, sys, time
os.environ["FAC_TIME"] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
from bench import build_corpus
from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits

corpus = build_corpus(24 << 20)
sub = corpus[: 24 << 20]
rng = np.random.default_rng(7)
alphabet = "abcdefghijklmnopqrstuvwxyz"
many = sorted({
    "".join(alphabet[i] for i in rng.integers(0, 26, size=int(m)))
    for m in rng.integers(6, 12, size=1000)
})
long_pats = [p for p in many if len(p) >= 9]
buf = bytearray(sub.encode())
step = max(1, len(buf) // 4000)
for j in range(4000):
    p = long_pats[j % len(long_pats)]
    w = (" " + p[:2] + ("x" if p[2] != "x" else "y") + p[3:] + " ").encode()
    pos = 100 + j * step
    if pos + len(w) >= len(buf):
        break
    buf[pos : pos + len(w)] = w
msub = buf.decode()
eng = (FuzzyAhoCorasickBuilder.new().fuzzy(FuzzyLimits.new().edits(1))
       .case_insensitive(True).build(many))
eng.backend = "device"
t0 = time.time(); ms = eng.search_raw(msub, 0.82); print("warm1", time.time()-t0, len(ms), eng.last_stats)
t0 = time.time(); ms = eng.search_raw(msub, 0.82); print("warm2", time.time()-t0, len(ms))
t0 = time.time(); ms = eng.search_raw(msub, 0.82); dt = time.time()-t0
print("timed", dt, "->", len(msub)/dt/1e6, "MB/s")
print("stats", eng.last_stats)
