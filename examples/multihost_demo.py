"""Multi-host demo: launch N OS processes under jax.distributed and search
a shared corpus, each process owning one host shard; the in-driver
all-gather hands every process the identical complete match list.

The multi-host analog of the reference's thread-pool scaling example
(reference examples/replace_bench.rs:88-127 measures scaling across thread
counts; here the workers are *processes* coordinated by jax.distributed —
the same launch shape a real multi-host cluster uses, exercised on CPU with
the scan kernels in Pallas interpret mode).

Run:  python examples/multihost_demo.py            # 2 processes
      N_PROCS=4 python examples/multihost_demo.py  # 4 processes
"""

import json
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_WORKER = r"""
import os, sys, json, time
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["FAC_INTERPRET"] = "1"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[4])
import jax

from fuzzy_aho_corasick_tpu import FuzzyAhoCorasickBuilder, FuzzyLimits
from fuzzy_aho_corasick_tpu.parallel import multihost

port, nproc, pid, repo = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
multihost.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
)

engine = (
    FuzzyAhoCorasickBuilder.new()
    .fuzzy(FuzzyLimits.new().edits(1))
    .case_insensitive(True)
    .build(["needle", "pattern"])
)
corpus = (("filler " * 97) + "needle " + ("words " * 83) + "pattren ").encode() * 200
t0 = time.time()
ms = multihost.search_multihost(engine, corpus, 0.8)
dt = time.time() - t0
print(json.dumps({
    "process": pid,
    "hosts": jax.process_count(),
    "local_devices": len(jax.local_devices()),
    "corpus_mb": round(len(corpus) / 1e6, 1),
    "matches": len(ms),
    "first": [ms[0].start, ms[0].end, ms[0].pattern_index],
    "last": [ms[-1].start, ms[-1].end, ms[-1].pattern_index],
    "seconds": round(dt, 2),
}))
"""


def main():
    n = int(os.environ.get("N_PROCS", "2"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    worker = os.path.join("/tmp", f"fac_multihost_worker_{os.getpid()}.py")
    with open(worker, "w") as f:
        f.write(_WORKER)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(n), str(pid), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
        )
        for pid in range(n)
    ]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"worker rc={p.returncode}"
        results.append(json.loads(out.splitlines()[-1]))
    os.unlink(worker)

    for r in results:
        print(f"process {r['process']}: {r['matches']} matches "
              f"({r['hosts']} hosts x {r['local_devices']} devices, "
              f"{r['corpus_mb']} MB in {r['seconds']}s)")
    assert len({json.dumps(r["first"]) for r in results}) == 1
    assert len({r["matches"] for r in results}) == 1
    print(f"all {n} processes agree on the full gathered match list "
          f"({results[0]['matches']} matches) in {time.time() - t0:.1f}s total")


if __name__ == "__main__":
    main()
