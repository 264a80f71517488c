# The twin of benchmarks/bench_backends.py for repro_torch: the reference
# file with its imports rewritten and its CSV named
# results/fig7_backends_torch.csv.  tests/test_torch_isolation.py holds it
# equal to the original, tests/test_torch_bench_figures.py its rows.
"""Paper Fig. 7: Cassandra vs ScyllaDB backends (tight-loop, high latency).

Paper: ScyllaDB ~4.0 GB/s net; Cassandra ~1.6 GB/s net with ~3.6 GB/s disk
reads (block-read amplification ~2.25x).
"""

from __future__ import annotations

from repro_torch.core import tight_loop
from .torch_common import make_loader, make_store, write_csv

PAPER = {"scylla": (4081, 1.0), "cassandra": (1600, 2.25)}


def run(n_batches: int = 250, seed: int = 1) -> str:
    store, uuids = make_store()
    lines = [f"{'backend':10s} {'net MB/s':>9s} {'disk MB/s':>10s} "
             f"{'disk/net':>9s} {'paper net':>10s} {'paper amp':>10s}"]
    rows = []
    for backend in ("scylla", "cassandra"):
        ld = make_loader(store, uuids, "high", backend=backend, seed=seed)
        res = tight_loop(ld, n_batches=n_batches)
        net = res["throughput_Bps"] / 1e6
        # measure disk/net over the same consumed bytes window
        amp = res["disk_bytes"] / max(res["net_bytes"], 1)
        disk = net * amp
        lines.append(f"{backend:10s} {net:9.0f} {disk:10.0f} {amp:9.2f} "
                     f"{PAPER[backend][0]:>10d} {PAPER[backend][1]:>10.2f}")
        rows.append(f"{backend},{net:.0f},{disk:.0f},{amp:.2f}")
    write_csv("fig7_backends_torch.csv",
              "backend,net_MBps,disk_MBps,amplification", rows)
    return "\n".join(lines)


def main() -> None:
    print("# Fig. 7 — Cassandra vs ScyllaDB (tight-loop, high latency)")
    print(run())


if __name__ == "__main__":
    main()
