# The twin of benchmarks/bench_tightloop.py for repro_torch: the reference
# file with its imports rewritten and its CSV named
# results/table3_tightloop_torch.csv.  tests/test_torch_isolation.py holds it
# equal to the original, tests/test_torch_bench_figures.py its rows.
"""Paper Table 3: tight-loop reading throughput at varying latencies.

Compares Cassandra-DALI (ours, OOO prefetching, ScyllaDB backend) against the
MosaicML-SD and tf.data-service loader models, all over the same simulated
network.  Paper targets (MB/s): ours 6066/5957/4081, SD 326/308/203,
tf.data 437/57/12 for low/med/high.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import Cluster, KVStore, VirtualClock, tight_loop
from repro_torch.core.competitors import (RecordShardLoader,
                                          SyncWindowLoader, build_shards)

from .torch_common import (BATCH_SIZE, make_loader, make_store, mean_std,
                           write_csv)

PAPER = {
    "cassandra-dali": {"low": 6066, "med": 5957, "high": 4081},
    "mosaicml-sd": {"low": 326, "med": 308, "high": 203},
    "tfdata-service": {"low": 437, "med": 57, "high": 12},
}


def run_ours(route: str, seeds=(1, 2, 3), n_batches=200) -> list:
    store, uuids = make_store()
    out = []
    for seed in seeds:
        ld = make_loader(store, uuids, route, seed=seed)
        res = tight_loop(ld, n_batches=n_batches)
        out.append(res["throughput_Bps"] / 1e6)
    return out


def run_sd(route: str, seeds=(1, 2), n_batches=150) -> list:
    store, uuids = make_store()
    shards = build_shards(store, uuids)
    out = []
    for seed in seeds:
        clock = VirtualClock()
        cluster = Cluster(clock, store, backend="scylla", seed=seed)
        ld = RecordShardLoader(clock, cluster, route, shards,
                               batch_size=BATCH_SIZE, seed=seed).start()
        for _ in range(n_batches):
            ld.next_batch()
        out.append(ld.throughput() / 1e6)
    return out


def run_tfdata(route: str, seeds=(1, 2), n_batches=60) -> list:
    store, uuids = make_store()
    avg = store.total_bytes() // len(store)
    out = []
    for seed in seeds:
        clock = VirtualClock()
        cluster = Cluster(clock, store, backend="scylla", seed=seed)
        ld = SyncWindowLoader(clock, cluster, route, avg,
                              batch_size=BATCH_SIZE, seed=seed).start()
        for _ in range(n_batches):
            ld.next_batch(timeout=20000.0)
        out.append(ld.throughput() / 1e6)
    return out


def run() -> str:
    rows, lines = [], []
    lines.append(f"{'loader':16s} {'tier':5s} {'ours (MB/s)':>14s} "
                 f"{'paper (MB/s)':>13s}")
    for name, fn in [("cassandra-dali", run_ours), ("mosaicml-sd", run_sd),
                     ("tfdata-service", run_tfdata)]:
        for route in ("low", "med", "high"):
            vals = fn(route)
            lines.append(f"{name:16s} {route:5s} {mean_std(vals):>14s} "
                         f"{PAPER[name][route]:>13d}")
            rows.append(f"{name},{route},{np.mean(vals):.1f},"
                        f"{np.std(vals):.1f},{PAPER[name][route]}")
    write_csv("table3_tightloop_torch.csv",
              "loader,tier,throughput_MBps,std,paper_MBps", rows)
    return "\n".join(lines)


def main() -> None:
    print("# Table 3 — tight-loop reading throughput")
    print(run())


if __name__ == "__main__":
    main()
