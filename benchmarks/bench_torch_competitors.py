"""Competitor baselines against the port's adaptive stack — the paper's
Table 2/3 story.  The twin of ``benchmarks/bench_competitors.py`` for
``repro_torch``.

Three loaders in one simulated environment (store, routes, virtual clock):
**SD** (``RecordShardLoader``, the MosaicML StreamingDataset model),
**sync** (``SyncWindowLoader``, the tf.data service model) and **ours**
(the adaptive stack built by ``repro_torch.core.build_stack``), on the
local, med and high (150 ms) routes.  The checks are the reference's: ours
beats both baselines on the high route, SD degrades with distance and sync
collapses with it.

Everything runs on the virtual clock in ``repro_torch.core``, the
reference's code, so the gated metrics equal
``benchmarks/baselines/competitors.json`` exactly (``torch_gate``).
Results land in ``results/competitors_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_competitors [--quick]

The simulation runs in the host's numpy and touches no device, so the
bench takes no ``--device`` and needs no card.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import (Cluster, LoaderConfig, VirtualClock, build_stack,
                              tight_loop)
from repro_torch.core.competitors import (RecordShardLoader,
                                          SyncWindowLoader, build_shards)

from . import torch_gate
from .torch_common import make_store

ROUTES = ("local", "med", "high")
BATCH = 256
SHARD_BYTES = 64 * 2 ** 20
PREDOWNLOAD = 8
SEED = 7


def competitor_sizes(quick: bool) -> dict:
    return {"n_samples": 12_000 if quick else 48_000,
            "n_batches": 24 if quick else 96}


def run_sd(store, uuids, route: str, n_batches: int) -> float:
    clock = VirtualClock()
    cluster = Cluster(clock, store, backend="scylla", n_nodes=1,
                      seed=SEED + 5)
    shards = build_shards(store, uuids, shard_bytes=SHARD_BYTES)
    ld = RecordShardLoader(clock, cluster, route, shards, batch_size=BATCH,
                           predownload=PREDOWNLOAD, seed=SEED).start()
    for _ in range(n_batches):
        ld.next_batch(timeout=3000.0)
    return ld.throughput(skip=2)


def run_sync(store, uuids, route: str, n_batches: int) -> float:
    clock = VirtualClock()
    cluster = Cluster(clock, store, backend="scylla", n_nodes=1,
                      seed=SEED + 5)
    avg = int(sum(store.get_data(u).size for u in uuids) / len(uuids))
    ld = SyncWindowLoader(clock, cluster, route, avg_sample_bytes=avg,
                          batch_size=BATCH, seed=SEED).start()
    for _ in range(n_batches):
        ld.next_batch(timeout=3000.0)
    return ld.throughput(skip=2)


def run_ours(store, uuids, route: str, n_batches: int) -> float:
    # The paper configuration (Listing 3 defaults + adaptive flow control),
    # codec-free to match the baselines' wire model.
    cfg = LoaderConfig(batch_size=BATCH, prefetch_buffers=16, io_threads=16,
                       conns_per_thread=2, route=route, backend="scylla",
                       seed=SEED, flow_control="adaptive")
    stack = build_stack(store=store, uuids=uuids, config=cfg)
    res = tight_loop(stack.loader, n_batches, timeout=3000.0)
    return res["throughput_Bps"]


def run_table(quick: bool = False) -> dict:
    sz = competitor_sizes(quick)
    store, uuids = make_store(n_samples=sz["n_samples"], seed=0)
    cells = {}
    for route in ROUTES:
        n = sz["n_batches"]
        cells[route] = {"ours_MBps": run_ours(store, uuids, route, n) / 1e6,
                        "sd_MBps": run_sd(store, uuids, route, n) / 1e6,
                        "sync_MBps": run_sync(store, uuids, route, n) / 1e6}
    hi = cells["high"]
    return {
        "quick": quick, "seed": SEED, "batch_size": BATCH,
        "n_samples": sz["n_samples"], "n_batches": sz["n_batches"],
        "shard_bytes": SHARD_BYTES, "cells": cells,
        "checks": {
            "ours_beats_sd_on_high": hi["ours_MBps"] >= hi["sd_MBps"],
            "ours_beats_sync_on_high": hi["ours_MBps"] >= hi["sync_MBps"],
            "sd_degrades_with_distance":
                cells["high"]["sd_MBps"] < cells["local"]["sd_MBps"],
            "sync_collapses_with_distance":
                cells["high"]["sync_MBps"]
                < 0.1 * cells["local"]["sync_MBps"],
        },
    }


def print_table(r: dict) -> None:
    print(f"  {'route':>6s} {'ours MB/s':>20s} {'SD MB/s':>20s} "
          f"{'sync MB/s':>20s}")
    for route, c in r["cells"].items():
        print(f"  {route:>6s} {c['ours_MBps']!r:>20s} {c['sd_MBps']!r:>20s} "
              f"{c['sync_MBps']!r:>20s}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI size: the baseline's sizing")
    args = ap.parse_args(argv)
    print("# Competitor baselines vs adaptive stack (repro_torch)"
          + (" (quick)" if args.quick else ""))
    results = run_table(quick=args.quick)
    print_table(results)
    return torch_gate.finish("competitors.json", results, quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
