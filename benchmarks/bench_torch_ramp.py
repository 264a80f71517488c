"""Adaptive flow control against a static depth sweep, on the port's
loader.  The twin of ``benchmarks/bench_ramp.py --flowctl`` for
``repro_torch``.

Static prefetch depths are swept against the BDP-tracking controller
(``core/flowctl.py``) on the local / medium / intercontinental routes, plus
one federated mixed-route run (``MultiHostRun`` over a local and a 150 ms
member).  Everything runs on the virtual clock in ``repro_torch.core``,
the reference's code, so the numbers equal the committed baseline
``benchmarks/baselines/flowctl_ramp.json`` exactly; ``torch_gate`` holds
them to it.  The checks are the reference's: adaptive >= 90% of the best
static depth on the 150 ms route, steady-state depth <= 2x the true route
BDP on the local route, and the WAN member ramps deeper than the local
one.  Results land in ``results/flowctl_ramp_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_ramp --flowctl \\
        [--quick]

The sweep runs in the host's numpy and touches no device, so the bench
takes no ``--device`` and needs no card.  The reference's eager vs
incremental ramp table (``bench_ramp.run``) has no baseline and no twin.
"""

from __future__ import annotations

import argparse
import math
import sys

from repro_torch.core import (CassandraLoader, ClusterSpec, LoaderConfig,
                              MultiHostConfig, MultiHostRun)
from repro_torch.core.netsim import route_bdp_samples

from . import torch_gate
from .torch_common import make_store

BATCH = 512
FLOW_ROUTES = ("local", "med", "high")
STATIC_SWEEP = (2, 4, 8, 16, 32)


def flowctl_sizes(quick: bool) -> dict:
    if quick:
        return dict(batch=256, io_threads=8, n_batches=70, n_samples=30_000,
                    rounds=30, sweep=(2, 8, 16, 32))
    return dict(batch=BATCH, io_threads=16, n_batches=120,
                n_samples=120_000, rounds=60, sweep=STATIC_SWEEP)


def _route_bdp_batches(route: str, batch: int, io_threads: int,
                       sample_bytes: float) -> int:
    """True route BDP in batches (``netsim.route_bdp_samples``, the
    analytic yardstick — not the controller's own estimate)."""
    return max(1, math.ceil(route_bdp_samples(route, io_threads * 2,
                                              sample_bytes) / batch))


def flow_run(store, uuids, route: str, mode: str, k: int, *, batch: int,
             io_threads: int, n_batches: int, seed: int = 2) -> dict:
    cfg = LoaderConfig(batch_size=batch, prefetch_buffers=k,
                       io_threads=io_threads, route=route, backend="scylla",
                       seed=seed, flow_control=mode)
    ld = CassandraLoader(store, uuids, cfg)
    ld.start()
    for _ in range(n_batches):
        ld.next_batch(timeout=3000.0)
    out = {"MBps": ld.stats.throughput(skip=max(2, n_batches // 5)) / 1e6}
    if ld.flow_controller is not None:
        rep = ld.flow_controller.report()
        out.update(steady_depth=rep["depth_batches"],
                   budget_samples=rep["budget_samples"],
                   bdp_est_samples=rep["bdp_samples"],
                   min_rtt_s=rep["min_rtt_s"],
                   backoffs=rep["backoffs"],
                   loss_signals=rep["loss_signals"])
    return out


def flow_federated(store, uuids, *, batch: int, io_threads: int,
                   rounds: int, seed: int = 9) -> dict:
    """One run mixing a local member with a 150 ms member: each member's
    controller ramps to its own route's BDP."""
    cfg = MultiHostConfig(
        n_hosts=2, batch_size=batch, io_threads=io_threads,
        hedge_after=None, seed=seed, flow_control="adaptive",
        placement="cluster_aware",
        clusters=(ClusterSpec("near", route="local", n_nodes=2),
                  ClusterSpec("far", route="high", n_nodes=2)))
    run = MultiHostRun(store, uuids, cfg).start()
    rep = run.run(rounds)
    members = {}
    for name in ("near", "far"):
        per_host = [f["members"][name] for f in rep["flow"]]
        members[name] = {
            "depth_batches": [m["depth_batches"] for m in per_host],
            "budget_samples": [m["budget_samples"] for m in per_host],
            "min_rtt_s": [m["min_rtt_s"] for m in per_host],
        }
    return {"aggregate_MBps": rep["aggregate_Bps"] / 1e6,
            "wan_bytes_share": rep["wan_bytes_share"],
            "members": members}


def run_flowctl(quick: bool = False) -> dict:
    sz = flowctl_sizes(quick)
    batch, io_threads, n_batches = sz["batch"], sz["io_threads"], \
        sz["n_batches"]
    store, uuids = make_store(n_samples=sz["n_samples"])
    sample_bytes = store.total_bytes() / len(uuids)
    results = {"batch_size": batch, "io_threads": io_threads,
               "n_batches": n_batches, "static_sweep": list(sz["sweep"]),
               "routes": {}}
    for route in FLOW_ROUTES:
        static = {k: flow_run(store, uuids, route, "static", k, batch=batch,
                              io_threads=io_threads,
                              n_batches=n_batches)["MBps"]
                  for k in sz["sweep"]}
        ad = flow_run(store, uuids, route, "adaptive", 8, batch=batch,
                      io_threads=io_threads, n_batches=n_batches)
        best_k = max(static, key=static.get)
        bdp_true = _route_bdp_batches(route, batch, io_threads, sample_bytes)
        results["routes"][route] = {
            "static_MBps": {str(k): v for k, v in static.items()},
            "best_static": {"num_buffers": best_k, "MBps": static[best_k]},
            "adaptive": ad,
            "adaptive_over_best_static": ad["MBps"] / max(static[best_k],
                                                          1e-9),
            "bdp_batches_true": bdp_true,
            "depth_over_true_bdp": ad["steady_depth"] / bdp_true,
        }
    results["federated"] = flow_federated(
        store, uuids, batch=max(batch // 2, 64), io_threads=io_threads // 2,
        rounds=sz["rounds"])
    far = results["federated"]["members"]["far"]["budget_samples"]
    near = results["federated"]["members"]["near"]["budget_samples"]
    results["checks"] = {
        "adaptive_ge_90pct_best_static_on_150ms_route":
            results["routes"]["high"]["adaptive_over_best_static"] >= 0.9,
        "local_steady_depth_le_2x_true_bdp":
            results["routes"]["local"]["depth_over_true_bdp"] <= 2.0,
        "wan_member_ramps_deeper_than_local":
            min(far) > max(near),
    }
    return results


def print_flowctl(results: dict) -> None:
    print(f"{'route':8s} {'adaptive MB/s':>22s} {'best static MB/s':>22s} "
          f"{'k':>3s} {'depth':>6s} {'true BDP':>8s}")
    for route, r in results["routes"].items():
        print(f"{route:8s} {r['adaptive']['MBps']!r:>22s} "
              f"{r['best_static']['MBps']!r:>22s} "
              f"{r['best_static']['num_buffers']:3d} "
              f"{r['adaptive']['steady_depth']:6d} "
              f"{r['bdp_batches_true']:8d}")
    fed = results["federated"]
    print(f"federated adaptive {fed['aggregate_MBps']!r} MB/s; budgets "
          f"far(150ms)={fed['members']['far']['budget_samples']} "
          f"near(local)={fed['members']['near']['budget_samples']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--flowctl", action="store_true",
                    help="the flow-control section (the only section)")
    ap.add_argument("--quick", action="store_true",
                    help="CI size: the baseline's sizing")
    args = ap.parse_args(argv)
    print("# Flow control — static depth sweep vs BDP-tracking controller "
          "(repro_torch)" + (" (quick)" if args.quick else ""))
    results = run_flowctl(quick=args.quick)
    print_flowctl(results)
    return torch_gate.finish("flowctl_ramp.json", results, quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
