"""Time-varying routes x flow-control modes, plus a federated tracking run,
on the port's loader.  The twin of ``benchmarks/bench_scenarios.py`` for
``repro_torch``.

* **Matrix**: every declarative scenario of ``core/scenarios.py`` (step /
  ramp / sinusoid / outage / random-walk schedules over one route) under
  every mode — the static depth sweep, the adaptive controller and the
  schedule-aware oracle.  Checks: adaptive >= oracle / 1.5 on every cell,
  and every static depth falls below that bound on some dynamic cell.
* **Tracking**: a 2-cluster federation whose WAN member's latency ramps x6
  while a Zipf hotset rotates.  Checks: the rotated-away replicas are
  demoted, rebalancing fires on its cadence, the replica cache serves hits.

Everything runs on the virtual clock in ``repro_torch.core``, the
reference's code, so the gated metrics equal
``benchmarks/baselines/scenarios.json`` exactly (``torch_gate``).  Results
land in ``results/scenarios_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_scenarios \\
        [--quick] [--matrix | --tracking]

The simulation runs in the host's numpy and touches no device, so the
bench takes no ``--device`` and needs no card.  Only a whole ``--quick``
run is held to the baseline.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import (ClusterSpec, MultiHostConfig, MultiHostRun,
                              ReplicationConfig, run_cell)
from repro_torch.core.netsim import RouteProfile, RouteSchedule
from repro_torch.core.scenarios import MODES, STATIC_SWEEP, matrix

from . import torch_gate
from .torch_common import make_store

# The oracle-relative throughput bound both headline checks pivot on.
ORACLE_SLACK = 1.5

N_SAMPLES_QUICK = 30_000
N_SAMPLES_FULL = 60_000


def n_samples(quick: bool) -> int:
    return N_SAMPLES_QUICK if quick else N_SAMPLES_FULL


def matrix_cell(store, uuids, sc, seed: int = 2) -> dict:
    """One scenario under every mode: its oracle MB/s and each other
    mode's ratio to it."""
    res = {m: run_cell(store, uuids, sc, m, seed=seed) for m in MODES}
    oracle = res["oracle"]["MBps"]
    ratios = {m: res[m]["MBps"] / max(oracle, 1e-9) for m in MODES[:-1]}
    return {"scenario": sc.to_dict(), "modes": res, "oracle_MBps": oracle,
            "ratios": ratios, "dynamic": sc.dynamic}


def run_matrix(quick: bool = False, seed: int = 2) -> dict:
    store, uuids = make_store(n_samples=n_samples(quick))
    cells = {sc.name: matrix_cell(store, uuids, sc, seed)
             for sc in matrix(quick=quick)}
    bound = 1.0 / ORACLE_SLACK
    adaptive_floor = min(c["ratios"]["adaptive"] for c in cells.values())
    # for each static depth: its best ratio over the *dynamic* cells must
    # still dip under the bound somewhere — one cell it cannot buffer for
    static_worst = {
        k: min(c["ratios"][f"static-{k}"] for c in cells.values()
               if c["dynamic"])
        for k in STATIC_SWEEP
    }
    return {
        "cells": cells,
        "adaptive_floor_ratio": adaptive_floor,
        "static_worst_dynamic_ratio": {str(k): v
                                       for k, v in static_worst.items()},
        "checks": {
            "adaptive_ge_oracle_over_1p5_on_every_cell":
                adaptive_floor >= bound,
            "every_static_depth_fails_on_some_dynamic_cell":
                all(v < bound for v in static_worst.values()),
        },
    }


def _tracking_cfg(seed: int) -> MultiHostConfig:
    # The WAN member's latency creeps x6 over [1s, 5s] and holds.
    far_route = RouteProfile(
        "wan/creep", rtt=0.08, conn_capacity=0.5e9, loss_per_byte=1e-11,
        schedules=(RouteSchedule("latency", "ramp", factor=6.0,
                                 at=1.0, until=5.0),))
    specs = (ClusterSpec("near", route="low", n_nodes=4,
                         replication_factor=2, weight=1),
             ClusterSpec("far", route=far_route, n_nodes=4,
                         replication_factor=2, weight=2))
    return MultiHostConfig(
        n_hosts=2, batch_size=128, prefetch_buffers=8, io_threads=4,
        ramp_every=1, hedge_after="auto", seed=seed,
        placement="replication_aware", clusters=specs,
        flow_control="adaptive", route_admission=True,
        sampling="zipf", zipf_s=1.3, zipf_shift_every=2,
        rebalance_every=5,
        replication=ReplicationConfig(window=1.0, demote_after=0.5,
                                      min_count=6))


def run_tracking(quick: bool = False, seed: int = 23) -> dict:
    rounds = 30 if quick else 60
    store, uuids = make_store(n_samples=n_samples(quick))
    # a small key universe cycles Zipf epochs (and hotset rotations) fast
    cfg = _tracking_cfg(seed)
    run = MultiHostRun(store, uuids[:2400], cfg).start()
    rep = run.run(rounds, step_time=0.05)
    replication = rep["replication"]
    return {
        "rounds": rounds,
        "aggregate_MBps": rep["aggregate_Bps"] / 1e6,
        "replica_hit_frac": rep["replica_hit_frac"],
        "promotions": replication["promotions"],
        "demotions": replication["demotions"],
        "rebalances": rep["rebalances"],
        "ownership_weights": rep["ownership_weights"],
        "replica_hedges": sum(ld.pool.replica_hedges for ld in run.loaders),
        "admission_deferrals": sum(ld.prefetcher.deferrals
                                   for ld in run.loaders),
        "wan_bytes_share": rep["wan_bytes_share"],
        "checks": {
            "hotset_shift_demotes_replicas": replication["demotions"] >= 1,
            "rebalance_fires_on_cadence":
                rep["rebalances"] == rounds // cfg.rebalance_every,
            "replica_cache_serves_hits": rep["replica_hit_frac"] > 0.0,
        },
    }


def run_all(quick: bool = False, matrix_only: bool = False,
            tracking_only: bool = False) -> dict:
    results = {"quick": quick, "n_samples": n_samples(quick),
               "static_sweep": list(STATIC_SWEEP),
               "oracle_slack": ORACLE_SLACK,
               "checks": {}}
    if not tracking_only:
        results["matrix"] = run_matrix(quick=quick)
        results["checks"].update(results["matrix"]["checks"])
    if not matrix_only:
        results["tracking"] = run_tracking(quick=quick)
        results["checks"].update(results["tracking"]["checks"])
    return results


def print_all(results: dict) -> None:
    if "matrix" in results:
        print(f"{'scenario':14s} {'oracle MB/s':>20s} "
              + "".join(f"{m:>11s}" for m in MODES[:-1]))
        for name, c in results["matrix"]["cells"].items():
            print(f"{name:14s} {c['oracle_MBps']!r:>20s} "
                  + "".join(f"{c['ratios'][m]:11.4f}" for m in MODES[:-1]))
        print(f"adaptive floor over all cells: "
              f"{results['matrix']['adaptive_floor_ratio']!r}")
    if "tracking" in results:
        t = results["tracking"]
        print(f"federated tracking ({t['rounds']} rounds): "
              f"{t['aggregate_MBps']!r} MB/s aggregate, replica hits "
              f"{t['replica_hit_frac']!r}, promotions {t['promotions']}, "
              f"demotions {t['demotions']}, rebalances {t['rebalances']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI size: the baseline's sizing")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--matrix", action="store_true",
                      help="the scenario matrix alone")
    only.add_argument("--tracking", action="store_true",
                      help="the federated tracking run alone")
    args = ap.parse_args(argv)
    print("# Scenario matrix — schedules x flow-control modes (repro_torch)"
          + (" (quick)" if args.quick else ""))
    results = run_all(quick=args.quick, matrix_only=args.matrix,
                      tracking_only=args.tracking)
    print_all(results)
    whole = not (args.matrix or args.tracking)
    return torch_gate.finish("scenarios.json", results,
                             quick=args.quick and whole)


if __name__ == "__main__":
    sys.exit(main())
