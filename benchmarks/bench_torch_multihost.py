"""Multi-host loading on the port: the 1000-host scale-out and hot-key
replication.  The twin of ``benchmarks/bench_multihost.py --scale`` and
``--replication`` for ``repro_torch``.

* ``--scale``: 1000 training hosts over a 3-cluster local/med/high
  federation in one virtual run (``MultiHostRun``, cluster-aware
  placement) — the cell the calendar-queue event core exists for.  Its
  virtual-clock metrics, ``events_total`` included, equal
  ``benchmarks/baselines/multihost_scale.json``.  Its two wall-clock checks
  (the CI budget and the events/sec floor) time the host.
* ``--replication``: a Zipf sampler over an asymmetric local +
  intercontinental federation opens a throughput gap against uniform
  sampling, ``replication_aware`` placement must close >= 1.5x of it, and
  a bandwidth-aware ownership rebalance shifts weight toward the member
  with spare BDP.  Its metrics equal
  ``benchmarks/baselines/multihost_replication.json``.

Everything runs on the virtual clock in ``repro_torch.core``, the
reference's code, so ``torch_gate`` holds the numbers to the baselines for
equality; the checks are the reference's.  Results land in
``results/multihost_{scale,replication}_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_multihost \\
        (--scale | --replication) [--quick]

The simulation runs in the host's numpy and touches no device, so the
bench takes no ``--device`` and needs no card.  The reference's scaling,
placement, elastic and federation tables (``bench_multihost.run``) have no
baseline and no twin.
"""

from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core import ClusterSpec, MultiHostConfig, MultiHostRun

from . import torch_gate
from .torch_common import make_store

NODE_EGRESS = 1.25e9        # 10 GbE per storage node

# ---------------------------------------------------------------------------
# 1000-host scale-out: the calendar-queue event core at full width
# ---------------------------------------------------------------------------

SCALE_HOSTS = 1000
SCALE_CLUSTERS = (("us", "local"), ("eu", "med"), ("ap", "high"))
# The reference's wall-clock budget for the quick CI cell and floor on the
# event core's throughput (~5-10x headroom on a dev box).
SCALE_WALL_BUDGET_S = 120.0
SCALE_EVENTS_PER_SEC_FLOOR = 8_000.0
# The scale cell's checks that time the host, not the simulation.
SCALE_WALL_CLOCK_CHECKS = ("wall_within_ci_budget", "events_per_sec_floor")


def scale_sizes(quick: bool) -> dict:
    n_samples, rounds, batch = (48_000, 2, 16) if quick else (224_000, 6, 32)
    return {"n_samples": n_samples, "rounds": rounds, "batch": batch}


def _scale_cfg(batch_size: int, seed: int) -> MultiHostConfig:
    specs = tuple(ClusterSpec(name, route=route, n_nodes=8,
                              replication_factor=2,
                              node_egress_bandwidth=NODE_EGRESS)
                  for name, route in SCALE_CLUSTERS)
    # 2 io_threads x 1 conn keeps the sim at 6k connections total — wide,
    # not deep: the point is 1000 concurrent hosts, not per-host depth.
    return MultiHostConfig(n_hosts=SCALE_HOSTS, batch_size=batch_size,
                           prefetch_buffers=4, io_threads=2,
                           conns_per_thread=1, seed=seed,
                           placement="cluster_aware", clusters=specs)


def run_scale(seed: int = 23, quick: bool = False) -> dict:
    """1000 hosts x 3 clusters (local/med/high routes) in one virtual run:
    the virtual-clock metrics (aggregate MB/s, fairness, WAN share,
    replica-local share, total event count) and the wall-clock ones
    (setup, run, events/sec), with the reference's checks."""
    sz = scale_sizes(quick)
    store, uuids = make_store(n_samples=sz["n_samples"])
    t0 = time.perf_counter()
    mh = MultiHostRun(store, uuids, _scale_cfg(sz["batch"], seed)).start()
    setup_s = time.perf_counter() - t0
    delivered = [0]

    def _count(host_id, batch_obj):
        delivered[0] += 1

    ev0 = mh.clock.events_processed
    t0 = time.perf_counter()
    rep = mh.run(sz["rounds"], on_batch=_count)
    wall_s = time.perf_counter() - t0
    events = mh.clock.events_processed - ev0
    eps = events / max(wall_s, 1e-9)
    expect = SCALE_HOSTS * sz["rounds"]
    return {
        "quick": quick, "seed": seed,
        "n_hosts": SCALE_HOSTS, "n_clusters": len(SCALE_CLUSTERS),
        "rounds": sz["rounds"], "batch_size": sz["batch"],
        "n_samples": sz["n_samples"],
        # virtual-clock metrics: deterministic, equal to the baseline
        "aggregate_MBps": rep["aggregate_Bps"] / 1e6,
        "fairness": rep["fairness"],
        "wan_bytes_share": rep["wan_bytes_share"],
        "replica_local_hit_frac": rep["replica_local_hit_frac"],
        "virtual_elapsed_s": rep["elapsed_s"],
        "events_total": events,
        "delivered": delivered[0],
        # wall-clock numbers: machine-dependent, judged by checks only
        "setup_s": setup_s, "wall_s": wall_s, "events_per_sec": eps,
        "checks": {
            "all_batches_delivered": delivered[0] == expect,
            "every_host_made_progress": min(rep["per_client_Bps"]) > 0.0,
            "wall_within_ci_budget": wall_s <= SCALE_WALL_BUDGET_S,
            "events_per_sec_floor": eps >= SCALE_EVENTS_PER_SEC_FLOOR,
        },
    }


def print_scale(r: dict) -> None:
    print(f"scale-out ({r['n_hosts']} hosts, {r['n_clusters']} clusters "
          f"{'/'.join(route for _, route in SCALE_CLUSTERS)}, "
          f"{r['rounds']} rounds x batch {r['batch_size']}):")
    print(f"  setup {r['setup_s']:.1f}s, run {r['wall_s']:.1f}s wall "
          f"({r['virtual_elapsed_s']:.1f}s virtual) — {r['events_total']} "
          f"events, {r['events_per_sec']/1e3:.0f}k events/s (floor "
          f"{SCALE_EVENTS_PER_SEC_FLOOR/1e3:.0f}k, budget "
          f"{SCALE_WALL_BUDGET_S:.0f}s)")
    print(f"  aggregate {r['aggregate_MBps']!r} MB/s, fairness "
          f"{r['fairness']!r}, WAN share {r['wan_bytes_share']!r}, "
          f"replica-local {r['replica_local_hit_frac']!r}, "
          f"{r['delivered']}/{r['n_hosts'] * r['rounds']} batches delivered")


# ---------------------------------------------------------------------------
# Hot-key replication: skewed (Zipf) access over the WAN federation
# ---------------------------------------------------------------------------

ZIPF_S = 1.3


def replication_sizes(quick: bool) -> dict:
    n_samples, rounds = (30_000, 16) if quick else (120_000, 40)
    return {"n_samples": n_samples, "rounds": rounds}


def rep_cfg(seed: int, **kw) -> MultiHostConfig:
    """8 hosts over an asymmetric federation: a 6-node cluster next to the
    hosts and a 4-node one, owning 3/4 of the keyspace, an ocean away."""
    specs = (ClusterSpec("onprem", route="local", n_nodes=6,
                         replication_factor=2, weight=1,
                         node_egress_bandwidth=NODE_EGRESS),
             ClusterSpec("overseas", route="high", n_nodes=4,
                         replication_factor=2, weight=3,
                         node_egress_bandwidth=NODE_EGRESS))
    cfg = dict(n_hosts=8, batch_size=256, prefetch_buffers=24, io_threads=8,
               ramp_every=1, hedge_after=1.0, seed=seed,
               placement="cluster_aware", clusters=specs)
    cfg.update(kw)
    return MultiHostConfig(**cfg)


# The three sampling cells: (name, rep_cfg keywords).
REPLICATION_CELLS = (
    ("uniform", {}),
    ("zipf", {"sampling": "zipf", "zipf_s": ZIPF_S}),
    ("zipf+replication", {"sampling": "zipf", "zipf_s": ZIPF_S,
                          "placement": "replication_aware"}),
)


def run_replication_cell(store, uuids, name: str, rounds: int,
                         seed: int = 19) -> dict:
    """One of ``REPLICATION_CELLS``: its ``MultiHostRun`` report."""
    kw = dict(REPLICATION_CELLS)[name]
    return MultiHostRun(store, uuids, rep_cfg(seed, **kw)).run(rounds)


def run_replication(seed: int = 19, quick: bool = False) -> dict:
    sz = replication_sizes(quick)
    rounds = sz["rounds"]
    store, uuids = make_store(n_samples=sz["n_samples"])
    scenarios = {name: run_replication_cell(store, uuids, name, rounds, seed)
                 for name, _ in REPLICATION_CELLS}
    uni, zipf, rep = (scenarios["uniform"], scenarios["zipf"],
                      scenarios["zipf+replication"])
    gap = uni["aggregate_Bps"] - zipf["aggregate_Bps"]
    remaining = max(uni["aggregate_Bps"] - rep["aggregate_Bps"], 0.0)
    closure = gap / max(remaining, 1e-9)

    # bandwidth-aware ownership rebalancing on the WAN-heavy weight split
    reb = MultiHostRun(store, uuids, rep_cfg(
        seed, n_hosts=4, flow_control="adaptive")).start()
    before = reb.run(rounds // 2)
    weights0 = before["ownership_weights"]
    weights1 = reb.rebalance(step=0.3)
    after = reb.run(rounds // 2)
    scenarios["rebalance_before"] = before
    scenarios["rebalance_after"] = after

    def _share(w):
        return w["onprem"] / max(sum(w.values()), 1)

    return {
        "seed": seed, "quick": quick, "rounds": rounds,
        "n_samples": sz["n_samples"], "zipf_s": ZIPF_S,
        "uniform_MBps": uni["aggregate_Bps"] / 1e6,
        "zipf_MBps": zipf["aggregate_Bps"] / 1e6,
        "zipf_replicated_MBps": rep["aggregate_Bps"] / 1e6,
        "gap_MBps": gap / 1e6,
        "remaining_gap_MBps": remaining / 1e6,
        "gap_closure": min(closure, 999.0),
        "replica_hit_frac": rep["replica_hit_frac"],
        "wan_bytes_saved_MB": rep["wan_bytes_saved"] / 1e6,
        "rebalance_weights_before": weights0,
        "rebalance_weights_after": weights1,
        "scenarios": scenarios,
        "checks": {
            "zipf_opens_a_gap": gap > 0.0,
            "replication_recovers_1_5x_of_zipf_gap":
                gap > 0.0 and remaining * 1.5 <= gap,
            "replication_cuts_wan_share":
                rep["wan_bytes_share"] < zipf["wan_bytes_share"],
            "rebalance_shifts_weight_toward_spare_member":
                _share(weights1) > _share(weights0),
            "rebalance_cuts_wan_share":
                after["wan_bytes_share"] < before["wan_bytes_share"],
        },
    }


def print_replication(r: dict) -> None:
    print(f"hot-key replication (8 clients, 6-node local + 4-node "
          f"intercontinental, zipf s={r['zipf_s']}, {r['rounds']} rounds):")
    for tag in ("uniform", "zipf", "zipf+replication"):
        rep = r["scenarios"][tag]
        print(f"  {tag:>18s} {rep['aggregate_Bps']/1e6!r:>20s} MB/s, WAN "
              f"share {rep['wan_bytes_share']:.2f}, replica hits "
              f"{rep.get('replica_hit_frac', 0.0):.2f}")
    print(f"  -> gap {r['gap_MBps']:.0f} MB/s, replication leaves "
          f"{r['remaining_gap_MBps']:.0f} ({r['gap_closure']:.1f}x closer, "
          f"target >= 1.5x); rebalance weights "
          f"{r['rebalance_weights_before']} -> "
          f"{r['rebalance_weights_after']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    section = ap.add_mutually_exclusive_group(required=True)
    section.add_argument("--scale", action="store_true",
                         help="the 1000-host x 3-cluster scale point")
    section.add_argument("--replication", action="store_true",
                         help="hot-key replication and rebalancing")
    ap.add_argument("--quick", action="store_true",
                    help="CI size: the baseline's sizing")
    args = ap.parse_args(argv)
    tag = " (quick)" if args.quick else ""
    if args.scale:
        print("# 1000-host scale-out (repro_torch)" + tag)
        results = run_scale(quick=args.quick)
        print_scale(results)
        return torch_gate.finish("multihost_scale.json", results,
                                 quick=args.quick)
    print("# Hot-key replication & ownership rebalancing (repro_torch)" + tag)
    results = run_replication(quick=args.quick)
    print_replication(results)
    return torch_gate.finish("multihost_replication.json", results,
                             quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
