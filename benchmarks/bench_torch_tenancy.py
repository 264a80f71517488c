"""Multi-tenant QoS isolation on the port: a latency tenant against an
aggressive batch tenant.  The twin of ``benchmarks/bench_tenancy.py`` for
``repro_torch``.

One latency-sensitive serve host shares the client NIC with three batch
hosts drawing Zipf(1.3) keys.  Three scenarios, each a ``MultiHostRun``
built by ``build_stack(MultiHostConfig)``: **solo** (the serve host alone),
**untenanted** (the mix under the equal-split ``SharedIngressLimiter``) and
**tenanted** (the mix under the weighted-fair ``TenantScheduler`` with
tenant admission).  The checks are the reference's: the serve tenant's p99
stays within 1.25x of solo, the aggregate within 10% of untenanted, QoS
beats the untenanted tail, and the batch tenant is still served.

Everything runs on the virtual clock in ``repro_torch.core``, the
reference's code, so the gated metrics equal
``benchmarks/baselines/tenancy.json`` exactly (``torch_gate``).  Results
land in ``results/tenancy_torch.json``.

    PYTHONPATH=src python -m benchmarks.bench_torch_tenancy [--quick]

The simulation runs in the host's numpy and touches no device, so the
bench takes no ``--device`` and needs no card.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.core import MultiHostConfig, TenantSpec, build_stack

from . import torch_gate
from .torch_common import make_store

N_NODES = 4
NODE_EGRESS = 1.25e9            # 10 GbE per storage node: the nodes, not the
CLIENT_NIC = 5.0e9              # client NIC, are the contended resource
ZIPF_S = 1.3
SEED = 11
BATCH = 256

SERVE = TenantSpec("serve", qos="latency", weight=3.0, rate_ceiling=0.8e9)
TRAIN = TenantSpec("train", qos="batch", weight=1.0, rate_ceiling=2.6e9,
                   sampling="zipf", zipf_s=ZIPF_S)


def tenancy_sizes(quick: bool) -> dict:
    return {"n_samples": 30_000 if quick else 120_000,
            "rounds": 16 if quick else 40}


def _cfg(n_hosts: int, **kw) -> MultiHostConfig:
    defaults = dict(n_hosts=n_hosts, batch_size=BATCH, prefetch_buffers=8,
                    io_threads=8, route="high", backend="scylla",
                    n_nodes=N_NODES, replication_factor=2, hedge_after=None,
                    seed=SEED, node_egress_bandwidth=NODE_EGRESS,
                    flow_control="adaptive", shared_client_ingress=True,
                    client_ingress_bandwidth=CLIENT_NIC, zipf_s=ZIPF_S)
    defaults.update(kw)
    return MultiHostConfig(**defaults)


# The three scenarios: host 0 is the serve host in each; the mixed runs add
# three zipf batch hosts, tenanted or not.
SCENARIOS = {
    "solo": lambda: _cfg(1),
    "untenanted": lambda: _cfg(
        4, host_sampling=("uniform", "zipf", "zipf", "zipf")),
    "tenanted": lambda: _cfg(
        4, tenants=(SERVE, TRAIN),
        tenant_of_host=("serve", "train", "train", "train"),
        route_admission=True),
}


def measure(store, uuids, scenario: str, rounds: int) -> dict:
    """One scenario: a warm-up of ``rounds``, then ``rounds`` measured."""
    run = build_stack(store=store, uuids=uuids, config=SCENARIOS[scenario](),
                      start=True).run
    run.run(rounds)             # warm-up: slow-start ramp + filter windows
    rep = run.run(rounds)
    out = {
        "aggregate_MBps": rep["aggregate_Bps"] / 1e6,
        "per_client_MBps": [b / 1e6 for b in rep["per_client_Bps"]],
        "p50_ms": rep["request_latency_s"][0]["p50"] * 1e3,
        "p99_ms": rep["request_latency_s"][0]["p99"] * 1e3,
    }
    if "tenants" in rep:
        out["tenants"] = {
            name: {"share_MBps": t["share_Bps"] / 1e6,
                   "egress_MBps": t["egress_Bps"] / 1e6,
                   "stall_frac": t["stall_frac"],
                   "p99_ms": t["request_latency_s"]["p99"] * 1e3,
                   "admit_checks": t["admit_checks"],
                   "admit_denials": t["admit_denials"]}
            for name, t in rep["tenants"].items()}
        out["serve_MBps"] = rep["tenants"]["serve"]["egress_Bps"] / 1e6
    return out


def run_isolation(quick: bool = False) -> dict:
    sz = tenancy_sizes(quick)
    store, uuids = make_store(n_samples=sz["n_samples"], seed=0)
    solo, untenanted, tenanted = (measure(store, uuids, name, sz["rounds"])
                                  for name in SCENARIOS)
    t = tenanted["tenants"]
    return {
        "quick": quick, "rounds": sz["rounds"],
        "n_samples": sz["n_samples"], "batch_size": BATCH,
        "zipf_s": ZIPF_S, "seed": SEED,
        "solo": solo, "untenanted": untenanted, "tenanted": tenanted,
        "checks": {
            "isolation_p99_within_1_25x_of_solo":
                tenanted["p99_ms"] <= 1.25 * solo["p99_ms"],
            "aggregate_within_10pct_of_untenanted":
                tenanted["aggregate_MBps"]
                >= 0.9 * untenanted["aggregate_MBps"],
            "qos_beats_untenanted_tail":
                tenanted["p99_ms"] < untenanted["p99_ms"],
            "batch_tenant_still_served":
                t["train"]["egress_MBps"] > 0.0,
        },
    }


def print_isolation(r: dict) -> None:
    print(f"  {'scenario':>12s} {'agg MB/s':>20s} {'serve p50 ms':>20s} "
          f"{'serve p99 ms':>20s}")
    for tag in SCENARIOS:
        rep = r[tag]
        print(f"  {tag:>12s} {rep['aggregate_MBps']!r:>20s} "
              f"{rep['p50_ms']!r:>20s} {rep['p99_ms']!r:>20s}")
    t = r["tenanted"]["tenants"]
    print(f"  -> tenanted shares: serve {t['serve']['share_MBps']:.0f} "
          f"MB/s, train {t['train']['share_MBps']:.0f} MB/s (train deferred "
          f"{t['train']['admit_denials']} of {t['train']['admit_checks']} "
          "admission checks)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="CI size: the baseline's sizing")
    args = ap.parse_args(argv)
    print("# Multi-tenant QoS isolation — serve tenant vs zipf batch tenant "
          "(repro_torch)" + (" (quick)" if args.quick else ""))
    results = run_isolation(quick=args.quick)
    print_isolation(results)
    return torch_gate.finish("tenancy.json", results, quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
