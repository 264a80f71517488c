"""Multi-host data-parallel training against one shared cluster, on the
PyTorch port.  The twin of ``examples/multihost_train.py`` for
``repro_torch``: the same runs, printing the same numbers.

Four training hosts, each owning a token-aware replica-skewed strip of one
global shuffle, consume batches in lockstep (one batch per host per step,
modelling synchronous data parallelism) while a fixed per-step compute time
emulates the GPU.  Midway, a coordinated checkpoint is taken, the cluster
"shrinks" — the run is restored onto TWO hosts (elastic N -> M resharding:
the unfinished epoch is reflowed into two strips, nothing skipped, nothing
repeated) — and a storage node is killed during the resized phase,
demonstrating that (a) the checkpoint captures a consistent batch boundary,
(b) the reflow preserves exactly-once delivery per epoch, and (c) hedged
requests + connection failover ride through the node failure.

A final phase federates the same dataset across TWO storage clusters — one
local, one an intercontinental WAN hop away (the data stays where it was
produced) — with cluster-aware placement routing every key to its owning
cluster and a replica-local node inside it.  Mid-phase the overseas cluster
suffers a region outage and reads degrade to the surviving cluster.

The loader runs on the host (numpy on the virtual clock) and touches no
device, so the example needs no card.

Run: PYTHONPATH=src python examples/torch_multihost_train.py
"""

from repro_torch.core import (ClusterSpec, KVStore, MultiHostConfig,
                              build_stack)
from repro_torch.data.datasets import SyntheticImageDataset, ingest

N_HOSTS = 4
RESIZED_HOSTS = 2
STEP_TIME = 0.05           # 50 ms of GPU compute per step
STEPS_PER_PHASE = 40


def _cfg(n_hosts: int) -> MultiHostConfig:
    return MultiHostConfig(n_hosts=n_hosts, batch_size=256,
                           prefetch_buffers=8, io_threads=8, route="high",
                           backend="scylla", n_nodes=4, replication_factor=2,
                           hedge_after=1.0, seed=4,
                           node_egress_bandwidth=1.25e9,
                           placement="token_aware")


def main() -> None:
    store = KVStore()
    uuids = ingest(store, SyntheticImageDataset(n_samples=60_000, seed=0))
    run = build_stack(store=store, uuids=uuids, config=_cfg(N_HOSTS),
                      start=True).run
    print(f"{run.describe()}; shard sizes {run.shard_sizes()}\n")

    rep = run.run(STEPS_PER_PHASE, step_time=STEP_TIME)
    print(f"phase 1: {STEPS_PER_PHASE} steps x {N_HOSTS} hosts, "
          f"{rep['aggregate_Bps']/1e6:.0f} MB/s aggregate, "
          f"fairness {rep['fairness']:.2f}, "
          f"replica-local {rep['replica_local_hit_frac']:.0%}")

    ckpt = run.checkpoint()
    print(f"checkpoint at global step {ckpt['rounds']}: "
          + ", ".join(f"shard{i}=(e{s['epoch']},c{s['cursor']})"
                      for i, s in enumerate(ckpt["shards"])))

    # the cluster shrinks: restore the 4-host checkpoint onto 2 hosts
    # (elastic reshard) and lose a storage node mid-phase on top
    # restore from a checkpoint: build unstarted, then start(ckpt)
    run2 = build_stack(store=store, uuids=uuids,
                       config=_cfg(RESIZED_HOSTS)).run.start(ckpt)
    print(f"\nelastic restore {N_HOSTS} -> {RESIZED_HOSTS} hosts; "
          f"shard sizes now {run2.shard_sizes()} "
          "(interrupted epoch reflowed, exactly-once preserved)")
    run2.inject_failure("node2", after=0.5)
    rep2 = run2.run(STEPS_PER_PHASE, step_time=STEP_TIME)
    print(f"phase 2 (resized, node2 dark mid-phase): "
          f"{rep2['aggregate_Bps']/1e6:.0f} MB/s aggregate, "
          f"{rep2['failovers']} failovers, fairness {rep2['fairness']:.2f}")

    load = rep2["cluster_load"]
    print("\nper-node load after phase 2:")
    for name, v in load.items():
        mark = " (down)" if v["down"] else ""
        print(f"  {name}: {v['requests']:6.0f} reqs, "
              f"{v['egress_bytes']/1e9:5.2f} GB egress "
              f"({v['egress_share']:.0%} share){mark}")

    resumed = run2.checkpoint()   # raises if shards drifted out of lockstep
    print(f"\nresized run advanced {resumed['rounds']} steps "
          f"(global step {ckpt['rounds'] + resumed['rounds']}) — "
          "all shards at one consistent boundary")

    # phase 3: the same dataset federated across two storage clusters, one
    # of them an ocean away; deeper prefetch hides the WAN latency, and a
    # cluster-level outage degrades reads to the surviving cluster
    specs = (ClusterSpec("onprem", route="local", n_nodes=4,
                         replication_factor=2,
                         node_egress_bandwidth=1.25e9),
             ClusterSpec("overseas", route="high", n_nodes=4,
                         replication_factor=2,
                         node_egress_bandwidth=1.25e9))
    fed_cfg = MultiHostConfig(n_hosts=N_HOSTS, batch_size=256,
                              prefetch_buffers=24, io_threads=8,
                              ramp_every=1, hedge_after=1.0, seed=4,
                              placement="cluster_aware", clusters=specs)
    fed = build_stack(store=store, uuids=uuids, config=fed_cfg,
                      start=True).run
    print(f"\nphase 3 (federated): {fed.describe()}")
    own = fed.federation.ownership_counts(uuids)
    print(f"  ownership: " + ", ".join(f"{c}={n}" for c, n in own.items()))
    rep3 = fed.run(STEPS_PER_PHASE, step_time=STEP_TIME)
    print(f"  {rep3['aggregate_Bps']/1e6:.0f} MB/s aggregate, WAN-bytes "
          f"share {rep3['wan_bytes_share']:.0%}, replica-local "
          f"{rep3['replica_local_hit_frac']:.0%}")
    fed.inject_cluster_outage("overseas", after=0.0)
    rep4 = fed.run(STEPS_PER_PHASE, step_time=STEP_TIME)
    print(f"  overseas region dark: {rep4['aggregate_Bps']/1e6:.0f} MB/s, "
          f"WAN-bytes share {rep4['wan_bytes_share']:.0%}, "
          f"{rep4['cluster_failovers']} cluster failovers — "
          "reads degraded to the surviving cluster, nothing lost")


if __name__ == "__main__":
    main()
