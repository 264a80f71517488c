"""Multi-host loading: N training hosts against one shared cluster.

The paper's scaling story (Sec. 4, multi-GPU training) has several training
hosts hammering the same database cluster at once; what makes that realistic
here is that all the *shared* server-side resources — per-node disk and NIC
egress FIFOs, backend service processes — live in one ``Cluster`` on one
``VirtualClock``, while each host brings its own ``ConnectionPool`` (own TCP
connections, own AIMD processes, own ingress NIC).  Adding clients therefore
degrades per-client throughput through genuine egress/disk contention, not
through an ad-hoc penalty factor.

``MultiHostRun`` wires up N ``CassandraLoader`` shards — one strip of one
global shuffle per host, carved by a placement policy (``contiguous`` or the
replica-skewed ``token_aware``, see ``core/placement.py``) — and drives them
in round-robin lockstep: one batch per host per round, so every host has
consumed the same number of batches whenever control returns to the caller.
That lockstep is what makes ``checkpoint()`` consistent: the per-shard
``(epoch, cursor)`` states it captures all correspond to the same global
batch boundary.

``start(checkpoint)`` is *elastic*: a checkpoint taken with N hosts restores
onto M hosts for any M.  With M == N every shard resumes exactly where it
stopped (bit-identical to the fixed-count behaviour).  With M != N the
unfinished part of the interrupted epoch(s) is reflowed — ``compute_reflow``
collects each old shard's undelivered tail per epoch, the placement policy
splits every tail into M balanced strips, and those strips are installed as
per-epoch overrides on the M fresh plans — so every sample is still
delivered exactly once per epoch across the resize, and later epochs use the
plain M-host sharding (identical to a run that started with M hosts).

Failure injection (``inject_failure``) takes a ``SimServerNode`` dark
mid-run; hedged requests plus the connection-pool failover path keep all
loaders alive through it (requests re-route to live replicas).

Adaptive flow control (``MultiHostConfig.flow_control="adaptive"``,
``core/flowctl.py``): every host gets its own BDP-tracking controller (one
per member cluster under a federation), per-shard controller snapshots ride
``checkpoint()`` (elastic restores merge the N budgets and split them M
ways instead of re-slow-starting), and ``shared_client_ingress=True`` puts
all hosts behind one client NIC with a fair-share budget cap so they
converge to ~1/N shares.  The default ``"static"`` keeps runs bit-identical
to pre-flow-control behaviour.

Multi-cluster federation (``MultiHostConfig.clusters``): instead of one
shared cluster, the run spans several storage clusters — each with its own
token ring, node set, replication factor and WAN route (``core/federation``).
Every uuid is owned by exactly one member cluster; each host's
``FederatedConnectionPool`` routes fetches to the owning cluster over that
cluster's route, degrading to a replica cluster when the owner is dark.
``cluster_aware`` placement prefers the key's same-region cluster first and
a replica-local node within it second; the run report breaks out
per-cluster egress and the WAN-bytes share.  Checkpoints record the
federation's ring metadata, so elastic restores rebuild the old strips
exactly — across host-count changes AND federation changes.

Runtime placement (``core/replication.py``): ``sampling="zipf"`` opens the
skewed-access workload class (with-replacement Zipf draws, globally-shared
hot keys); ``placement="replication_aware"`` (or an explicit
``MultiHostConfig.replication``) promotes hot keys onto the hosts' region
cluster and serves them locally, reported as ``replica_hit_frac`` and
``wan_bytes_saved``; ``MultiHostRun.rebalance()`` shifts weighted keyspace
ownership toward members whose flow controllers measure spare
bandwidth-delay product.  Replica cache and rebalanced ownership map ride
``checkpoint()`` and restore across elastic N->M unchanged.

Multi-tenant QoS (``MultiHostConfig.tenants``, ``core/tenancy.py``): hosts
are tagged with tenants (round-robin, or an explicit ``tenant_of_host``
map) and the shared client ingress is scheduled by a weighted-fair
``TenantScheduler`` instead of the equal-split ``SharedIngressLimiter`` —
rate floors/ceilings, work-conserving redistribution, tenant-level
admission on the route-admission path, and per-tenant
egress/hit-rate/stall/latency sections in the run report.  Tenant specs
may carry their own sampling mode, so one run mixes a uniform
latency-sensitive tenant with zipf batch tenants; ``host_sampling``
expresses the same mixed workload without tenancy (the untenanted
baseline of ``benchmarks/bench_tenancy.py``).  Scheduler state rides
``checkpoint()`` like flow snapshots do.

Invariants this module maintains (property-tested in
``tests/test_resharding.py`` / ``tests/test_multihost.py`` /
``tests/test_federation.py``):

* **Exactly-once per epoch** — each epoch delivers every dataset uuid
  exactly once across all hosts, through checkpoint/restore, elastic N->M
  resizes, node failures and cluster outages.  It is a *plan* property
  (strips are disjoint and jointly covering), never a routing one.
* **Contiguous-strip-of-shuffle sharding** — strips are contiguous slices
  of one seeded global shuffle (never strided slices of the raw uuid list),
  so shards stay unbiased samples and sizes differ by at most one.
* **M == N bit-identity** — restoring a checkpoint onto the same host count
  with the same strip-defining metadata (seed, placement, ring, federation)
  resumes each shard exactly where it stopped, bit-identical to an
  uninterrupted run; any metadata mismatch triggers a reflow instead of
  silently applying old cursors to different strips.
* **Lockstep checkpoints** — the round-robin driver keeps every shard at the
  same global batch boundary, so ``checkpoint()`` is always consistent.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .cluster import Cluster, TokenRing
from .federation import (ClusterSpec, FederatedCluster,
                         FederatedConnectionPool, FederatedRing,
                         federated_preferred_subsets)
from .flowctl import (FlowControlConfig, FlowControllerGroup,
                      SharedIngressLimiter, merge_snapshots)
from .kvstore import KVStore
from .loader import CassandraLoader, LoaderConfig
from .netsim import DISK_BANDWIDTH, NIC_BANDWIDTH, RateResource, VirtualClock
from .placement import (FEDERATED_POLICIES, PLACEMENT_POLICIES,
                        RING_POLICIES, global_order, preferred_node_subsets,
                        split_strips)
from .prefetcher import EpochPlan, compute_reflow
from .replication import SAMPLING_MODES, ReplicationConfig, ZipfPlan
from .stats import summarize
from .tenancy import TenantScheduler, TenantSpec

import numpy as np


@dataclass
class MultiHostConfig:
    """N-host run over a shared cluster; loader knobs mirror LoaderConfig."""

    n_hosts: int = 2
    batch_size: int = 256
    prefetch_buffers: int = 8
    io_threads: int = 8
    conns_per_thread: int = 2
    out_of_order: bool = True
    incremental_ramp: bool = True
    ramp_every: int = 4
    # route tier name or a RouteProfile (schedule-carrying dynamic routes)
    route: "str | object" = "high"
    backend: str = "scylla"
    n_nodes: int = 4
    replication_factor: int = 2
    # Hedge delay in seconds, None (no hedging), or "auto" — with adaptive
    # flow control, derive the delay per fetch from the controller's
    # measured min-RTT (see FlowControlConfig.hedge_rtt_multiple) so the
    # trigger tracks the route instead of needing hand-tuning per tier.
    hedge_after: "Optional[float | str]" = 1.0
    seed: int = 0
    materialize: bool = False
    # Shared-cluster capacity: per-node NIC/disk.  The default is the paper's
    # 50 Gb/s NIC; pinch it (e.g. 1-10 GbE) to study egress contention as the
    # client count grows.
    node_egress_bandwidth: float = NIC_BANDWIDTH
    node_disk_bandwidth: float = DISK_BANDWIDTH
    # Shard placement policy: "contiguous" (paper-faithful strips),
    # "token_aware" (replica-skewed strips + preferred-node routing),
    # "cluster_aware" (federation: same-region cluster, then replica-local
    # node; requires ``clusters``) or "replication_aware" (cluster_aware
    # strips + hot-key replica serving/promotion at runtime; requires
    # ``clusters`` and switches replication on with default knobs).
    placement: str = "contiguous"
    # Multi-cluster federation: when set, the run spans these member
    # clusters (per-cluster ring/route/rf/weight; see core/federation.py)
    # instead of one shared cluster built from route/backend/n_nodes/
    # replication_factor above, and each host talks to every member over
    # that member's own route via a FederatedConnectionPool.
    clusters: Optional[Tuple[ClusterSpec, ...]] = None
    # Flow control (core/flowctl.py): "static" keeps the fixed
    # prefetch_buffers depth (default, bit-identical to pre-flow-control
    # runs); "adaptive" gives every host its own BDP-tracking controller
    # (one per member cluster under a federation).
    flow_control: str = "static"
    flow: Optional[FlowControlConfig] = None
    # Shared client ingress: all hosts behind ONE client NIC (co-located
    # consumers) instead of one NIC per host.  With adaptive flow control a
    # fairness cap limits each host's budget to its fair-share BDP of that
    # NIC, so N hosts converge to ~1/N shares.
    shared_client_ingress: bool = False
    client_ingress_bandwidth: float = NIC_BANDWIDTH
    # Hot-key replication knobs (core/replication.py): set to enable
    # promotion of skewed-access keys onto the hosts' region cluster under
    # any federated placement; ``placement="replication_aware"`` enables it
    # with defaults when left None.  Needs ``clusters``.
    replication: Optional[ReplicationConfig] = None
    # Access distribution: "uniform" (per-epoch permutations, exactly-once —
    # the default and the paper's workload) or "zipf" (seeded Zipf(zipf_s)
    # sampling with replacement over the global key list — the skewed
    # workload class hot-key replication exists for; exactly-once per epoch
    # deliberately does not hold, see core/replication.py:ZipfPlan).
    sampling: str = "uniform"
    zipf_s: float = 1.05
    # Moving hotset: rotate the Zipf rank->key map every this many epochs
    # (see ZipfPlan.shift_every) — the workload class replica demotion
    # (ReplicationConfig.demote_after) exists for.  None = fixed hotset.
    zipf_shift_every: Optional[int] = None
    # Ownership-rebalance cadence: every this many rounds, ``run()`` invokes
    # ``rebalance()`` with its default step — so a route whose measured
    # spare BDP drifts (schedules, outages) sheds keyspace weight without
    # the caller scripting it.  Requires a federation + adaptive flow
    # control.  None = caller-invoked only (the pre-cadence behaviour).
    rebalance_every: Optional[int] = None
    # Per-key route admission in the prefetcher (see PrefetchConfig):
    # requires adaptive flow control to have per-route budgets to consult.
    route_admission: bool = False
    # Multi-tenant QoS (core/tenancy.py): when set, hosts are tagged with
    # tenants (``tenant_of_host``, or round-robin over the specs) and the
    # client NIC is scheduled by a weighted-fair TenantScheduler instead of
    # the equal-split SharedIngressLimiter.  Requires
    # flow_control="adaptive" (QoS shares are enforced through the
    # controllers' budget caps) and — single-cluster — also
    # shared_client_ingress=True (the NIC the shares divide); under a
    # federation the scheduler caps per-member budgets against
    # client_ingress_bandwidth without a shared ingress pipe (each host
    # keeps its own NIC).  A tenant spec's ``sampling``/``zipf_s`` drive
    # that tenant's hosts' access pattern.
    tenants: Optional[Tuple[TenantSpec, ...]] = None
    tenant_of_host: Optional[Tuple[str, ...]] = None
    # Per-host sampling override ("uniform"/"zipf" per host), independent of
    # tenancy — how the untenanted baseline of bench_tenancy expresses the
    # same mixed workload.  Takes precedence over tenant-spec sampling;
    # ``sampling="zipf"`` above still forces every host to zipf.
    host_sampling: Optional[Tuple[str, ...]] = None
    # Wire codec — LoaderConfig.wire_codec, one level up.  A codec name
    # applies to every host's pool; under a federation (``clusters``) a
    # ``{member: codec}`` dict or ``"auto"`` (compress WAN members only,
    # see FederatedConnectionPool) are also accepted.  "none" stays
    # bit-identical to the pre-codec path.
    wire_codec: "str | Dict[str, str]" = "none"
    # Controller-driven issue-parallelism scaling — LoaderConfig.io_scaling
    # spelling; needs flow_control="adaptive" to have a budget to follow.
    io_scaling: bool = False
    # Pinned-arena batch assembly — LoaderConfig.use_arena spelling; only
    # effective with materialize=True (same rule as the single-host loader).
    use_arena: bool = False
    arena_slot_bytes: Optional[int] = None

    def loader_config(self, shard_id: int,
                      preferred_nodes: Optional[tuple] = None) -> LoaderConfig:
        return LoaderConfig(
            batch_size=self.batch_size,
            prefetch_buffers=self.prefetch_buffers,
            io_threads=self.io_threads,
            conns_per_thread=self.conns_per_thread,
            out_of_order=self.out_of_order,
            incremental_ramp=self.incremental_ramp,
            ramp_every=self.ramp_every,
            route=self.route,
            backend=self.backend,
            n_nodes=self.n_nodes,
            replication_factor=self.replication_factor,
            hedge_after=self.hedge_after,
            seed=self.seed,
            shard_id=shard_id,
            num_shards=self.n_hosts,
            materialize=self.materialize,
            virtual_clock=True,
            preferred_nodes=preferred_nodes,
            flow_control=self.flow_control,
            flow=self.flow,
            route_admission=self.route_admission,
            # dict/"auto" codecs are federation-level: the per-member
            # resolution happens in FederatedConnectionPool, which replaces
            # the loader-built pool, so the per-loader config carries the
            # codec only when it is a plain name
            wire_codec=(self.wire_codec
                        if isinstance(self.wire_codec, str)
                        and self.wire_codec != "auto" else "none"),
            io_scaling=self.io_scaling,
            use_arena=self.use_arena,
            arena_slot_bytes=self.arena_slot_bytes)


class MultiHostRun:
    """Coordinator for N sharded loaders on one clock + one cluster."""

    def __init__(self, store: KVStore, uuids: List[_uuid.UUID],
                 cfg: MultiHostConfig,
                 clock: Optional[VirtualClock] = None,
                 cluster: Optional[Cluster] = None) -> None:
        if cfg.n_hosts < 1:
            raise ValueError("need at least one host")
        if cfg.placement not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement policy {cfg.placement!r} "
                             f"(choose from {PLACEMENT_POLICIES})")
        if cfg.placement in FEDERATED_POLICIES and not cfg.clusters \
                and not isinstance(cluster, FederatedCluster):
            raise ValueError(f"{cfg.placement} placement needs a federation "
                             "(set MultiHostConfig.clusters)")
        if cfg.sampling not in SAMPLING_MODES:
            raise ValueError(f"unknown sampling mode {cfg.sampling!r} "
                             f"(choose from {SAMPLING_MODES})")
        if cfg.rebalance_every is not None:
            if cfg.rebalance_every < 1:
                raise ValueError(f"rebalance_every must be >= 1, "
                                 f"got {cfg.rebalance_every}")
            if not cfg.clusters and not isinstance(cluster, FederatedCluster):
                raise ValueError("rebalance_every needs a federation "
                                 "(set MultiHostConfig.clusters)")
            if cfg.flow_control != "adaptive":
                raise ValueError("rebalance_every needs "
                                 "flow_control='adaptive' (the spare-BDP "
                                 "signal comes from the flow controllers)")
        if cfg.hedge_after == "auto" and cfg.flow_control != "adaptive":
            raise ValueError("hedge_after='auto' needs "
                             "flow_control='adaptive' (the delay comes from "
                             "the controller's min-RTT)")
        if cfg.tenant_of_host is not None and not cfg.tenants:
            raise ValueError("tenant_of_host needs tenants "
                             "(set MultiHostConfig.tenants)")
        if (cfg.wire_codec == "auto" or isinstance(cfg.wire_codec, dict)) \
                and not cfg.clusters \
                and not isinstance(cluster, FederatedCluster):
            raise ValueError("wire_codec='auto' / per-member codec dicts "
                             "are federation-level (set "
                             "MultiHostConfig.clusters); a single shared "
                             "cluster takes one codec name")
        if cfg.io_scaling and cfg.flow_control != "adaptive":
            raise ValueError("io_scaling needs flow_control='adaptive' "
                             "(the active-connection prefix follows the "
                             "controller's budget)")
        if cfg.use_arena and not cfg.materialize:
            raise ValueError("use_arena needs materialize=True (the arena "
                             "holds real payload bytes)")
        self.tenant_of_host: Optional[Tuple[str, ...]] = None
        if cfg.tenants:
            if cfg.flow_control != "adaptive":
                raise ValueError("tenants need flow_control='adaptive' (QoS "
                                 "shares are enforced through the "
                                 "controllers' budget caps)")
            assignment = cfg.tenant_of_host or tuple(
                cfg.tenants[i % len(cfg.tenants)].name
                for i in range(cfg.n_hosts))
            if len(assignment) != cfg.n_hosts:
                raise ValueError(f"tenant_of_host has {len(assignment)} "
                                 f"entries for {cfg.n_hosts} hosts")
            known = {t.name for t in cfg.tenants}
            unknown = sorted(set(assignment) - known)
            if unknown:
                raise ValueError(f"tenant_of_host names unknown tenants "
                                 f"{unknown} (have {sorted(known)})")
            self.tenant_of_host = tuple(assignment)
        if cfg.host_sampling is not None:
            if len(cfg.host_sampling) != cfg.n_hosts:
                raise ValueError(f"host_sampling has "
                                 f"{len(cfg.host_sampling)} entries for "
                                 f"{cfg.n_hosts} hosts")
            bad = sorted(set(cfg.host_sampling) - set(SAMPLING_MODES))
            if bad:
                raise ValueError(f"unknown sampling modes {bad} in "
                                 f"host_sampling (choose from "
                                 f"{SAMPLING_MODES})")
        self.cfg = cfg
        self.clock = clock or VirtualClock()
        if cluster is not None:
            self.cluster = cluster
        elif cfg.clusters:
            self.cluster = FederatedCluster(self.clock, store, cfg.clusters,
                                            seed=cfg.seed + 5)
        else:
            self.cluster = Cluster(
                self.clock, store, backend=cfg.backend, n_nodes=cfg.n_nodes,
                rf=cfg.replication_factor, seed=cfg.seed + 5,
                disk_bandwidth=cfg.node_disk_bandwidth,
                egress_bandwidth=cfg.node_egress_bandwidth)
        self.federation = (self.cluster
                           if isinstance(self.cluster, FederatedCluster)
                           else None)
        # Hot-key replication: explicit config or the replication_aware
        # policy switches it on (shared tracker + cache on the federation).
        if cfg.replication is not None or cfg.placement == "replication_aware":
            if self.federation is None:
                raise ValueError("hot-key replication needs a federation "
                                 "(set MultiHostConfig.clusters)")
            self.federation.attach_replication(cfg.replication)
        self.rebalances = 0
        self._uuids = list(uuids)
        if self.federation is not None:
            self.preferred = federated_preferred_subsets(
                self.federation.node_names_by_cluster(), cfg.n_hosts)
        else:
            self.preferred = preferred_node_subsets(
                self.cluster.node_names(), cfg.n_hosts)
        prefs = (self.preferred if cfg.placement in RING_POLICIES
                 else [None] * cfg.n_hosts)
        # Per-host access pattern: the global sampling mode forces every
        # host to zipf; else an explicit host_sampling map; else the hosts'
        # tenant specs; else uniform everywhere (the default).
        if cfg.sampling == "zipf":
            self._host_sampling = ["zipf"] * cfg.n_hosts
            self._host_zipf_s: List[Optional[float]] = \
                [cfg.zipf_s] * cfg.n_hosts
        elif cfg.host_sampling is not None:
            self._host_sampling = list(cfg.host_sampling)
            self._host_zipf_s = [cfg.zipf_s if s == "zipf" else None
                                 for s in self._host_sampling]
        elif self.tenant_of_host is not None:
            by_host = [{t.name: t for t in cfg.tenants}[name]
                       for name in self.tenant_of_host]
            self._host_sampling = [t.sampling for t in by_host]
            self._host_zipf_s = [t.zipf_s if t.sampling == "zipf" else None
                                 for t in by_host]
        else:
            self._host_sampling = ["uniform"] * cfg.n_hosts
            self._host_zipf_s = [None] * cfg.n_hosts
        # zipf hosts sample the global rank->key map with replacement
        # (placement strips don't apply — there is no exactly-once delivery
        # set — preferred-node routing does); uniform hosts keep their
        # strip-of-shuffle plans even in a mixed run, so *their* epochs stay
        # exactly-once over their strips.
        strips = None
        if (cfg.placement in RING_POLICIES
                and "uniform" in self._host_sampling):
            strips = _steady_strips(uuids, cfg.seed, cfg.n_hosts,
                                    cfg.placement, ring=self.cluster.ring,
                                    rf=self.cluster.rf,
                                    preferred=self.preferred)
        plans: List[object] = []
        for i in range(cfg.n_hosts):
            if self._host_sampling[i] == "zipf":
                plans.append(ZipfPlan(uuids, cfg.seed, i, cfg.n_hosts,
                                      s=self._host_zipf_s[i],
                                      shift_every=cfg.zipf_shift_every))
            elif strips is not None:
                plans.append(EpochPlan.from_samples(strips[i], cfg.seed, i,
                                                    cfg.n_hosts))
            else:   # contiguous: loader carves its own strip (PR1 semantics)
                plans.append(None)
        if cfg.shared_client_ingress and self.federation is not None:
            raise ValueError("shared_client_ingress is not supported with a "
                             "federation (each host already multiplexes its "
                             "member sub-pools over one NIC)")
        if cfg.tenants and self.federation is None \
                and not cfg.shared_client_ingress:
            raise ValueError("tenants need shared_client_ingress=True (the "
                             "NIC whose bandwidth the QoS shares divide) — "
                             "or a federation, where the scheduler caps "
                             "per-member budgets against "
                             "client_ingress_bandwidth instead")
        # Co-located consumers: one client NIC for every host, plus — under
        # adaptive flow control — a fairness cap so the hosts' budgets
        # converge to ~1/N shares of that NIC instead of out-buffering each
        # other.  With tenants the cap generalizes to weighted-fair QoS
        # shares (core/tenancy.py); under a federation the scheduler runs
        # caps-only (no shared ingress pipe — each host has its own NIC).
        shared_ingress = None
        self.limiter: Optional[SharedIngressLimiter] = None
        if cfg.shared_client_ingress:
            shared_ingress = RateResource("client/shared-ingress",
                                          cfg.client_ingress_bandwidth)
            if cfg.flow_control == "adaptive":
                if cfg.tenants:
                    self.limiter = TenantScheduler(
                        cfg.client_ingress_bandwidth, cfg.tenants,
                        clock=self.clock)
                else:
                    self.limiter = SharedIngressLimiter(
                        cfg.client_ingress_bandwidth, clock=self.clock)
        elif cfg.tenants:
            self.limiter = TenantScheduler(cfg.client_ingress_bandwidth,
                                           cfg.tenants, clock=self.clock)
        self.loaders = []
        for i in range(cfg.n_hosts):
            pool = None
            if self.federation is not None:
                pool = FederatedConnectionPool(
                    self.clock, self.federation,
                    io_threads=cfg.io_threads,
                    conns_per_thread=cfg.conns_per_thread,
                    seed=cfg.seed + 11 + 104729 * i,
                    hedge_after=cfg.hedge_after,
                    materialize=cfg.materialize,
                    preferred_nodes=prefs[i],
                    wire_codec=(None if cfg.wire_codec == "none"
                                else cfg.wire_codec),
                    io_scaling=cfg.io_scaling)
            self.loaders.append(
                CassandraLoader(store, uuids,
                                cfg.loader_config(i, None if pool
                                                  else prefs[i]),
                                clock=self.clock, cluster=self.cluster,
                                plan=plans[i], pool=pool,
                                ingress=shared_ingress,
                                flow_limiter=self.limiter))
        # Tag every host's controller(s) with its tenant — under a
        # federation that is each member controller of the host's group, so
        # the scheduler sees per-route demand and the summed group budget
        # respects the tenant's cap.
        if self.tenant_of_host is not None:
            for ld, tenant in zip(self.loaders, self.tenant_of_host):
                ctl = ld.flow_controller
                members = (ctl.members.values()
                           if isinstance(ctl, FlowControllerGroup)
                           else [ctl])
                for m in members:
                    self.limiter.assign(m, tenant)
        # Per-host consumption accounting (cheap bookkeeping, no clock
        # events): buffer hits vs stalls behind ``next_batch``, the inputs
        # of the per-tenant hit_frac/stall_frac report sections.
        self._host_pulls = [0] * cfg.n_hosts
        self._host_hits = [0] * cfg.n_hosts
        self._host_stall_s = [0.0] * cfg.n_hosts
        self.rounds_consumed = 0
        self._started = False

    def _split(self, samples: List[_uuid.UUID]) -> List[List[_uuid.UUID]]:
        return split_strips(samples, self.cfg.n_hosts, self.cfg.placement,
                            ring=self.cluster.ring, rf=self.cluster.rf,
                            preferred=self.preferred)

    # -- lifecycle ----------------------------------------------------------
    def start(self, checkpoint: Optional[Dict] = None) -> "MultiHostRun":
        """Start all shards: fresh, from a matching-shards checkpoint (each
        shard resumes exactly where it stopped), or via an elastic reshard
        (``_start_resharded``) when the host count — or any strip-defining
        metadata like seed or placement policy — differs, so old cursors are
        never silently applied to different strips."""
        if checkpoint is None:
            for ld in self.loaders:
                ld.start()
            self._started = True
            return self
        # every strip (old and new) is a deterministic function of the uuid
        # list, so restoring against a different dataset would silently
        # reflow wrong permutations — refuse instead
        ck_size = checkpoint.get("dataset_size", len(self._uuids))
        if ck_size != len(self._uuids):
            raise ValueError(f"checkpoint was taken over {ck_size} samples, "
                             f"this run has {len(self._uuids)} — not the "
                             "same dataset")
        ck_hs = checkpoint.get("host_sampling")
        ck_zipf = (checkpoint.get("sampling", "uniform") == "zipf"
                   or (ck_hs is not None and "zipf" in ck_hs))
        if ck_zipf or "zipf" in self._host_sampling:
            self._start_zipf(checkpoint)
        elif (len(checkpoint["shards"]) == len(self.loaders)
                and self._same_strips(checkpoint)):
            for ld, s in zip(self.loaders, checkpoint["shards"]):
                overrides = s.get("overrides")
                if overrides:
                    ld.plan.install_overrides(_parse_overrides(overrides))
                ld.start(s["epoch"], s["cursor"])
                ld.restore_flow(s.get("flow"))
        else:
            self._start_resharded(checkpoint)
        self._restore_runtime_placement(checkpoint)
        # per-tenant cumulative counters re-seed (specs themselves come from
        # this run's config — a restore never resurrects dropped tenants)
        if self.tenant_of_host is not None:
            self.limiter.restore(checkpoint.get("tenants"))
        self._started = True
        return self

    def _start_zipf(self, checkpoint: Dict) -> None:
        """Restore involving Zipf sampling (pure or mixed per host):
        with-replacement draws have no exactly-once delivery set to reflow,
        so a matching checkpoint resumes each shard's sample stream exactly
        and any mismatch (host count, seed, exponent, per-host sampling
        map) restarts at the slowest shard's epoch boundary with the merged
        flow-control budget.  In a *mixed* run that boundary restart also
        applies to the uniform hosts — their interrupted epoch replays
        (at-least-once) because the zipf hosts leave nothing to reflow
        against; matching restores stay exact/exactly-once."""
        shards = checkpoint["shards"]
        # Per-host sampling metadata, defaulted for checkpoints predating
        # mixed workloads (pure-zipf runs recorded only the global keys).
        ck_hs = checkpoint.get("host_sampling") or \
            [checkpoint.get("sampling", "uniform")] * len(shards)
        ck_zs = checkpoint.get("host_zipf_s") or \
            [checkpoint.get("zipf_s", self.cfg.zipf_s) if s == "zipf"
             else None for s in ck_hs]
        exact = (len(shards) == len(self.loaders)
                 and list(ck_hs) == list(self._host_sampling)
                 and list(ck_zs) == list(self._host_zipf_s)
                 and checkpoint.get("seed", self.cfg.seed) == self.cfg.seed
                 and checkpoint.get("zipf_shift_every",
                                    self.cfg.zipf_shift_every)
                 == self.cfg.zipf_shift_every
                 and (("uniform" not in ck_hs)
                      or self._same_strips(checkpoint)))
        if exact:
            for ld, s in zip(self.loaders, shards):
                ld.start(s["epoch"], s["cursor"])
                ld.restore_flow(s.get("flow"))
            return
        start_epoch = min(s["epoch"] for s in shards)
        merged = merge_snapshots([s.get("flow") for s in shards],
                                 len(self.loaders))
        for ld in self.loaders:
            ld.start(start_epoch, 0)
            ld.restore_flow(merged)

    def _restore_runtime_placement(self, checkpoint: Dict) -> None:
        """Re-install checkpointed runtime placement state: the rebalanced
        ownership map and the hot-key replication snapshot.  Both are
        cluster-side, so they restore unchanged across elastic N->M; state
        recorded against a *different* federation is dropped (its member
        names no longer resolve)."""
        if self.federation is None:
            return
        members = {s.name for s in self.federation.specs}
        own = checkpoint.get("ownership")
        if own and [m["name"] for m in own] == [s.name
                                                for s in self.federation.specs]:
            self.federation.install_ownership(FederatedRing.from_metadata(own))
        snap = checkpoint.get("replication")
        if snap and self.federation.replication is not None:
            cache = {k: v for k, v in (snap.get("cache") or {}).items()
                     if v.get("cluster") in members}
            self.federation.replication.restore(
                {"tracker": snap.get("tracker"), "cache": cache})

    def _same_strips(self, checkpoint: Dict) -> bool:
        """Does the checkpointed run's strip assignment match this run's?
        Keys missing from pre-elastic checkpoints default to what those runs
        actually were — contiguous placement (the only pre-elastic policy;
        must match ``_rebuild_old_plans``) and this run's seed."""
        if (checkpoint.get("seed", self.cfg.seed) != self.cfg.seed
                or checkpoint.get("placement",
                                  "contiguous") != self.cfg.placement):
            return False
        if self.cfg.placement in RING_POLICIES:
            # ring-derived strips also depend on the topology: for a
            # federation that is the full per-member ring metadata, for a
            # single cluster the (node_names, ring_seed, rf) triple.
            fed_meta = (self.federation.ring.metadata()
                        if self.federation is not None else None)
            if checkpoint.get("federation") != fed_meta:
                return False
            if self.federation is not None:
                return True
            return (checkpoint.get("node_names",
                                   self.cluster.node_names())
                    == self.cluster.node_names()
                    and checkpoint.get("ring_seed", self.cluster.ring_seed)
                    == self.cluster.ring_seed
                    and checkpoint.get("replication_factor",
                                       self.cfg.replication_factor)
                    == self.cfg.replication_factor)
        return True

    def _start_resharded(self, checkpoint: Dict) -> None:
        """Elastic N->M restore: reflow the undelivered tail of every epoch
        at the checkpoint boundary into M strips (exactly-once preserved),
        then fall through to plain M-host sharding for later epochs."""
        old_plans = self._rebuild_old_plans(checkpoint)
        positions = [(s["epoch"], s["cursor"]) for s in checkpoint["shards"]]
        start_epoch, tails = compute_reflow(old_plans, positions)
        for epoch, tail in sorted(tails.items()):
            for ld, strip in zip(self.loaders, self._split(tail)):
                ld.plan.install_overrides({epoch: strip})
        # Re-seed flow control across the resize: the cluster-wide in-flight
        # total is conserved (N shards' budgets merge, then split M ways), so
        # the restored run resumes at the measured operating point instead of
        # re-slow-starting against a warm cluster.
        merged_flow = merge_snapshots(
            [s.get("flow") for s in checkpoint["shards"]], len(self.loaders))
        for ld in self.loaders:
            ld.start(start_epoch, 0)
            ld.restore_flow(merged_flow)

    def _rebuild_old_plans(self, checkpoint: Dict) -> List[EpochPlan]:
        """Reconstruct the checkpointed run's shard plans from the recorded
        (seed, placement, ring) metadata — strips are deterministic functions
        of those, so the checkpoint itself stays small."""
        shards = checkpoint["shards"]
        old_n = len(shards)
        seed = checkpoint.get("seed", self.cfg.seed)
        policy = checkpoint.get("placement", "contiguous")
        fed_meta = checkpoint.get("federation")
        if policy in RING_POLICIES and fed_meta:
            # federated strips: rebuild the keyspace ring (per-member token
            # rings + ownership weights) straight from the metadata
            ring = FederatedRing.from_metadata(fed_meta)
            preferred = federated_preferred_subsets(
                {m["name"]: [f"{m['name']}/node{i}"
                             for i in range(m["n_nodes"])]
                 for m in fed_meta}, old_n)
            strips = _steady_strips(self._uuids, seed, old_n, policy,
                                    ring=ring, rf=0, preferred=preferred)
            plans = [EpochPlan.from_samples(strips[i], seed, i, old_n)
                     for i in range(old_n)]
        elif policy == "token_aware":
            n_nodes = checkpoint.get("n_nodes", self.cfg.n_nodes)
            names = checkpoint.get("node_names",
                                   [f"node{i}" for i in range(n_nodes)])
            ring = TokenRing(names,
                             seed=checkpoint.get("ring_seed", seed + 5))
            rf = min(checkpoint.get("replication_factor",
                                    self.cfg.replication_factor), len(names))
            strips = _steady_strips(self._uuids, seed, old_n, "token_aware",
                                    ring=ring, rf=rf,
                                    preferred=preferred_node_subsets(names,
                                                                     old_n))
            plans = [EpochPlan.from_samples(strips[i], seed, i, old_n)
                     for i in range(old_n)]
        else:
            plans = [EpochPlan(self._uuids, seed=seed, shard_id=i,
                               num_shards=old_n) for i in range(old_n)]
        for plan, s in zip(plans, shards):
            overrides = s.get("overrides")
            if overrides:
                plan.install_overrides(_parse_overrides(overrides))
        return plans

    def inject_failure(self, node: str, after: float,
                       recover_after: Optional[float] = None) -> None:
        """Schedule ``node`` to go dark ``after`` virtual seconds from now.
        In a federation, node names are qualified: ``"eu/node2"``."""
        self.cluster.schedule_failure(node, after, recover_after)

    def inject_cluster_outage(self, cluster_name: str, after: float,
                              recover_after: Optional[float] = None) -> None:
        """Take an entire member cluster dark (region outage): its keys
        degrade to the replica cluster until it recovers."""
        if self.federation is None:
            raise ValueError("cluster outage injection needs a federation "
                             "(set MultiHostConfig.clusters)")
        self.federation.schedule_cluster_outage(cluster_name, after,
                                                recover_after)

    # -- driving ------------------------------------------------------------
    def run(self, n_rounds: int, step_time: float = 0.0,
            timeout: float = 600.0,
            on_batch: Optional[Callable] = None) -> Dict:
        """Consume ``n_rounds`` batches on every host, round-robin lockstep.

        ``step_time`` models the per-step GPU compute all hosts perform in
        parallel (one sleep per round, not per host).  ``on_batch(host_id,
        batch)`` is invoked for every delivered batch (tests and benchmarks
        use it to audit delivery instead of re-deriving from logs).  Returns
        a report dict; cumulative over repeated calls on the same run.
        """
        if not self._started:
            self.start()
        t0 = self.clock.now()
        bytes0 = [ld.pool.bytes_received for ld in self.loaders]
        served0 = [dict(ld.pool.served_by_node) for ld in self.loaders]
        egress0 = {name: node.egress_bytes
                   for name, node in self.cluster.nodes.items()}
        # retry counters snapshot: reports are per-window like the egress
        # numbers, so a recovered outage stops showing up in later windows
        counters0 = {
            "failovers": sum(ld.pool.failovers for ld in self.loaders),
            "requests_sent": sum(ld.pool.requests_sent
                                 for ld in self.loaders),
            "host_pulls": list(self._host_pulls),
            "host_hits": list(self._host_hits),
            "host_stall_s": list(self._host_stall_s),
        }
        if self.federation is not None:
            counters0["cluster_failovers"] = sum(ld.pool.cluster_failovers
                                                 for ld in self.loaders)
            if self.federation.replication is not None:
                counters0["fetches"] = sum(ld.pool.fetches
                                           for ld in self.loaders)
                counters0["replica_hits"] = sum(ld.pool.replica_hits
                                                for ld in self.loaders)
                counters0["wan_bytes_saved"] = sum(ld.pool.wan_bytes_saved
                                                   for ld in self.loaders)
        for _ in range(n_rounds):
            for host_id, ld in enumerate(self.loaders):
                t_pull = self.clock.now()
                hit = ld.ready_batches > 0
                batch = ld.next_batch(timeout=timeout)
                self._host_stall_s[host_id] += self.clock.now() - t_pull
                self._host_pulls[host_id] += 1
                if hit:
                    self._host_hits[host_id] += 1
                if on_batch is not None:
                    on_batch(host_id, batch)
            self.rounds_consumed += 1
            # Runtime placement maintenance on the round cadence: demote
            # replicas the hotset moved away from (no-op unless
            # ReplicationConfig.demote_after is set), and re-derive the
            # ownership map from the controllers' spare-BDP signal (no-op
            # unless rebalance_every is set) — counted against the run's
            # *total* rounds so the cadence survives repeated run() calls.
            if (self.federation is not None
                    and self.federation.replication is not None):
                self.federation.replication.demote_cold(self.clock.now())
            if (self.cfg.rebalance_every
                    and self.rounds_consumed % self.cfg.rebalance_every == 0):
                self.rebalance()
            if step_time > 0.0:
                self.clock.sleep(step_time)
        return self._report(t0, bytes0, served0, egress0, counters0,
                            n_rounds)

    def _report(self, t0: float, bytes0: List[int],
                served0: List[Dict[str, int]], egress0: Dict[str, int],
                counters0: Dict[str, int], n_rounds: int) -> Dict:
        elapsed = max(self.clock.now() - t0, 1e-9)
        per_client_bytes = [ld.pool.bytes_received - b0
                            for ld, b0 in zip(self.loaders, bytes0)]
        per_client_Bps = [b / elapsed for b in per_client_bytes]
        # placement stats over this run window: how many of each host's
        # fetches were served by one of its preferred nodes, and how the
        # cluster's egress split across nodes.
        local_served = total_served = 0
        for ld, base, pref in zip(self.loaders, served0, self.preferred):
            pref_set = frozenset(pref)
            for name, count in ld.pool.served_by_node.items():
                delta = count - base.get(name, 0)
                total_served += delta
                if name in pref_set:
                    local_served += delta
        egress_delta = {name: node.egress_bytes - egress0[name]
                        for name, node in self.cluster.nodes.items()}
        egress_total = max(sum(egress_delta.values()), 1)
        egress_share = {name: d / egress_total
                        for name, d in egress_delta.items()}
        mean_share = 1.0 / max(len(egress_share), 1)
        report = {
            "n_hosts": self.cfg.n_hosts,
            "rounds": n_rounds,
            "elapsed_s": elapsed,
            "aggregate_Bps": sum(per_client_bytes) / elapsed,
            "per_client_Bps": per_client_Bps,
            # fairness: worst/best per-client rate (1.0 = perfectly fair)
            "fairness": (min(per_client_Bps) / max(max(per_client_Bps), 1e-9)
                         if per_client_Bps else 0.0),
            "failovers": (sum(ld.pool.failovers for ld in self.loaders)
                          - counters0["failovers"]),
            "requests_sent": (sum(ld.pool.requests_sent
                                  for ld in self.loaders)
                              - counters0["requests_sent"]),
            "placement": self.cfg.placement,
            "replica_local_hit_frac": local_served / max(total_served, 1),
            "per_node_egress_share": egress_share,
            # max node share / even share (1.0 = perfectly balanced egress)
            "egress_imbalance": (max(egress_share.values()) / mean_share
                                 if egress_share else 0.0),
            "cluster_load": self.cluster.load_report(),
        }
        if self.cfg.flow_control == "adaptive":
            # per-host controller operating points (per member cluster under
            # a federation): budget, BDP estimate, min-RTT, backoff counts
            report["flow"] = [ld.flow_controller.report()
                              for ld in self.loaders]
        if self.limiter is not None:
            # per-host request-latency summaries from the limiter's
            # completion rings (recent fetches, bounded per member)
            report["request_latency_s"] = [
                summarize(np.asarray(self._host_request_latencies(ld),
                                     dtype=float))
                for ld in self.loaders]
        if self.tenant_of_host is not None:
            # per-tenant QoS view over this window: the scheduler's own
            # section (share, cumulative egress, latency summary, admission
            # counters) plus windowed consumption stats from the driver
            sched = self.limiter.report()
            tenants: Dict[str, Dict] = {}
            for name in self.limiter.tenants:
                hosts = [i for i, t in enumerate(self.tenant_of_host)
                         if t == name]
                t_bytes = sum(per_client_bytes[i] for i in hosts)
                pulls = sum(self._host_pulls[i]
                            - counters0["host_pulls"][i] for i in hosts)
                hits = sum(self._host_hits[i]
                           - counters0["host_hits"][i] for i in hosts)
                stall = sum(self._host_stall_s[i]
                            - counters0["host_stall_s"][i] for i in hosts)
                entry = dict(sched[name])
                entry.update({
                    "hosts": hosts,
                    "egress_Bps": t_bytes / elapsed,
                    "hit_frac": hits / max(pulls, 1),
                    "stall_frac": stall / (elapsed * max(len(hosts), 1)),
                })
                tenants[name] = entry
            report["tenants"] = tenants
        if self.federation is not None:
            # break the window's egress out per member cluster; the WAN-bytes
            # share is the fraction served over WAN routes (federation
            # placement + routing exist to keep it pinned at the WAN
            # clusters' ownership share, not above it)
            per_cluster: Dict[str, int] = {s.name: 0
                                           for s in self.federation.specs}
            for name, delta in egress_delta.items():
                per_cluster[self.federation.cluster_of_node(name)] += delta
            total = max(sum(per_cluster.values()), 1)
            wan = self.federation.wan_clusters()
            report["per_cluster_egress_bytes"] = per_cluster
            report["per_cluster_egress_share"] = {
                c: v / total for c, v in per_cluster.items()}
            report["wan_bytes_share"] = sum(
                v for c, v in per_cluster.items() if c in wan) / total
            report["cluster_failovers"] = (
                sum(ld.pool.cluster_failovers for ld in self.loaders)
                - counters0["cluster_failovers"])
            report["cluster_report"] = self.federation.cluster_report()
            if self.federation.replication is not None:
                # hot-key replication over this window: fraction of fetches
                # served from a promoted replica, and the WAN bytes those
                # hits kept off the intercontinental route
                fetches = (sum(ld.pool.fetches for ld in self.loaders)
                           - counters0["fetches"])
                hits = (sum(ld.pool.replica_hits for ld in self.loaders)
                        - counters0["replica_hits"])
                report["replica_hit_frac"] = hits / max(fetches, 1)
                report["wan_bytes_saved"] = (
                    sum(ld.pool.wan_bytes_saved for ld in self.loaders)
                    - counters0["wan_bytes_saved"])
                report["replication"] = self.federation.replication.report()
            report["ownership_weights"] = \
                self.federation.routing_ring.weights
            report["rebalances"] = self.rebalances
        return report

    def _host_request_latencies(self, ld) -> List[float]:
        """One host's recent per-fetch RTTs, pulled from the limiter's
        completion rings (all member controllers under a federation)."""
        ctl = ld.flow_controller
        if ctl is None or self.limiter is None:
            return []
        members = (ctl.members.values()
                   if isinstance(ctl, FlowControllerGroup) else [ctl])
        out: List[float] = []
        for m in members:
            out.extend(self.limiter.latencies(m))
        return out

    # -- bandwidth-aware ownership rebalancing -------------------------------
    def rebalance(self, step: float = 0.25) -> Dict[str, int]:
        """Shift weighted keyspace ownership toward member clusters with
        spare bandwidth-delay product, as measured by every host's
        per-member flow controllers (``FlowController.spare_bdp_samples``).
        Emits — and installs — a new deterministic ownership map; returns
        its weight map.  The declared ring (and therefore placement strips
        and exactly-once accounting) is untouched: rebalancing only moves
        *serving* load, which is safe because the keyspace is shared.
        Requires a federation and ``flow_control="adaptive"`` (the signal
        comes from the controllers)."""
        if self.federation is None:
            raise ValueError("ownership rebalancing needs a federation "
                             "(set MultiHostConfig.clusters)")
        if self.cfg.flow_control != "adaptive":
            raise ValueError("ownership rebalancing needs "
                             "flow_control='adaptive' (the spare-BDP signal "
                             "comes from the flow controllers)")
        spare = {s.name: 0.0 for s in self.federation.specs}
        for ld in self.loaders:
            for name, val in ld.flow_controller.spare_by_member().items():
                spare[name] += val
        new_ring = self.federation.routing_ring.rebalance(spare, step=step)
        self.federation.install_ownership(new_ring)
        self.rebalances += 1
        return new_ring.weights

    # -- coordinated checkpointing ------------------------------------------
    def checkpoint(self) -> Dict:
        """Consistent snapshot: all shards are at the same batch boundary
        (guaranteed by the round-robin driver).  Restorable onto any host
        count — the recorded seed/placement/topology let the restore rebuild
        the old strips, and any still-pending reshard-transition overrides
        travel with their shard."""
        consumed = {ld.prefetcher.consumed for ld in self.loaders}
        if len(consumed) > 1:
            raise RuntimeError(f"shards out of lockstep: consumed={consumed}")
        shards = []
        for ld in self.loaders:
            s = dict(ld.state())
            pending = ld.plan.pending_overrides(s["epoch"])
            if pending:
                s["overrides"] = {int(e): [str(u) for u in samples]
                                  for e, samples in pending.items()}
            if ld.flow_controller is not None:
                s["flow"] = ld.flow_controller.snapshot()
            shards.append(s)
        ck = {
            "rounds": self.rounds_consumed,
            "num_shards": self.cfg.n_hosts,
            "dataset_size": len(self._uuids),
            "seed": self.cfg.seed,
            "placement": self.cfg.placement,
            "sampling": self.cfg.sampling,
            "n_nodes": self.cfg.n_nodes,
            "node_names": self.cluster.node_names(),
            "ring_seed": self.cluster.ring_seed,
            "replication_factor": self.cfg.replication_factor,
            "shards": shards,
        }
        if self.cfg.sampling == "zipf":
            ck["zipf_s"] = self.cfg.zipf_s
            if self.cfg.zipf_shift_every is not None:
                ck["zipf_shift_every"] = self.cfg.zipf_shift_every
        if "zipf" in self._host_sampling and self.cfg.sampling != "zipf":
            # mixed workload: the per-host sampling map (and per-host zipf
            # exponents) decide restore exactness, see _start_zipf
            ck["host_sampling"] = list(self._host_sampling)
            ck["host_zipf_s"] = list(self._host_zipf_s)
            if self.cfg.zipf_shift_every is not None:
                ck["zipf_shift_every"] = self.cfg.zipf_shift_every
        if self.tenant_of_host is not None:
            ck["tenant_of_host"] = list(self.tenant_of_host)
            ck["tenants"] = self.limiter.snapshot()
        if self.federation is not None:
            ck["federation"] = self.federation.ring.metadata()
            # runtime placement state rides along: the rebalanced ownership
            # map (when one is installed) and the hot-key replica cache —
            # both cluster-side, so they restore onto any host count
            if self.federation.routing_ring is not self.federation.ring:
                ck["ownership"] = self.federation.routing_ring.metadata()
            if self.federation.replication is not None:
                ck["replication"] = self.federation.replication.snapshot()
        return ck

    # -- introspection -------------------------------------------------------
    def shard_sizes(self) -> List[int]:
        return [len(ld.plan) for ld in self.loaders]

    def describe(self) -> str:
        tenants = ""
        if self.cfg.tenants:
            tenants = " [tenants: " + ", ".join(
                f"{t.name}({t.qos}, w={t.weight:g})"
                for t in self.cfg.tenants) + "]"
        if self.federation is not None:
            members = ", ".join(
                f"{s.name}({s.n_nodes}x{s.backend}, rf={s.replication_factor},"
                f" {s.route if isinstance(s.route, str) else s.route_profile().name}"
                " route)" for s in self.federation.specs)
            return (f"{self.cfg.n_hosts} hosts x B={self.cfg.batch_size} "
                    f"-> federation [{members}] "
                    f"({self.cfg.placement} placement){tenants}")
        return (f"{self.cfg.n_hosts} hosts x B={self.cfg.batch_size} "
                f"-> {self.cfg.n_nodes}-node {self.cfg.backend} "
                f"(rf={self.cfg.replication_factor}, {self.cfg.route} route, "
                f"{self.cfg.placement} placement){tenants}")


def _steady_strips(uuids: List[_uuid.UUID], seed: int, n_hosts: int,
                   policy: str, ring=None, rf: int = 1,
                   preferred=None) -> List[List[_uuid.UUID]]:
    """One strip per host of the global shuffle, per placement policy — the
    single strip-builder both fresh runs and checkpoint reconstruction use,
    so the two can never drift."""
    return split_strips(global_order(uuids, seed, n_hosts), n_hosts, policy,
                        ring=ring, rf=rf, preferred=preferred)


def _parse_overrides(overrides: Dict) -> Dict[int, List[_uuid.UUID]]:
    """Checkpoint override lists back to UUID objects (keys may be str)."""
    return {int(e): [u if isinstance(u, _uuid.UUID) else _uuid.UUID(u)
                     for u in samples]
            for e, samples in overrides.items()}


__all__ = ["MultiHostConfig", "MultiHostRun"]
