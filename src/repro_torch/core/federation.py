"""Multi-cluster federation: one training run spanning several storage
clusters over heterogeneous WAN routes.

The paper's headline result is sustaining training throughput when the image
store sits behind a high-latency route (local vs medium vs intercontinental,
Sec. 4.2).  This module models the next step on that axis: a *single* run
whose dataset is spread across N storage clusters — each with its own token
ring, node set, replication factor and WAN route — so data can live in the
region where it was produced.

Pieces, bottom up:

``ClusterSpec``
    Declarative description of one member cluster: name, route tier (a
    ``netsim.TIERS`` key or a ``RouteProfile``), backend, node count,
    replication factor, ownership ``weight`` and per-node bandwidths.

``FederatedRing``
    The keyspace-level routing object.  Every uuid belongs to exactly one
    member cluster — the dataset->cluster *ownership map*, computed
    deterministically from the key's token and the members' weights — and
    ``replicas(key)`` returns only the owning cluster's replica nodes,
    qualified as ``"<cluster>/<node>"``.  Because it quacks like a
    ``TokenRing``, the existing ``split_token_aware`` placement runs over it
    unchanged and becomes *cluster-aware*: prefer the key's same-region
    cluster, then a replica-local node within it.  A ring can be rebuilt
    from checkpoint metadata alone (``FederatedRing.from_metadata``), so
    elastic restores never need the original simulator objects.

``FederatedCluster``
    Composes N ``Cluster`` instances behind one keyspace (one shared
    ``KVStore``: the logical contents are global; per-node simulation state —
    disk, NIC egress, GC — stays per cluster, so routing decisions have
    performance consequences).  Duck-types the slice of the ``Cluster``
    surface that ``MultiHostRun`` consumes (``nodes``, ``ring``, ``rf``,
    ``node_names``, ``load_report``, ``schedule_failure``...), plus
    cluster-level failure injection (``schedule_cluster_outage``) and a
    cluster-of-node reverse map for per-cluster egress accounting.

``FederatedConnectionPool``
    One *per-cluster* ``ConnectionPool`` per member — each with the member's
    own ``RouteProfile`` and AIMD processes, all sharing one client-ingress
    NIC (a host has one NIC no matter how many clusters it talks to).
    ``fetch`` routes each key to its owning cluster; when that cluster has
    no live node (cluster-level outage), or when every connection to it has
    failed mid-flight, the request *degrades* to the next cluster in
    failover order — possible because the keyspace is shared, exactly the
    replica-cluster degradation the federation benchmark exercises.  A
    once-guard keeps delivery exactly-once even when a hedge and a
    cross-cluster failover race.

Runtime placement (this PR's layer, see ``core/replication.py``):

* **Hot-key replication** — ``attach_replication`` gives the federation a
  shared ``HotKeyTracker`` + ``ReplicaCache``; every pool records accesses,
  serves live same-version replicas from the host's *region* cluster before
  the home cluster, and promotes hot off-region keys with a real WAN copy
  (home replica node disk+egress plus the home route's RTT and transfer
  time).  ``write_through`` bumps the key's version and invalidates its
  replica, so a stale copy can never serve.
* **Bandwidth-aware rebalancing** — ``FederatedRing.rebalance`` emits a new
  deterministic ownership map shifted toward members with spare
  bandwidth-delay product (measured by the flow controllers,
  ``FlowController.spare_bdp_samples``); ``install_ownership`` swaps it in
  as the *routing* ring while the declared ring keeps defining placement
  strips, and checkpoints carry both.

Exactly-once per epoch is a *plan* property (``EpochPlan`` strips are
disjoint and jointly covering; see ``core/prefetcher.py``), not a routing
one — so it holds across the federation, through cluster outages, elastic
N->M resizes, replica serving and ownership rebalances, without this module
doing anything special.
"""

from __future__ import annotations

import uuid as _uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .cluster import Cluster, TokenRing
from .connection import ConnectionPool
from .flowctl import (FlowControlConfig, FlowControllerGroup,
                      SharedIngressLimiter)
from .kvstore import DataRow, KVStore, MetaRow, token_of
from .netsim import (DISK_BANDWIDTH, NIC_BANDWIDTH, Clock, RateResource,
                     RouteProfile, TIERS)
from .placement import preferred_node_subsets
from .replication import Replication, ReplicationConfig

# A route is "WAN" when its RTT clears this threshold — separates the paper's
# local/low tiers (same building / same region) from med/high (cross-region /
# intercontinental) for the wan_bytes_share accounting.
WAN_RTT_THRESHOLD = 0.005


@dataclass(frozen=True)
class ClusterSpec:
    """One member cluster of a federation."""

    name: str
    route: str | RouteProfile = "local"  # TIERS key or explicit profile
    backend: str = "scylla"
    n_nodes: int = 4
    replication_factor: int = 2
    weight: int = 1                      # ownership share of the keyspace
    node_egress_bandwidth: float = NIC_BANDWIDTH
    node_disk_bandwidth: float = DISK_BANDWIDTH

    def route_profile(self) -> RouteProfile:
        return TIERS[self.route] if isinstance(self.route, str) else self.route

    @property
    def is_wan(self) -> bool:
        return self.route_profile().rtt > WAN_RTT_THRESHOLD


class FederatedRing:
    """Keyspace-level ring: per-cluster token rings + weighted ownership.

    ``owner_of(key)`` maps a key's token onto the member clusters by
    cumulative weight (md5 tokens are uniform, so shares converge to the
    weights); ``replicas(key)`` walks only the owning cluster's ring with
    that cluster's replication factor.  Both are pure functions of
    ``metadata()``, which is what checkpoints record.
    """

    def __init__(self, names: Sequence[str], rings: Dict[str, TokenRing],
                 rfs: Dict[str, int], weights: Dict[str, int],
                 ring_seeds: Dict[str, int],
                 n_nodes: Dict[str, int]) -> None:
        if not names:
            raise ValueError("a federation needs at least one cluster")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate cluster names in {list(names)}")
        if any(weights[n] < 1 for n in names):
            raise ValueError("cluster ownership weights must be >= 1")
        self.names = list(names)
        self._rings = rings
        self._rfs = rfs
        self._weights = weights
        self._ring_seeds = ring_seeds
        self._n_nodes = n_nodes
        self._total_weight = sum(weights[n] for n in names)
        self._cum: List[Tuple[int, str]] = []
        acc = 0
        for n in names:
            acc += weights[n]
            self._cum.append((acc, n))

    @classmethod
    def from_clusters(cls, specs: Sequence[ClusterSpec],
                      clusters: Dict[str, Cluster]) -> "FederatedRing":
        names = [s.name for s in specs]
        return cls(names,
                   rings={s.name: clusters[s.name].ring for s in specs},
                   rfs={s.name: clusters[s.name].rf for s in specs},
                   weights={s.name: s.weight for s in specs},
                   ring_seeds={s.name: clusters[s.name].ring_seed
                               for s in specs},
                   n_nodes={s.name: s.n_nodes for s in specs})

    @classmethod
    def from_metadata(cls, meta: Sequence[Dict]) -> "FederatedRing":
        """Rebuild the ring from checkpoint metadata (see :meth:`metadata`) —
        strips are deterministic functions of it, so elastic restores can
        reconstruct an old federation's sharding without its simulator."""
        names = [m["name"] for m in meta]
        rings = {m["name"]: TokenRing(
            [f"{m['name']}/node{i}" for i in range(m["n_nodes"])],
            seed=m["ring_seed"]) for m in meta}
        return cls(names, rings,
                   rfs={m["name"]: m["rf"] for m in meta},
                   weights={m["name"]: m["weight"] for m in meta},
                   ring_seeds={m["name"]: m["ring_seed"] for m in meta},
                   n_nodes={m["name"]: m["n_nodes"] for m in meta})

    def metadata(self) -> List[Dict]:
        """Everything strip construction depends on, JSON-serializable."""
        return [{"name": n, "n_nodes": self._n_nodes[n],
                 "ring_seed": self._ring_seeds[n], "rf": self._rfs[n],
                 "weight": self._weights[n]} for n in self.names]

    @property
    def weights(self) -> Dict[str, int]:
        return dict(self._weights)

    # -- bandwidth-aware rebalancing -----------------------------------------
    # Rebalanced weights are expressed in finer grains than the declared
    # ones so a fractional ownership shift stays an integer weight map.
    REBALANCE_GRAIN = 16

    def rebalance(self, spare: Dict[str, float],
                  step: float = 0.25) -> "FederatedRing":
        """A new ring with ownership shifted toward spare capacity.

        ``spare`` is per-cluster spare bandwidth-delay product (samples of
        unused in-flight headroom, see ``FlowController.spare_bdp_samples``).
        The new weight map moves ``step`` of the total weight from the
        current shares toward the spare-BDP shares:

            w'[c] ∝ (1 - step) * w[c] + step * total * spare[c] / Σ spare

        rounded largest-remainder with deterministic (name-ordered) tie
        breaks, every weight clamped to >= 1, and the total conserved — so
        the result is a pure function of ``(weights, spare, step)``: two
        hosts computing it from the same inputs get byte-identical ownership
        maps, and ``metadata()`` checkpoints it exactly like the declared
        ring (property-tested in ``tests/test_replication.py``).  With no
        spare anywhere the ring is returned unchanged.
        """
        if not 0.0 <= step <= 1.0:
            raise ValueError(f"step must be in [0, 1], got {step}")
        s_total = sum(max(spare.get(n, 0.0), 0.0) for n in self.names)
        if step == 0.0 or s_total <= 0.0:
            return self
        grains = {n: self._weights[n] * self.REBALANCE_GRAIN
                  for n in self.names}
        total = sum(grains.values())
        targets = {n: ((1.0 - step) * grains[n]
                       + step * total * max(spare.get(n, 0.0), 0.0) / s_total)
                   for n in self.names}
        new = {n: max(1, int(targets[n])) for n in self.names}
        # largest-remainder distribution of the leftover grains, then — if
        # the >=1 clamp overshot — take grains back from the largest weights
        remainder = total - sum(new.values())
        order = sorted(self.names,
                       key=lambda n: (-(targets[n] - int(targets[n])), n))
        i = 0
        while remainder > 0:
            new[order[i % len(order)]] += 1
            remainder -= 1
            i += 1
        give_back = sorted(self.names, key=lambda n: (-new[n], n))
        i = 0
        while remainder < 0:
            n = give_back[i % len(give_back)]
            if new[n] > 1:
                new[n] -= 1
                remainder += 1
            i += 1
        return FederatedRing(self.names, self._rings, self._rfs, new,
                             self._ring_seeds, self._n_nodes)

    # -- ownership ----------------------------------------------------------
    def owner_of(self, key: _uuid.UUID) -> str:
        slot = token_of(key) % self._total_weight
        for acc, name in self._cum:
            if slot < acc:
                return name
        return self._cum[-1][1]          # unreachable; defensive

    def failover_order(self, owner: str) -> List[str]:
        """Owner first, then the remaining clusters in declaration order —
        the degradation path when a whole cluster goes dark."""
        return [owner] + [n for n in self.names if n != owner]

    # -- TokenRing surface ---------------------------------------------------
    def replicas(self, key: _uuid.UUID, rf: int = 0) -> List[str]:
        """Replica nodes of ``key`` *within its owning cluster* (qualified
        names).  ``rf`` is accepted for TokenRing compatibility but each
        cluster's own replication factor governs."""
        owner = self.owner_of(key)
        return self._rings[owner].replicas(key, self._rfs[owner])


def federated_preferred_subsets(node_names_by_cluster: Dict[str, List[str]],
                                n_hosts: int) -> List[Tuple[str, ...]]:
    """Per-host preference map spanning every member cluster.

    The union of per-cluster round-robin subsets
    (:func:`repro.core.placement.preferred_node_subsets`), so every host has
    a preferred node in every cluster that has one to give.  A flat
    round-robin over the concatenated node list would leave some hosts with
    no preferred node in some cluster whenever the host count doesn't divide
    the per-cluster node counts — and a host with no local preference in the
    intercontinental cluster would receive none of its keys in pass 1,
    skewing the WAN work onto the other hosts.
    """
    out: List[Tuple[str, ...]] = [() for _ in range(n_hosts)]
    for names in node_names_by_cluster.values():
        for j, subset in enumerate(preferred_node_subsets(names, n_hosts)):
            out[j] = out[j] + subset
    return out


class FederatedCluster:
    """N member ``Cluster`` instances behind one keyspace.

    Presents the ``Cluster`` surface ``MultiHostRun`` relies on (merged
    ``nodes`` dict with qualified names, a ``ring``, ``rf``,
    ``load_report()``, ``schedule_failure()``), plus federation-only
    operations: the ownership map, cluster-level outage injection, and
    per-cluster load/egress summaries.
    """

    def __init__(self, clock: Clock, store: KVStore,
                 specs: Sequence[ClusterSpec], seed: int = 1234) -> None:
        specs = tuple(specs)
        if not specs:
            raise ValueError("a federation needs at least one ClusterSpec")
        if len({s.name for s in specs}) != len(specs):
            raise ValueError("duplicate cluster names in federation")
        for s in specs:
            if "/" in s.name:
                raise ValueError(f"cluster name {s.name!r} may not contain "
                                 "'/' (reserved for node qualification)")
        self.clock = clock
        self.store = store
        self.specs = specs
        self.ring_seed = seed
        self.clusters: Dict[str, Cluster] = {
            s.name: Cluster(clock, store, backend=s.backend,
                            n_nodes=s.n_nodes, rf=s.replication_factor,
                            seed=seed + 101 * i,
                            disk_bandwidth=s.node_disk_bandwidth,
                            egress_bandwidth=s.node_egress_bandwidth,
                            node_prefix=f"{s.name}/")
            for i, s in enumerate(specs)
        }
        self.routes: Dict[str, RouteProfile] = {
            s.name: s.route_profile() for s in specs}
        # ``ring`` is the *declared* keyspace map — what placement strips are
        # derived from and what ``checkpoint["federation"]`` records.
        # ``routing_ring`` is what serving consults; it starts as the same
        # object and diverges when bandwidth-aware rebalancing installs a
        # shifted ownership map (checkpointed separately as "ownership").
        # The keyspace is shared, so routing off the declared map is always
        # safe — rebalance changes performance, never correctness.
        self.ring = FederatedRing.from_clusters(specs, self.clusters)
        self.routing_ring = self.ring
        # Hot-key replication (core/replication.py): attached on demand;
        # None keeps every fetch on its home cluster.
        self.replication: Optional[Replication] = None
        # Keyspace write versions: bumped by write_through so a replica
        # copied before a write can never serve after it (the cache checks).
        self._versions: Dict[_uuid.UUID, int] = {}

    # -- ownership / topology ------------------------------------------------
    def owner_of(self, key: _uuid.UUID) -> str:
        return self.routing_ring.owner_of(key)

    def install_ownership(self, ring: FederatedRing) -> None:
        """Swap in a rebalanced ownership map (same members, new weights).
        Replicas promoted under the old map stay valid — the cache pins the
        serving cluster per key, and version checks guard staleness."""
        if list(ring.names) != [s.name for s in self.specs]:
            raise ValueError(f"ownership map members {list(ring.names)} != "
                             f"federation members "
                             f"{[s.name for s in self.specs]}")
        self.routing_ring = ring

    def ownership_counts(self, uuids: Sequence[_uuid.UUID]) -> Dict[str, int]:
        counts = {s.name: 0 for s in self.specs}
        for u in uuids:
            counts[self.owner_of(u)] += 1
        return counts

    def serving_cluster(self, key: _uuid.UUID,
                        exclude: frozenset = frozenset()) -> Optional[str]:
        """First *live* cluster in the owner's failover order, skipping
        ``exclude``; ``None`` when every candidate is dark.  The single
        authority on degradation order — routing and mid-flight failover
        both go through here (keyspace is shared, so any member can serve
        any key)."""
        for name in self.routing_ring.failover_order(self.owner_of(key)):
            if name not in exclude and self.clusters[name].alive_nodes():
                return name
        return None

    # -- hot-key replication -------------------------------------------------
    def attach_replication(self,
                           cfg: Optional[ReplicationConfig] = None
                           ) -> Replication:
        """Switch hot-key replication on (idempotent): one shared tracker +
        replica cache for every host's pool (hotness is a workload property,
        and one host's promotion serves them all)."""
        if self.replication is None:
            self.replication = Replication(cfg or ReplicationConfig(),
                                           self.clock)
        return self.replication

    def version_of(self, key: _uuid.UUID) -> int:
        return self._versions.get(key, 0)

    def write_through(self, data: DataRow, meta: MetaRow) -> None:
        """Keyspace write: update the shared store, bump the key's version
        and invalidate any replica of it — write-through semantics, so the
        home cluster always has the new value and a stale copy can never be
        served (the version check catches even an invalidation lost to a
        concurrent promotion)."""
        self.store.insert_atomic(data, meta)
        self._versions[data.uuid] = self._versions.get(data.uuid, 0) + 1
        if self.replication is not None:
            self.replication.cache.invalidate(data.uuid)

    def promote(self, key: _uuid.UUID, on_done, on_abort) -> None:
        """Promotion copy of ``key``'s row out of its home cluster (the
        destination is pinned by the caller's ``ReplicaCache`` entry): one
        real WAN transfer — the home replica node serves the bytes (disk +
        egress load where the data lives) and the copy crosses the home
        cluster's route before the replica entry may go live.  ``on_abort``
        fires instead when no home replica node is up."""
        row = self.store.get_data(key)
        owner = self.owner_of(key)
        cl = self.clusters[owner]
        live = [n for n in cl.ring.replicas(key, cl.rf)
                if not cl.nodes[n].down]
        if not live:
            on_abort()
            return
        route = self.routes[owner]
        now = self.clock.now()
        t_leave = cl.nodes[live[0]].serve(now, row.size)
        delay = max(t_leave - now, 0.0) + route.rtt \
            + row.size / route.conn_capacity
        if self.replication is not None:
            self.replication.promotion_wan_bytes += row.size
        self.clock.schedule(delay, on_done)

    def cluster_of_node(self, qualified_name: str) -> str:
        return qualified_name.split("/", 1)[0]

    def node_names_by_cluster(self) -> Dict[str, List[str]]:
        return {s.name: self.clusters[s.name].node_names()
                for s in self.specs}

    def wan_clusters(self) -> frozenset:
        return frozenset(s.name for s in self.specs if s.is_wan)

    # -- Cluster-compatible surface -----------------------------------------
    @property
    def nodes(self) -> Dict:
        merged = {}
        for s in self.specs:
            merged.update(self.clusters[s.name].nodes)
        return merged

    @property
    def rf(self) -> int:
        # only consulted by TokenRing-compatible call sites; the federated
        # ring applies each member's own rf regardless.
        return max(self.clusters[s.name].rf for s in self.specs)

    def node_names(self) -> List[str]:
        return [n for s in self.specs
                for n in self.clusters[s.name].node_names()]

    def alive_nodes(self) -> List[str]:
        return [n for s in self.specs
                for n in self.clusters[s.name].alive_nodes()]

    def total_disk_bytes(self) -> int:
        return sum(self.clusters[s.name].total_disk_bytes()
                   for s in self.specs)

    # -- failure injection ---------------------------------------------------
    def schedule_failure(self, qualified_name: str, after: float,
                         recover_after: Optional[float] = None) -> None:
        cname = self.cluster_of_node(qualified_name)
        self.clusters[cname].schedule_failure(qualified_name, after,
                                              recover_after)

    def schedule_cluster_outage(self, name: str, after: float,
                                recover_after: Optional[float] = None) -> None:
        """Take a whole member cluster dark (region outage / WAN partition):
        every node fails at once, so reads degrade to the replica cluster."""
        for node in self.clusters[name].node_names():
            self.clusters[name].schedule_failure(node, after, recover_after)

    # -- load reporting -----------------------------------------------------
    def load_report(self) -> Dict[str, Dict[str, float]]:
        """Per-node report over qualified names (merged member reports)."""
        merged: Dict[str, Dict[str, float]] = {}
        for s in self.specs:
            merged.update(self.clusters[s.name].load_report())
        return merged

    def cluster_report(self) -> Dict[str, Dict[str, float]]:
        """Per-cluster rollup: egress, requests, route tier, liveness."""
        out: Dict[str, Dict[str, float]] = {}
        total_egress = max(sum(n.egress_bytes for n in self.nodes.values()), 1)
        for s in self.specs:
            cl = self.clusters[s.name]
            egress = sum(n.egress_bytes for n in cl.nodes.values())
            out[s.name] = {
                "route": s.route if isinstance(s.route, str)
                         else s.route_profile().name,
                "rtt": self.routes[s.name].rtt,
                "wan": float(s.is_wan),
                "egress_bytes": egress,
                "egress_share": egress / total_egress,
                "requests": sum(n.requests_served for n in cl.nodes.values()),
                "nodes_down": sum(1 for n in cl.nodes.values() if n.down),
                "n_nodes": s.n_nodes,
            }
        return out


class FederatedConnectionPool:
    """All connections of one training host to every member cluster.

    Mirrors the ``ConnectionPool`` surface the prefetcher and the multi-host
    coordinator consume (``fetch``, ``bytes_received``, ``requests_sent``,
    ``failovers``, ``served_by_node``, ``inflight``), aggregating over one
    sub-pool per member cluster.  Each sub-pool runs the member's own
    ``RouteProfile`` (own RTT, own AIMD bandwidth processes); all sub-pools
    share one client-ingress NIC.
    """

    def __init__(self, clock: Clock, federation: FederatedCluster,
                 io_threads: int = 8, conns_per_thread: int = 2,
                 seed: int = 99, hedge_after: Optional[float] = None,
                 materialize: bool = False,
                 client_ingress_bandwidth: float = NIC_BANDWIDTH,
                 preferred_nodes: Optional[Sequence[str]] = None,
                 region: Optional[str] = None,
                 wire_codec: "str | Dict[str, str] | None" = None,
                 io_scaling: bool = False) -> None:
        self.clock = clock
        self.federation = federation
        self.cluster = federation          # Cluster-surface alias
        self.ingress = RateResource("client/ingress",
                                    client_ingress_bandwidth)
        # This host's home region: hot keys are promoted into (and served
        # from) this member cluster.  Default: the member with the lowest
        # route RTT — the cluster "next to" the training hosts.
        if region is not None and region not in federation.clusters:
            raise ValueError(f"unknown region cluster {region!r} (members: "
                             f"{[s.name for s in federation.specs]})")
        self.region = region or min(
            federation.specs, key=lambda s: (s.route_profile().rtt, s.name)
        ).name
        self.cluster_failovers = 0         # fetches served off-owner
        self.duplicates_suppressed = 0     # late completions the once-guard ate
        self.replica_hedges = 0            # WAN fetches hedged onto a replica
        # completion-attributed replica accounting: hits and the fetch
        # denominator both count when a fetch *delivers*, so the hit
        # fraction compares like with like (a fetch routed to a replica but
        # diverted mid-flight counts as a completed fetch, not a hit)
        self.fetches = 0                   # completed fetches
        self.replica_hits = 0              # completions served by a replica
        self.wan_bytes_saved = 0           # replica hits whose home was WAN
        self.promotions_issued = 0         # promotion copies this host started
        # Adaptive flow control: one FlowController per member cluster (each
        # fed by that member's sub-pool over that member's route), summed
        # into the host budget by a FlowControllerGroup.
        self.controller: Optional[FlowControllerGroup] = None
        preferred = list(preferred_nodes or ())
        self.pools: Dict[str, ConnectionPool] = {}
        for i, spec in enumerate(federation.specs):
            # this host's preferred nodes *within* this member cluster
            prefix = f"{spec.name}/"
            local_pref = [n for n in preferred if n.startswith(prefix)]
            self.pools[spec.name] = ConnectionPool(
                clock, federation.clusters[spec.name],
                federation.routes[spec.name],
                io_threads=io_threads, conns_per_thread=conns_per_thread,
                seed=seed + 7919 * i, hedge_after=hedge_after,
                materialize=materialize,
                preferred_nodes=local_pref or None,
                ingress=self.ingress,
                on_exhausted=self._make_exhausted(spec.name),
                wire_codec=self._member_codec(wire_codec, spec),
                io_scaling=io_scaling)

    # WAN routes trade cheap node/host CPU for scarce intercontinental
    # bandwidth; sub-millisecond routes have nothing to buy.  ``"auto"``
    # draws the line at this RTT (core/wirefmt.py rationale).
    WAN_CODEC_RTT = 0.010
    AUTO_WAN_CODEC = "byteshuffle"

    def _member_codec(self, wire_codec, spec) -> Optional[str]:
        """Per-member codec: a dict maps member name -> codec, ``"auto"``
        compresses WAN members only, a plain name applies everywhere."""
        if wire_codec is None:
            return None
        if isinstance(wire_codec, dict):
            return wire_codec.get(spec.name, "none")
        if wire_codec == "auto":
            return (self.AUTO_WAN_CODEC
                    if spec.route_profile().rtt >= self.WAN_CODEC_RTT
                    else "none")
        return wire_codec

    def attach_flow_control(self, cfg: FlowControlConfig, batch_size: int,
                            limiter: Optional[SharedIngressLimiter] = None
                            ) -> FlowControllerGroup:
        """One BDP-tracking controller per member cluster — a 150 ms WAN
        member ramps deep while a local member stays shallow — summed into
        the host's in-flight budget.  Idempotent."""
        if self.controller is None:
            members = {}
            for name, pool in self.pools.items():
                ctl = pool.attach_flow_control(cfg, batch_size,
                                               limiter=limiter)
                ctl.name = name            # report by member, not route tier
                members[name] = ctl
            self.controller = FlowControllerGroup(members, batch_size)
        return self.controller

    # -- admission / routing helpers ----------------------------------------
    def _live_replica(self, key: _uuid.UUID,
                      exclude: frozenset = frozenset()) -> Optional[str]:
        """Cluster holding a live, current-version, *reachable* replica of
        ``key`` — without consuming a cache hit or refreshing LRU recency
        (advisory peeks must not distort the serving statistics)."""
        rep = self.federation.replication
        if rep is None:
            return None
        e = rep.cache.get(key)
        if (e is not None and e.live
                and e.version == self.federation.version_of(key)
                and e.cluster not in exclude
                and e.cluster in self.federation.clusters
                and self.federation.clusters[e.cluster].alive_nodes()):
            return e.cluster
        return None

    def _serving_member(self, key: _uuid.UUID) -> str:
        """The member cluster a fetch issued *now* would target: a live
        same-version replica first, then the owner's failover order."""
        cl = self._live_replica(key)
        if cl is not None:
            return cl
        return (self.federation.serving_cluster(key)
                or self.federation.owner_of(key))

    def admit(self, key: _uuid.UUID) -> bool:
        """Per-key route admission (``PrefetchConfig.route_admission``),
        resolved against the *serving member's* budget: a key whose home
        sits behind a saturated WAN member is deferred while a key served
        by the local member (or a local replica) is admitted — so issue
        order follows per-route headroom, not plan order.  Advisory, like
        the base pool's: the prefetcher defers bounded and force-issues."""
        return self.pools[self._serving_member(key)].admit(key)

    # -- fetch --------------------------------------------------------------
    def fetch(self, key: _uuid.UUID,
              on_done: Callable) -> None:
        """Route ``key``: a live same-version hot-key replica first (see
        ``core/replication.py``), then its owning cluster (degraded to a
        live replica cluster when the owner is dark).  Delivery is
        exactly-once even when a hedge in a dying cluster races a
        cross-cluster failover — replica-served fetches share the same
        once-guard and exhaustion path as owner-served ones.

        Replica-aware hedging: a fetch sent to a *WAN* member is hedged
        against a live local replica when one exists at hedge time — the
        window where a promotion lands while the WAN read is in flight.
        The hedge delay comes from the WAN member's own pool
        (``ConnectionPool._hedge_delay``: the configured constant, or the
        member controller's measured min-RTT under ``hedge_after="auto"``),
        and the once-guard arbitrates the race."""
        state = {"done": False}

        def once(res, replica_of=None) -> None:
            if state["done"]:
                self.duplicates_suppressed += 1
                return
            state["done"] = True
            self.fetches += 1
            if replica_of is not None and res.node is not None:
                # attribute at completion: a fetch *routed* to a replica but
                # diverted mid-flight (region outage -> exhausted -> home
                # cluster) must not be reported as a replica hit or a WAN
                # saving — the bytes crossed the WAN after all
                served = self.federation.cluster_of_node(res.node)
                if served == replica_of:
                    self.replica_hits += 1
                    if (self.federation.owner_of(key)
                            in self.federation.wan_clusters()
                            and served
                            not in self.federation.wan_clusters()):
                        self.wan_bytes_saved += res.size
            on_done(res)

        owner = self.federation.owner_of(key)
        rep = self.federation.replication
        if rep is not None:
            rep.tracker.record(key)
            # a dark replica cluster is vetoed without consuming the cache
            # hit (the entry survives — the outage path must not
            # mass-invalidate a still-valid cache)
            cached = rep.cache.serving_cluster(
                key, self.federation.version_of(key), self.clock.now(),
                usable=lambda c: (c in self.federation.clusters
                                  and self.federation.clusters[c]
                                  .alive_nodes()))
            if cached is not None:
                # replica serving fans out across the target cluster
                # (cfg.replica_rf nodes, 0 = all), so hot traffic spreads
                # instead of re-pinning an rf-sized node set
                rf = (rep.cfg.replica_rf
                      or len(self.federation.clusters[cached].nodes))
                self.pools[cached].fetch(
                    key, lambda res: once(res, replica_of=cached), rf=rf)
                return
            self._maybe_promote(key, owner, rep)
        # total blackout: keep targeting the owner, whose pool backs off and
        # retries (so a recovering cluster is picked up automatically)
        target = self.federation.serving_cluster(key) or owner
        if target != owner:
            self.cluster_failovers += 1
        self.pools[target].fetch(key, once)

        # replica-aware hedge: the replica is checked at *fire* time, so a
        # promotion that lands while the WAN read is in flight gets used
        if rep is not None and target in self.federation.wan_clusters():
            delay = self.pools[target]._hedge_delay()
            if delay is not None:
                def maybe_replica_hedge() -> None:
                    if state["done"]:
                        return
                    cl = self._live_replica(key,
                                            exclude=frozenset((target,)))
                    if cl is None:
                        return
                    self.replica_hedges += 1
                    ctl = self.pools[target].controller
                    if ctl is not None:
                        ctl.on_hedge()   # the WAN member is the slow one
                    rf = (rep.cfg.replica_rf
                          or len(self.federation.clusters[cl].nodes))
                    self.pools[cl].fetch(
                        key, lambda res: once(res, replica_of=cl), rf=rf)

                self.clock.schedule(delay, maybe_replica_hedge)

    def _maybe_promote(self, key: _uuid.UUID, owner: str, rep) -> None:
        """Start a promotion copy when ``key`` is hot, lives off-region, and
        the cache takes the reservation.  The entry serves only after the
        WAN copy lands (``FederatedCluster.promote``); an abort (home
        cluster dark) releases the reservation."""
        if owner == self.region or not rep.tracker.is_hot(key):
            return
        if not self.federation.clusters[self.region].alive_nodes():
            return
        version = self.federation.version_of(key)
        token = rep.cache.begin_promotion(key, self.region, version,
                                          self.clock.now())
        if token is None:
            return
        self.promotions_issued += 1

        def landed() -> None:
            rep.cache.commit_promotion(key, token)

        def aborted() -> None:
            rep.promotions_aborted += 1
            rep.cache.release(key, token)

        self.federation.promote(key, on_done=landed, on_abort=aborted)

    def _make_exhausted(self, cname: str):
        """Cluster-level failover: when every connection to ``cname`` has
        failed for a request, hand it to the next live cluster.  Returns
        False (keep backing off in place) when no other cluster is alive,
        so a total blackout still surfaces as the caller's timeout and a
        recovering cluster is picked up automatically."""
        def handler(key: _uuid.UUID, on_done: Callable) -> bool:
            target = self.federation.serving_cluster(
                key, exclude=frozenset((cname,)))
            if target is None:
                return False
            if target != self.federation.owner_of(key):
                self.cluster_failovers += 1
            self.pools[target].fetch(key, on_done)
            return True
        return handler

    # -- aggregated counters (ConnectionPool surface) ------------------------
    @property
    def bytes_received(self) -> int:
        return sum(p.bytes_received for p in self.pools.values())

    @property
    def payload_bytes_received(self) -> int:
        return sum(p.payload_bytes_received for p in self.pools.values())

    @property
    def requests_sent(self) -> int:
        return sum(p.requests_sent for p in self.pools.values())

    @property
    def failovers(self) -> int:
        return sum(p.failovers for p in self.pools.values())

    @property
    def served_by_node(self) -> Dict[str, int]:
        merged: Dict[str, int] = {}
        for p in self.pools.values():
            for name, count in p.served_by_node.items():
                merged[name] = merged.get(name, 0) + count
        return merged

    @property
    def inflight(self) -> int:
        return sum(p.inflight for p in self.pools.values())

    def throughput_traces(self, window: float = 0.5):
        return {name: p.throughput_traces(window)
                for name, p in self.pools.items()}


__all__ = ["ClusterSpec", "FederatedRing", "FederatedCluster",
           "FederatedConnectionPool", "federated_preferred_subsets",
           "WAN_RTT_THRESHOLD", "Replication", "ReplicationConfig"]
