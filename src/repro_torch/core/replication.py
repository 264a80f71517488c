"""Hot-key cross-cluster replication: runtime data-placement for skew.

The federation layer (``core/federation.py``) serves every key from its
*home* cluster — the one the weighted ownership map assigns it to.  Under the
uniform per-epoch sampling of ordinary training that is fine: load spreads
over every member in proportion to its weight.  Under a *skewed* access
distribution (feature-store reads, curriculum re-sampling, preemptible
multi-tenant consumers replaying hot shards — the non-uniform workloads the
loader-landscape survey shows collapsing throughput) a handful of hot keys
pin their home cluster's replica nodes and, when that home sits behind the
intercontinental route, the WAN becomes the whole run's bottleneck.  This
module is the repo's first layer that *mutates placement at runtime*:

``HotKeyTracker``
    Space-saving top-k counters (Metwally et al.) over the access stream —
    memory stays O(k) no matter how many distinct keys flow past — each
    tracked key carrying windowed access counts aggregated through the
    shared :func:`repro.core.stats.windowed_series` helper, so "hot" means a
    *recent rate*, not an all-time count, and keys cool off when the skew
    moves.

``ReplicaCache``
    The set of keys currently replicated off their home cluster, with the
    member cluster each replica lives on and the key *version* it was copied
    at.  Entries go live only when the promotion copy lands
    (``begin_promotion`` / ``commit_promotion``); write-through invalidation
    (``FederatedCluster.write_through``) drops them, and a version check at
    serve time blocks the race where a read starts between a write and its
    invalidation — a replica never serves a stale version (property-tested
    across cluster-outage injection in ``tests/test_replication.py``).

``Replication``
    The bundle a ``FederatedCluster`` attaches: one tracker + one cache +
    promotion accounting, shared by every host's
    ``FederatedConnectionPool`` (hotness is a property of the workload, not
    of one host).  Snapshots ride the multi-host checkpoint and restore
    across elastic N->M resizes unchanged — the cache is cluster-side state,
    independent of the host count.

``ZipfPlan``
    The skewed-access workload class itself: a drop-in ``EpochPlan``
    duck-type whose per-epoch "permutation" is a seeded Zipf(s) sample
    *with replacement* over the global key list, identical ranks on every
    host (hot keys are globally hot).  Exactly-once per epoch deliberately
    does NOT hold for this plan — sampling with replacement is the point —
    so elastic restores of a Zipf run resume at the epoch boundary without
    reflow (there is no delivery set to preserve).  Epoch length matches the
    host's uniform strip so lockstep batch accounting is unchanged.

Ownership *rebalancing* — the other half of runtime placement — lives on
``FederatedRing.rebalance`` (``core/federation.py``), fed by the flow
controllers' spare bandwidth-delay product (``core/flowctl.py``): clusters
whose measured budget exceeds their measured in-flight load have WAN
headroom, and the ring shifts weighted ownership toward them while staying a
deterministic, checkpoint-serializable map.
"""

from __future__ import annotations

import math
import uuid as _uuid
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .placement import global_order, strip_bounds
from .stats import windowed_series


@dataclass(frozen=True)
class ReplicationConfig:
    """Knobs of hot-key promotion (defaults sized for benchmark scale)."""

    track_k: int = 128          # space-saving counters: memory is O(track_k)
    window: float = 2.0         # access-rate horizon, seconds
    hot_rate: float = 4.0       # accesses/s over a window bucket => hot
    min_count: int = 8          # total observed accesses before promotion
    capacity: int = 512         # max keys replicated at once (LRU eviction)
    # Serving fan-out on the target cluster: a hot key is cached on this
    # many of the region cluster's nodes (0 = all of them), so its traffic
    # spreads instead of re-concentrating on an rf-sized replica set — the
    # point of promoting is that a handful of keys saturating two nodes'
    # NICs becomes k keys spread over the whole region cluster.
    replica_rf: int = 0
    # Hotset-shift demotion: a live replica whose key has cooled below the
    # hot threshold AND not served a read for this many seconds is dropped
    # (``ReplicaCache.demote_cold``), freeing capacity for the keys the
    # workload moved on to — instead of waiting for LRU eviction pressure,
    # which only fires once the cache is full.  None = never demote.
    demote_after: Optional[float] = None

    def __post_init__(self) -> None:
        if self.replica_rf < 0:
            raise ValueError(f"replica_rf must be >= 0, "
                             f"got {self.replica_rf}")
        if self.demote_after is not None and self.demote_after <= 0.0:
            raise ValueError(f"demote_after must be positive, "
                             f"got {self.demote_after}")
        if self.track_k < 1:
            raise ValueError(f"track_k must be >= 1, got {self.track_k}")
        if self.window <= 0.0:
            raise ValueError(f"window must be positive, got {self.window}")
        if self.hot_rate <= 0.0:
            raise ValueError(f"hot_rate must be positive, "
                             f"got {self.hot_rate}")
        if self.min_count < 1:
            raise ValueError(f"min_count must be >= 1, got {self.min_count}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


class _KeyStat:
    """One space-saving counter: total count, over-estimate error, and
    bucketed access timestamps for the windowed rate."""

    __slots__ = ("count", "error", "buckets")

    def __init__(self, count: int, error: int) -> None:
        self.count = count
        self.error = error
        # [bucket_start, accesses] aggregates, newest last — the same
        # bounded-deque shape the flow controller's rate filter uses.
        self.buckets: Deque[List[float]] = deque()


class HotKeyTracker:
    """Windowed top-k access tracker with O(k) memory.

    Space-saving semantics: a tracked key's count only grows; an untracked
    key evicts the minimum counter and inherits its count as ``error`` (the
    classic over-estimate bound).  Hotness is judged on the *windowed* rate —
    the max bucket of :func:`repro.core.stats.windowed_series` over the last
    ``cfg.window`` seconds — so a key that was hot an epoch ago and went
    quiet stops qualifying.
    """

    def __init__(self, cfg: ReplicationConfig, clock) -> None:
        self.cfg = cfg
        self._clock = clock
        self._stats: Dict[_uuid.UUID, _KeyStat] = {}
        self._bucket_width = cfg.window / 4.0
        self.recorded = 0

    def __len__(self) -> int:
        return len(self._stats)

    # -- intake -------------------------------------------------------------
    def record(self, key: _uuid.UUID) -> None:
        self.recorded += 1
        now = self._clock.now()
        st = self._stats.get(key)
        if st is None:
            if len(self._stats) < self.cfg.track_k:
                st = _KeyStat(count=1, error=0)
            else:
                # evict the minimum counter (deterministic tie-break on the
                # key's int — no per-entry string allocation: under a skewed
                # workload most accesses are cold-tail misses, so this scan
                # runs per fetch); the newcomer inherits its count + 1
                victim = min(self._stats,
                             key=lambda k: (self._stats[k].count, k.int))
                floor = self._stats.pop(victim).count
                st = _KeyStat(count=floor + 1, error=floor)
            self._stats[key] = st
        else:
            st.count += 1
        w = self._bucket_width
        b = math.floor(now / w) * w
        if st.buckets and st.buckets[-1][0] == b:
            st.buckets[-1][1] += 1.0
        else:
            st.buckets.append([b, 1.0])
            horizon = b - self.cfg.window
            while st.buckets[0][0] < horizon:
                st.buckets.popleft()

    # -- queries ------------------------------------------------------------
    def rate(self, key: _uuid.UUID) -> float:
        """Peak windowed access rate (accesses/s) over the horizon."""
        st = self._stats.get(key)
        if st is None:
            return 0.0
        now = self._clock.now()
        events = [(t, n) for t, n in st.buckets
                  if t >= now - self.cfg.window]
        if not events:
            return 0.0
        series = windowed_series(events, self._bucket_width,
                                 start=events[0][0])
        return max(r for _, r in series)

    def is_hot(self, key: _uuid.UUID) -> bool:
        st = self._stats.get(key)
        if st is None or st.count - st.error < self.cfg.min_count:
            return False
        return self.rate(key) >= self.cfg.hot_rate

    def top(self, n: int = 10) -> List[Tuple[_uuid.UUID, int, float]]:
        """(key, count, windowed rate), hottest first — report material."""
        ranked = sorted(self._stats,
                        key=lambda k: (-self._stats[k].count, str(k)))
        return [(k, self._stats[k].count, self.rate(k)) for k in ranked[:n]]

    # -- checkpoint ---------------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        return {str(k): st.count for k, st in self._stats.items()}

    def restore(self, state: Optional[Dict[str, int]]) -> None:
        """Re-seed the counts (rates restart cold: windowed buckets are
        meaningless across a restore's time discontinuity)."""
        if not state:
            return
        for k, count in state.items():
            key = _uuid.UUID(k)
            st = self._stats.get(key)
            if st is None:
                self._stats[key] = _KeyStat(count=int(count), error=0)
            else:
                st.count = max(st.count, int(count))
        # keep the space-saving bound across merged snapshots
        while len(self._stats) > self.cfg.track_k:
            victim = min(self._stats,
                         key=lambda k: (self._stats[k].count, k.int))
            del self._stats[victim]


@dataclass
class ReplicaEntry:
    """One replicated key: where its copy lives and what version it holds."""

    cluster: str
    version: int
    live: bool = False          # False while the promotion copy is in flight
    token: int = 0              # reservation id: stale copy callbacks no-op
    last_hit: float = 0.0
    hits: int = 0


class ReplicaCache:
    """Keys currently replicated off their home cluster (capacity-bounded).

    The cache is *routing* state: an entry says "cluster X holds a copy of
    key U at version V".  Serving checks the version against the keyspace's
    current one, so an invalidation lost to a race still cannot produce a
    stale read — the entry is dropped and the fetch falls through to the
    home cluster.
    """

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: Dict[_uuid.UUID, ReplicaEntry] = {}
        self.hits = 0
        self.misses = 0
        self.stale_blocked = 0
        self.promotions = 0         # copies committed (entry went live)
        self.invalidations = 0
        self.evictions = 0
        self.demotions = 0          # live entries dropped on hotset shift
        self._next_token = 1

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: _uuid.UUID) -> Optional[ReplicaEntry]:
        return self._entries.get(key)

    def keys(self) -> List[_uuid.UUID]:
        return list(self._entries.keys())

    # -- serving ------------------------------------------------------------
    def serving_cluster(self, key: _uuid.UUID, version: int, now: float,
                        usable=None) -> Optional[str]:
        """Cluster holding a *live, current-version* replica of ``key``, or
        None.  A version mismatch (write raced the read) blocks the entry
        and drops it — never a stale read.  ``usable(cluster) -> bool``
        lets the caller veto an unreachable replica cluster (outage)
        without consuming a hit or refreshing the entry's LRU recency —
        the entry itself survives, still valid for when the cluster
        returns."""
        e = self._entries.get(key)
        if e is None or not e.live:
            self.misses += 1
            return None
        if e.version != version:
            self.stale_blocked += 1
            del self._entries[key]
            return None
        if usable is not None and not usable(e.cluster):
            self.misses += 1
            return None
        e.last_hit = now
        e.hits += 1
        self.hits += 1
        return e.cluster

    # -- promotion lifecycle -------------------------------------------------
    def begin_promotion(self, key: _uuid.UUID, cluster: str, version: int,
                        now: float) -> Optional[int]:
        """Reserve an entry for ``key`` (copy in flight): returns the
        reservation token the copy's completion must present, or None when
        the key is already cached/promoting or no live entry can be
        evicted.  The token makes a copy whose reservation was invalidated
        and re-issued mid-flight unable to commit (or release) the newer
        reservation."""
        if key in self._entries:
            return None
        if len(self._entries) >= self.capacity:
            live = [k for k, e in self._entries.items() if e.live]
            if not live:
                return None             # everything in flight: back off
            coldest = min(live, key=lambda k: (self._entries[k].last_hit,
                                               str(k)))
            del self._entries[coldest]
            self.evictions += 1
        token = self._next_token
        self._next_token += 1
        self._entries[key] = ReplicaEntry(cluster=cluster, version=version,
                                          token=token, last_hit=now)
        return token

    def commit_promotion(self, key: _uuid.UUID, token: int) -> None:
        """The copy landed: the entry starts serving.  A no-op when the
        reservation was invalidated (or evicted and re-issued) while the
        copy was in flight."""
        e = self._entries.get(key)
        if e is not None and not e.live and e.token == token:
            e.live = True
            self.promotions += 1

    def release(self, key: _uuid.UUID, token: int) -> None:
        """Abort a reservation (promotion copy failed); token-guarded like
        :meth:`commit_promotion`."""
        e = self._entries.get(key)
        if e is not None and not e.live and e.token == token:
            del self._entries[key]

    def invalidate(self, key: _uuid.UUID) -> bool:
        """Write-through hook: drop the replica (live or in-flight)."""
        if key in self._entries:
            del self._entries[key]
            self.invalidations += 1
            return True
        return False

    def demote_cold(self, now: float, is_hot, demote_after: float) -> int:
        """Drop live replicas the hotset has moved away from: entries whose
        key is no longer hot (``is_hot(key)`` — the tracker's windowed
        judgment) and whose last served read is older than ``demote_after``.
        In-flight promotions are never touched (their commit callback still
        owns the reservation token).  Dropping an entry is always safe for
        consistency — the next access just falls through to the home
        cluster — so demotion can only reclaim capacity, never introduce a
        stale read.  Returns the number demoted."""
        cold = [k for k, e in self._entries.items()
                if e.live and now - e.last_hit >= demote_after
                and not is_hot(k)]
        for k in cold:
            del self._entries[k]
        self.demotions += len(cold)
        return len(cold)

    # -- checkpoint ---------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Live entries only — an in-flight copy does not survive a restore
        (its completion callback dies with the old simulator)."""
        return {str(k): {"cluster": e.cluster, "version": e.version,
                         "hits": e.hits}
                for k, e in self._entries.items() if e.live}

    def restore(self, state: Optional[Dict[str, Dict]]) -> None:
        if not state:
            return
        for k, e in state.items():
            if len(self._entries) >= self.capacity:
                break
            self._entries[_uuid.UUID(k)] = ReplicaEntry(
                cluster=e["cluster"], version=int(e["version"]), live=True,
                hits=int(e.get("hits", 0)))


class Replication:
    """Tracker + cache + promotion accounting for one federation.

    Attached via ``FederatedCluster.attach_replication`` and shared by every
    host's pool: accesses aggregate across hosts (a key is hot because the
    *workload* hammers it) and a promotion by one host serves them all.
    """

    def __init__(self, cfg: ReplicationConfig, clock) -> None:
        self.cfg = cfg
        self.tracker = HotKeyTracker(cfg, clock)
        self.cache = ReplicaCache(cfg.capacity)
        self.promotion_wan_bytes = 0    # copy traffic (the cost of promotion)
        self.promotions_aborted = 0     # home cluster dark mid-copy

    def demote_cold(self, now: float) -> int:
        """Demote replicas the tracked hotset has shifted away from (no-op
        unless ``cfg.demote_after`` is set).  Called on the multi-host run's
        round cadence; any caller with a clock may invoke it directly."""
        if self.cfg.demote_after is None:
            return 0
        return self.cache.demote_cold(now, self.tracker.is_hot,
                                      self.cfg.demote_after)

    def report(self) -> Dict:
        c = self.cache
        return {
            "cached_keys": len(c),
            "tracked_keys": len(self.tracker),
            "hits": c.hits,
            "misses": c.misses,
            "stale_blocked": c.stale_blocked,
            "promotions": c.promotions,
            "promotions_aborted": self.promotions_aborted,
            "invalidations": c.invalidations,
            "evictions": c.evictions,
            "demotions": c.demotions,
            "promotion_wan_bytes": self.promotion_wan_bytes,
        }

    def snapshot(self) -> Dict:
        return {"tracker": self.tracker.snapshot(),
                "cache": self.cache.snapshot()}

    def restore(self, state: Optional[Dict]) -> None:
        if not state:
            return
        self.tracker.restore(state.get("tracker"))
        self.cache.restore(state.get("cache"))


class ZipfPlan:
    """Skewed-access plan: Zipf(s) sampling with replacement, EpochPlan
    duck-type.

    Rank r (0-based) of the seeded global shuffle gets probability
    proportional to ``1/(r+1)**s`` — every host uses the *same* rank->key
    map, seeded by the seed ALONE (not ``(seed, num_shards)`` like the
    uniform strips): the skew must survive an elastic N->M resize, so hot
    keys stay the same keys and a restored replica cache keeps serving
    them.  Each shard draws its own sample stream over that shared map.
    ``epoch_length`` equals the host's uniform strip size, keeping lockstep
    round/batch accounting identical to the uniform plans.

    Exactly-once per epoch does NOT hold here (with-replacement sampling is
    the workload).  Consequently elastic restores resume at an epoch
    boundary without reflow, and per-epoch overrides are rejected.

    ``shift_every`` models a *moving* hotset (curriculum phases, tenant
    churn): every ``shift_every`` epochs the rank->key map rotates by a
    fixed stride larger than any tracked top-k, so the previous hot keys go
    cold and a disjoint set becomes hot — the workload that exercises
    replica demotion (``ReplicaCache.demote_cold``).  The rotation is a
    pure function of ``(seed, epoch)``, so it is deterministic, identical
    on every host, and survives elastic resizes like the base map does.
    """

    def __init__(self, uuids: List[_uuid.UUID], seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 s: float = 1.05, shift_every: Optional[int] = None) -> None:
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"bad shard spec {shard_id}/{num_shards}")
        if s <= 0.0:
            raise ValueError(f"zipf exponent must be positive, got {s}")
        if not uuids:
            raise ValueError("ZipfPlan needs a non-empty dataset")
        if shift_every is not None and shift_every < 1:
            raise ValueError(f"shift_every must be >= 1, got {shift_every}")
        self._uuids = global_order(uuids, seed, 1)   # resize-invariant map
        self._seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.s = s
        self.shift_every = shift_every
        # golden-ratio-conjugate stride: consecutive rotations land far
        # apart, so hotsets stay disjoint for many shifts before wrapping
        self._shift_stride = max(1, int(round(len(self._uuids) * 0.381966)))
        lo, hi = strip_bounds(len(uuids), num_shards)[shard_id]
        self._epoch_len = hi - lo
        if self._epoch_len == 0:
            raise ValueError("ZipfPlan shard is empty — more shards than "
                             "samples")
        ranks = np.arange(1, len(self._uuids) + 1, dtype=np.float64)
        p = ranks ** -s
        self._p = p / p.sum()

    def __len__(self) -> int:
        return self._epoch_len

    def epoch_length(self, epoch: int) -> int:
        return self._epoch_len

    # -- EpochPlan surface ---------------------------------------------------
    def permutation(self, epoch: int) -> List[_uuid.UUID]:
        rng = np.random.default_rng((self._seed, self.shard_id, epoch))
        idx = rng.choice(len(self._uuids), size=self._epoch_len, p=self._p)
        if self.shift_every:
            n = len(self._uuids)
            offset = (epoch // self.shift_every) * self._shift_stride % n
            if offset:
                return [self._uuids[(i + offset) % n] for i in idx]
        return [self._uuids[i] for i in idx]

    def iter_from(self, epoch: int, cursor: int):
        e = epoch
        while True:
            perm = self.permutation(e)
            for i in range(cursor, len(perm)):
                yield e, perm[i]
            cursor = 0
            e += 1

    def advance(self, epoch: int, cursor: int, n_samples: int = 0) -> tuple:
        if cursor < 0:
            raise ValueError(f"negative cursor {cursor}")
        c = cursor + n_samples
        return epoch + c // self._epoch_len, c % self._epoch_len

    def install_overrides(self, overrides: Dict) -> None:
        raise ValueError("Zipf plans sample with replacement — there is no "
                         "exactly-once delivery set to reflow, so per-epoch "
                         "overrides are meaningless here")

    def pending_overrides(self, from_epoch: int) -> Dict:
        return {}


SAMPLING_MODES = ("uniform", "zipf")

__all__ = ["ReplicationConfig", "HotKeyTracker", "ReplicaCache",
           "ReplicaEntry", "Replication", "ZipfPlan", "SAMPLING_MODES"]
