"""Multi-tenant weighted-fair QoS: tenant specs, scheduling, admission.

A production federation serving "millions of users" (ROADMAP north star)
multiplexes many concurrent jobs — latency-sensitive serve-style decode
streams next to throughput batch scans — over the same client NICs, and
cloud-storage contention between such tenants is exactly where throughput
and tail latency collapse (Krichevsky et al., arxiv 2108.06322).
:class:`repro.core.flowctl.SharedIngressLimiter` splits that NIC equally
*per host* with no notion of tenant, priority, or starvation; this module
generalizes it:

* :class:`TenantSpec` — a declarative tenant: QoS class (``latency`` |
  ``batch``), weight, optional rate floor/ceiling in bytes/s, and the
  tenant's workload shape (``uniform``, or the PR-5 ``zipf`` machinery as
  the adversarial batch tenant).
* :class:`TenantScheduler` — a deficit-round-robin-style weighted-fair
  split of the NIC among tenants *with demand*, enforced the same way the
  base limiter enforces its equal split: as a cap on each member
  controller's budget (``fair_cap_samples``), so adaptive flow control and
  QoS compose instead of fight.  Plus tenant-level admission control
  (``admit``), consulted by ``ConnectionPool.admit`` on the PR-6
  route-admission deferral path.

Scheduling invariants (property-tested in ``tests/test_tenancy.py``):

* **conservation** — granted shares never sum above the NIC bandwidth;
* **weighted fairness** — backlogged tenants without floors/ceilings split
  the NIC in proportion to their weights;
* **work conservation** — an idle tenant's share (and the slice a capped
  or low-demand tenant cannot use) is fully redistributed over the tenants
  that still have demand, never stranded;
* **no starvation** — a tenant holding a ``rate_floor`` is granted at
  least that floor whenever it has demand, no matter how heavy an
  adversarial tenant's weight or workload is.

A single tenant with default weights degenerates to exactly the untenanted
limiter: the water-fill grants it the whole NIC (same floats as
``bandwidth / n_active``), demand caps are skipped when no other tenant
could use the surplus, and admission always passes — the bit-identity
regression in ``tests/test_tenancy.py`` pins this.
"""

from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .flowctl import FlowController, SharedIngressLimiter
from .replication import SAMPLING_MODES
from .stats import summarize

QOS_CLASSES = ("latency", "batch")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant sharing the federation: QoS class, scheduling weight,
    optional absolute rate floor/ceiling (bytes/s), and workload shape.

    ``qos`` steers admission (``latency`` tenants get burst headroom so a
    short serve-style burst rides through; ``batch`` tenants defer strictly
    at their share) and groups the per-tenant report sections.  ``weight``
    sets the proportional share of NIC bandwidth left after floors.
    ``sampling``/``zipf_s`` describe the tenant's access pattern — hosts
    tagged with a ``zipf`` tenant run the PR-5 skewed sampler, which is how
    the aggressive batch tenant of the isolation bench is expressed."""

    name: str
    qos: str = "batch"
    weight: float = 1.0
    rate_floor: Optional[float] = None      # guaranteed bytes/s under load
    rate_ceiling: Optional[float] = None    # hard cap, bytes/s
    sampling: str = "uniform"
    zipf_s: float = 1.05

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("a tenant needs a non-empty name")
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"unknown qos class {self.qos!r} "
                             f"(choose from {QOS_CLASSES})")
        if self.weight <= 0.0:
            raise ValueError(f"tenant weight must be positive, "
                             f"got {self.weight}")
        if self.rate_floor is not None and self.rate_floor <= 0.0:
            raise ValueError(f"rate_floor must be positive, "
                             f"got {self.rate_floor}")
        if self.rate_ceiling is not None and self.rate_ceiling <= 0.0:
            raise ValueError(f"rate_ceiling must be positive, "
                             f"got {self.rate_ceiling}")
        if (self.rate_floor is not None and self.rate_ceiling is not None
                and self.rate_ceiling < self.rate_floor):
            raise ValueError(f"rate_ceiling ({self.rate_ceiling}) below "
                             f"rate_floor ({self.rate_floor})")
        if self.sampling not in SAMPLING_MODES:
            raise ValueError(f"unknown sampling mode {self.sampling!r} "
                             f"(choose from {SAMPLING_MODES})")
        if self.zipf_s <= 0.0:
            raise ValueError(f"zipf_s must be positive, got {self.zipf_s}")


class TenantScheduler(SharedIngressLimiter):
    """Weighted-fair NIC shares per tenant, enforced through budget caps.

    Member controllers (one per host route, or one per federation member
    under a :class:`~repro.core.flowctl.FlowControllerGroup`) are
    ``assign``-ed to tenants.  ``tenant_shares`` runs a DRR-style water-
    fill: rate floors come off the top, the remainder is split by weight,
    and a tenant closes out early at its ``rate_ceiling`` or at its
    *measured demand* (delivery rate plus growth headroom) — its unused
    slice re-enters the fill for the still-open tenants, which is what
    makes the split work-conserving.  ``fair_cap_samples`` then divides a
    tenant's share equally among its active members and converts to a BDP
    cap exactly like the base limiter.

    ``admit`` adds tenant-level admission on top of the per-route budget:
    a new request is deferred when the tenant's measured in-flight load
    already covers its share's BDP (``latency`` tenants get
    ``latency_burst`` headroom).  It is advisory like the rest of the
    admission chain — the prefetcher defers boundedly and force-issues, so
    delivery is never dropped (see ``OutOfOrderPrefetcher``).
    """

    _TENANT_RING = 65536        # recent request latencies kept per tenant

    def __init__(self, bandwidth: float, tenants: Sequence[TenantSpec],
                 clock=None, activity_window: float = 1.0,
                 latency_burst: float = 1.25,
                 demand_headroom: float = 1.5) -> None:
        super().__init__(bandwidth, clock=clock,
                         activity_window=activity_window)
        specs: Tuple[TenantSpec, ...] = tuple(tenants)
        if not specs:
            raise ValueError("a tenant scheduler needs at least one tenant")
        names = [t.name for t in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")
        floors = sum(t.rate_floor or 0.0 for t in specs)
        if floors > bandwidth:
            raise ValueError(f"rate floors oversubscribe the NIC "
                             f"({floors:.4g} > {bandwidth:.4g} B/s)")
        if latency_burst < 1.0:
            raise ValueError(f"latency_burst must be >= 1, "
                             f"got {latency_burst}")
        if demand_headroom <= 1.0:
            raise ValueError(f"demand_headroom must be > 1, "
                             f"got {demand_headroom}")
        self.specs = specs
        self.tenants: Dict[str, TenantSpec] = {t.name: t for t in specs}
        self.latency_burst = latency_burst
        self.demand_headroom = demand_headroom
        self._default_tenant = specs[0].name
        self._tenant_of: Dict[FlowController, str] = {}
        self._tenant_bytes: Dict[str, int] = {n: 0 for n in names}
        self._tenant_completions: Dict[str, int] = {n: 0 for n in names}
        self._tenant_latency: Dict[str, Deque[float]] = {
            n: deque(maxlen=self._TENANT_RING) for n in names}
        self.admit_checks: Dict[str, int] = {n: 0 for n in names}
        self.admit_denials: Dict[str, int] = {n: 0 for n in names}
        # water-fill memo: the split only moves when virtual time advances
        # or a completion/registration lands, and the admission path asks
        # for it once per would-be fetch — without the memo a deferring
        # tenant recomputes an identical split thousands of times per round
        self._events = 0
        self._shares_cache: Optional[Tuple[tuple, Dict[str, float]]] = None
        # admission memo: at a fixed instant with no new completions or
        # issues, the verdict for one asking controller cannot change, but
        # the prefetcher re-asks once per deferred key per fill slot — a
        # deferral storm makes that thousands of identical computations
        self._admit_cache: Dict[str, Tuple[tuple, bool]] = {}

    # -- membership ---------------------------------------------------------
    def register(self, ctl: FlowController) -> None:
        super().register(ctl)
        self._tenant_of.setdefault(ctl, self._default_tenant)
        self._events += 1

    def assign(self, ctl: FlowController, tenant: str) -> None:
        """Tag a controller with its tenant (``MultiHostRun`` calls this for
        each host's controller — or each group member — after wiring)."""
        if tenant not in self.tenants:
            raise ValueError(f"unknown tenant {tenant!r} "
                             f"(have {sorted(self.tenants)})")
        super().register(ctl)
        self._tenant_of[ctl] = tenant
        self._events += 1

    def note_issue(self) -> None:
        """A member pool issued a fetch: in-flight EMAs moved, so cached
        admission verdicts (and shares, conservatively) are stale."""
        self._events += 1

    def tenant_of(self, ctl: FlowController) -> Optional[str]:
        return self._tenant_of.get(ctl)

    def _members_of(self, name: str, now: float,
                    include: Optional[FlowController] = None,
                    ) -> List[FlowController]:
        """A tenant's *active* members (same activity rule as the base
        limiter, scoped to the tenant)."""
        out = [c for c in self._members
               if self._tenant_of.get(c) == name
               and (c not in self._last_seen
                    or now - self._last_seen[c] <= self.activity_window)]
        if (include is not None and include not in out
                and self._tenant_of.get(include) == name):
            out.append(include)
        return out

    # -- bookkeeping --------------------------------------------------------
    def on_complete(self, ctl: FlowController, rtt: float, now: float,
                    nbytes: int) -> None:
        super().on_complete(ctl, rtt, now, nbytes)
        self._events += 1
        name = self._tenant_of.get(ctl)
        if name is not None:
            self._tenant_bytes[name] += nbytes
            self._tenant_completions[name] += 1
            self._tenant_latency[name].append(rtt)

    # -- the weighted-fair split --------------------------------------------
    def _demand_cap(self, spec: TenantSpec,
                    members: List[FlowController]) -> Optional[float]:
        """Measured demand of a tenant (bytes/s) padded with growth
        headroom, floored at its ``rate_floor``.  ``None`` = unbounded: a
        member without a rate sample yet is still ramping and must be
        allowed to probe past any measurement."""
        total = 0.0
        for m in members:
            rate = m.delivery_rate()
            avg = m.avg_sample_bytes()
            if rate is None or avg is None:
                return None
            total += rate * avg
        return max(total * self.demand_headroom, spec.rate_floor or 0.0)

    def tenant_shares(self, now: Optional[float] = None,
                      include: Optional[FlowController] = None,
                      ) -> Dict[str, float]:
        """Work-conserving weighted-fair split of the NIC among tenants
        with demand (bytes/s per active tenant; idle tenants get nothing —
        their slice is redistributed).  Floors come off the top; the
        remainder water-fills by weight, closing a tenant out at its
        ceiling or measured demand and re-filling the surplus."""
        if now is None:
            now = self._now()
        # memo: same instant + no new events + same asking tenant => same
        # split (rates/activity are functions of time and completions only)
        key = (now, self._events,
               self._tenant_of.get(include) if include is not None else None)
        if self._shares_cache is not None and self._shares_cache[0] == key:
            return dict(self._shares_cache[1])
        active_members = {name: self._members_of(name, now, include)
                          for name in self.tenants}
        active = [self.tenants[n]
                  for n, ms in active_members.items() if ms]
        if not active:
            return {}
        grant = {t.name: 0.0 for t in active}
        remaining = self.bandwidth
        # 1. rate floors off the top (ctor validates they fit the NIC)
        for t in active:
            f = min(t.rate_floor or 0.0, remaining)
            grant[t.name] += f
            remaining -= f
        # 2. per-tenant close-out caps.  Demand caps exist so another
        # tenant can use the surplus — with a single active tenant there is
        # no beneficiary, and skipping them keeps the lone-tenant grant
        # bit-identical to the untenanted limiter's full-NIC share.
        caps: Dict[str, Optional[float]] = {}
        for t in active:
            cap = t.rate_ceiling
            if len(active) > 1:
                demand = self._demand_cap(t, active_members[t.name])
                if demand is not None:
                    cap = demand if cap is None else min(cap, demand)
            caps[t.name] = cap
        # 3. DRR-style water-fill of the remainder by weight
        todo = list(active)
        while todo and remaining > 1e-9:
            wsum = sum(t.weight for t in todo)
            closed = [t for t in todo
                      if caps[t.name] is not None
                      and grant[t.name] + remaining * t.weight / wsum
                      >= caps[t.name]]
            if not closed:
                for t in todo:
                    grant[t.name] += remaining * t.weight / wsum
                break
            for t in closed:
                extra = min(max(caps[t.name] - grant[t.name], 0.0),
                            remaining)
                grant[t.name] += extra
                remaining -= extra
                todo.remove(t)
        self._shares_cache = (key, dict(grant))
        return grant

    def fair_cap_samples(self, ctl: FlowController) -> float:
        min_rtt = ctl.min_rtt()
        avg = ctl.avg_sample_bytes()
        if min_rtt is None or avg is None:
            return math.inf
        name = self._tenant_of.get(ctl)
        if name is None:                    # unassigned: equal-split fallback
            return super().fair_cap_samples(ctl)
        now = self._now()
        shares = self.tenant_shares(now, include=ctl)
        members = self._members_of(name, now, include=ctl)
        share = shares.get(name, 0.0) / max(len(members), 1)
        return ctl.cfg.gain * (share / avg) * min_rtt

    # -- admission ----------------------------------------------------------
    def admit(self, ctl: FlowController) -> bool:
        """May this tenant put one more request in flight?  Compares the
        tenant's measured in-flight load (sum of member EMAs) against the
        BDP of its granted share; ``latency`` tenants ride ``latency_burst``
        headroom, ``batch`` tenants defer right at their share."""
        name = self._tenant_of.get(ctl)
        if name is None:
            return True
        self.admit_checks[name] += 1
        now = self._now()
        # the verdict is a function of (time, completions/issues seen,
        # asking controller) — ``note_issue`` bumps ``_events`` so an
        # in-fill issue invalidates this like a completion would
        key = (now, self._events, id(ctl))
        hit = self._admit_cache.get(name)
        if hit is not None and hit[0] == key:
            ok = hit[1]
        else:
            ok = self._admit_verdict(name, ctl, now)
            self._admit_cache[name] = (key, ok)
        if not ok:
            self.admit_denials[name] += 1
        return ok

    def _admit_verdict(self, name: str, ctl: FlowController,
                       now: float) -> bool:
        members = self._members_of(name, now, include=ctl)
        cap = 0.0
        for m in members:
            c = self.fair_cap_samples(m)
            if math.isinf(c):
                return True                 # still unmeasured: let it ramp
            cap += c
        load = sum(m.inflight_samples() for m in members)
        burst = (self.latency_burst
                 if self.tenants[name].qos == "latency" else 1.0)
        return load < burst * cap

    # -- reporting / checkpoint ---------------------------------------------
    def report(self) -> Dict:
        """Per-tenant scheduling view: current share, cumulative egress,
        request-latency summary over the recent ring, admission counters."""
        now = self._now()
        shares = self.tenant_shares(now)
        out: Dict[str, Dict] = {}
        for name, spec in self.tenants.items():
            lat = np.asarray(self._tenant_latency[name], dtype=float)
            out[name] = {
                "qos": spec.qos,
                "weight": spec.weight,
                "rate_floor": spec.rate_floor,
                "rate_ceiling": spec.rate_ceiling,
                "active_members": len(self._members_of(name, now)),
                "share_Bps": shares.get(name, 0.0),
                "egress_bytes": self._tenant_bytes[name],
                "completions": self._tenant_completions[name],
                "request_latency_s": summarize(lat),
                "admit_checks": self.admit_checks[name],
                "admit_denials": self.admit_denials[name],
            }
        return out

    def snapshot(self) -> Dict:
        """Checkpoint state: specs ride along so an elastic N->M restore can
        assert weight conservation, counters re-seed the cumulative
        per-tenant totals."""
        return {"bandwidth": self.bandwidth,
                "tenants": {name: {
                    "qos": spec.qos,
                    "weight": spec.weight,
                    "rate_floor": spec.rate_floor,
                    "rate_ceiling": spec.rate_ceiling,
                    "egress_bytes": self._tenant_bytes[name],
                    "completions": self._tenant_completions[name],
                    "admit_checks": self.admit_checks[name],
                    "admit_denials": self.admit_denials[name],
                } for name, spec in self.tenants.items()}}

    def restore(self, state: Optional[Dict]) -> None:
        if not state:
            return
        for name, s in (state.get("tenants") or {}).items():
            if name not in self.tenants:
                continue        # tenant dropped from the config: state moot
            self._tenant_bytes[name] = int(s.get("egress_bytes", 0))
            self._tenant_completions[name] = int(s.get("completions", 0))
            self.admit_checks[name] = int(s.get("admit_checks", 0))
            self.admit_denials[name] = int(s.get("admit_denials", 0))


__all__ = ["QOS_CLASSES", "TenantSpec", "TenantScheduler"]
