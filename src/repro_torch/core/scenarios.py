"""Declarative experiment scenarios: routes x schedules x workload x mode.

The time-varying route machinery (``netsim.RouteSchedule`` /
``RouteProfile.schedules``) turns "the network degraded mid-epoch" from a
hand-written test fixture into data.  This module goes one step further and
makes the whole *experiment* data: a ``Scenario`` is a frozen, JSON-round-
trippable description of one network condition — base route parameters, the
schedules and outage windows laid over them, the consumer workload (tight
loop or paced training steps) and the run length — and the benchmark matrix
(``benchmarks/bench_scenarios.py``) is just ``SCENARIOS x MODES``.

Modes compare three ways of choosing the prefetch in-flight budget on the
same scenario:

* ``static-<k>``  — the paper's fixed depth ``k`` (no knowledge of time);
* ``adaptive``    — the BDP-tracking ``FlowController`` (measures, so it
  re-converges when the route moves; see ``core/flowctl.py``);
* ``oracle``      — ``OracleDepthController``: reads the *scenario itself*
  and sets depth from the analytic schedule-aware BDP at every fill
  (``netsim.route_bdp_samples`` at the current clock), depth 1 inside an
  outage window.  It knows the future; nothing real can.  It is the
  yardstick the adaptive controller is judged against, and the bar no
  fixed depth clears on every scenario.

The headline assertion of the matrix benchmark: adaptive holds
``>= oracle/1.5`` throughput on *every* cell with zero per-scenario tuning,
while every fixed depth falls below that bound on at least one dynamic
scenario — under-buffered after a latency spike multiplies the BDP, or
pointlessly deep when the route shrinks under it.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass, replace
from typing import Dict, List, Optional, Tuple

from .flowctl import FlowControlConfig
from .loader import CassandraLoader, LoaderConfig
from .netsim import (CASSANDRA, RouteProfile, RouteSchedule, SCYLLA,
                     route_bdp_samples)
from .prefetcher import PrefetchConfig, make_prefetcher

# The flow-control modes of one matrix row.  The static sweep spans the
# useful depth range on the scenario base route: 2 is near the static BDP,
# 32 is deep over-provisioning.
STATIC_SWEEP: Tuple[int, ...] = (2, 8, 32)
MODES: Tuple[str, ...] = tuple(f"static-{k}" for k in STATIC_SWEEP) \
    + ("adaptive", "oracle")


@dataclass(frozen=True)
class Scenario:
    """One cell-row of the matrix: a network condition plus a workload.

    Everything is a plain value — ``to_dict``/``from_dict`` round-trip
    through JSON, so a scenario can live in a config file or a results
    artifact as easily as in this registry.  The base route is deliberately
    scaled *down* from the paper tiers (tens of MB/s per connection, 150 ms
    RTT) so a full matrix runs in CI: what matters is the ratio between the
    bandwidth-delay product and the prefetch depth, not absolute rates.
    """

    name: str
    description: str = ""
    # -- base route (static part) -------------------------------------------
    rtt: float = 0.15                  # s; WAN-ish so BDP spans batches
    conn_capacity: float = 30e6        # bytes/s per TCP stream
    loss_per_byte: float = 1e-11       # low: AIMD noise would blur ratios
    # -- time-varying part ----------------------------------------------------
    schedules: Tuple[RouteSchedule, ...] = ()
    outages: Tuple[Tuple[float, float], ...] = ()
    # -- workload -------------------------------------------------------------
    workload: str = "tight"            # "tight" | "paced"
    step_time: float = 0.05            # paced: per-batch consumer compute, s
    n_batches: int = 160
    batch_size: int = 128
    io_threads: int = 4                # x2 connections
    backend: str = "scylla"
    # -- controller sizing ----------------------------------------------------
    # Short dynamic runs need short filter horizons: the min-RTT window must
    # expire a pre-degradation minimum within seconds or the budget stays
    # pinned to the old route (exactly the failure mode the windowed
    # filters exist to fix — see FlowControlConfig.rtt_window).  But both
    # horizons must also clear the *worst* RTT any schedule produces: a
    # PROBE_RTT interval shorter than one post-spike round trip would keep
    # the controller in permanent drain.
    rtt_window: float = 8.0
    probe_rtt_interval: float = 12.0
    # One completed min-RTT bucket whose floor sits regime_factor above the
    # filter minimum is already unambiguous at these run lengths (a bucket
    # is 2 s of samples); the conservative default of 2 exists for noisy
    # production-scale windows, not for a 30-60 s scenario.
    regime_buckets: int = 1
    # The backoff threshold is load-aware (inflation x expected self-RTT,
    # see FlowControlConfig.rtt_inflation), so the transfer-heavy scenario
    # routes work at the stock default; the knob stays declarative here so
    # a scenario *can* pick a twitchier or laxer controller.
    rtt_inflation: float = 2.0
    ceiling_batches: int = 128

    def __post_init__(self) -> None:
        if self.workload not in ("tight", "paced"):
            raise ValueError(f"unknown workload {self.workload!r} "
                             f"(choose tight | paced)")
        if not isinstance(self.schedules, tuple):
            object.__setattr__(self, "schedules", tuple(self.schedules))
        if not isinstance(self.outages, tuple):
            object.__setattr__(self, "outages",
                               tuple((float(s), float(d))
                                     for s, d in self.outages))

    @property
    def dynamic(self) -> bool:
        return bool(self.schedules or self.outages)

    def route(self) -> RouteProfile:
        return RouteProfile(f"scn/{self.name}", rtt=self.rtt,
                            conn_capacity=self.conn_capacity,
                            loss_per_byte=self.loss_per_byte,
                            schedules=self.schedules, outages=self.outages)

    def flow(self) -> FlowControlConfig:
        return FlowControlConfig(rtt_window=self.rtt_window,
                                 probe_rtt_interval=self.probe_rtt_interval,
                                 rtt_inflation=self.rtt_inflation,
                                 regime_buckets=self.regime_buckets,
                                 ceiling_batches=self.ceiling_batches)

    def backend_model(self):
        return CASSANDRA if self.backend == "cassandra" else SCYLLA

    # -- declarative round-trip ----------------------------------------------
    def to_dict(self) -> Dict:
        d = asdict(self)
        d["schedules"] = [asdict(s) for s in self.schedules]
        d["outages"] = [list(o) for o in self.outages]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Scenario":
        d = dict(d)
        d["schedules"] = tuple(RouteSchedule(**s) if isinstance(s, dict)
                               else s for s in d.get("schedules", ()))
        d["outages"] = tuple((float(s), float(dur))
                             for s, dur in d.get("outages", ()))
        return cls(**d)


class OracleDepthController:
    """Schedule-aware analytic depth: the controller that read the config.

    Duck-types the one method the prefetcher consults
    (``depth(batch_size)``); no samples are fed to it — the depth is
    recomputed from first principles at every fill, from the scenario's own
    schedules evaluated at the current clock:

        depth(t) = clamp(ceil(gain * BDP_samples(t) / B), 1, ceiling)

    with ``BDP_samples(t)`` = ``netsim.route_bdp_samples(..., t=t)`` (the
    same analytic yardstick the flow-control tests use, with the schedule
    multipliers applied at ``t``) and depth pinned to 1 inside an outage
    window — a down link has no BDP worth buffering for.  ``gain`` matches
    the adaptive controller's headroom factor so the two modes aim at the
    same operating point and differ only in *how they know* the BDP.
    """

    def __init__(self, clock, route: RouteProfile, n_conns: int,
                 sample_bytes: float, backend=None, gain: float = 1.75,
                 ceiling_batches: int = 128, batch_size: int = 128) -> None:
        self._clock = clock
        self.route = route
        self.n_conns = n_conns
        self.sample_bytes = sample_bytes
        self.backend = backend
        self.gain = gain
        self.ceiling_batches = ceiling_batches
        self.batch_size = batch_size

    def depth(self, batch_size: Optional[int] = None) -> int:
        B = batch_size or self.batch_size
        t = self._clock.now()
        if self.route.down_at(t):
            return 1
        bdp = route_bdp_samples(self.route, self.n_conns, self.sample_bytes,
                                self.backend, t=t)
        return max(1, min(self.ceiling_batches,
                          math.ceil(self.gain * bdp / B)))


def run_cell(store, uuids, sc: Scenario, mode: str, seed: int = 2) -> Dict:
    """Run one (scenario, mode) cell; returns its metrics.

    Every mode consumes the same ``sc.n_batches`` batches over the same
    route object on a virtual clock, so throughput ratios reduce to
    sim-time ratios and the comparison is deterministic.
    """
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} (choose from {MODES})")
    route = sc.route()
    static_k = int(mode.split("-", 1)[1]) if mode.startswith("static-") else 8
    cfg = LoaderConfig(
        batch_size=sc.batch_size, prefetch_buffers=static_k,
        io_threads=sc.io_threads, route=route, backend=sc.backend,
        seed=seed, virtual_clock=True,
        flow_control="adaptive" if mode == "adaptive" else "static",
        flow=sc.flow() if mode == "adaptive" else None)
    ld = CassandraLoader(store, uuids, cfg)
    if mode == "oracle":
        sample_bytes = store.total_bytes() / max(len(uuids), 1)
        oc = OracleDepthController(
            ld.clock, route, n_conns=sc.io_threads * cfg.conns_per_thread,
            sample_bytes=sample_bytes, backend=sc.backend_model(),
            gain=sc.flow().gain, ceiling_batches=sc.ceiling_batches,
            batch_size=sc.batch_size)
        pcfg = PrefetchConfig(batch_size=sc.batch_size,
                              num_buffers=static_k, out_of_order=True)
        ld.prefetcher = make_prefetcher(ld.clock, ld.pool, ld.plan, pcfg,
                                        controller=oc)
    ld.start()
    for _ in range(sc.n_batches):
        ld.next_batch(timeout=3000.0)
        if sc.workload == "paced":
            ld.clock.sleep(sc.step_time)
    out = {
        "MBps": ld.stats.throughput(skip=2) / 1e6,
        "t_end_s": ld.clock.now(),
        "failovers": ld.pool.failovers,
    }
    if ld.flow_controller is not None:
        rep = ld.flow_controller.report()
        out.update(steady_depth=rep["depth_batches"],
                   min_rtt_s=rep["min_rtt_s"],
                   backoffs=rep["backoffs"],
                   regime_shifts=rep["regime_shifts"])
    return out


# ---------------------------------------------------------------------------
# The registry: one named scenario per network condition the matrix covers.
# ---------------------------------------------------------------------------

def _scn(*args, **kw) -> Scenario:
    return Scenario(*args, **kw)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    # Static control cell: no schedules at all — the pre-refactor network.
    # Keeps the matrix honest (adaptive must also win nothing here) and
    # regression-guards the static fast path.
    _scn("steady", "static base route, no time variation",
         n_batches=120),
    # Bandwidth collapses to a quarter mid-run and stays there (congested
    # peering, throttled tenant).  The BDP *shrinks*: the adaptive
    # controller's expiring max-rate filter must let the old rate go
    # instead of budgeting for a pipe that no longer exists.
    _scn("bw_step", "bandwidth x0.25 step at t=3s, permanent",
         schedules=(RouteSchedule("bandwidth", "step", factor=0.25, at=3.0),),
         workload="paced", step_time=0.04, n_batches=140),
    # RTT jumps x32 at t=2s (severe WAN reroute).  The BDP multiplies to
    # ~72 batches: every fixed depth under-buffers (even depth 32 delivers
    # about half of what the pipe can carry), and a min-RTT filter that
    # never expired its pre-spike minimum would pin the adaptive budget to
    # the old route.  This is the cell that kills every static depth.
    _scn("lat_spike", "latency x32 step at t=2s, permanent",
         schedules=(RouteSchedule("latency", "step", factor=32.0, at=2.0),),
         n_batches=400),
    # Slow congestion onset: latency ramps up x8 over [2s, 8s] and holds —
    # the gradual version of lat_spike; re-convergence must track a moving
    # target, not just a single step edge.
    _scn("lat_ramp", "latency ramp to x8 over [2s, 8s], holds",
         schedules=(RouteSchedule("latency", "ramp", factor=8.0, at=2.0,
                                  until=8.0),),
         n_batches=360),
    # Diurnal-style oscillation: bandwidth swings +-50% with a 6 s period
    # (fast-forwarded day/night).  Nothing converges once and rests; the
    # budget has to breathe with the route.
    _scn("diurnal", "bandwidth sinusoid, amplitude 0.5, period 6s",
         schedules=(RouteSchedule("bandwidth", "sinusoid", amplitude=0.5,
                                  period=6.0),),
         n_batches=170),
    # A 1 s hard outage at t=4s: every in-flight request fails and retries.
    # Tests recovery, not steady state — the oracle drops to depth 1 for
    # the window (buffering for a dead link is pointless), everyone eats
    # the same dead second, and the adaptive controller must come back
    # without being pinned by outage-era RTT garbage.
    _scn("outage_flash", "1s full route outage at t=4s",
         outages=((4.0, 1.0),),
         n_batches=160),
    # Random-walk wander (full matrix only — slowest to simulate): the
    # bandwidth multiplier exp-random-walks with sigma 0.35 per 0.5 s
    # step, seeded, so the run is still deterministic.
    _scn("rwalk", "seeded bandwidth random walk, sigma 0.35 per 0.5s",
         schedules=(RouteSchedule("bandwidth", "random_walk", sigma=0.35,
                                  interval=0.5, seed=7),),
         n_batches=170),
)}

# The quick matrix drops the random walk (it needs the longest run to be
# interesting) — CI runs 6 scenarios x 5 modes.
QUICK_MATRIX: Tuple[str, ...] = ("steady", "bw_step", "lat_spike",
                                 "lat_ramp", "diurnal", "outage_flash")
FULL_MATRIX: Tuple[str, ...] = QUICK_MATRIX + ("rwalk",)


def matrix(quick: bool = False) -> List[Scenario]:
    names = QUICK_MATRIX if quick else FULL_MATRIX
    out = []
    for n in names:
        sc = SCENARIOS[n]
        # full mode doubles the run length: ratios sharpen as the dynamic
        # tail dominates the shared pre-event prefix
        out.append(sc if quick else replace(sc, n_batches=sc.n_batches * 2))
    return out


__all__ = ["Scenario", "SCENARIOS", "QUICK_MATRIX", "FULL_MATRIX", "MODES",
           "STATIC_SWEEP", "OracleDepthController", "run_cell", "matrix"]
