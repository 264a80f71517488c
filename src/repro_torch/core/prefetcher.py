"""Prefetching strategies (paper Sec. 3.4).

``InOrderPrefetcher``  — classic k-buffer prefetch: batch i is assembled from
exactly the samples of permutation slice i, so every batch waits for its
slowest connection.

``OutOfOrderPrefetcher`` — the paper's contribution: requests for up to k
batches' worth of samples are in flight simultaneously and output batches are
filled with whichever samples *arrive first*.  Valid because (a) training is
robust to uniformly random permutations and (b) labels travel with features,
so any sample is self-contained.

Both support the *incremental ramp* (staggered buffer filling): instead of
front-loading k batches of requests at t=0 (bursting the network to k× the
steady rate), request one extra batch every ``ramp_every`` consumed — a
transient of only +1/ramp_every (25% for the paper's value of 4).

Both also support **adaptive flow control**
(``PrefetchConfig.flow_control="adaptive"``): a BDP-tracking
``FlowController`` (``core/flowctl.py``) replaces the fixed depth k and the
fixed ramp — the in-flight budget slow-starts to the measured
bandwidth-delay product of the route and backs off on queueing-delay
inflation, so no ``num_buffers`` hand-tuning is needed.  ``"static"`` (the
default) is bit-identical to the pre-flow-control behaviour.

Sharding / restart invariants carried by ``EpochPlan`` (property-tested in
``tests/test_resharding.py``; the multi-host and federation layers build on
them, see ``core/multihost.py``):

* **Contiguous-strip-of-shuffle** — with ``num_shards > 1`` every host
  computes the same global shuffle (seeded by ``(seed, num_shards)``) and
  takes its *contiguous strip* of it; strips are disjoint, jointly cover
  the dataset, and differ in size by at most one.  Never a strided slice
  of the raw uuid list — strides of an unshuffled list are biased samples.
* **Exactly-once per epoch** — each epoch delivers every dataset uuid
  exactly once across all shards.  Per-epoch *overrides* preserve this
  through elastic N->M resizes: ``compute_reflow`` collects every epoch's
  undelivered tail at a coordinated checkpoint boundary, the placement
  policy splits each tail into M balanced strips, and those strips pin the
  transition epochs of the M fresh plans; later epochs fall back to plain
  M-host strips (indistinguishable from a fresh M-host run).
* **M == N bit-identity** — restoring onto the same shard count with the
  same strip-defining metadata replays the identical per-epoch
  permutations; ``advance`` is the exact (epoch, cursor) odometer even
  when override epochs have different lengths.
"""

from __future__ import annotations

import uuid as _uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np

from .batch_loader import AssembledBatch, BatchAssembler, BatchRequest
from .connection import ConnectionPool, FetchResult
from .flowctl import FLOW_CONTROL_MODES, FlowControlConfig
from .netsim import Clock
from .placement import global_order, split_contiguous
from .stats import LoaderStats


@dataclass
class PrefetchConfig:
    batch_size: int = 512
    num_buffers: int = 8            # prefetch depth k (paper: e.g. 8 per GPU)
    out_of_order: bool = True       # the paper's key optimization
    incremental_ramp: bool = True   # staggered buffer filling
    ramp_every: int = 4             # +1 extra batch every N consumed
    # "static": the paper's fixed depth k + incremental ramp (default,
    # bit-identical to pre-flow-control behaviour).  "adaptive": a
    # BDP-tracking FlowController (core/flowctl.py) sets the in-flight
    # budget from measured RTT and delivery rate; num_buffers and the ramp
    # knobs are ignored (the controller's slow start is the ramp).
    flow_control: str = "static"
    flow: Optional[FlowControlConfig] = None
    # Per-key route admission (out-of-order + adaptive only): before issuing
    # a key, ask ``pool.admit(key)`` whether its *serving route* has
    # in-flight headroom; keys whose route is at budget are deferred (up to
    # one batch of lookahead) and plan-later keys on uncongested routes
    # issue first — issue order is no longer forced to equal plan order.
    # Deferral reorders, never drops: deferred keys re-try first on every
    # fill, and when nothing is admissible the oldest is force-issued, so
    # delivery (and the exactly-once plan property) is untouched.
    route_admission: bool = False

    def __post_init__(self) -> None:
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, "
                             f"got {self.batch_size}")
        if self.route_admission:
            if self.flow_control != "adaptive":
                raise ValueError("route_admission needs "
                                 "flow_control='adaptive' (admission "
                                 "consults per-route controller budgets)")
            if not self.out_of_order:
                raise ValueError("route_admission needs out_of_order=True "
                                 "(in-order assembly consumes in plan "
                                 "order, so reordered issue just stalls "
                                 "the head batch)")
        if self.num_buffers < 1:
            raise ValueError(f"num_buffers must be >= 1, "
                             f"got {self.num_buffers}")
        if self.ramp_every < 1:
            raise ValueError(f"ramp_every must be >= 1, "
                             f"got {self.ramp_every}")
        if self.flow_control not in FLOW_CONTROL_MODES:
            raise ValueError(f"unknown flow_control mode "
                             f"{self.flow_control!r} (choose from "
                             f"{FLOW_CONTROL_MODES})")


class EpochPlan:
    """Seeded uniform permutation per epoch — the 'predetermined' future
    requests that make prefetching possible (Sec. 3.4).

    With ``num_shards > 1`` every host constructs the same global shuffle
    (seeded by ``(seed, num_shards)``) and takes its contiguous strip, so the
    N shards are disjoint, jointly cover the dataset, and differ in size by
    at most one sample when N does not divide the dataset.  Each shard then
    reshuffles *its own strip* per epoch.

    A plan can additionally carry per-epoch *overrides* — fixed sample lists
    that replace the shuffled strip for specific epochs.  Overrides are how
    an elastic N->M restart reflows the unfinished part of the interrupted
    epoch(s) onto M new hosts (see :func:`compute_reflow`): the transition
    epochs are pinned to explicit strips of the leftover samples, and every
    later epoch falls back to the plan's own strip.
    """

    def __init__(self, uuids: List[_uuid.UUID], seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1) -> None:
        if num_shards < 1 or not 0 <= shard_id < num_shards:
            raise ValueError(f"bad shard spec {shard_id}/{num_shards}")
        if num_shards > 1:
            # per-host shard of the global UUID list (multi-host loading):
            # contiguous strips of the *shuffled* list stay unbiased.
            shuffled = global_order(uuids, seed, num_shards)
            self._uuids = split_contiguous(shuffled, num_shards)[shard_id]
        else:
            self._uuids = list(uuids)
        self._seed = seed
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._overrides: Dict[int, List[_uuid.UUID]] = {}

    @classmethod
    def from_samples(cls, samples: List[_uuid.UUID], seed: int = 0,
                     shard_id: int = 0, num_shards: int = 1) -> "EpochPlan":
        """A shard whose strip was assigned externally (placement policies,
        strip reflow) instead of carved from the global shuffle here."""
        plan = cls(list(samples), seed=seed)
        plan.shard_id = shard_id
        plan.num_shards = num_shards
        return plan

    def __len__(self) -> int:
        return len(self._uuids)

    # -- per-epoch overrides (elastic-reshard transitions) ------------------
    def install_overrides(self,
                          overrides: Dict[int, List[_uuid.UUID]]) -> None:
        """Pin specific epochs to fixed sample lists."""
        for e, samples in overrides.items():
            self._overrides[int(e)] = list(samples)

    def pending_overrides(self, from_epoch: int) -> Dict[int, List[_uuid.UUID]]:
        """Overrides not yet fully consumed at ``from_epoch`` — the part a
        checkpoint must carry for the restore to replay the transition."""
        return {e: list(s) for e, s in self._overrides.items()
                if e >= from_epoch}

    def epoch_length(self, epoch: int) -> int:
        ov = self._overrides.get(epoch)
        return len(self._uuids) if ov is None else len(ov)

    def advance(self, epoch: int, cursor: int, n_samples: int = 0) -> tuple:
        """Normalize ``(epoch, cursor + n_samples)`` against the per-epoch
        lengths: a position at/past the end of an epoch rolls into later
        epochs.  This is the shard's odometer — exact for override epochs of
        any length, constant-time once past the last override."""
        if cursor < 0:
            raise ValueError(f"negative cursor {cursor}")
        c = cursor + n_samples
        e = epoch
        last_override = max(self._overrides, default=-1)
        while e <= last_override:
            length = self.epoch_length(e)
            if c < length:
                return e, c
            c -= length
            e += 1
        n = len(self._uuids)
        if n == 0:
            raise ValueError("EpochPlan shard is empty — more shards than "
                             "samples (or an empty dataset)")
        return e + c // n, c % n

    # -- per-epoch delivery order -------------------------------------------
    def permutation(self, epoch: int) -> List[_uuid.UUID]:
        ov = self._overrides.get(epoch)
        if ov is not None:
            return list(ov)
        rng = np.random.default_rng((self._seed, epoch))
        order = rng.permutation(len(self._uuids))
        return [self._uuids[i] for i in order]

    def iter_from(self, epoch: int, cursor: int) -> Iterator[tuple]:
        """Infinite (epoch, uuid) stream starting at (epoch, cursor)."""
        e = epoch
        while True:
            perm = self.permutation(e)
            for i in range(cursor, len(perm)):
                yield e, perm[i]
            cursor = 0
            e += 1


def compute_reflow(old_plans: List[EpochPlan],
                   old_positions: List[tuple]) -> tuple:
    """Per-epoch leftovers at a coordinated N-host checkpoint boundary.

    ``old_positions`` holds one ``(epoch, cursor)`` per old shard.  Uneven
    strips drift apart in epoch number over time, so the boundary spans the
    epochs between the slowest and the fastest shard; for each such epoch
    this returns the samples *not yet delivered*, concatenated in shard
    order.  Splitting every epoch's tail into M balanced strips (see
    ``repro.core.placement.split_strips``) and installing them as overrides
    on M fresh plans yields an elastic N->M restart that still delivers
    every sample exactly once per epoch.

    Returns ``(start_epoch, {epoch: [uuid, ...]})`` where ``start_epoch`` is
    the slowest shard's epoch — the position all new shards restart from.
    """
    if len(old_plans) != len(old_positions) or not old_plans:
        raise ValueError("need one (epoch, cursor) position per old plan")
    epochs = [e for e, _ in old_positions]
    e_start, e_end = min(epochs), max(epochs)
    # A prior reshard may have pinned overrides *beyond* every shard's
    # current epoch (multi-epoch transitions); those epochs are still
    # partial globally, so the reflow window must reach them or the new
    # plans would deliver them as full plain epochs (duplicates).
    for plan, (e_i, _) in zip(old_plans, old_positions):
        pending = plan.pending_overrides(e_i)
        if pending:
            e_end = max(e_end, max(pending))
    tails: Dict[int, List[_uuid.UUID]] = {e: [] for e in
                                          range(e_start, e_end + 1)}
    for plan, (e_i, c_i) in zip(old_plans, old_positions):
        for e in range(e_i, e_end + 1):
            perm = plan.permutation(e)
            tails[e].extend(perm[c_i:] if e == e_i else perm)
    return e_start, tails


class _PrefetcherBase:
    def __init__(self, clock: Clock, pool: ConnectionPool, plan: EpochPlan,
                 cfg: PrefetchConfig, assembler: Optional[BatchAssembler] = None,
                 real_copy: bool = False, controller=None) -> None:
        self.clock = clock
        self.pool = pool
        self.plan = plan
        self.cfg = cfg
        # Adaptive flow control (core/flowctl.py): when a controller is
        # wired in, it owns the in-flight budget; the static k-buffer ramp
        # below is the default-compatible path.
        self.controller = controller
        self.assembler = assembler or BatchAssembler(clock, real_copy=real_copy)
        self.stats = LoaderStats(clock)
        self.consumed = 0               # batches handed to the consumer
        self._epoch0 = 0
        self._cursor0 = 0
        self._started = False

    # -- ramp / flow control ----------------------------------------------
    def _target_depth(self) -> int:
        """Allowed number of batches in flight (requests+ready) right now."""
        if self.controller is not None:
            return self.controller.depth(self.cfg.batch_size)
        k = self.cfg.num_buffers
        if not self.cfg.incremental_ramp:
            return k
        # 1 buffer at start; +1 extra every ramp_every consumed.
        return min(k, 1 + self.consumed // self.cfg.ramp_every)

    @property
    def started(self) -> bool:
        """True once ``start()`` has run (public — consumers must not poke
        at ``_started``)."""
        return self._started

    @property
    def ready_batches(self) -> int:
        """Assembled batches a ``next_batch`` call would return without
        blocking — what the device feed consults for buffer-hit accounting."""
        raise NotImplementedError

    # -- checkpoint/restart ------------------------------------------------
    def _set_origin(self, epoch: int, cursor: int) -> None:
        """Normalize a restart position: a cursor at/past the end of this
        shard's epoch (possible when shards divide unevenly and a global
        batch count is mapped onto each shard) rolls into later epochs —
        honouring per-epoch override lengths during reshard transitions."""
        self._epoch0, self._cursor0 = self.plan.advance(epoch, cursor)

    def state(self, rewind_batches: int = 0) -> dict:
        """Loader position for fault-tolerant restart (batch granularity).

        ``rewind_batches`` backs the cursor off by already-pulled batches a
        downstream buffer (e.g. ``DeviceFeed``'s device queue) is holding
        past the consumer: the checkpoint must record the *consumer-facing*
        position, or a restore would silently skip those samples."""
        if rewind_batches < 0:
            raise ValueError(f"negative rewind_batches {rewind_batches}")
        consumed = max(0, self.consumed - rewind_batches)
        epoch, cursor = self.plan.advance(
            self._epoch0, self._cursor0, consumed * self.cfg.batch_size)
        return {"epoch": epoch, "cursor": cursor, "consumed": consumed}

    def describe(self) -> str:
        mode = "OOO" if self.cfg.out_of_order else "in-order"
        if self.controller is not None:
            return (f"{mode}/adaptive depth={self._target_depth()} "
                    f"B={self.cfg.batch_size}")
        ramp = "incremental" if self.cfg.incremental_ramp else "eager"
        return f"{mode}/{ramp} k={self.cfg.num_buffers} B={self.cfg.batch_size}"


class InOrderPrefetcher(_PrefetcherBase):
    """Baseline strategy: per-batch request groups, in-order delivery."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._ready: Dict[int, AssembledBatch] = {}
        self._outstanding = 0
        self._next_issue = 0
        self._next_consume = 0
        self._stream: Optional[Iterator] = None

    @property
    def ready_batches(self) -> int:
        # in-order delivery: only the head-of-line batch counts as ready
        return 1 if self._next_consume in self._ready else 0

    def start(self, epoch: int = 0, cursor: int = 0) -> None:
        self._set_origin(epoch, cursor)
        self._stream = self.plan.iter_from(self._epoch0, self._cursor0)
        self._started = True
        self._fill()

    def _fill(self) -> None:
        while self._outstanding + len(self._ready) < self._target_depth():
            uuids, ep = [], 0
            for _ in range(self.cfg.batch_size):
                ep, u = next(self._stream)
                uuids.append(u)
            seq = self._next_issue
            self._next_issue += 1
            self._outstanding += 1
            BatchRequest(seq, ep, uuids, self.pool, self.assembler, self._on_ready)

    def _on_ready(self, batch: AssembledBatch) -> None:
        self._outstanding -= 1
        self._ready[batch.seq] = batch
        self.stats.on_batch_ready(batch)

    def next_batch(self, timeout: float = 600.0) -> AssembledBatch:
        if not self._started:
            self.start()
        seq = self._next_consume
        ok = self.clock.run_until(lambda: seq in self._ready, timeout=timeout)
        if not ok:
            raise TimeoutError(f"batch {seq} not ready after {timeout}s "
                               f"({self.describe()})")
        batch = self._ready.pop(seq)
        self._next_consume += 1
        self.consumed += 1
        self.stats.on_consume(batch)
        self._fill()
        return batch


class OutOfOrderPrefetcher(_PrefetcherBase):
    """The paper's strategy: sample-level in-flight window, arrival-order
    batch assembly."""

    def __init__(self, *args, **kw) -> None:
        super().__init__(*args, **kw)
        self._pool_arrived: deque = deque()   # FetchResults in arrival order
        self._samples_inflight = 0
        self._ready: deque = deque()          # assembled batches, FIFO
        self._assembling = 0
        self._next_seq = 0
        self._stream: Optional[Iterator] = None
        self._cur_epoch = 0
        # route-admission lookahead: (epoch, uuid) keys whose serving route
        # was at budget when drawn — retried first on every fill
        self._deferred: deque = deque()
        self.deferrals = 0                    # keys deferred at least once
        self.forced_issues = 0                # force-issued (nothing admissible)

    @property
    def ready_batches(self) -> int:
        return len(self._ready)

    def start(self, epoch: int = 0, cursor: int = 0) -> None:
        self._set_origin(epoch, cursor)
        self._cur_epoch = self._epoch0
        self._stream = self.plan.iter_from(self._epoch0, self._cursor0)
        self._started = True
        self._fill()

    def _fill(self) -> None:
        B = self.cfg.batch_size
        budget = self._target_depth() * B
        if not self.cfg.route_admission:
            while (self._samples_inflight + len(self._pool_arrived)
                   + self._assembling * B + len(self._ready) * B) < budget:
                ep, u = next(self._stream)
                self._cur_epoch = ep
                self._samples_inflight += 1
                self.pool.fetch(u, self._on_sample)
            return
        self._fill_with_admission(budget)

    def _fill_with_admission(self, budget: int) -> None:
        """Budget fill with per-key route admission: deferred keys (their
        route was at budget) retry first; fresh keys that fail admission
        join the deferral window; once the window holds a full batch with
        nothing admissible, the oldest key is force-issued — admission
        shapes issue *order*, the global budget alone decides *volume*, so
        the fill can never stall behind one saturated route."""
        B = self.cfg.batch_size

        def issue(ep: int, u: _uuid.UUID) -> None:
            self._cur_epoch = ep
            self._samples_inflight += 1
            self.pool.fetch(u, self._on_sample)

        # Admission verdicts only move with the clock, a completion, or an
        # issue (in-flight counts/EMAs) — none of which happen while keys
        # are merely rotated through the deferral window.  So once a full
        # scan of the window admits nothing, re-scanning it is pure waste
        # until the next issue: skip it (``window_dry``), and let each
        # issue re-arm the scan.  Behavior is unchanged — only the
        # redundant re-checks (quadratic in window size per fill under a
        # deferral storm) are elided.
        window_dry = False
        while (self._samples_inflight + len(self._pool_arrived)
               + self._assembling * B + len(self._ready) * B) < budget:
            issued = False
            if not window_dry:
                for _ in range(len(self._deferred)):
                    ep, u = self._deferred.popleft()
                    if self.pool.admit(u):
                        issue(ep, u)
                        issued = True
                        break
                    self._deferred.append((ep, u))
                window_dry = not issued and bool(self._deferred)
            if issued:
                continue
            if len(self._deferred) >= B:
                self.forced_issues += 1
                issue(*self._deferred.popleft())
                window_dry = False
                continue
            ep, u = next(self._stream)
            if self.pool.admit(u):
                issue(ep, u)
                window_dry = False
            else:
                self.deferrals += 1
                self._deferred.append((ep, u))

    def _on_sample(self, res: FetchResult) -> None:
        self._samples_inflight -= 1
        self._pool_arrived.append(res)
        self._maybe_assemble()

    def _maybe_assemble(self) -> None:
        B = self.cfg.batch_size
        while len(self._pool_arrived) >= B:
            samples = [self._pool_arrived.popleft() for _ in range(B)]
            seq = self._next_seq
            self._next_seq += 1
            self._assembling += 1
            self.assembler.assemble(seq, self._cur_epoch, samples, self._on_ready)

    def _on_ready(self, batch: AssembledBatch) -> None:
        self._assembling -= 1
        self._ready.append(batch)
        self.stats.on_batch_ready(batch)

    def next_batch(self, timeout: float = 600.0) -> AssembledBatch:
        if not self._started:
            self.start()
        ok = self.clock.run_until(lambda: len(self._ready) > 0, timeout=timeout)
        if not ok:
            raise TimeoutError(f"no batch ready after {timeout}s ({self.describe()})")
        batch = self._ready.popleft()
        self.consumed += 1
        self.stats.on_consume(batch)
        self._fill()
        return batch


def make_prefetcher(clock: Clock, pool: ConnectionPool, plan: EpochPlan,
                    cfg: PrefetchConfig, real_copy: bool = False,
                    controller=None,
                    assembler: Optional[BatchAssembler] = None):
    """``assembler`` overrides the default per-batch assembler — how the
    loader wires in an arena-backed one (``core/arena.py``) so real copies
    land in reused pinned slabs instead of fresh buffers."""
    cls = OutOfOrderPrefetcher if cfg.out_of_order else InOrderPrefetcher
    return cls(clock, pool, plan, cfg, real_copy=real_copy,
               controller=controller, assembler=assembler)


__all__ = ["PrefetchConfig", "EpochPlan", "compute_reflow",
           "InOrderPrefetcher", "OutOfOrderPrefetcher", "make_prefetcher"]
