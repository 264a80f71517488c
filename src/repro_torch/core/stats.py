"""Instrumentation: batch-time series, throughput windows, epoch summaries.

Produces the raw material for the paper's Figs. 4-7 and Tables 3-4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def windowed_series(events: Sequence[Tuple[float, float]],
                    window: float = 0.5,
                    start: float = 0.0) -> List[Tuple[float, float]]:
    """Aggregate timestamped amounts into fixed windows.

    ``events`` is a time-ordered sequence of ``(t, amount)``; the result is
    one ``(window_start, amount_per_second)`` tuple per ``window``-wide
    bucket from ``start`` through the last event (empty buckets yield 0.0).

    This is the single windowed-throughput aggregation the whole stack
    shares: per-connection transfer traces (``SimConnection
    .throughput_series``, Figs. 5/6), consumed-batch throughput
    (``LoaderStats.throughput_windows``, Fig. 4), and the flow controller's
    delivery-rate estimate (``core/flowctl.py``).
    """
    if window <= 0.0:
        raise ValueError(f"window must be positive, got {window}")
    if not events:
        return []
    out: List[Tuple[float, float]] = []
    acc = 0.0
    w0, i = start, 0
    end = events[-1][0]
    while w0 <= end:
        w1 = w0 + window
        while i < len(events) and events[i][0] < w1:
            acc += events[i][1]
            i += 1
        out.append((w0, acc / window))
        acc, w0 = 0.0, w1
    return out


class LoaderStats:
    def __init__(self, clock) -> None:
        self._clock = clock
        self.batch_ready_t: List[float] = []
        self.batch_consume_t: List[float] = []
        self.batch_nbytes: List[int] = []
        self.batch_wait: List[float] = []      # consumer-visible wait per batch
        self._last_consume: Optional[float] = None

    # -- hooks -------------------------------------------------------------
    def on_batch_ready(self, batch) -> None:
        self.batch_ready_t.append(batch.t_ready)

    def on_consume(self, batch) -> None:
        now = self._clock.now()
        self.batch_consume_t.append(now)
        self.batch_nbytes.append(batch.nbytes)
        prev = self._last_consume if self._last_consume is not None else 0.0
        # "batch loading time" as plotted in Fig. 4: gap between consecutive
        # batch deliveries as seen by the consumer.
        self.batch_wait.append(now - prev)
        self._last_consume = now

    # -- summaries -----------------------------------------------------------
    def batch_times(self, skip: int = 0) -> np.ndarray:
        return np.asarray(self.batch_wait[skip:], dtype=np.float64)

    def throughput(self, skip: int = 0) -> float:
        """Average bytes/s over consumed batches (epoch-style accounting)."""
        if len(self.batch_consume_t) <= skip + 1:
            return 0.0
        t0 = self.batch_consume_t[skip]
        t1 = self.batch_consume_t[-1]
        nbytes = sum(self.batch_nbytes[skip + 1:])
        return nbytes / max(t1 - t0, 1e-9)

    def samples_per_second(self, batch_size: int, skip: int = 0) -> float:
        if len(self.batch_consume_t) <= skip + 1:
            return 0.0
        t0, t1 = self.batch_consume_t[skip], self.batch_consume_t[-1]
        n = (len(self.batch_consume_t) - skip - 1) * batch_size
        return n / max(t1 - t0, 1e-9)

    def throughput_windows(self, window: float = 0.5) -> List[tuple]:
        """(t, bytes/s) aggregate over consumed batches."""
        return windowed_series(list(zip(self.batch_consume_t,
                                        self.batch_nbytes)), window)


class StepStats:
    """Per-step data-stall accounting (Zolnouri et al., arxiv 2005.02130).

    Where ``LoaderStats`` measures the *supply* side (batch delivery gaps),
    ``StepStats`` measures what the accelerator actually sees: every train
    step is split into *wait-for-batch* time (the consumer blocked on the
    data pipeline) and *step-compute* time.  ``DeviceFeed`` feeds the wait
    half (``on_wait`` per ``__next__``, flagging whether the batch was
    served from the double buffer or had to block on the loader) and the
    training loop feeds the compute half (``on_compute`` per step); steps
    pair up positionally, so summaries only read the paired prefix.

    All timestamps live on ONE clock — the loader's (virtual or real) — so
    stall fractions are internally consistent even when the network is
    simulated.
    """

    def __init__(self, clock=None) -> None:
        self._clock = clock
        self.wait_s: List[float] = []      # per-step wait-for-batch seconds
        self.compute_s: List[float] = []   # per-step compute seconds
        self.step_end_t: List[float] = []  # clock time at each step end
        self.buffer_hits = 0               # __next__ served without blocking
        self.blocked = 0                   # __next__ had to wait on the loader

    # -- hooks -------------------------------------------------------------
    def on_wait(self, wait: float, blocked: bool = True) -> None:
        """One ``DeviceFeed.__next__``: seconds blocked on the loader."""
        self.wait_s.append(float(wait))
        if blocked:
            self.blocked += 1
        else:
            self.buffer_hits += 1

    def on_compute(self, compute: float, t_end: Optional[float] = None) -> None:
        """Close the current step with its compute seconds."""
        self.compute_s.append(float(compute))
        if t_end is None:
            t_end = self._clock.now() if self._clock is not None else 0.0
        self.step_end_t.append(float(t_end))

    # -- summaries ---------------------------------------------------------
    @property
    def steps(self) -> int:
        """Completed (wait, compute) pairs."""
        return min(len(self.wait_s), len(self.compute_s))

    def _paired(self, skip: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        n = self.steps
        return (np.asarray(self.wait_s[skip:n], dtype=np.float64),
                np.asarray(self.compute_s[skip:n], dtype=np.float64))

    def stall_frac(self, skip: int = 0) -> float:
        """Fraction of wall time the consumer spent waiting for data."""
        w, c = self._paired(skip)
        total = float(w.sum() + c.sum())
        return float(w.sum()) / total if total > 0 else 0.0

    def goodput_sps(self, batch_size: int, skip: int = 0) -> float:
        """Samples/s actually trained (wait + compute in the denominator)."""
        w, c = self._paired(skip)
        total = float(w.sum() + c.sum())
        return len(w) * batch_size / total if total > 0 else 0.0

    def stall_windows(self, window: float = 0.5) -> List[Tuple[float, float]]:
        """(t, stalled-seconds-per-second) over fixed windows — the
        stall-rate mirror of ``LoaderStats.throughput_windows``."""
        n = self.steps
        return windowed_series(list(zip(self.step_end_t[:n],
                                        self.wait_s[:n])), window)

    def summary(self, batch_size: int, skip: int = 0) -> dict:
        w, c = self._paired(skip)
        return {
            "steps": self.steps,
            "skip": skip,
            "stall_frac": self.stall_frac(skip),
            "goodput_sps": self.goodput_sps(batch_size, skip),
            "buffer_hits": self.buffer_hits,
            "blocked": self.blocked,
            "wait_s": summarize(w),
            "compute_s": summarize(c),
        }


def summarize(values: np.ndarray) -> dict:
    if values.size == 0:
        return {"mean": 0.0, "std": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    return {"mean": float(values.mean()), "std": float(values.std()),
            "p50": float(np.percentile(values, 50)),
            "p99": float(np.percentile(values, 99)),
            "max": float(values.max())}


__all__ = ["LoaderStats", "StepStats", "summarize", "windowed_series"]
