"""The traced runs' reading of a ``torch.profiler`` trace, kept in memory.

``Profile`` profiles a block of steps on the card (CPU and CUDA
activities) and keeps, from the raw Kineto events: every device activity
(kernels, copies, fills) with the host time its launch was made, the
host ops (for what the host did in each idle gap), and the block's own
range.  ``ranges`` wraps a module attribute (a kernel's entry point) in
a named range while the profile runs, so that a reader can take the
device time of everything launched inside each call.  Nothing is written
to disk.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"
# Device-side markers that carry timestamps but are no work of the card.
NOT_WORK = ("Command Buffer Full",)


def kind_of(e) -> str:
    """"device" (a kernel, copy or fill on the card), "launch" (a CUDA
    runtime or driver call on the host), "annotation" (a named range) or
    "host" (an op on the host) for a raw Kineto event."""
    if e.device_type() != torch.autograd.DeviceType.CPU:
        if e.is_user_annotation() or e.name() in NOT_WORK:
            return "annotation"
        return "device"
    if e.is_user_annotation():
        return "annotation"
    name = e.name()
    if name.startswith("cuda") or name.startswith("cu") and \
            name[2:3].isupper():
        return "launch"
    return "host"


def union_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def merged(spans) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Profile:
    """``with Profile(device) as p:`` around the steps to trace."""

    def __init__(self, device: torch.device):
        self.device = device
        self._prof = None
        self._range = None

    def __enter__(self) -> "Profile":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:        # keep every event of the block, not its last cycle's
            self._prof = torch.profiler.profile(activities=acts,
                                                acc_events=True)
        except TypeError:
            self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        _sync(self.device)
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        _sync(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self._range.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())

    def _read(self, events) -> None:
        launch_at: Dict[int, int] = {}
        self.device_ops: List[Tuple[int, int, str, int]] = []
        self.host_ops: List[Tuple[int, int, str]] = []
        self.annotations: List[Tuple[int, int, str]] = []
        names = set()
        for e in events:
            kind = kind_of(e)
            if kind == "device":
                link = e.linked_correlation_id() or e.correlation_id()
                self.device_ops.append((e.start_ns(), e.end_ns(), e.name(),
                                        link))
            elif kind == "annotation":
                if e.device_type() == torch.autograd.DeviceType.CPU:
                    self.annotations.append((e.start_ns(), e.end_ns(),
                                             e.name()))
                    names.add(e.name())
            else:
                if kind == "launch":
                    launch_at[e.correlation_id()] = e.start_ns()
                self.host_ops.append((e.start_ns(), e.end_ns(), e.name()))
        # a device-side copy of a named range is no work of the card
        self.device_ops = [d for d in self.device_ops if d[2] not in names]
        launched = sorted((launch_at[link], s, e) for s, e, _, link in
                          self.device_ops if link in launch_at)
        self._launch_ns = [x[0] for x in launched]
        self._launched = [(s, e) for _, s, e in launched]
        self.host_ops.sort()
        self._host_starts = [o[0] for o in self.host_ops]
        win = [a for a in self.annotations if a[2] == WINDOW]
        self.window_ns = (win[0][0], win[0][1])

    # -- readings ---------------------------------------------------------------
    def busy_s(self) -> float:
        a, b = self.window_ns
        spans = [(max(s, a), min(e, b)) for s, e, _, _ in self.device_ops
                 if e > a and s < b]
        return union_ns(spans) / 1e9

    def window_s(self) -> float:
        a, b = self.window_ns
        return (b - a) / 1e9

    def device_s_of(self, name: str) -> List[float]:
        """The device seconds (union) of what each call to ``name`` (a
        range from :meth:`ranges`) launched, in call order."""
        out = []
        for s, e, n in sorted(self.annotations):
            if n != name:
                continue
            lo = bisect.bisect_left(self._launch_ns, s)
            hi = bisect.bisect_right(self._launch_ns, e)
            out.append(union_ns(self._launched[lo:hi]) / 1e9)
        return out

    def host_op_at(self, t: int, scan: int = 64) -> str:
        """The innermost host op running at ``t`` (the latest-started one
        that has not ended), looking back over ``scan`` ops."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, n in reversed(self.host_ops[max(0, i - scan):i]):
            if e >= t:
                return n
        return "python (no op)"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device ops that took most time, and the idle gaps summed by
        the innermost host op running at each gap's middle."""
        by_name: Dict[str, int] = {}
        for s, e, n, _ in self.device_ops:
            by_name[n] = by_name.get(n, 0) + (e - s)
        a, b = self.window_ns
        busy = merged([(max(s, a), min(e, b)) for s, e, _, _ in
                       self.device_ops if e > a and s < b])
        edges = [a] + [x for span in busy for x in span] + [b]
        gaps: Dict[str, int] = {}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 > g0:
                label = self.host_op_at((g0 + g1) // 2)
                gaps[label] = gaps.get(label, 0) + (g1 - g0)

        def top_of(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": top_of(by_name), "idle_gaps": top_of(gaps)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def ranges(module, attr: str, name: str, record: Callable
           ) -> Iterator[None]:
    """Within the block, ``module.attr`` runs inside the profiler range
    ``name``, and ``record(*args)`` notes each call's arguments first."""
    fn = getattr(module, attr)

    def wrapped(*args, **kwargs):
        record(*args)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    setattr(module, attr, wrapped)
    try:
        yield
    finally:
        setattr(module, attr, fn)


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile (linear between order statistics), or None."""
    if not values:
        return None
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


__all__ = ["Profile", "ranges", "union_ns", "merged", "percentile",
           "kind_of"]
