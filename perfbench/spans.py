"""Readings of the program's own spans and counters, for the per-layer
metrics listed in ``perfbench/span_metrics.json``.

The program (``repro_torch.core.spans``) records, while spans are on, each
span's name, start and end on the host clock, the span open around it on
the same thread, and the thread; while a profiler runs, each span is also
one of the trace's annotations, on the profiler's clock.  A traced run
with spans on adds three keys to the driver's ``layer``:

- ``spans``: the records, as ``spans.take()`` gives them (host clock);
- ``span_device``: :func:`device_by_span` of the profiled slice, on the
  launches of its raw events (:func:`launches`);
- ``counters``: the serving engine's ``steps``, ``slot_steps``,
  ``prompt_tokens_fed`` and ``tokens_out`` after the window.

Host readings take the records, device readings the annotations; nothing
converts one clock into the other.  :func:`detail` gives the run's detail
beside the metrics.  A program without spans gives none of the keys, and
every reader of them then reports nothing.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from perfbench.trace import Profile, kind_of, union_ns

OUTSIDE = "outside the program"
Launch = Tuple[int, int, int, str]     # launched at, start, end, name


def launches(events) -> List[Launch]:
    """Each device activity (kernel, copy, fill) of the raw Kineto events
    with the host time of the CUDA call that launched it, sorted by that
    time.  An activity and its launch share one CUPTI correlation id
    (``correlation_id()``); ``linked_correlation_id()`` is the id of the
    PyTorch op it ran under, another numbering.  An activity whose launch
    is not among the events is left out."""
    launch_at: Dict[int, int] = {}
    device, names = [], set()
    for e in events:
        kind = kind_of(e)
        if kind == "launch":
            launch_at[e.correlation_id()] = e.start_ns()
        elif kind == "device":
            device.append((e.correlation_id(), e.start_ns(), e.end_ns(),
                           e.name()))
        elif kind == "annotation":
            names.add(e.name())
    return sorted((launch_at[c], s, e, n) for c, s, e, n in device
                  if c in launch_at and n not in names)


def _in_window(profile: Profile, names: Iterable[str]) -> List[tuple]:
    a, b = profile.window_ns
    keep = set(names)
    return sorted((s, e, n) for s, e, n in profile.annotations
                  if n in keep and s >= a and e <= b)


def _open_at(anns: List[tuple], times: Sequence[int]) -> List[list]:
    """For each of the sorted ``times``, the annotations open there
    (start <= t <= end), in the order they started."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(anns) and anns[i][0] <= t:
            active.append(anns[i])
            i += 1
        active = [x for x in active if x[1] >= t]
        out.append(list(active))
    return out


def device_by_span(profile: Profile, names: Iterable[str],
                   launched: List[Launch]) -> Dict[str, Dict[str, float]]:
    """For each span name, over the profiled slice: ``device_s``, the
    device time (a union) of what was launched (``launched``, from
    :func:`launches` of the profile's events) while a span of that name
    was open; ``self_device_s``, of what was launched while it was the
    innermost span open; and ``calls``, how many such spans the slice
    holds."""
    anns = _in_window(profile, names)
    a, b = profile.window_ns
    mine = [x for x in launched if a <= x[0] <= b]
    inside: Dict[str, list] = {}
    own: Dict[str, list] = {}
    for (_, s, e, _), active in zip(mine,
                                    _open_at(anns, [x[0] for x in mine])):
        for n in {x[2] for x in active}:
            inside.setdefault(n, []).append((s, e))
        if active:
            own.setdefault(active[-1][2], []).append((s, e))
    out = {}
    for n in sorted({x[2] for x in anns}):
        out[n] = {"device_s": union_ns(inside.get(n, [])) / 1e9,
                  "self_device_s": union_ns(own.get(n, [])) / 1e9,
                  "calls": sum(x[2] == n for x in anns)}
    return out


def idle_by_span(profile: Profile, names: Iterable[str]
                 ) -> Dict[str, float]:
    """The slice's idle gaps on the card (no kernel, copy or fill), in
    seconds, summed by the innermost program span open at each gap's
    middle; gaps with none open go to ``OUTSIDE``."""
    a, b = profile.window_ns
    busy = sorted((max(s, a), min(e, b)) for s, e, _, _ in profile.device_ops
                  if e > a and s < b)
    edges, end = [], a
    for s, e in busy:
        if s > end:
            edges.append((end, s))
        end = max(end, e)
    if b > end:
        edges.append((end, b))
    mids = [(g0 + g1) // 2 for g0, g1 in edges]
    out: Dict[str, float] = {}
    for (g0, g1), active in zip(edges, _open_at(_in_window(profile, names),
                                                mids)):
        label = active[-1][2] if active else OUTSIDE
        out[label] = out.get(label, 0.0) + (g1 - g0) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def per_step_ms(layer: Dict, kind: str, name: str,
                key: str = "device_s") -> Optional[float]:
    """``span_device[name][key]`` in ms per profiled step (``engine.step``
    or ``train.step`` spans in the slice); None without a card, or where
    the slice has no such span."""
    dev = layer.get("span_device")
    if layer.get("kind") != kind or not dev or \
            layer.get("device_kind") == "cpu":
        return None
    steps = dev.get("engine.step" if kind == "serve" else "train.step")
    if name not in dev or not steps or not steps["calls"]:
        return None
    return 1e3 * dev[name][key] / steps["calls"]


def roots(records: Sequence, root: str, n: Optional[int] = None
          ) -> List[int]:
    """The indices of the first ``n`` (all for None) top-level spans
    named ``root``."""
    idx = [i for i, r in enumerate(records)
           if r.name == root and r.parent < 0 and r.end_ns >= 0]
    return idx if n is None else idx[:n]


def child_ms(records: Sequence, tops: List[int], names: Iterable[str]
             ) -> Optional[float]:
    """The mean, over the spans at ``tops``, of the summed durations of
    their children named in ``names`` (ms)."""
    if not tops:
        return None
    keep, pick = set(tops), set(names)
    total = sum(r.end_ns - r.start_ns for r in records
                if r.parent in keep and r.name in pick)
    return total / len(tops) / 1e6


def host_self_ms(records: Sequence, tops: List[int],
                 per: Optional[int] = None) -> Dict[str, float]:
    """Each span name's host self time (its duration less its children's)
    over the spans at ``tops`` and everything opened inside them on their
    thread, per span at ``tops`` or per ``per`` (ms)."""
    if not tops:
        return {}
    top = list(range(len(records)))
    for i, r in enumerate(records):
        if r.parent >= 0:
            top[i] = top[r.parent]
    dur = [max(r.end_ns - r.start_ns, 0) for r in records]
    own = list(dur)
    for i, r in enumerate(records):
        if r.parent >= 0:
            own[r.parent] -= dur[i]
    keep = set(tops)
    out: Dict[str, float] = {}
    for i, r in enumerate(records):
        if top[i] in keep:
            out[r.name] = out.get(r.name, 0.0) + own[i]
    return {k: v / (per or len(tops)) / 1e6 for k, v in sorted(out.items())}


def between_ms(records: Sequence, tops: List[int]) -> Optional[float]:
    """Mean host time from the end of one span at ``tops`` to the start of
    the next (ms): the caller's own loop between steps."""
    gaps = [records[j].start_ns - records[i].end_ns
            for i, j in zip(tops, tops[1:])]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None


def steps_before(layer: Dict, profile: Optional[Profile], skip: int = 0
                 ) -> List[int]:
    """The step spans (``engine.step`` or ``train.step``) of the window
    before the profiled slice: serving, the steps ``layer["step_s"]``
    times; training, those after the first ``skip`` (set-up) that ended
    before the profile started (``Profile.t0``, the host clock)."""
    records = layer["spans"]
    if layer.get("kind") == "serve":
        return roots(records, "engine.step", len(layer["step_s"]))
    tops = roots(records, "train.step")[skip:]
    if profile is None:
        return tops
    return [i for i in tops if records[i].end_ns < profile.t0 * 1e9]


def fed_share(layer: Dict) -> Optional[float]:
    """The share of the window's slot-steps that fed a prompt token
    (``prompt_tokens_fed`` over ``slot_steps``, %); None without the
    counters.  With ``slot_yield`` (the share that served a token) it
    accounts for the slot-steps: the step that feeds a prompt's last
    token also serves its first, so the two overlap by one slot-step a
    request, and what is left over is the empty slot-steps."""
    c = layer.get("counters")
    if layer.get("kind") != "serve" or not c or not c.get("slot_steps"):
        return None
    return 100.0 * c["prompt_tokens_fed"] / c["slot_steps"]


def detail(layer: Dict, profile: Optional[Profile], skip: int = 0) -> Dict:
    """The run's detail from its spans and counters: each span's mean host
    self ms per step before the profiled slice (``span_host_ms``;
    training's with the feed's ``feed.next`` before each step), the
    caller's ms between those steps (``harness_ms``), the share of
    slot-steps that fed a prompt (``slot_fed_share``, :func:`fed_share`)
    and the slice's idle gaps by the innermost span open
    (``idle_by_span``)."""
    records = layer.get("spans")
    if not records:
        return {}
    tops = steps_before(layer, profile, skip)
    mine = list(tops)
    if layer.get("kind") == "train":     # and the feed's call before each
        feeds = roots(records, "feed.next")
        mine += [max(f for f in feeds if f < i) for i in tops
                 if feeds and feeds[0] < i]
    out = {"span_host_ms": host_self_ms(records, mine, len(tops)),
           "harness_ms": between_ms(records, tops)}
    fed = fed_share(layer)
    if fed is not None:
        out["slot_fed_share"] = fed
    if profile is not None:
        out["idle_by_span"] = idle_by_span(profile,
                                           {r.name for r in records})
    return out


__all__ = ["launches", "device_by_span", "idle_by_span", "per_step_ms",
           "roots", "child_ms", "host_self_ms", "between_ms",
           "steps_before", "fed_share", "detail", "OUTSIDE"]
