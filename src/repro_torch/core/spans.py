"""Named spans at the port's layer boundaries, kept in memory, off unless
turned on.

    with span("engine.step"):
        ...

Off (the default), ``span`` returns one shared object whose enter and exit
do nothing: it reads no clock, allocates nothing and makes no torch call.
On (``enable()``), each span keeps a record: its name, its start and end
(``time.perf_counter_ns``), the index of the span open around it on the
same thread, and the thread.  A span opened on another thread (autograd's
backward thread re-running a checkpointed forward) starts its own chain
of parents there.  While a torch profiler runs, each span also opens
``torch.profiler.record_function(name)``, so that it lands among the
trace's annotations, on the profiler's clock: the clock of the device's
activity and of the launches that caused it.  The two clocks are never
converted into each other: host readings take the records, device
readings the profiler's copies.

``take()`` returns the records kept so far, in the order the spans were
opened, and clears them.

The spans the port opens (``engine.*`` in ``serve/engine.py``; ``moe``,
``moe.experts`` and ``unembed`` in ``models/``; ``train.*`` in
``train/``; ``feed.*`` in ``data/pipeline.py``; ``kernels.build`` in
``kernels/build.py``) are named where they are opened.
"""

from __future__ import annotations

import threading
import time
from typing import List, NamedTuple

import torch
from torch.autograd import profiler as _profiler

_on = False
_open: list = []              # every span since the last take, as opened
_clock = time.perf_counter_ns


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int               # -1 while the span is open
    parent: int               # index in the same ``take()``; -1 for none
    thread: int


class _Thread(threading.local):
    """Per thread: its stack of open spans and its id, in one lookup."""

    def __init__(self):
        self.top = ([], threading.get_ident())


_thread = _Thread()


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Span:
    """One span: its own record while spans are on.  Its enter and exit
    run between the caller's torch calls, with the host's caches cold, so
    they do as little as they can: one thread-local lookup, and no torch
    call unless a profiler runs (``_is_profiler_enabled`` is torch's own
    flag for such checks)."""

    __slots__ = ("name", "start", "end", "parent", "thread", "_stack",
                 "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        stack, self.thread = _thread.top
        self.parent = stack[-1] if stack else None
        stack.append(self)
        _open.append(self)
        self._stack = stack
        self.end = -1
        if _profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start = _clock()

    def __exit__(self, *exc) -> bool:
        self.end = _clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        stack = self._stack
        if stack and stack[-1] is self:
            stack.pop()
        return False


def span(name: str):
    """A context manager that records ``name`` while spans are on."""
    if not _on:
        return OFF
    return _Span(name)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> List[Record]:
    """The records kept since the last call, in opening order; a parent
    taken by an earlier call is given as -1."""
    global _open
    spans, _open = _open, []
    index = {id(r): i for i, r in enumerate(spans)}
    return [Record(r.name, r.start, r.end,
                   -1 if r.parent is None else index.get(id(r.parent), -1),
                   r.thread) for r in spans]


__all__ = ["span", "enable", "disable", "take", "Record", "OFF"]
