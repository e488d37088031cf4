"""Spans: nested, timed ranges of the program's own work, on the clock of
torch's profiler.

``span(name, **fields)`` is a context manager around one layer boundary
of the program (an admission round, the solver's sweep, a split group's
forward).  A finished span holds its name, its id, its parent's id (the
innermost span open in the same thread when it opened) and its trace id
(a root's own id unless the root names one; a child takes its parent's),
``t0_ns`` and ``t1_ns``, its ``fields``, and on CUDA ``device_s``.
Fields may be set while the span is open (``set``, ``add``), so counts
known only at close go in.  A field may be a tensor (a count kept on the
device): it becomes a Python number where the span is read
(``finished``, or the bus's ``span`` event), never while the work runs.
``add(**counts)`` at module level adds to the innermost open span of the
calling thread, which is how the solver's counters reach the span of the
layer that ran them.

One clock with the device trace: ``t0_ns`` and ``t1_ns`` are
``time.time_ns()``, the clock of ``kineto_results.trace_start_ns()`` and
of each profiler event's ``start_ns()``; a kernel record's ``start_us``
past ``trace_start_ns()`` lands on the same axis.  While a profiler
records, each span is also a ``torch.profiler.record_function`` range, so
a CPU+CUDA profile shows the spans on the host timeline beside the
kernels.

``device_s``: the elapsed time between two timing events recorded on the
current CUDA stream at open and at close (none while the stream is
capturing a graph).  The events come from a pool and are read only when
spans are read (``finished``), never while the work runs.

On and off.  The tracer records while ``enable()`` holds, and while a
torch profiler records (``profiler_recording``), so a profiled stretch
records spans without any other switch.  It looks only when a span
opens: a span opened while it records is always closed and kept.  Off,
``span`` returns one shared no-op context after that check, and nothing
is allocated.  ``enable(bus)`` also emits each finished span on the
bus's ``span`` stream (host times and fields, tensor fields settled
there, which waits for the device; ``device_s`` is read by ``finished``
alone), which is how ``launch/serve.py --trace`` writes them to its
JSONL.

Finished spans go into a bounded ring (``CAPACITY``); ``finished()``
returns them, oldest first, and ``clear()`` empties it.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 4096


def profiler_recording() -> bool:
    """True while a torch profiler records in this process: the flag torch
    sets, for every thread, when ``torch.profiler.profile`` or the
    autograd profiler starts and clears when it stops.  (The C++ state,
    ``torch._C._autograd._profiler_enabled()``, is the starting thread's
    alone, and costs a call where this is one attribute read.)"""
    return _autograd_profiler._is_profiler_enabled


class Span:
    """One span (module docs); ``bool(span)`` is True, the no-op's
    False, so a caller computes a field only where it is kept."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "t0_ns",
                 "t1_ns", "fields", "device_s", "_tracer", "_events",
                 "_range")

    def __init__(self, tracer: "Tracer", name: str, trace_id, fields: Dict):
        self.name = name
        self.trace_id = trace_id
        self.fields = fields
        self.span_id = self.parent_id = None
        self.t0_ns = self.t1_ns = None
        self.device_s: Optional[float] = None
        self._tracer = tracer
        self._events = self._range = None

    def set(self, **fields) -> None:
        self.fields.update(fields)

    def add(self, **counts) -> None:
        f = self.fields
        for k, v in counts.items():
            f[k] = f.get(k, 0) + v

    @property
    def wall_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def settle(self) -> None:
        """Tensor fields to Python numbers (waits for their device)."""
        f = self.fields
        for k, v in f.items():
            if isinstance(v, torch.Tensor):
                f[k] = v.item()

    def as_dict(self) -> Dict:
        return dict(self.fields, span=self.name, span_id=self.span_id,
                    parent_id=self.parent_id, trace_id=self.trace_id,
                    t0_ns=self.t0_ns, t1_ns=self.t1_ns)

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        self._tracer._open(self)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._close(self)
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.span_id}, "
                f"parent={self.parent_id}, trace={self.trace_id}, "
                f"fields={self.fields})")


class _NoSpan:
    """The shared context ``span`` returns while the tracer is off."""

    __slots__ = ()

    def set(self, **fields) -> None:
        pass

    def add(self, **counts) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


class _Stacks(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.stack: List[Span] = []


class Tracer:
    """The ring of finished spans, each thread's stack of open ones, the
    timing-event pool and the switches (module docs)."""

    def __init__(self, capacity: int = CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=int(capacity))
        self._local = _Stacks()
        self._ids = itertools.count(1)
        self._enabled = 0
        self._buses: List = []
        self._pool: Dict[int, List] = {}    # device index -> free events

    # ---- switches -------------------------------------------------------
    def recording(self) -> bool:
        return bool(self._enabled) or profiler_recording()

    @contextmanager
    def enable(self, bus=None):
        """Record spans while the block holds; with ``bus``, emit each
        finished span on its ``span`` stream too."""
        with self._lock:
            self._enabled += 1
            if bus is not None:
                self._buses.append(bus)
        try:
            yield self
        finally:
            with self._lock:
                self._enabled -= 1
                if bus is not None:
                    self._buses.remove(bus)

    # ---- producer side --------------------------------------------------
    def span(self, name: str, trace_id=None, **fields):
        if not (self._enabled or _autograd_profiler._is_profiler_enabled):
            return NO_SPAN
        return Span(self, name, trace_id, fields)

    def add(self, **counts) -> None:
        """Add ``counts`` to the innermost open span of this thread."""
        stack = self._local.stack
        if stack:
            stack[-1].add(**counts)

    def _open(self, sp: Span) -> None:
        stack = self._local.stack
        parent = stack[-1] if stack else None
        sp.span_id = next(self._ids)
        if parent is not None:
            sp.parent_id = parent.span_id
            sp.trace_id = parent.trace_id
        elif sp.trace_id is None:
            sp.trace_id = sp.span_id
        stack.append(sp)
        if torch.cuda.is_initialized() and not _capturing():
            dev = torch.cuda.current_device()
            start, end = self._event(dev), self._event(dev)
            start.record()
            sp._events = (start, end, dev)
        if profiler_recording():
            sp._range = torch.profiler.record_function(sp.name)
            sp.t0_ns = time.time_ns()
            sp._range.__enter__()
        else:
            sp.t0_ns = time.time_ns()

    def _close(self, sp: Span) -> None:
        if sp._range is not None:
            sp._range.__exit__(None, None, None)
            sp._range = None
        sp.t1_ns = time.time_ns()
        if sp._events is not None:
            if _capturing():
                self._release(sp._events)
                sp._events = None
            else:
                sp._events[1].record()
        stack = self._local.stack
        if stack and stack[-1] is sp:
            stack.pop()
        else:
            stack.remove(sp)
        with self._lock:
            self._ring.append(sp)
            buses = tuple(self._buses)
        if buses:
            sp.settle()
        for bus in buses:
            bus.emit("span", **sp.as_dict())

    def _event(self, dev: int):
        with self._lock:
            free = self._pool.get(dev)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _release(self, events) -> None:
        start, end, dev = events
        with self._lock:
            self._pool.setdefault(dev, []).extend((start, end))

    # ---- consumer side --------------------------------------------------
    def finished(self) -> List[Span]:
        """The retained finished spans, oldest first, each CUDA span's
        ``device_s`` read from its events (waiting for its close event) and
        its tensor fields settled."""
        with self._lock:
            out = list(self._ring)
        for sp in out:
            sp.settle()
            ev = sp._events
            if ev is None:
                continue
            with self._lock:
                if sp._events is None:     # another reader resolved it
                    continue
                sp._events = None
            ev[1].synchronize()
            sp.device_s = ev[0].elapsed_time(ev[1]) / 1e3
            self._release(ev)
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


TRACER = Tracer()

span = TRACER.span
add = TRACER.add
enable = TRACER.enable
recording = TRACER.recording
finished = TRACER.finished
clear = TRACER.clear


def subtree(root: Span, spans: List[Span]) -> List[Span]:
    """The spans of ``spans`` under ``root`` (children, their children,
    ...), in the order given."""
    inside = {root.span_id}
    out = []
    for sp in sorted(spans, key=lambda s: s.span_id):
        if sp.parent_id in inside:
            inside.add(sp.span_id)
            out.append(sp)
    return out
