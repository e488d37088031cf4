"""In-process telemetry event bus for the serving stack (the JAX
package's ``telemetry/bus.py``, copied: it imports only the standard
library).

The ERA solver is only "QoE-aware" if someone can see QoE: the serving
layers (admission rounds, schedule swaps, cell churn, the cluster facade)
emit structured events here, and consumers — the load harness, the serve
launcher's summary table, a JSONL trace sink — read them back without
ever touching the emitting component's locks.

Design constraints (this sits next to the admission round's hot path):

  * **Lock-cheap.** One bus-wide mutex; an ``emit`` is an append to a
    bounded ``deque`` plus O(1) streaming-aggregate updates.  No numpy,
    no sorting, no per-event allocation beyond the caller's kwargs dict.
  * **Bounded.** Each stream is a ring buffer (``capacity`` events);
    always-on serving can emit forever without growing memory.  The
    streaming aggregates keep summarising everything ever emitted even
    after the ring has wrapped.
  * **Streaming quantiles.** p50/p95/p99 come from a fixed-size P²
    quantile sketch (Jain & Chlamtac 1985): five markers per quantile,
    updated in O(1) per observation — never a sort over the ring on the
    hot path, and the estimate covers the whole stream, not just the
    retained window.
  * **Injectable clock.** Timestamps come from the bus's ``clock``
    (default ``time.monotonic``); the load harness and the unit tests
    inject a fake clock so every event timestamp is deterministic.
  * **Optional everywhere.** Components take ``bus=None`` and guard each
    emit with ``if bus is not None`` — the no-telemetry path allocates
    nothing and calls nothing (regression-tested by
    ``tests/test_torch_telemetry.py``).

Sinks (``attach``) observe every event as it is emitted — e.g. the JSONL
``FileSink`` (sinks.py) behind ``launch/serve.py --trace``.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional


class Event(NamedTuple):
    """One emitted telemetry event: bus-clock timestamp, stream name,
    and the emitter's field dict (kept by reference — emitters must not
    mutate it afterwards)."""
    t: float
    name: str
    fields: Dict


class _P2Quantile:
    """P² streaming quantile estimator (Jain & Chlamtac 1985).

    Five markers track (min, p/2, p, (1+p)/2, max); each observation
    adjusts marker heights with a piecewise-parabolic interpolation.
    O(1) memory and time per observation — the fixed-size sketch behind
    the bus's p50/p95/p99 with no sample retention and no sorting."""

    __slots__ = ("p", "_buf", "q", "n", "n_des", "dn")

    def __init__(self, p: float):
        self.p = float(p)
        self._buf: List[float] = []     # first five observations
        self.q: Optional[List[float]] = None   # marker heights
        self.n: Optional[List[float]] = None   # marker positions
        self.n_des: Optional[List[float]] = None  # desired positions
        self.dn: Optional[List[float]] = None  # desired-position increments

    def add(self, x: float) -> None:
        if self.q is None:
            self._buf.append(x)
            if len(self._buf) == 5:
                self._buf.sort()
                p = self.p
                self.q = list(self._buf)
                self.n = [0.0, 1.0, 2.0, 3.0, 4.0]
                self.n_des = [0.0, 2 * p, 4 * p, 2 + 2 * p, 4.0]
                self.dn = [0.0, p / 2, p, (1 + p) / 2, 1.0]
            return
        q, n = self.q, self.n
        if x < q[0]:
            q[0] = x
            k = 0
        elif x >= q[4]:
            q[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x >= q[i]:
                    k = i
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self.n_des[i] += self.dn[i]
        for i in (1, 2, 3):
            d = self.n_des[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or \
                    (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                qp = self._parabolic(i, d)
                if not q[i - 1] < qp < q[i + 1]:
                    qp = self._linear(i, d)
                q[i] = qp
                n[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        q, n = self.q, self.n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self.q is not None:
            return self.q[2]
        if not self._buf:
            return math.nan
        # fewer than five observations: exact small-sample quantile
        # (a sort of <= 4 floats — never reached from the hot path once
        # the stream is warm)
        s = sorted(self._buf)
        idx = self.p * (len(s) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (idx - lo) * (s[hi] - s[lo])


@dataclass(frozen=True)
class StreamSummary:
    """Streaming aggregate of one numeric field of one stream — covers
    every value ever emitted, not just the ring-retained window."""
    count: int
    mean: float
    min: float
    max: float
    p50: float
    p95: float
    p99: float


class _FieldStats:
    """count/mean/min/max + the three P² sketches for one field."""

    __slots__ = ("count", "total", "min", "max", "p50", "p95", "p99")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.p50 = _P2Quantile(0.50)
        self.p95 = _P2Quantile(0.95)
        self.p99 = _P2Quantile(0.99)

    def add(self, x: float) -> None:
        self.count += 1
        self.total += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        self.p50.add(x)
        self.p95.add(x)
        self.p99.add(x)

    def summary(self) -> StreamSummary:
        return StreamSummary(
            count=self.count,
            mean=self.total / self.count if self.count else math.nan,
            min=self.min if self.count else math.nan,
            max=self.max if self.count else math.nan,
            p50=self.p50.value(),
            p95=self.p95.value(),
            p99=self.p99.value(),
        )


class TelemetryBus:
    """Bounded, lock-cheap event bus (module docstring has the design).

    ``emit(name, **fields)`` appends an ``Event`` to the stream's ring
    buffer, folds every numeric field into its streaming aggregates and
    hands the event to attached sinks.  ``snapshot``/``drain`` read the
    retained window; ``summary`` reads the full-stream aggregates."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.clock = clock
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._streams: Dict[str, deque] = {}
        self._stats: Dict[str, Dict[str, _FieldStats]] = {}
        self._counts: Dict[str, int] = {}
        self._sinks: List = []

    # ---- producer side -------------------------------------------------
    def emit(self, name: str, **fields) -> None:
        """Record one event on stream ``name``.  Numeric fields (int /
        float, not bool) additionally update the stream's aggregates."""
        ev = Event(self.clock(), name, fields)
        with self._lock:
            ring = self._streams.get(name)
            if ring is None:
                ring = deque(maxlen=self.capacity)
                self._streams[name] = ring
                self._stats[name] = {}
                self._counts[name] = 0
            ring.append(ev)
            self._counts[name] += 1
            stats = self._stats[name]
            for k, v in fields.items():
                if type(v) is int or type(v) is float:
                    fs = stats.get(k)
                    if fs is None:
                        fs = stats[k] = _FieldStats()
                    fs.add(float(v))
            sinks = tuple(self._sinks)
        # sinks write OUTSIDE the bus lock: a slow file flush must not
        # stall a concurrent emitter on the serving path
        for sink in sinks:
            sink.write(ev)

    # ---- consumer side -------------------------------------------------
    def streams(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def count(self, name: str) -> int:
        """Total events ever emitted on ``name`` (>= len(snapshot))."""
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self, name: str) -> List[Event]:
        """The retained window of ``name`` (ring order), non-destructive."""
        with self._lock:
            ring = self._streams.get(name)
            return list(ring) if ring is not None else []

    def drain(self, name: str) -> List[Event]:
        """Take and clear the retained window of ``name``.  Aggregates
        and total counts are NOT reset — they summarise the stream's
        whole history."""
        with self._lock:
            ring = self._streams.get(name)
            if ring is None:
                return []
            out = list(ring)
            ring.clear()
            return out

    def summary(self, name: str, field: str) -> Optional[StreamSummary]:
        """Streaming aggregates of ``field`` on stream ``name``; None if
        the pair has never carried a numeric value."""
        with self._lock:
            fs = self._stats.get(name, {}).get(field)
            return fs.summary() if fs is not None else None

    # ---- sinks ---------------------------------------------------------
    def attach(self, sink) -> None:
        """Subscribe a sink (any object with ``write(Event)``); it sees
        every subsequent emit."""
        with self._lock:
            self._sinks.append(sink)

    def detach(self, sink) -> None:
        with self._lock:
            self._sinks.remove(sink)

    def close(self) -> None:
        """Close every attached sink (idempotent per sink contract)."""
        with self._lock:
            sinks, self._sinks = list(self._sinks), []
        for sink in sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()
