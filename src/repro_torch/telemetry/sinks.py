"""Telemetry sinks: durable consumers attached to a ``TelemetryBus``.

``FileSink`` lands every event as one JSON line — the trace format behind
``serve.py --trace PATH`` and the load harness's optional trace dumps.
One line per event keeps the file greppable and tail-able while a run is
live; a crashed run loses at most the unflushed tail.
"""
from __future__ import annotations

import json
import threading
from typing import IO, Optional, Union

from repro_torch.telemetry.bus import Event


def _jsonable(v):
    """Coerce non-JSON field values (numpy scalars, exceptions, arrays)
    to something serialisable without importing numpy here."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)   # numpy scalar -> python scalar
    if item is not None:
        try:
            return item()
        except (TypeError, ValueError):
            pass
    tolist = getattr(v, "tolist", None)
    if tolist is not None:
        try:
            return tolist()
        except (TypeError, ValueError):
            pass
    return repr(v)


class FileSink:
    """JSONL sink: ``{"t": ..., "event": ..., **fields}`` per line.

    Writes are serialised by a sink-local lock (the bus hands events over
    OUTSIDE its own lock, so two emitters may race into the sink).
    ``flush_every`` bounds how many events a crash can lose; ``close()``
    flushes and (for paths the sink opened itself) closes the file."""

    def __init__(self, path_or_file: Union[str, IO], *,
                 flush_every: int = 64):
        if hasattr(path_or_file, "write"):
            self._f: Optional[IO] = path_or_file
            self._owns = False
            self.path = getattr(path_or_file, "name", "<stream>")
        else:
            self.path = str(path_or_file)
            self._f = open(self.path, "w")
            self._owns = True
        self._lock = threading.Lock()
        self._flush_every = max(int(flush_every), 1)
        self._since_flush = 0
        self.n_written = 0

    def write(self, ev: Event) -> None:
        rec = {"t": ev.t, "event": ev.name}
        for k, v in ev.fields.items():
            rec[k] = _jsonable(v)
        line = json.dumps(rec, separators=(",", ":"))
        with self._lock:
            if self._f is None:
                return            # closed — drop silently (shutdown race)
            self._f.write(line + "\n")
            self.n_written += 1
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._f.flush()
                self._since_flush = 0

    def flush(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._since_flush = 0

    def close(self) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            if self._owns:
                self._f.close()
            self._f = None
