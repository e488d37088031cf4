"""The schedule store of the multi-cell serving engine.

``MultiCellServeEngine`` keeps the installed per-cell ``Schedule``s as one
immutable, versioned ``ScheduleSet``, swapped as a single reference under
a lock: a reader sees the whole previous round's schedules or the whole
new one, never a mix.  The admission loop installs and swaps schedules;
the cluster facade snapshots them.  Executing a served model on the
schedules arrives with the model slice of the port: until then the engine
is solver-only and takes ``params=None``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.scheduler import MultiCellScheduler, Schedule


@dataclass(frozen=True)
class ScheduleSet:
    """Immutable installed-schedule snapshot (one per cell, one version)."""
    version: int
    schedules: Tuple[Schedule, ...]


class MultiCellServeEngine:
    """Versioned schedule store for B cells.

    ``bus`` is an optional duck-typed event sink (anything with
    ``emit(name, **fields)``); every install/swap/resize records its
    version's install time, and the first ``round_snapshot`` of a version
    emits ``swap_to_serve`` with the lag."""

    def __init__(self, params, cfg, scns, scheduler: MultiCellScheduler,
                 *, bus=None, clock=time.monotonic):
        if params is not None:
            raise NotImplementedError(
                "model execution is not ported yet (the served-model slice "
                "of ROADMAP.md); build the engine solver-only with "
                "params=None")
        self.params = params
        self.cfg = cfg
        self.scns = list(scns)
        self.scheduler = scheduler
        self.bus = bus
        self.clock = clock
        self._pending_serve: Dict[int, float] = {}   # version -> install t
        self._lock = threading.Lock()
        self._installed: Optional[ScheduleSet] = None

    @property
    def n_cells(self) -> int:
        return len(self.scns)

    # ---- schedule store ------------------------------------------------
    def install_schedules(self, scheds: Sequence[Schedule]) -> int:
        """Atomically replace every cell's schedule; returns new version."""
        scheds = tuple(scheds)
        if len(scheds) != self.n_cells:
            raise ValueError(f"need {self.n_cells} schedules, "
                             f"got {len(scheds)}")
        with self._lock:
            version = (self._installed.version + 1) if self._installed else 1
            self._installed = ScheduleSet(version, scheds)
            self._pending_serve[version] = self.clock()
        if self.bus is not None:
            self.bus.emit("schedule_swap", version=version,
                          n_swapped=len(scheds), kind="install")
        return version

    def swap_schedules(self, per_cell: Dict[int, Schedule]) -> int:
        """Atomically swap a subset of cells' schedules; untouched cells
        keep theirs."""
        bad = [b for b in per_cell if not 0 <= int(b) < self.n_cells]
        if bad:
            raise ValueError(f"cells {bad} out of range [0, {self.n_cells})")
        with self._lock:
            if self._installed is None:
                raise RuntimeError("no schedules installed yet "
                                   "(bootstrap with install_schedules)")
            scheds = list(self._installed.schedules)
            for b, sched in per_cell.items():
                scheds[b] = sched
            version = self._installed.version + 1
            self._installed = ScheduleSet(version, tuple(scheds))
            self._pending_serve[version] = self.clock()
        if self.bus is not None:
            self.bus.emit("schedule_swap", version=version,
                          n_swapped=len(per_cell), kind="swap")
        return version

    def resize(self, scns, schedules=None, keep: Dict[int, int] = None
               ) -> int:
        """Cell churn: atomically replace the cell list AND its schedules
        in ONE versioned swap.  ``schedules`` = full per-cell sequence, or
        ``keep`` = {new_lane: old_lane} carrying surviving cells'
        installed schedules over with ``schedules`` = {new_lane: Schedule}
        for the other lanes."""
        scns = list(scns)
        if schedules is None and keep is None:
            raise ValueError("resize needs schedules (full sequence or "
                             "{lane: Schedule}) and/or keep= "
                             "{new_lane: old_lane} — every new lane must "
                             "get a schedule from one of the two")
        with self._lock:
            cur = self._installed
            if keep is not None or isinstance(schedules, dict):
                scheds: List[Optional[Schedule]] = [None] * len(scns)
                for new_i, old_i in (keep or {}).items():
                    if cur is None:
                        raise RuntimeError("keep= carries installed "
                                           "schedules over, but none are "
                                           "installed yet")
                    if not (0 <= new_i < len(scns)
                            and 0 <= old_i < len(cur.schedules)):
                        raise ValueError(f"keep entry {new_i}->{old_i} out "
                                         "of range")
                    scheds[new_i] = cur.schedules[old_i]
                for new_i, sched in (schedules or {}).items():
                    if not 0 <= int(new_i) < len(scns):
                        raise ValueError(f"schedule for lane {new_i} out "
                                         f"of range [0, {len(scns)})")
                    scheds[int(new_i)] = sched
                missing = [i for i, s in enumerate(scheds) if s is None]
                if missing:
                    raise ValueError(f"lanes {missing} have neither a "
                                     "carried-over (keep=) nor a fresh "
                                     "schedule")
            else:
                scheds = list(schedules)
                if len(scheds) != len(scns):
                    raise ValueError(f"need one schedule per cell: "
                                     f"{len(scns)} cells, {len(scheds)} "
                                     "schedules")
            version = (cur.version + 1) if cur else 1
            self.scns = scns
            self._installed = ScheduleSet(version, tuple(scheds))
            self._pending_serve[version] = self.clock()
        if self.bus is not None:
            self.bus.emit("schedule_swap", version=version,
                          n_swapped=len(scheds), kind="resize")
        return version

    def current_schedules(self) -> Optional[ScheduleSet]:
        """Consistent snapshot (single reference read under the lock)."""
        with self._lock:
            return self._installed

    def round_snapshot(self):
        """(ScheduleSet, scns, profiles) for one round, captured under one
        lock acquisition; emits the swap-to-serve lag on the first
        snapshot of a version."""
        lag = None
        with self._lock:
            ss, scns = self._installed, list(self.scns)
            if ss is not None and self._pending_serve:
                t_inst = self._pending_serve.pop(ss.version, None)
                if t_inst is not None:
                    lag = self.clock() - t_inst
                for v in [v for v in self._pending_serve
                          if v < ss.version]:
                    del self._pending_serve[v]
        if lag is not None and self.bus is not None:
            self.bus.emit("swap_to_serve", version=ss.version, lag_s=lag)
        profs = [self.scheduler.profile_for(b) for b in range(len(scns))]
        return ss, scns, profs

    @property
    def schedule_version(self) -> int:
        ss = self.current_schedules()
        return ss.version if ss else 0

    def set_scenario(self, cell: int, scn) -> None:
        """Publish a drifted channel snapshot for one cell (schedules are
        re-solved by the admission loop, not here)."""
        with self._lock:
            self.scns[cell] = scn
