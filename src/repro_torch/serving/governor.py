"""Cross-cell QoS governor: caps solver duty-cycle under pressure (the
JAX package's ``serving/governor.py``, copied: pure Python).

The admission loop (serving.admission) re-solves every cell that drifted
or received arrivals.  Under cluster-wide pressure — a flash crowd
touching every cell each round — that policy burns the whole solver
budget re-solving cells whose installed schedules are still fine, while
cells whose users are actually missing their QoE deadlines wait in the
same queue.  The governor closes the observe→decide loop the telemetry
bus makes possible: consulted once per admission round, it partitions
the touched-cell set into

  * **prioritised** — cells whose last measured QoE attainment (fraction
    of users whose predicted delay beats their effective aged threshold,
    emitted on the bus per round) is below ``attainment_floor``.  Always
    solved, never deferred, and first in line under the duty-cycle cap.
  * **forced** — cells deferred ``max_defer_rounds`` consecutive times.
    Starvation bound: a low-drift cell under sustained pressure is
    solved at least every ``max_defer_rounds + 1`` rounds.
  * **deferred** — cells whose drift is below ``defer_band`` (their
    installed schedule is still near-optimal) and whose attainment is
    healthy.  Their work is NOT dropped: the admission round re-marks
    them dirty, so they rejoin the next round's touched set (and their
    arrivals' threshold updates, already applied at drain, are solved
    then).

The remaining touched cells (drift at or above the band) are solved,
trimmed to ``ceil(max_solve_frac * n_cells)`` lanes per round — the
duty-cycle cap — in deterministic priority order: forced first, then
prioritised (worst attainment first), then by descending drift; ties
break on lane index.  Prioritised/forced cells are never trimmed.
Below ``pressure`` (touched fraction of the fleet) the governor is
inert: every touched cell solves, exactly the ungoverned policy.

Decisions are pure functions of (touched, drift, attainment, internal
defer counters) — deterministic under the fake clock, unit-tested in
tests/test_torch_governor.py, and emitted on the telemetry bus by the
admission round (stream ``governor``) so the load harness can assert
the governor actually sheds load during a flash crowd.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple


@dataclass(frozen=True)
class GovernorDecision:
    """One round's verdict.  ``solve`` is the lane subset the round
    should actually solve (deterministic priority order); the other
    three record WHY, for the bus and the tests.  ``prioritised`` and
    ``forced`` are subsets of ``solve``; ``deferred`` is disjoint."""
    solve: Tuple[int, ...]
    deferred: Tuple[int, ...]
    prioritised: Tuple[int, ...]
    forced: Tuple[int, ...]
    engaged: bool                 # False: below pressure, governor inert


class QoSGovernor:
    """Policy knobs (all documented in README "Observability"):

    ``pressure``         touched/total fraction at which the governor
                         engages (below it every touched cell solves).
    ``defer_band``       drift below which a healthy cell may be
                         deferred under pressure.  Must sit above the
                         admission loop's ``drift_threshold`` to ever
                         matter for drift-marked cells.
    ``attainment_floor`` cells whose last QoE attainment is below this
                         are prioritised (never deferred or trimmed).
    ``max_defer_rounds`` consecutive deferrals before a cell is forced
                         into the round (starvation bound).
    ``max_solve_frac``   duty-cycle cap: at most ceil(frac * n_cells)
                         non-prioritised lanes solve per engaged round.
    """

    def __init__(self, *, pressure: float = 0.5,
                 defer_band: float = 0.35,
                 attainment_floor: float = 0.9,
                 max_defer_rounds: int = 3,
                 max_solve_frac: float = 0.5):
        if not 0.0 <= pressure <= 1.0:
            raise ValueError(f"pressure must be in [0, 1], got {pressure}")
        if defer_band < 0.0:
            raise ValueError(f"defer_band must be >= 0, got {defer_band}")
        if not 0.0 <= attainment_floor <= 1.0:
            raise ValueError("attainment_floor must be in [0, 1], "
                             f"got {attainment_floor}")
        if max_defer_rounds < 1:
            raise ValueError("max_defer_rounds must be >= 1, "
                             f"got {max_defer_rounds}")
        if not 0.0 < max_solve_frac <= 1.0:
            raise ValueError("max_solve_frac must be in (0, 1], "
                             f"got {max_solve_frac}")
        self.pressure = float(pressure)
        self.defer_band = float(defer_band)
        self.attainment_floor = float(attainment_floor)
        self.max_defer_rounds = int(max_defer_rounds)
        self.max_solve_frac = float(max_solve_frac)
        # consecutive-deferral count per lane; reset when the lane solves
        self._defer_count: Dict[int, int] = {}

    # ---- the per-round decision ---------------------------------------
    def review(self, touched: Sequence[int],
               drift: Mapping[int, float],
               attainment: Sequence[float],
               n_cells: int) -> GovernorDecision:
        """Partition ``touched`` for one admission round.

        ``drift``: per-touched-lane drift vs the solved reference
        (missing lanes read as 0.0 — arrival-only cells).
        ``attainment``: last measured per-lane QoE attainment, indexed
        by lane; NaN (never measured) reads as healthy.  Mutates only
        the internal defer counters."""
        touched = sorted(int(c) for c in touched)
        if not touched:
            return GovernorDecision((), (), (), (), False)
        if len(touched) / max(n_cells, 1) < self.pressure:
            # inert: everything solves, deferral streaks end
            for c in touched:
                self._defer_count.pop(c, None)
            return GovernorDecision(tuple(touched), (), (), (), False)

        def att(c: int) -> float:
            a = float(attainment[c]) if c < len(attainment) else math.nan
            return a if not math.isnan(a) else 1.0

        forced = [c for c in touched
                  if self._defer_count.get(c, 0) >= self.max_defer_rounds]
        failing = [c for c in touched
                   if c not in forced and att(c) < self.attainment_floor]
        must = set(forced) | set(failing)
        hot = [c for c in touched if c not in must
               and float(drift.get(c, 0.0)) >= self.defer_band]
        cold = [c for c in touched if c not in must and c not in hot]

        # deterministic priority order: forced (lane order), prioritised
        # (worst attainment first), then hottest drift; lane breaks ties
        failing.sort(key=lambda c: (att(c), c))
        hot.sort(key=lambda c: (-float(drift.get(c, 0.0)), c))
        cap = math.ceil(self.max_solve_frac * max(n_cells, 1))
        # the cap trims only the drift-ranked tail — prioritised/forced
        # lanes always solve, even if that overshoots the cap
        budget = max(cap - len(forced) - len(failing), 0)
        solve = forced + failing + hot[:budget]
        deferred = hot[budget:]
        # idle-budget fill: when the hot list leaves solve slots unused,
        # cold cells take them (longest defer streak first, lane index
        # tiebreak) instead of deferring for nothing — un-filled slots
        # just let streaks accrue until the starvation bound forces every
        # cold cell in at once, overshooting the cap it was protecting
        leftover = budget - len(hot)
        if leftover > 0:
            cold.sort(key=lambda c: (-self._defer_count.get(c, 0), c))
            solve += cold[:leftover]
            cold = cold[leftover:]
        deferred += cold

        for c in solve:
            self._defer_count.pop(c, None)
        for c in deferred:
            self._defer_count[c] = self._defer_count.get(c, 0) + 1
        return GovernorDecision(tuple(solve), tuple(sorted(deferred)),
                                tuple(failing), tuple(forced), True)

    # ---- churn ---------------------------------------------------------
    def remap(self, old_to_new: Mapping[int, int]) -> None:
        """Follow a cell-lane remap (``AdmissionController.remove_cell``):
        surviving lanes keep their deferral streaks, removed lanes drop
        theirs.  Joining lanes need nothing — absent means streak 0."""
        self._defer_count = {old_to_new[c]: n
                             for c, n in self._defer_count.items()
                             if c in old_to_new}

    def note_solved(self, lane: int) -> None:
        """Reset ``lane``'s deferral streak after an out-of-band solve
        (handover: ``move_user`` re-solves the receiving cell outside any
        admission round).  The starvation bound should count rounds since
        the lane's schedule was actually fresh, not since ``review`` last
        happened to pick it."""
        self._defer_count.pop(int(lane), None)

    def defer_count(self, lane: int) -> int:
        """Current consecutive-deferral streak of ``lane`` (tests)."""
        return self._defer_count.get(lane, 0)
