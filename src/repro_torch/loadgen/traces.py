"""Synthetic arrival traces for the million-user load harness (the JAX
package's ``loadgen/traces.py``, copied: it uses only numpy).

A trace scripts the OFFERED LOAD per simulated round: how many users
arrive in each cell (posting fresh QoE deadlines through
``SplitInferenceCluster.submit``) and how hard the channels drift
(``observe``).  Four shapes, chosen to stress different parts of the
admission/governor loop:

  ``poisson``      stationary Poisson arrivals, gentle drift — the
                   steady-state baseline every other trace is read
                   against.
  ``diurnal``      sinusoidal day curve: load sweeps base→peak→base
                   over ``period_rounds``.  Exercises the bucket ladder
                   across every occupancy level.
  ``flash``        flash crowd: base load with a ``spike_mult``× step
                   inside a window.  Arrivals touch every cell every
                   round inside the window while drift stays low — the
                   exact regime the QoS governor exists for (defer
                   healthy low-drift cells, keep the solver duty-cycle
                   bounded).  The window is exposed so the harness can
                   A/B solver rounds inside it.
  ``adversarial``  all-cells-dirty: heavy drift every round on top of
                   steady arrivals, and every cell force-marked dirty —
                   the governor cannot defer hot cells, only cap and
                   rotate them.

Traces are pure descriptions: sampling happens in the driver with ITS
``numpy.random.Generator``, so one (trace, seed) pair is one
deterministic workload — the governor A/B replays bit-identical
arrivals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class RoundLoad:
    """Offered load of one simulated round (driver-facing)."""
    arrivals_per_cell: np.ndarray   # (B,) int — submit() calls per cell
    drift_steps: int                # Gauss-Markov chain steps this round
    force_dirty: bool               # adversarial: mark EVERY cell dirty


class ArrivalTrace:
    """Base trace: Poisson-sample ``rate(r)`` arrivals per cell."""

    name = "trace"

    def rate(self, r: int) -> float:
        """Mean arrivals per cell at simulated round ``r``."""
        raise NotImplementedError

    def drift_steps(self, r: int) -> int:
        """Fading-chain steps every cell takes at round ``r``."""
        return 1

    def force_dirty(self, r: int) -> bool:
        return False

    def load(self, r: int, n_cells: int,
             rng: np.random.Generator) -> RoundLoad:
        return RoundLoad(
            arrivals_per_cell=rng.poisson(self.rate(r), n_cells),
            drift_steps=self.drift_steps(r),
            force_dirty=self.force_dirty(r))


@dataclass(frozen=True)
class PoissonTrace(ArrivalTrace):
    rate_per_cell: float = 20.0
    name: str = "poisson"

    def rate(self, r: int) -> float:
        return self.rate_per_cell


@dataclass(frozen=True)
class DiurnalTrace(ArrivalTrace):
    """Sinusoidal day curve, troughs at r = 0 mod period."""
    base_rate: float = 5.0
    peak_rate: float = 40.0
    period_rounds: int = 200
    name: str = "diurnal"

    def rate(self, r: int) -> float:
        phase = 2.0 * math.pi * (r % self.period_rounds) / self.period_rounds
        return self.base_rate + (self.peak_rate - self.base_rate) \
            * 0.5 * (1.0 - math.cos(phase))


@dataclass(frozen=True)
class FlashCrowdTrace(ArrivalTrace):
    """Step spike: ``spike_mult`` × base inside [spike_start,
    spike_start + spike_rounds).  Low drift throughout — the spike is
    pure arrival pressure, the governor's home turf."""
    base_rate: float = 8.0
    spike_mult: float = 8.0
    spike_start: int = 100
    spike_rounds: int = 150
    name: str = "flash"

    def rate(self, r: int) -> float:
        return self.base_rate * (self.spike_mult if self.in_spike(r)
                                 else 1.0)

    def in_spike(self, r: int) -> bool:
        return self.spike_start <= r < self.spike_start + self.spike_rounds

    def drift_steps(self, r: int) -> int:
        # channels drift slowly: inside the spike the touched set is
        # arrival-driven, exactly the shape deferral is safe on
        return 1 if r % 4 == 0 else 0


@dataclass(frozen=True)
class AdversarialTrace(ArrivalTrace):
    """Worst case for the solver: every cell dirty every round, with
    hard drift — deferral is never safe, only the duty-cycle cap and
    the starvation force apply."""
    rate_per_cell: float = 15.0
    drift_steps_per_round: int = 3
    name: str = "adversarial"

    def rate(self, r: int) -> float:
        return self.rate_per_cell

    def drift_steps(self, r: int) -> int:
        return self.drift_steps_per_round

    def force_dirty(self, r: int) -> bool:
        return True


@dataclass(frozen=True)
class RandomWaypointTrace(FlashCrowdTrace):
    """Mobility on top of a flash crowd: users hop between grid-adjacent
    cells (random-waypoint over a ``cols``-wide cell grid) while the
    arrival spike drives the governor into deferral — handover lands
    exactly where churn is most expensive.  ``moves(r, ...)`` is the
    per-round user→cell movement matrix, sampled with the DRIVER's rng
    like arrivals, so one (trace, seed) pair replays bit-identical
    mobility for the move vs leave+rejoin A/B.

    ``move_rate``: mean handovers per round across the whole fleet;
    multiplied by ``spike_move_mult`` inside the flash window (a crowd
    that surges also moves)."""
    move_rate: float = 2.0
    spike_move_mult: float = 2.0
    grid_cols: int = 0              # 0: auto — ~square grid
    name: str = "mobility"

    def neighbours(self, cell: int, n_cells: int) -> list:
        """Grid 4-neighbourhood of ``cell`` (row-major, ``cols`` wide)."""
        cols = self.grid_cols or max(math.isqrt(max(n_cells, 1)), 1)
        row, col = divmod(cell, cols)
        out = []
        for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            nr, nc = row + dr, col + dc
            dst = nr * cols + nc
            if nr >= 0 and 0 <= nc < cols and 0 <= dst < n_cells:
                out.append(dst)
        return out

    def moves(self, r: int, n_cells: int, n_users: int,
              rng: np.random.Generator) -> list:
        """Sample this round's handovers: a list of (src_cell, dst_cell,
        user) hops to grid-adjacent cells.  Duck-typed by the driver —
        any trace growing a ``moves`` method becomes a mobility trace."""
        if n_cells < 2:
            return []
        mean = self.move_rate * (self.spike_move_mult if self.in_spike(r)
                                 else 1.0)
        hops = []
        for _ in range(int(rng.poisson(mean))):
            src = int(rng.integers(n_cells))
            nbrs = self.neighbours(src, n_cells)
            if not nbrs:
                continue
            dst = int(nbrs[rng.integers(len(nbrs))])
            hops.append((src, dst, int(rng.integers(n_users))))
        return hops


_TRACES = {
    "poisson": PoissonTrace,
    "diurnal": DiurnalTrace,
    "flash": FlashCrowdTrace,
    "adversarial": AdversarialTrace,
    "mobility": RandomWaypointTrace,
}


def make_trace(name: str, **kw) -> ArrivalTrace:
    """Trace registry: ``make_trace('flash', spike_mult=10)`` etc."""
    try:
        cls = _TRACES[name]
    except KeyError:
        raise ValueError(f"unknown trace {name!r} — "
                         f"one of {sorted(_TRACES)}") from None
    return cls(**kw)
