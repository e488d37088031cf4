"""The port's QoSGovernor (``repro_torch.serving.governor``), the mirror
of tests/test_governor.py.  Decision policy: deterministic partitions of the touched
set under pressure — deferral band, prioritisation ordering, duty-cycle
cap, starvation force, churn remap.  Pure unit tests: no solver, no
clock, no threads — decisions are functions of (touched, drift,
attainment, defer streaks) only."""
import math

import pytest

from repro_torch.serving import GovernorDecision, QoSGovernor
from repro_torch.serving import governor as governor_mod

pytestmark = pytest.mark.telemetry

HEALTHY = [1.0] * 8


def _gov(**kw):
    kw.setdefault("pressure", 0.5)
    kw.setdefault("defer_band", 0.35)
    kw.setdefault("attainment_floor", 0.9)
    kw.setdefault("max_defer_rounds", 3)
    kw.setdefault("max_solve_frac", 0.5)
    return QoSGovernor(**kw)


# ------------------------------------------------------------- engagement
def test_inert_below_pressure():
    gov = _gov()
    # 3 of 8 touched < 0.5 pressure: ungoverned behaviour, lane order
    d = gov.review([2, 0, 1], {0: 0.9}, HEALTHY, n_cells=8)
    assert d == GovernorDecision((0, 1, 2), (), (), (), False)


def test_empty_touched_set():
    d = _gov().review([], {}, HEALTHY, n_cells=8)
    assert d.solve == () and not d.engaged


def test_inert_round_resets_defer_streaks():
    gov = _gov(max_solve_frac=0.25)
    for _ in range(2):  # build streaks on cold lanes under pressure
        d = gov.review(list(range(8)), {}, HEALTHY, n_cells=8)
    assert gov.defer_count(5) == 2
    gov.review([5], {}, HEALTHY, n_cells=8)          # below pressure
    assert gov.defer_count(5) == 0


# ---------------------------------------------------------- deferral band
def test_deferral_band_splits_hot_from_cold():
    gov = _gov(max_solve_frac=0.5)              # cap = 2: budget is full
    drift = {0: 0.50, 1: 0.34, 2: 0.36, 3: 0.0}
    d = gov.review([0, 1, 2, 3], drift, HEALTHY, n_cells=4)
    assert d.engaged
    # at/above the band solves (hottest first); below it defers
    assert d.solve == (0, 2)
    assert d.deferred == (1, 3)
    assert d.prioritised == () and d.forced == ()


def test_arrival_only_cells_read_zero_drift():
    gov = _gov(max_solve_frac=0.5)              # cap = 1: budget is full
    # lane 1 touched by arrivals only (absent from drift map) -> cold
    d = gov.review([0, 1], {0: 0.5}, HEALTHY, n_cells=2)
    assert d.solve == (0,) and d.deferred == (1,)


def test_idle_budget_filled_from_cold_longest_streak_first():
    gov = _gov(max_solve_frac=0.5)              # cap = 2 at n_cells=4
    # all cold: the cap's two slots go to cold lanes instead of sitting
    # idle while every lane defers and accrues streak
    d = gov.review([0, 1, 2, 3], {}, HEALTHY, n_cells=4)
    assert d.solve == (0, 1) and d.deferred == (2, 3)
    # next round the longest streaks (2, 3) take the slots
    d = gov.review([0, 1, 2, 3], {}, HEALTHY, n_cells=4)
    assert d.solve == (2, 3) and d.deferred == (0, 1)


def test_no_cell_defers_while_budget_idle():
    gov = _gov(max_solve_frac=1.0)
    # budget covers the whole fleet: an engaged round defers nothing
    d = gov.review(list(range(8)), {0: 0.9}, HEALTHY, n_cells=8)
    assert d.engaged and d.deferred == ()
    assert sorted(d.solve) == list(range(8))
    assert all(gov.defer_count(c) == 0 for c in range(8))


# ------------------------------------------------- prioritisation ordering
def test_failing_cells_prioritised_worst_first():
    gov = _gov(max_solve_frac=1.0)
    att = [1.0, 0.5, 0.8, 1.0]
    d = gov.review([0, 1, 2, 3], {0: 0.9, 3: 0.6}, att, n_cells=4)
    # failing lanes lead, worst attainment first, then drift-descending
    assert d.solve == (1, 2, 0, 3)
    assert d.prioritised == (1, 2)
    assert d.deferred == ()


def test_failing_cells_never_deferred_even_when_cold():
    gov = _gov(max_solve_frac=0.5)              # cap = 1, eaten by 0
    att = [0.2, 1.0]
    d = gov.review([0, 1], {}, att, n_cells=2)  # both zero drift
    assert 0 in d.solve and d.prioritised == (0,)
    assert d.deferred == (1,)


def test_nan_attainment_reads_healthy():
    gov = _gov(max_solve_frac=0.5)              # cap = 1: budget is full
    d = gov.review([0, 1], {0: 0.5}, [math.nan, math.nan], n_cells=2)
    assert d.prioritised == ()
    assert d.solve == (0,) and d.deferred == (1,)


def test_duty_cycle_cap_trims_drift_tail_only():
    gov = _gov(max_solve_frac=0.5)          # cap = ceil(0.5 * 8) = 4
    att = [1.0] * 8
    att[6] = 0.1
    att[7] = 0.2
    drift = {c: 0.4 + 0.01 * c for c in range(6)}   # all hot, 5 hottest
    d = gov.review(list(range(8)), drift, att, n_cells=8)
    # failing lanes occupy budget first; remaining 2 slots go to the
    # hottest drift; the drift tail defers
    assert d.prioritised == (6, 7)
    assert d.solve == (6, 7, 5, 4)
    assert d.deferred == (0, 1, 2, 3)


def test_prioritised_overflow_never_trimmed():
    gov = _gov(max_solve_frac=0.25)         # cap = 1
    att = [0.1, 0.2, 0.3, 1.0]
    d = gov.review([0, 1, 2, 3], {3: 0.9}, att, n_cells=4)
    # three failing cells overshoot the cap and all still solve; the
    # healthy hot cell is what pays
    assert d.solve == (0, 1, 2)
    assert d.deferred == (3,)


# ---------------------------------------------------------- starvation
def test_all_dirty_forced_round_after_max_deferrals():
    gov = _gov(max_defer_rounds=2, max_solve_frac=0.25)   # cap = 1
    touched = list(range(4))
    d = gov.review(touched, {}, HEALTHY, n_cells=4)       # all cold
    assert d.solve == (0,) and d.deferred == (1, 2, 3)
    # the longest-streak cold lane takes the idle slot next
    d = gov.review(touched, {}, HEALTHY, n_cells=4)
    assert d.solve == (1,) and d.deferred == (0, 2, 3)
    assert gov.defer_count(2) == 2 and gov.defer_count(3) == 2
    d = gov.review(touched, {}, HEALTHY, n_cells=4)
    # lanes 2 and 3 hit the starvation bound together -> both forced,
    # overshooting the cap (forced lanes are never trimmed)
    assert d.forced == (2, 3)
    assert d.solve == (2, 3) and d.deferred == (0, 1)
    assert gov.defer_count(2) == 0 and gov.defer_count(3) == 0


def test_forced_cells_lead_the_solve_order():
    gov = _gov(max_defer_rounds=1, max_solve_frac=0.5)
    # round 1 (cap 2): hot lane 1 solves, the idle slot pulls in lane 0,
    # lane 2 defers straight to the starvation bound
    d = gov.review([0, 1, 2], {1: 0.9}, HEALTHY, n_cells=3)
    assert d.solve == (1, 0) and d.deferred == (2,)
    att = [1.0, 0.5, 1.0, 1.0]
    d = gov.review([0, 1, 2, 3], {3: 0.9}, att, n_cells=4)
    # forced (lane order) > failing > hot; forced+failing eat the cap
    assert d.forced == (2,)
    assert d.solve == (2, 1)
    assert d.deferred == (0, 3)


def test_solving_resets_streak_deferring_extends_it():
    gov = _gov(max_defer_rounds=3, max_solve_frac=0.5)    # cap = 1
    gov.review([0, 1], {}, HEALTHY, n_cells=2)         # 0 fills, 1 defers
    gov.review([0, 1], {0: 0.9}, HEALTHY, n_cells=2)   # 0 solves, 1 defers
    assert gov.defer_count(0) == 0 and gov.defer_count(1) == 2


def test_note_solved_resets_streak():
    gov = _gov(max_solve_frac=0.25)                    # cap = 1
    gov.review([0, 1, 2, 3], {3: 0.9}, HEALTHY, n_cells=4)
    assert gov.defer_count(1) == 1
    # an out-of-band solve (move_user's receiver) resets only that lane
    gov.note_solved(1)
    assert gov.defer_count(1) == 0 and gov.defer_count(2) == 1


# ---------------------------------------------------------- determinism
def test_decisions_deterministic():
    def play(gov):
        out = []
        out.append(gov.review(list(range(8)),
                              {c: 0.1 * c for c in range(8)},
                              [1.0, 0.3, 1.0, 0.85, 1.0, 1.0, 0.1, 1.0],
                              n_cells=8))
        out.append(gov.review([1, 3, 5, 7], {5: 0.7},
                              HEALTHY, n_cells=8))
        out.append(gov.review(list(range(8)), {}, HEALTHY, n_cells=8))
        return out

    assert play(_gov()) == play(_gov())


# --------------------------------------------------------------- churn
def test_remap_carries_streaks_drops_removed():
    gov = _gov(max_solve_frac=0.25)                    # cap = 1
    # hot lane 3 absorbs the whole budget, so 0..2 defer both rounds
    gov.review([0, 1, 2, 3], {3: 0.9}, HEALTHY, n_cells=4)
    gov.review([0, 1, 2, 3], {3: 0.9}, HEALTHY, n_cells=4)
    gov.remap({0: 0, 2: 1})                            # lane 1 removed
    assert gov.defer_count(0) == 2
    assert gov.defer_count(1) == 2      # was lane 2
    assert gov.defer_count(2) == 0


# ----------------------------------------------------------- validation
@pytest.mark.parametrize("kw", [
    {"pressure": 1.5}, {"defer_band": -0.1}, {"attainment_floor": 2.0},
    {"max_defer_rounds": 0}, {"max_solve_frac": 0.0},
])
def test_knob_validation(kw):
    with pytest.raises(ValueError):
        QoSGovernor(**kw)


def test_port_copy_matches_the_jax_package():
    """The port's copy makes the JAX package's decisions on a seeded
    stream of random rounds, streak for streak."""
    import dataclasses

    import numpy as np

    from repro.serving.governor import QoSGovernor as JaxGovernor

    rng = np.random.default_rng(0)
    kw = dict(pressure=0.4, defer_band=0.3, attainment_floor=0.85,
              max_defer_rounds=2, max_solve_frac=0.4)
    ours, theirs = governor_mod.QoSGovernor(**kw), JaxGovernor(**kw)
    for _ in range(200):
        n = int(rng.integers(1, 12))
        touched = sorted(rng.choice(n, int(rng.integers(0, n + 1)),
                                    replace=False).tolist())
        drift = {int(c): float(rng.uniform(0, 0.6)) for c in touched
                 if rng.random() < 0.7}
        att = [float(a) if rng.random() < 0.9 else math.nan
               for a in rng.uniform(0.5, 1.0, n)]
        if rng.random() < 0.1:
            keep = {c: i for i, c in enumerate(range(0, n, 2))}
            ours.remap(keep)
            theirs.remap(keep)
        got = ours.review(touched, drift, att, n_cells=n)
        want = theirs.review(touched, drift, att, n_cells=n)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert [ours.defer_count(c) for c in range(n)] == \
            [theirs.defer_count(c) for c in range(n)]
