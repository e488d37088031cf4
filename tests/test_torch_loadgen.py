"""The port's load generator (``repro_torch.loadgen``) and cross-cell
handover (``SplitInferenceCluster.move_user``) on the CPU: the mirror of
tests/test_loadgen.py and tests/test_handover.py at 10^3 users or fewer,
plus the port's driver held against the JAX driver on the same scenario
chain.

Load generator: traces + driver on the fake clock — arrivals replay
bit-identically per (trace, seed), swap-to-serve lag advances on the
SimClock, and the governor A/B mechanics are asserted at small scale.
Handover: per-(lane, user) state transfer, the 1-lane receiver-only warm
re-solve with the moved user's allocation row grafted from its source
cell, churn discipline, governor streak carry, the ``handover`` stream,
and the mobility-trace smoke.  The warm-seed assertions spy on
``ligd.solve_batch`` and compare the ``init_alloc`` the solve was GIVEN."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import ligd as ligd_mod
from repro_torch.core import network, profiles
from repro_torch.core.ligd import SolverSpec
from repro_torch.loadgen import (AdversarialTrace, DiurnalTrace,
                                 FlashCrowdTrace, PoissonTrace,
                                 RandomWaypointTrace, make_trace, run_load)
from repro_torch.loadgen import driver as port_driver
from repro_torch.serving import QoSGovernor
from repro_torch.serving.cluster import SplitInferenceCluster
from repro_torch.telemetry import TelemetryBus

pytestmark = pytest.mark.telemetry

CPU = "cpu"


# ---------------------------------------------------------------- traces
def test_registry_builds_each_shape():
    assert isinstance(make_trace("poisson"), PoissonTrace)
    assert isinstance(make_trace("diurnal"), DiurnalTrace)
    assert isinstance(make_trace("flash", spike_mult=10.0), FlashCrowdTrace)
    assert isinstance(make_trace("adversarial"), AdversarialTrace)
    with pytest.raises(ValueError, match="unknown trace"):
        make_trace("tsunami")


def test_diurnal_rate_curve():
    tr = DiurnalTrace(base_rate=5.0, peak_rate=40.0, period_rounds=200)
    assert tr.rate(0) == pytest.approx(5.0)          # trough
    assert tr.rate(100) == pytest.approx(40.0)       # peak at half period
    assert tr.rate(200) == pytest.approx(5.0)        # periodic
    assert 5.0 < tr.rate(50) < 40.0


def test_flash_window_and_multiplier():
    tr = FlashCrowdTrace(base_rate=8.0, spike_mult=8.0,
                         spike_start=10, spike_rounds=5)
    assert not tr.in_spike(9) and tr.in_spike(10)
    assert tr.in_spike(14) and not tr.in_spike(15)
    assert tr.rate(9) == pytest.approx(8.0)
    assert tr.rate(12) == pytest.approx(64.0)


def test_adversarial_forces_every_cell_dirty():
    tr = AdversarialTrace()
    rng = np.random.default_rng(0)
    load = tr.load(0, 4, rng)
    assert load.force_dirty and load.drift_steps == 3
    assert load.arrivals_per_cell.shape == (4,)


def test_trace_sampling_deterministic_per_seed():
    tr = PoissonTrace(rate_per_cell=20.0)
    a = tr.load(3, 8, np.random.default_rng(7)).arrivals_per_cell
    b = tr.load(3, 8, np.random.default_rng(7)).arrivals_per_cell
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- driver
SMOKE = dict(target_users=1_000, n_cells=4, users_per_cell=8,
             n_subchannels=4, seed=0, device=CPU)


def test_smoke_run_reports_the_headline_metrics():
    rep = run_load(make_trace("poisson"), **SMOKE)
    assert rep.n_users >= 1_000
    assert rep.rounds > 0 and rep.solve_rounds > 0
    assert rep.shed_rounds == 0                      # ungoverned
    assert rep.p99_solve_ms > 0
    assert 0.0 <= rep.qoe_attainment <= 1.0
    assert 0.0 <= rep.qoe_attainment_final <= 1.0
    # swap-to-serve lag is fake-clock: exactly the scripted serve delay
    assert rep.p99_swap_lag_ms == pytest.approx(50.0)
    assert rep.sim_s == pytest.approx(rep.rounds * 1.05)
    rec = rep.as_record()
    for k in ("trace", "n_users", "solve_rounds", "p99_solve_ms",
              "p99_swap_lag_ms", "qoe_attainment", "governor"):
        assert k in rec


def test_fake_clock_metrics_replay_identically():
    a = run_load(make_trace("diurnal", period_rounds=20), **SMOKE)
    b = run_load(make_trace("diurnal", period_rounds=20), **SMOKE)
    # everything not measured on the real wall clock is bit-identical
    assert a.n_users == b.n_users and a.rounds == b.rounds
    assert a.solve_rounds == b.solve_rounds
    assert a.lanes_solved == b.lanes_solved
    assert a.total_iters == b.total_iters
    assert a.p99_swap_lag_ms == b.p99_swap_lag_ms
    assert a.qoe_attainment == b.qoe_attainment
    assert a.qoe_attainment_final == b.qoe_attainment_final


def test_governor_ab_sheds_flash_crowd_load():
    tr = make_trace("flash", spike_start=5, spike_rounds=20,
                    base_rate=4.0, spike_mult=8.0)
    off = run_load(tr, **SMOKE)
    on = run_load(tr, **SMOKE, governor=QoSGovernor())
    # the A/B replays identical arrivals...
    assert on.n_users == off.n_users and on.rounds == off.rounds
    # ...and the governor strictly sheds spike-window solver LANES.
    # (Round counts no longer separate the modes: since the idle-budget
    # fill, an engaged round always solves >= 1 lane, so the shed shows
    # up in how many lanes each round solves, not in whether it solves.)
    assert on.extra["spike_lanes_solved"] < off.extra["spike_lanes_solved"]
    assert off.extra["spike_solve_rounds"] == off.extra["spike_rounds"]
    assert on.n_deferred > 0
    assert off.n_deferred == 0 and off.shed_rounds == 0
    # while QoE attainment holds (acceptance band: within 2%)
    assert on.qoe_attainment >= off.qoe_attainment - 0.02


def test_adversarial_trace_cannot_be_fully_shed():
    rep = run_load(make_trace("adversarial"), **SMOKE,
                   governor=QoSGovernor())
    # every cell dirty every round: the governor caps and rotates, but
    # each round still solves someone (deferral is never a full shed
    # once drift marks are hard)
    assert rep.solve_rounds + rep.shed_rounds == rep.rounds
    assert rep.solve_rounds == rep.rounds and rep.shed_rounds == 0
    # the cap defers the overflow every round, yet nothing starves into
    # a forced solve: idle-budget fill + drift rotation keep every lane
    # fresh before its streak reaches the starvation bound
    assert rep.n_deferred > 0 and rep.n_forced == 0


# ---------------------------------------------------------------- handover
N_USERS = 6
N_SUBCH = 3


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _scn(seed):
    cfg = network.small_config(n_users=N_USERS, n_subchannels=N_SUBCH)
    return network.make_scenario(torch.Generator().manual_seed(seed), cfg,
                                 CPU)


def _cluster(n=3, **kw):
    spec = kw.pop("spec", SolverSpec(max_steps=5, tol=0.0))
    clock = FakeClock()
    cl = SplitInferenceCluster(None, None, profiles.get_profile("nin", CPU),
                               spec=spec, clock=clock, default_q_s=0.4,
                               drift_threshold=0.15, device=CPU, **kw)
    ids = [cl.add_cell(_scn(s)) for s in range(n)]
    cl.start(threaded=False)
    return cl, ids, clock


def _alloc_rows(alloc, u):
    """One user's row of every Allocation leaf, as numpy."""
    return [np.asarray(leaf)[u] for leaf in alloc]


# ------------------------------------------------------ the core contract
def test_move_user_solves_only_receiver(monkeypatch):
    cl, (a, b, c), clock = _cluster()
    clock.advance(1.0)
    cl.submit(a, 2, 0.17)
    cl.step()

    before = {cid: cl.installed_schedule(cid) for cid in (a, b, c)}
    out_a, ref_a = cl.last_outcome(a), cl.drift_reference(a)
    ver0 = cl.schedule_version
    solved_lane_counts = []
    orig = ligd_mod.solve_batch

    def spy(*args, **kw):
        outs = orig(*args, **kw)
        solved_lane_counts.append(len(outs))
        return outs

    monkeypatch.setattr(ligd_mod, "solve_batch", spy)
    rnd = cl.move_user(a, b, 2)
    # exactly ONE 1-lane solve: the receiver; the source solves nothing
    assert solved_lane_counts == [1]
    assert rnd.cells == (cl.lane_of(b),)
    # one version bump, survivors' schedules object-identical
    assert cl.schedule_version == ver0 + 1
    assert cl.installed_schedule(a) is before[a]
    assert cl.installed_schedule(c) is before[c]
    assert cl.installed_schedule(b) is not before[b]
    # the source's drift reference and warm-start outcome are untouched
    assert cl.last_outcome(a) is out_a
    assert cl.drift_reference(a) is ref_a
    # the threshold transferred; the vacated slot keeps its placeholder
    assert cl.posted_q(b)[2] == np.float32(0.17)
    assert cl.posted_q(a)[2] == np.float32(0.17)
    cl.stop()


def test_move_user_transfers_threshold_age():
    cl, (a, b, _), clock = _cluster(qoe_half_life_s=10.0, q_age_cap=4.0)
    clock.advance(1.0)
    cl.submit(a, 3, 0.1)               # posted at t=1
    cl.step()
    clock.advance(10.0)                # one half-life idle
    cl.move_user(a, b, 3, dst_user=0)
    # the age travelled with the threshold: the destination slot reads
    # one half-life old (doubled), not freshly posted
    assert cl.effective_q(b)[0] == pytest.approx(0.2, rel=1e-3)
    assert cl.posted_q(b)[0] == np.float32(0.1)
    cl.stop()


def test_warm_seed_row_grafted_bitwise(monkeypatch):
    cl, (a, b, _), clock = _cluster()
    clock.advance(1.0)
    cl.submit(a, 4, 0.21)
    cl.step()
    src_rows = _alloc_rows(cl.last_outcome(a).alloc, 4)
    dst_out_before = cl.last_outcome(b)

    seeds = []
    orig = ligd_mod.solve_batch

    def spy(*args, **kw):
        seeds.append(kw.get("init_alloc"))
        return orig(*args, **kw)

    monkeypatch.setattr(ligd_mod, "solve_batch", spy)
    cl.move_user(a, b, 4, dst_user=1)
    # the receiver's 1-lane solve was seeded from its own previous
    # outcome with the moved user's row replaced by the SOURCE cell's
    # solved row — bitwise, before any in-solve softening
    assert len(seeds) == 1 and seeds[0] is not None
    init = seeds[0]
    for leaf, src_row in zip(init, src_rows):
        np.testing.assert_array_equal(np.asarray(leaf)[0, 1], src_row)
    # the other users' rows come from the receiver's own history
    for leaf, hist in zip(init, dst_out_before.alloc):
        for u in range(N_USERS):
            if u != 1:
                np.testing.assert_array_equal(np.asarray(leaf)[0, u],
                                              np.asarray(hist)[u])
    cl.stop()


def test_a_b_a_roundtrip_pins_warm_row(monkeypatch):
    cl, (a, b, _), clock = _cluster()
    clock.advance(1.0)
    cl.submit(a, 0, 0.19)
    cl.step()

    seeds = []
    orig = ligd_mod.solve_batch

    def spy(*args, **kw):
        seeds.append(kw.get("init_alloc"))
        return orig(*args, **kw)

    monkeypatch.setattr(ligd_mod, "solve_batch", spy)
    cl.move_user(a, b, 0)
    rows_after_b = _alloc_rows(cl.last_outcome(b).alloc, 0)
    cl.move_user(b, a, 0)
    # coming home, the user's warm row is bitwise the row B just solved
    # for it — the allocation follows the user through the round trip
    assert len(seeds) == 2
    for leaf, row_b in zip(seeds[1], rows_after_b):
        np.testing.assert_array_equal(np.asarray(leaf)[0, 0], row_b)
    # and the posted threshold round-trips to its original slot
    assert cl.posted_q(a)[0] == np.float32(0.19)
    cl.stop()


def test_move_user_without_warm_start(monkeypatch):
    cl, (a, b, _), clock = _cluster(
        spec=SolverSpec(max_steps=5, tol=0.0, warm=False))
    seeds = []
    orig = ligd_mod.solve_batch

    def spy(*args, **kw):
        seeds.append(kw.get("init_alloc"))
        return orig(*args, **kw)

    monkeypatch.setattr(ligd_mod, "solve_batch", spy)
    rnd = cl.move_user(a, b, 1)
    # warm start disabled: the override is moot, the solve runs cold —
    # handover still works, it just doesn't carry the allocation
    assert rnd.cells == (cl.lane_of(b),)
    assert seeds == [None]
    cl.stop()


def test_queued_arrival_follows_the_move():
    cl, (a, b, _), clock = _cluster()
    clock.advance(1.0)
    cl.submit(a, 5, 0.13)              # queued, not yet drained
    cl.move_user(a, b, 5, dst_user=2)
    rnd = cl.step()
    assert rnd is not None
    # the queued threshold landed on the DESTINATION slot, not on
    # whoever inherits the source slot
    assert cl.posted_q(b)[2] == np.float32(0.13)
    assert cl.posted_q(a)[5] == np.float32(0.4)
    cl.stop()


# ------------------------------------------------------------- validation
def test_move_user_validation():
    cl, (a, b, _), _ = _cluster()
    with pytest.raises(ValueError, match="same cell"):
        cl.move_user(a, a, 0)
    with pytest.raises(ValueError, match="out of range"):
        cl.move_user(a, b, N_USERS)
    with pytest.raises(ValueError, match="dst_user"):
        cl.move_user(a, b, 0, dst_user=-1)
    with pytest.raises(KeyError, match="unknown"):
        cl.move_user(a, 999, 0)
    cl.stop()


def test_move_user_requires_started_cluster():
    cl = SplitInferenceCluster(None, None, profiles.get_profile("nin", CPU),
                               spec=SolverSpec(max_steps=5, tol=0.0),
                               device=CPU)
    a = cl.add_cell(_scn(0))
    b = cl.add_cell(_scn(1))
    with pytest.raises(RuntimeError, match="start"):
        cl.move_user(a, b, 0)


# ------------------------------------------------------- governor interop
def test_move_user_resets_receiver_defer_streak():
    gov = QoSGovernor(max_solve_frac=0.25)      # cap = 1
    cl, ids, clock = _cluster(n=4, governor=gov)
    # hot lane 3 absorbs the budget twice: lanes 0..2 build streak 2
    for _ in range(2):
        gov.review([0, 1, 2, 3], {3: 0.9}, [1.0] * 4, n_cells=4)
    assert gov.defer_count(1) == 2 and gov.defer_count(2) == 2
    cl.move_user(ids[0], ids[1], 0)
    # the receiver just solved out of band -> its streak resets; the
    # source's (lane 0) and bystanders' streaks are untouched
    assert gov.defer_count(1) == 0
    assert gov.defer_count(0) == 2 and gov.defer_count(2) == 2
    cl.stop()


# ------------------------------------------------------------- telemetry
def test_handover_stream_emitted():
    bus = TelemetryBus(capacity=256)
    cl, (a, b, _), clock = _cluster(bus=bus)
    bus.clock = clock                  # sim-time stamps, like the driver
    clock.advance(1.0)
    cl.move_user(a, b, 3)
    evs = bus.snapshot("handover")
    assert len(evs) == 1
    f = evs[0].fields
    assert f["src"] == cl.lane_of(a) and f["dst"] == cl.lane_of(b)
    assert f["user"] == 3 and f["dst_user"] == 3
    assert f["warm_seeded"] is True
    assert f["solve_wall_s"] > 0
    # swap-to-serve continuity: the emitted version IS the installed one
    assert f["version"] == cl.schedule_version
    cl.stop()


# ------------------------------------------------------- mobility traces
def test_mobility_trace_moves_are_grid_adjacent():
    tr = make_trace("mobility", move_rate=5.0)
    assert isinstance(tr, RandomWaypointTrace)
    n_cells, n_users = 9, 8            # 3x3 grid
    moves = tr.moves(0, n_cells, n_users,
                     np.random.default_rng(7))
    assert moves                       # rate 5: all-empty is ~impossible
    for src, dst, u in moves:
        assert 0 <= u < n_users
        assert dst in tr.neighbours(src, n_cells)
    # deterministic: same rng seed -> identical movement matrix
    again = tr.moves(0, n_cells, n_users, np.random.default_rng(7))
    assert moves == again


def test_mobility_smoke_1k_users():
    """Tier-1 smoke: 10^3 fake-clock users through the mobility trace —
    handovers actually happen, the run stays error-free, and the report
    carries handover p99 next to solve p99."""
    tr = make_trace("mobility", spike_start=2, spike_rounds=8,
                    move_rate=1.5)
    rep = run_load(tr, target_users=1_000, n_cells=4, users_per_cell=8,
                   seed=0, device=CPU)
    assert rep.trace == "mobility"
    assert rep.n_users >= 1_000
    assert rep.handovers > 0
    assert np.isfinite(rep.p99_handover_ms) and rep.p99_handover_ms > 0
    assert np.isfinite(rep.p99_solve_ms)
    assert rep.extra["handover_mode"] == "move"
    rec = rep.as_record()
    assert "p99_handover_ms" in rec and "handovers" in rec


# ------------------------------------------------- against the JAX driver
def _jax_chains(seed, ncfg, n_cells, chain_len, rho, device):
    """The JAX driver's own scenario chain (``jax.random`` keys folded at
    ``100 + b`` and ``10_000 + b·chain_len + i``), carried into the port."""
    import jax

    import port_bridge as pb
    from repro.core import network as jnet

    key = jax.random.PRNGKey(seed)
    jcfg = jnet.NetworkConfig(**dataclasses.asdict(ncfg))
    chains = []
    for b in range(n_cells):
        chain = [jnet.make_scenario(jax.random.fold_in(key, 100 + b), jcfg)]
        for i in range(chain_len - 1):
            chain.append(jnet.evolve_scenario(
                chain[-1], jax.random.fold_in(key, 10_000 + b * chain_len + i),
                rho=rho))
        chains.append([pb.scenario(s) for s in chain])
    return chains


DETERMINISTIC = ("n_users", "n_cells", "users_per_cell", "rounds",
                 "solve_rounds", "shed_rounds", "lanes_solved", "governor",
                 "n_deferred", "n_prioritised", "n_forced", "sim_s",
                 "handovers")


@pytest.mark.parametrize("case", ["flash-governed", "mobility-rejoin"])
def test_driver_matches_jax_on_its_scenario_chain(monkeypatch, case):
    """With the JAX driver's scenario chain injected (the test's own
    patch of the port's ``fading_chains``), every deterministic report
    field equals the JAX driver's for the same trace and seed: arrivals
    and users sent, rounds, solved lanes in and out of the spike, the
    governor's counts, the fake-clock swap lag and the attainment."""
    from repro.core.ligd import SolverSpec as JaxSpec
    from repro.loadgen import make_trace as jax_trace
    from repro.loadgen import run_load as jax_run_load
    from repro.serving import QoSGovernor as JaxGovernor

    monkeypatch.setattr(port_driver, "fading_chains", _jax_chains)
    kw = dict(target_users=600, n_cells=4, users_per_cell=8,
              n_subchannels=4, seed=3, chain_len=16)
    if case == "flash-governed":
        trace = dict(name="flash", spike_start=3, spike_rounds=8,
                     base_rate=4.0, spike_mult=8.0)
        extra_j = dict(governor=JaxGovernor())
        extra = dict(governor=QoSGovernor())
    else:
        trace = dict(name="mobility", spike_start=2, spike_rounds=4,
                     move_rate=1.0)
        extra_j = extra = dict(handover_mode="rejoin")
    want = jax_run_load(jax_trace(**trace), **kw, **extra_j,
                        spec=JaxSpec(max_steps=6, per_user_split=False,
                                     step_impl="fused"))
    got = run_load(make_trace(**trace), **kw, **extra, device=CPU,
                   spec=SolverSpec(max_steps=6, per_user_split=False))
    for f in DETERMINISTIC:
        assert getattr(got, f) == getattr(want, f), f
    assert got.extra == want.extra
    assert got.p99_swap_lag_ms == want.p99_swap_lag_ms
    np.testing.assert_allclose(got.qoe_attainment, want.qoe_attainment,
                               atol=1e-6)
    np.testing.assert_allclose(got.qoe_attainment_final,
                               want.qoe_attainment_final, atol=1e-6)
    if case == "flash-governed":
        assert got.n_deferred > 0 and got.extra["spike_lanes_solved"] > 0
    else:
        assert got.handovers > 0


def test_driver_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_load(make_trace("poisson"), target_users=10, n_cells=2,
                 users_per_cell=4)


def test_seeded_generator_streams_differ_by_index_and_repeat():
    a = torch.rand(4, generator=port_driver.seeded_generator(0, 100))
    b = torch.rand(4, generator=port_driver.seeded_generator(0, 101))
    c = torch.rand(4, generator=port_driver.seeded_generator(0, 100))
    d = torch.rand(4, generator=port_driver.seeded_generator(1, 100))
    assert torch.equal(a, c)
    assert not torch.equal(a, b) and not torch.equal(a, d)
