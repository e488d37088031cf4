"""Load driver: pushes 10^5–10^6 scripted users through the cluster (the
port of the JAX package's ``loadgen/driver.py``).

Drives a solver-only ``SplitInferenceCluster`` (no model execution — the
solver/admission/governor path is what scales with users, the per-token
model math is benchmarked elsewhere) against a fake clock:

  per simulated round
    1. the trace scripts arrivals → ``cluster.submit`` per user
       (posting a fresh QoE deadline), and channel drift →
       ``cluster.observe`` with the next snapshot of a precomputed
       Gauss-Markov fading chain;
    2. one synchronous admission round (``cluster.step``) — where the
       governor, if attached, sheds load;
    3. the serving side picks the installed schedules up
       (``engine.round_snapshot``) after a scripted serve delay, which
       is what stamps the swap-to-serve lag on the bus.

Everything the report says comes off the telemetry bus: sustained
rounds/s and users/s (real wall clock), p50/p99 solver wall time (real),
p99 swap-to-serve lag (fake-clock seconds — deterministic), QoE
attainment, and the governor's defer/prioritise/force counts.  One
(trace, seed) pair is one deterministic workload, so a governor on/off
A/B replays bit-identical arrivals.

Scale notes: a submit is an O(1) validated enqueue (~µs), so the user
count is bounded by arrival volume, not solves; rounds cost one bucketed
partial solve each.  10^5 users ≈ 600 rounds at the default shape.

Scenarios: ``fading_chains`` draws each cell's scenario and its fading
chain with the port's own ``network.make_scenario``/``evolve_scenario``,
one ``torch.Generator`` per call seeded from ``(seed, index)`` at the
indices the JAX driver folds into its key (``100 + b`` for cell b's
scenario, ``10_000 + b·chain_len + i`` for link i of its chain).  torch
cannot reproduce the JAX driver's random bits, so the same seed gives
other channels than the JAX driver, with the same distribution;
everything else (the numpy draws, the rounds, the report) is the JAX
driver's.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import network, profiles
from repro_torch.core.ligd import SolverSpec
from repro_torch.launch.platform import resolve_device
from repro_torch.loadgen.traces import ArrivalTrace
from repro_torch.serving.cluster import SplitInferenceCluster
from repro_torch.telemetry import TelemetryBus


class SimClock:
    """The harness's fake clock — every cluster/bus timestamp is
    simulation time, so lag metrics and governor decisions are
    deterministic run to run."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclass
class LoadReport:
    """One load run, summarised off the bus (all latencies in ms)."""
    trace: str
    n_users: int                  # total submit() calls
    n_cells: int
    users_per_cell: int
    rounds: int                   # simulated rounds driven
    solve_rounds: int             # admission rounds that ran a solve
    shed_rounds: int              # rounds the governor fully deferred
    lanes_solved: int             # sum of per-round solved lane counts
    total_iters: int
    wall_s: float
    rounds_per_s: float           # simulated rounds / wall second
    users_per_s: float            # submits / wall second
    p50_solve_ms: float
    p99_solve_ms: float
    p99_swap_lag_ms: float        # fake-clock swap-to-serve lag
    qoe_attainment: float         # mean over per-round per-cell samples
    qoe_attainment_final: float   # mean of each cell's last measurement
    governor: bool
    n_deferred: int
    n_prioritised: int
    n_forced: int
    sim_s: float                  # fake-clock span of the run
    handovers: int = 0            # user moves applied (mobility traces)
    p99_handover_ms: float = float("nan")   # real wall, per handover
    extra: Dict = field(default_factory=dict)

    def as_record(self) -> Dict:
        d = asdict(self)
        d.update(d.pop("extra"))
        return d


def _sum_field(bus: TelemetryBus, stream: str, fld: str) -> float:
    s = bus.summary(stream, fld)
    return 0.0 if s is None or not s.count else s.mean * s.count


def seeded_generator(seed: int, *index: int) -> torch.Generator:
    """A host generator for draw ``index`` of run ``seed``: the port's
    counterpart of ``jax.random.fold_in(PRNGKey(seed), *index)``."""
    state = np.random.SeedSequence([seed, *index]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]) & (2**63 - 1))


def fading_chains(seed: int, ncfg, n_cells: int, chain_len: int,
                  rho: float, device) -> List[List]:
    """Per cell, ``chain_len`` Gauss-Markov snapshots of its channel, the
    first its fresh scenario."""
    chains: List[List] = []
    for b in range(n_cells):
        chain = [network.make_scenario(seeded_generator(seed, 100 + b),
                                       ncfg, device)]
        for i in range(chain_len - 1):
            chain.append(network.evolve_scenario(
                chain[-1],
                seeded_generator(seed, 10_000 + b * chain_len + i),
                rho=rho))
        chains.append(chain)
    return chains


def run_load(trace: ArrivalTrace, *,
             target_users: int = 100_000,
             n_cells: int = 8,
             users_per_cell: int = 16,
             n_subchannels: int = 4,
             profile: str = "nin",
             spec: Optional[SolverSpec] = None,
             governor=None,
             bus: Optional[TelemetryBus] = None,
             seed: int = 0,
             q_base_s: float = 0.35,
             drift_threshold: float = 0.15,
             drift_rho: float = 0.85,
             chain_len: int = 64,
             round_dt_s: float = 1.0,
             serve_dt_s: float = 0.05,
             max_rounds: int = 1_000_000,
             handover_mode: str = "move",
             device=None) -> LoadReport:
    """Run ``trace`` until ``target_users`` arrivals have been pushed.

    ``bus``: pass one to keep it (e.g. with a FileSink attached);
    default builds a fresh bus on the sim clock.  ``governor``: a
    ``QoSGovernor`` or None (ungoverned).  ``q_base_s`` is tuned so
    deadlines (``q_base * U(0.5, 2)``) straddle the solver's achievable
    latency: attainment lands strictly inside (0, 1), leaving the
    governor real failing-cell work instead of a degenerate all-pass or
    all-fail fleet (a below-typical-attainment floor turns EVERY cell
    "failing" and the governor can never defer; the default is tuned for
    the default shape over long drift-accumulating runs).  Returns the
    ``LoadReport``; the bus stays readable afterwards for deeper digs.

    Mobility: a trace exposing ``moves(r, n_cells, n_users, rng)`` (e.g.
    ``RandomWaypointTrace``) scripts per-round user→cell handovers,
    applied between arrivals and drift.  ``handover_mode`` picks the
    mechanism: ``'move'`` is ``cluster.move_user`` (one warm 1-lane
    solve of the receiver); ``'rejoin'`` is the naive leave+rejoin
    baseline — tear the receiving cell down and re-admit it with the
    moved user's threshold folded in (two resizes + a cold 1-lane
    solve, queued dst arrivals dropped) — the A/B the benchmark lane
    judges handover cost against.  Both modes consume identical rng
    draws, so the comparison replays bit-identical load.

    ``device``: where the cluster solves (default: the card; raises
    without one)."""
    clock = SimClock()
    if bus is None:
        bus = TelemetryBus(clock=clock, capacity=8192)
    else:
        # lag determinism requires every timestamp on the sim clock
        bus.clock = clock
    if spec is None:
        spec = SolverSpec(max_steps=6, per_user_split=False)
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    ncfg = network.small_config(n_users=users_per_cell,
                                n_subchannels=n_subchannels)
    prof = profiles.get_profile(profile, device)

    # precomputed Gauss-Markov fading chains, one per cell: the rounds
    # walk them forward so observe() sees genuinely continuous drift
    # without paying an evolve_scenario dispatch inside the timed loop
    chains = fading_chains(seed, ncfg, n_cells, chain_len, drift_rho,
                           device)

    cluster = SplitInferenceCluster(
        None, None, prof, spec=spec, clock=clock, bus=bus,
        governor=governor, drift_threshold=drift_threshold,
        default_q_s=q_base_s, device=device)
    ids = [cluster.add_cell(chain[0]) for chain in chains]
    cluster.start(threaded=False)
    engine = cluster.engine
    controller = cluster.controller

    if handover_mode not in ("move", "rejoin"):
        raise ValueError(f"handover_mode must be 'move' or 'rejoin', "
                         f"got {handover_mode!r}")
    pos = [0] * n_cells
    users_sent = 0
    r = 0
    # flash traces expose their spike window: break solve rounds (and
    # solved LANES — with idle-budget fill the round count alone no
    # longer separates governed from ungoverned) inside it out
    # separately — the numbers the governor A/B is judged on
    windowed = hasattr(trace, "in_spike")
    spike_rounds = spike_solve_rounds = spike_lanes_solved = 0
    # mobility traces script per-round handovers (duck-typed like the
    # spike window above)
    mobile = hasattr(trace, "moves")
    handover_wall: List[float] = []
    t_wall0 = time.perf_counter()
    while users_sent < target_users and r < max_rounds:
        load = trace.load(r, n_cells, rng)
        clock.advance(round_dt_s)
        for b, cid in enumerate(ids):
            for _ in range(int(load.arrivals_per_cell[b])):
                u = int(rng.integers(users_per_cell))
                q_s = float(q_base_s * rng.uniform(0.5, 2.0))
                cluster.submit(cid, u, q_s)
                users_sent += 1
        if mobile:
            for src, dst, u in trace.moves(r, n_cells, users_per_cell,
                                           rng):
                t_h0 = time.perf_counter()
                if handover_mode == "move":
                    cluster.move_user(ids[src], ids[dst], u)
                else:
                    # naive baseline: the receiving cell leaves and
                    # rejoins with the moved user's threshold folded in
                    q_dst = cluster.posted_q(ids[dst]).copy()
                    q_dst[u] = cluster.posted_q(ids[src])[u]
                    scn_dst = chains[dst][pos[dst]]
                    cluster.remove_cell(ids[dst])
                    ids[dst] = cluster.add_cell(scn_dst, q0=q_dst)
                handover_wall.append(time.perf_counter() - t_h0)
        if load.drift_steps:
            for b, cid in enumerate(ids):
                pos[b] = (pos[b] + load.drift_steps) % chain_len
                cluster.observe(cid, chains[b][pos[b]])
        if load.force_dirty:
            # adversarial trace: every cell is dirty THIS round whether
            # or not its drift crossed the threshold (reaches past the
            # facade on purpose — the queue is the documented seam)
            for b in range(n_cells):
                controller.queue.mark_dirty(b)
        result = cluster.step()
        if windowed and trace.in_spike(r):
            spike_rounds += 1
            spike_solve_rounds += int(result is not None)
            if result is not None:
                spike_lanes_solved += len(result.cells)
        clock.advance(serve_dt_s)
        # serving pickup: first snapshot of a fresh version stamps the
        # swap-to-serve lag on the bus
        engine.round_snapshot()
        r += 1
    wall_s = time.perf_counter() - t_wall0
    cluster.stop(drain=False)

    solve = bus.summary("admission_round", "solve_wall_s")
    lag = bus.summary("swap_to_serve", "lag_s")
    att = bus.summary("qoe_attainment", "attainment")
    att_final = controller.attainment()
    n_round_ev = bus.count("admission_round")
    solve_rounds = solve.count if solve else 0
    report = LoadReport(
        trace=trace.name,
        n_users=users_sent,
        n_cells=n_cells,
        users_per_cell=users_per_cell,
        rounds=r,
        solve_rounds=solve_rounds,
        shed_rounds=n_round_ev - solve_rounds,
        lanes_solved=int(round(_sum_field(bus, "admission_round",
                                          "n_solved"))),
        total_iters=int(round(_sum_field(bus, "admission_round", "iters"))),
        wall_s=wall_s,
        rounds_per_s=r / wall_s if wall_s > 0 else float("inf"),
        users_per_s=users_sent / wall_s if wall_s > 0 else float("inf"),
        p50_solve_ms=1e3 * solve.p50 if solve else float("nan"),
        p99_solve_ms=1e3 * solve.p99 if solve else float("nan"),
        p99_swap_lag_ms=1e3 * lag.p99 if lag else float("nan"),
        qoe_attainment=att.mean if att else float("nan"),
        qoe_attainment_final=float(np.mean(att_final))
        if att_final is not None else float("nan"),
        governor=governor is not None,
        n_deferred=int(round(_sum_field(bus, "admission_round",
                                        "n_deferred"))),
        n_prioritised=int(round(_sum_field(bus, "admission_round",
                                           "n_prioritised"))),
        n_forced=int(round(_sum_field(bus, "admission_round", "n_forced"))),
        sim_s=clock.t,
        handovers=len(handover_wall),
        p99_handover_ms=1e3 * float(np.percentile(handover_wall, 99))
        if handover_wall else float("nan"),
    )
    if windowed:
        report.extra["spike_rounds"] = spike_rounds
        report.extra["spike_solve_rounds"] = spike_solve_rounds
        report.extra["spike_lanes_solved"] = spike_lanes_solved
    if mobile:
        report.extra["handover_mode"] = handover_mode
    return report
