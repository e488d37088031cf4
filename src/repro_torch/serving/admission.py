"""Async admission loop: event-driven scheduling for the split-serving
engine.

The paper's ERA/Li-GD algorithm solves one static channel snapshot; a
deployed scheduler re-solves continuously as users arrive and fading
drifts (the NOMA-MEC predecessors' setting).  Before this module the
serving layer ran in lockstep — every round paid a full blocking solve
(``MultiCellServeEngine.serve_round``) even when nothing had changed.
Here admission is decoupled from serving: requests keep executing on the
installed schedules while a background solver thread batches up pending
work and swaps in fresh schedules when they are ready.

Admission round lifecycle
-------------------------
  1. ACCUMULATE — arrivals (users posting fresh QoE deadlines via
     ``AdmissionController.submit``) and drift marks (cells whose live
     channel diverged from the snapshot their active schedule was solved
     on, via ``observe_scenario``) land in the ``AdmissionQueue``.
     Serving continues untouched on the installed ``ScheduleSet``.  An
     optional batching window (``min_interval_s``) keeps the solver thread
     idle between rounds so bursts coalesce and the solve's CPU share is
     duty-cycle bounded.
  2. DRAIN — one admission round (``step``) drains everything queued so
     far: all arrivals coalesce into one per-cell QoE-threshold update,
     and the touched-cell set is the union of arrival cells and drifted
     cells.  N arrivals never cost N solves.
  3. SOLVE — one batched, warm-started solve over the touched cells
     (``MultiCellScheduler.schedule(..., warm=True)``), seeded from the
     previous round's solved allocations — the paper's loop-iteration
     warm start extended across time.  With ``partial_batch`` (default)
     a round touching k < B cells solves only those lanes, padded onto
     the scheduler's bucket ladder (1/2/4/…/B), so a 2-dirty-cell drift
     round costs a 2-lane sweep, not a full-B one; untouched cells'
     warm-start state is untouched.  On ``start()`` this runs on the
     solver thread, so serving only shares the GIL with host dispatch,
     not with the compiled solve.
  4. SWAP — the touched cells' new schedules are installed atomically
     (``MultiCellServeEngine.swap_schedules`` replaces ONE versioned
     reference); rounds already executing finish on the snapshot they
     grabbed, new rounds see the new version.  Untouched cells keep their
     schedules.
  5. RESET — each touched cell's reference (scenario snapshot + QoE
     vector) is updated, so subsequent drift is measured against the
     state its *current* schedule was actually solved on.

Cell churn (coordinated join/leave): ``add_cell``/``remove_cell`` run a
membership change as one atomic unit against the round lifecycle — the
scheduler's stacked prep is remapped (survivors gathered device-side),
only a joining lane is solved (a 1-lane bucket; a leave solves nothing),
and the engine's cell list + schedules swap in ONE versioned install
carrying surviving cells' installed schedules over object-identical.
Drift references, posted/aged thresholds and queued arrivals/dirty marks
all follow the lane remap (``AdmissionQueue.remap``), so drift keeps
being measured against each surviving cell's OWN solved snapshot — the
positional-reference bug the pre-churn ``resize`` stopgap had.  Churn
serialises against admission rounds via the round lock; producers and
serving never block on it.  The ``SplitInferenceCluster`` facade keys all
of this by stable ``CellId`` (serving.cluster).

Drift-aware QoE aging (``qoe_half_life_s``): a user's posted deadline is
only as fresh as its last arrival.  Long-idle users' thresholds relax
exponentially — the effective threshold doubles every half-life since the
user's last post, capped at ``q_age_cap`` — so stale tight deadlines stop
constraining fresh rounds (a dead-session user no longer forces the
solver to burn power/compute on its lane).  Aging applies to what the
SOLVE sees; the posted values (``current_q``) are preserved and a new
arrival resets the user's age to zero.

Telemetry (``bus=``, optional, duck-typed: anything with
``emit(name, **fields)``, such as ``repro_torch.telemetry.TelemetryBus``):
each round emits ``admission_round`` (arrival/touched/solved counts, the
solve's and the round's wall time, ``solve_wall_s`` and
``round_wall_s``, and iterations), per-cell
``qoe_attainment`` (fraction of users whose predicted delay beats their
effective aged threshold — the paper's QoE target, finally measured),
``governor`` decisions and ``round_error`` for caught solver-round
exceptions.  With no bus attached every emit site is a single
``is not None`` check — the no-telemetry path allocates nothing.

The round's phases are ``telemetry.spans``, recorded while the tracer
records: ``admission.round`` (drain to install, ``t_start`` to
``t_installed``; its trace id the round's sequence number; fields
``n_arrivals``, ``queue_wait_sum_s``/``queue_wait_max_s`` — the drain
time less each drained arrival's ``Arrival.t``, on the controller's
clock — ``n_solved`` and ``partial``), and under it ``admission.drain``,
``admission.restack`` (``cells``), the solver's ``solver.sweep`` and
``solver.finalize`` (``core.ligd``), ``admission.build`` (the
scheduler's ``build_schedule`` calls) and ``admission.swap``.

QoS governor (``governor=``, optional, duck-typed, such as
``repro_torch.serving.governor.QoSGovernor``): consulted between DRAIN and SOLVE.  Cells it defers
are NOT solved this round; their queued work is carried in a
controller-side deferred set and merged into the next
round's dirty set, so nothing is lost — deferral trades schedule
freshness on healthy low-drift cells for solver duty-cycle under
cluster-wide pressure.

Determinism for tests: the controller takes an injectable ``clock`` (any
zero-arg callable returning seconds) and ``step()`` can be driven
synchronously with no thread and no sleeps; the background thread blocks
on a condition variable, never polls.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core import network
from repro_torch.serving.engine import MultiCellServeEngine
from repro_torch.telemetry import spans

# bounded error backlog: always-on runs must never grow this without
# bound (each caught round failure also lands as a `round_error` event)
ERROR_BACKLOG = 64

# sentinel distinguishing "slot not in the per-user map" from "mapped to
# None" (= drop) in AdmissionQueue.remap
_UNMAPPED = object()


def qoe_attainment(sched, q_row) -> float:
    """Fraction of a cell's users whose predicted delay (from the
    installed ``Schedule``) beats their effective (aged) QoE threshold —
    the per-cell serving-quality number the governor and the load
    harness act on.  Pure numpy, O(U) — cheap enough to run per touched
    cell per admission round."""
    lat = np.asarray(sched.pred_latency, np.float64)
    q = np.asarray(q_row, np.float64)
    if lat.size == 0:
        return 1.0
    return float(np.mean(lat <= q))


def age_thresholds(q_posted: np.ndarray, t_posted: np.ndarray, now: float,
                   half_life_s: float, cap: Optional[float] = None
                   ) -> np.ndarray:
    """Drift-aware QoE aging: each threshold doubles per ``half_life_s``
    elapsed since its user's last post, optionally capped.  Pure — unit
    tested with the fake clock."""
    age = np.maximum(np.asarray(now, np.float64) - t_posted, 0.0)
    # clamp the exponent: past ~64 doublings the threshold is effectively
    # unconstrained anyway, and an unclamped exp2 overflows float64 to inf
    # for long-idle users when no cap is configured
    doublings = np.minimum(age / float(half_life_s), 64.0)
    aged = q_posted.astype(np.float64) * np.exp2(doublings)
    if cap is not None:
        aged = np.minimum(aged, cap)
    return np.maximum(aged, q_posted).astype(np.float32)


@dataclass(frozen=True)
class Arrival:
    """One user posting a request with a QoE deadline into a cell."""
    cell: int
    user: int
    q_s: float          # QoE latency threshold, seconds
    t: float            # submission time (controller clock)


class AdmissionQueue:
    """Thread-safe accumulator for work between solver rounds.

    Two kinds of work: ``Arrival``s (new/renewed user deadlines) and
    drift marks (cells whose channel diverged).  Producers are the serving
    side (submit / mark_dirty); the single consumer is the admission
    round, which takes everything at once (``drain``).  ``close()``
    rejects further arrivals but leaves queued work drainable — the
    shutdown path drains before exiting."""

    def __init__(self):
        self._cond = threading.Condition()
        self._arrivals: List[Arrival] = []
        self._dirty: Set[int] = set()
        self._closed = False

    def submit(self, arrival: Arrival) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            self._arrivals.append(arrival)
            self._cond.notify_all()

    def mark_dirty(self, cell: int) -> None:
        with self._cond:
            if not self._closed:
                self._dirty.add(cell)
                self._cond.notify_all()

    def drain(self) -> Tuple[List[Arrival], Set[int]]:
        """Take all queued work (arrivals in submission order + dirty set)."""
        with self._cond:
            arrivals, self._arrivals = self._arrivals, []
            dirty, self._dirty = self._dirty, set()
            return arrivals, dirty

    def remap(self, old_to_new: Dict[int, int],
              users: Dict[Tuple[int, int],
                          Optional[Tuple[int, int]]] = None) -> None:
        """Rewrite queued work after a membership change (churn): arrivals
        and dirty marks for surviving cells move to their new lanes, work
        for removed cells (absent from the map) is dropped.

        ``users`` refines the map to per-(cell, user) granularity — the
        handover path needs it, because a cell-level map can only move or
        drop WHOLE cells and would misdeliver a moved user's queued
        arrivals to whichever user inherits its old slot.  Keys are
        (old_cell, old_user) slots; an arrival matching one is rewritten
        to the mapped (new_cell, new_user) slot directly (post-remap
        coordinates, NOT run through ``old_to_new`` again), or dropped
        when the mapped value is None (the user departed the fleet).
        Non-matching arrivals follow the cell-level map as before; dirty
        marks stay cell-granular.  Atomic under the queue lock, so
        producers never see a half-remapped queue."""
        users = users or {}
        with self._cond:
            arrivals = []
            for a in self._arrivals:
                slot = users.get((a.cell, a.user), _UNMAPPED)
                if slot is _UNMAPPED:
                    if a.cell in old_to_new:
                        arrivals.append(dataclasses.replace(
                            a, cell=old_to_new[a.cell]))
                elif slot is not None:
                    arrivals.append(dataclasses.replace(
                        a, cell=slot[0], user=slot[1]))
            self._arrivals = arrivals
            self._dirty = {old_to_new[c] for c in self._dirty
                           if c in old_to_new}

    def has_work(self) -> bool:
        with self._cond:
            return bool(self._arrivals or self._dirty)

    def __len__(self) -> int:
        with self._cond:
            return len(self._arrivals)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def wait_for_work(self, timeout: Optional[float] = None) -> bool:
        """Block until work is queued or the queue closes.  Returns True
        when there is drainable work.  Condition-based — no polling."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._arrivals or self._dirty or self._closed,
                timeout=timeout)
            return bool(self._arrivals or self._dirty)


@dataclass
class AdmissionRound:
    """Record of one completed admission round (step)."""
    version: int                    # ScheduleSet version installed
    cells: Tuple[int, ...]          # cells whose schedules were swapped
    n_arrivals: int
    drift: Dict[int, float]        # drift of each drift-triggered cell
    total_iters: int               # solver iterations this round
    t_start: float                 # controller clock at drain
    t_installed: float             # controller clock after the swap


class AdmissionController:
    """Owns the admission loop around one ``MultiCellServeEngine``.

    Usage (sync, deterministic — tests):
        ctl = AdmissionController(engine, clock=fake_clock)
        ctl.bootstrap(q0)                  # initial solve + install
        ctl.submit(cell, user, q_s)        # arrivals accumulate
        ctl.observe_scenario(cell, scn)    # drift marks accumulate
        rnd = ctl.step()                   # one admission round (or None)

    Usage (async — serving):
        ctl.bootstrap(q0); ctl.start()
        ... serving thread keeps calling engine.serve_scheduled_round ...
        ctl.stop()                         # drains the queue, then joins
    """

    def __init__(self, engine: MultiCellServeEngine, *,
                 drift_threshold: float = 0.15,
                 clock: Callable[[], float] = time.monotonic,
                 warm_start: bool = True,
                 min_interval_s: float = 0.0,
                 partial_batch: bool = True,
                 qoe_half_life_s: Optional[float] = None,
                 q_age_cap: Optional[float] = None,
                 bus=None, governor=None):
        self.engine = engine
        self.scheduler = engine.scheduler
        self.queue = AdmissionQueue()
        self.drift_threshold = float(drift_threshold)
        self.clock = clock
        self.warm_start = warm_start
        # telemetry event sink — None keeps every emit site a single
        # attribute check, nothing allocated
        self.bus = bus
        # QoS governor — None is the ungoverned policy: every touched
        # cell solves every round
        self.governor = governor
        # cells the governor deferred: merged into the next round's dirty
        # set at drain (their arrivals' q updates were already applied).
        # Mutated only under _round_lock (rounds and churn both hold it).
        self._deferred: Set[int] = set()
        # last measured per-cell QoE attainment (NaN: not yet measured);
        # follows churn remaps like every other per-lane array
        self._attainment: Optional[np.ndarray] = None
        # partial rounds: solve only touched cells on the bucket ladder
        # (scheduler.schedule(cells=...)); False = always solve all B
        self.partial_batch = bool(partial_batch)
        # QoE aging: None disables; else idle users' effective thresholds
        # double per half-life (capped), see age_thresholds
        self.qoe_half_life_s = qoe_half_life_s
        self.q_age_cap = q_age_cap
        # batching window: the solver thread lets at least this long pass
        # between admission rounds, so bursts of arrivals coalesce into one
        # solve and the solve's CPU time is bounded to a duty-cycle slice
        # of serving (threaded mode only; assumes a real-time clock there)
        self.min_interval_s = float(min_interval_s)
        self.rounds: List[AdmissionRound] = []
        # failed threaded rounds — BOUNDED: an always-on run that keeps
        # failing must not leak memory (each failure also emits a
        # `round_error` event, so losing old entries loses no signal)
        self.errors: deque = deque(maxlen=ERROR_BACKLOG)
        self.round_done = threading.Event()   # pulses after each round
        # live channel state and the reference snapshot each cell's active
        # schedule was solved on (drift is measured live vs reference)
        self._live = list(engine.scns)
        self._ref = list(engine.scns)
        self._q: Optional[np.ndarray] = None   # (B, U) posted thresholds
        self._t_posted: Optional[np.ndarray] = None  # (B, U) last-post time
        self._state_lock = threading.Lock()
        # serialises whole admission ROUNDS (step) against cell churn
        # (add_cell/remove_cell): a membership change must never interleave
        # with a drained-but-not-yet-swapped round, whose lane indices
        # would silently point at the wrong cells after the remap.
        # Producers (submit/observe_scenario) never take it — serving
        # stays wait-free against a long solve.  Reentrant so churn can
        # run from within a paused loop if callers compose them.
        self._round_lock = threading.RLock()
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._last_round_t: Optional[float] = None
        self._round_seq = 0       # admission rounds run: the spans' trace id

    @property
    def n_cells(self) -> int:
        return self.engine.n_cells

    def bootstrap(self, q0) -> int:
        """Initial blocking solve: install schedules for every cell so
        serving can start; subsequent solves are incremental."""
        q0 = np.asarray(q0, np.float32)
        if q0.shape[0] != self.n_cells:
            raise ValueError(f"q0 must be (B={self.n_cells}, U), "
                             f"got {q0.shape}")
        with self._state_lock:
            self._q = q0.copy()
            self._t_posted = np.full_like(q0, self.clock(), np.float64)
            t0 = time.perf_counter()
            scheds = self.scheduler.schedule(self._q)
            solve_s = time.perf_counter() - t0
            version = self.engine.install_schedules(scheds)
            self._ref = list(self._live)
            self._attainment = np.array(
                [qoe_attainment(s, q0[b]) for b, s in enumerate(scheds)],
                np.float64)
        bus = self.bus
        if bus is not None:
            bus.emit("bootstrap", version=version, n_cells=len(scheds),
                     solve_wall_s=solve_s,
                     iters=sum(s.iters for s in scheds))
            for b, s in enumerate(scheds):
                bus.emit("qoe_attainment", cell=b,
                         attainment=float(self._attainment[b]),
                         version=version)
        return version

    # ---- producers (serving side) -------------------------------------
    def submit(self, cell: int, user: int, q_s: float) -> Arrival:
        """A user arrives (or renews its deadline) in ``cell``.  Bounds are
        validated HERE, in the producer's thread — a malformed arrival must
        not reach (and kill) the background solver loop.  Requires
        ``bootstrap()`` first: the user axis is unknown (hence
        unvalidatable) before the initial install.

        Validation AND enqueue happen under the state lock: cell churn
        remaps the queue under the same lock, so an arrival is either
        enqueued before the remap (and remapped with it) or validated
        against the post-churn lanes — never enqueued against a stale
        lane it was validated on."""
        cell, user = int(cell), int(user)
        with self._state_lock:
            if self._q is None:
                raise RuntimeError("bootstrap() before submitting arrivals")
            if not 0 <= cell < len(self._live):
                raise ValueError(
                    f"cell {cell} out of range [0, {len(self._live)})")
            n_users = self._q.shape[1]
            if not 0 <= user < n_users:
                raise ValueError(f"user {user} out of range [0, {n_users})")
            arrival = Arrival(cell, user, float(q_s), self.clock())
            self.queue.submit(arrival)
        return arrival

    def observe_scenario(self, cell: int, scn) -> float:
        """Publish a cell's live channel snapshot; returns its drift vs.
        the snapshot the active schedule was solved on, and marks the cell
        for re-scheduling when past the divergence threshold.

        The whole read-modify-write runs under the state lock (which cell
        churn also holds while remapping), so the live-state write, the
        engine update and the dirty mark can never land on a lane that a
        concurrent remove has shifted or dropped."""
        cell = int(cell)
        with self._state_lock:
            if not 0 <= cell < len(self._live):
                raise ValueError(
                    f"cell {cell} out of range [0, {len(self._live)})")
            self._live[cell] = scn
            drift = network.scenario_drift(scn, self._ref[cell])
            # during an add_cell the joiner exists in controller state
            # before the engine publishes it (resize) — skip the engine
            # write then; resize installs the fresh _live wholesale
            if cell < len(self.engine.scns):
                self.engine.set_scenario(cell, scn)
            if drift > self.drift_threshold:
                self.queue.mark_dirty(cell)
        return drift

    # ---- the admission round (consumer) -------------------------------
    def step(self) -> Optional[AdmissionRound]:
        """Run one admission round; returns None when nothing is pending.

        Everything queued so far is handled by ONE batched solve.  With
        ``partial_batch`` only the touched cells solve (padded onto the
        scheduler's bucket ladder so every round shape is one of O(log B)
        compiled programs); otherwise all B lanes solve and only touched
        cells' schedules are swapped.  Either way, references reset only
        for touched cells.

        The whole round — drain through swap — runs under ``_round_lock``
        so cell churn (``add_cell``/``remove_cell``) can never remap lanes
        out from under a round in flight."""
        with self._round_lock:
            return self._step_locked()

    def _step_locked(self) -> Optional[AdmissionRound]:
        t_wall0 = time.perf_counter()
        arrivals, dirty = self.queue.drain()
        # governor-deferred cells from previous rounds rejoin here: their
        # arrivals' threshold updates were applied at their own drain, so
        # a dirty mark is all the carried work they need
        if self._deferred:
            dirty |= self._deferred
            self._deferred.clear()
        if not arrivals and not dirty:
            return None
        t_start = self.clock()
        self._round_seq += 1
        bus = self.bus
        decision = None
        # the round's phases are spans (module docs), drain to install
        with spans.span("admission.round", trace_id=self._round_seq,
                        n_arrivals=len(arrivals)) as round_span:
            if round_span and arrivals:
                waits = [t_start - a.t for a in arrivals]
                round_span.set(queue_wait_sum_s=sum(waits),
                               queue_wait_max_s=max(waits))
            with spans.span("admission.drain"), self._state_lock:
                # bootstrap publishes _q under this lock; checking it out
                # here (as this method once did) races a concurrent
                # bootstrap into a half-initialised round instead of a
                # clean error
                if self._q is None:
                    raise RuntimeError(
                        "bootstrap() before running admission rounds")
                for a in arrivals:
                    self._q[a.cell, a.user] = a.q_s
                    self._t_posted[a.cell, a.user] = a.t
                touched = sorted(dirty | {a.cell for a in arrivals})
                drift = {b: network.scenario_drift(self._live[b],
                                                   self._ref[b])
                         for b in sorted(dirty)}
                if self.governor is not None:
                    # the governor ranks by drift across the WHOLE touched
                    # set — arrival-only cells measure theirs here
                    # (skipped ungoverned: the round would not use it)
                    drift_all = dict(drift)
                    for b in touched:
                        if b not in drift_all:
                            drift_all[b] = network.scenario_drift(
                                self._live[b], self._ref[b])
                    decision = self.governor.review(
                        touched, drift_all, self._attainment, self.n_cells)
                # snapshot the scenarios this round actually solves: _live
                # may move again while the solve runs, and the drift
                # reference must be the state the installed schedule was
                # solved ON
                solved = list(self._live)
                q = self._effective_q_locked(t_start)

            if decision is not None:
                self._deferred.update(decision.deferred)
                if bus is not None:
                    for c in decision.deferred:
                        bus.emit("governor", decision="deferred", cell=c,
                                 drift=float(drift_all.get(c, 0.0)),
                                 defer_count=self.governor.defer_count(c))
                    for c in decision.prioritised:
                        bus.emit("governor", decision="prioritised", cell=c,
                                 attainment=float(self._attainment[c]))
                    for c in decision.forced:
                        bus.emit("governor", decision="forced", cell=c)
                n_touched = len(touched)
                touched = sorted(decision.solve)   # empty: a shed round

            # multi-process multihost schedulers route EVERY incremental
            # round through the subset path (host-local solves): this
            # process's arrival and drift queue cannot put all processes
            # in lockstep
            partial = self.partial_batch and (
                len(touched) < self.n_cells
                or self.scheduler.host_local_rounds)
            round_span.set(n_solved=len(touched), partial=partial)

            if touched:
                # outside the lock: scheduler state belongs to this
                # (single-consumer) round, and the scatter/restack
                # dispatches must not stall serving-side submit()/
                # observe_scenario() producers.  Partial rounds scatter
                # only the touched lanes into the stacked prep (O(k) host
                # work); full rounds restack all B.
                with spans.span("admission.restack",
                                cells=len(touched) if partial
                                else self.n_cells):
                    self.scheduler.update_scenarios(
                        solved, cells=touched if partial else None)

                t_solve0 = time.perf_counter()
                if partial:
                    subset = self.scheduler.schedule(
                        q, warm=self.warm_start, cells=touched)
                    per_cell = dict(zip(touched, subset))
                    iters = sum(s.iters for s in subset)  # this round's lanes
                else:
                    scheds = self.scheduler.schedule(q, warm=self.warm_start)
                    per_cell = {b: scheds[b] for b in touched}
                    iters = sum(s.iters for s in scheds)  # all B lanes solved
                solve_s = time.perf_counter() - t_solve0
                with spans.span("admission.swap"):
                    version = self.engine.swap_schedules(per_cell)
                t_installed = self.clock()

        if not touched:
            # fully shed round: the governor solves nothing, nothing
            # swaps; the deferred set re-arms the next round trigger
            if bus is not None:
                # no solve_wall_s field on a shed round: the p99
                # solve-latency aggregate must summarise real solves,
                # not governor-shed zeros
                bus.emit("admission_round", version=-1,
                         n_arrivals=len(arrivals),
                         n_touched=n_touched, n_solved=0,
                         n_deferred=len(decision.deferred),
                         n_prioritised=0, n_forced=0, iters=0,
                         round_wall_s=time.perf_counter() - t_wall0)
            return None

        rnd = AdmissionRound(
            version=version, cells=tuple(touched),
            n_arrivals=len(arrivals), drift=drift, total_iters=iters,
            t_start=t_start, t_installed=t_installed)
        with self._state_lock:
            for b in touched:
                self._ref[b] = solved[b]
                self._attainment[b] = qoe_attainment(per_cell[b], q[b])
            # _last_round_t is read lock-free-ish by the solver thread's
            # batching window (_batching_wait_s snapshots it under this
            # lock) — publish it under the same lock as every other writer
            self._last_round_t = rnd.t_installed
        self.rounds.append(rnd)
        if bus is not None:
            bus.emit("admission_round", version=version,
                     n_arrivals=len(arrivals),
                     n_touched=len(touched) if decision is None
                     else len(touched) + len(decision.deferred),
                     n_solved=len(touched),
                     n_deferred=0 if decision is None
                     else len(decision.deferred),
                     n_prioritised=0 if decision is None
                     else len(decision.prioritised),
                     n_forced=0 if decision is None
                     else len(decision.forced),
                     iters=iters, solve_wall_s=solve_s,
                     round_wall_s=time.perf_counter() - t_wall0)
            for b in touched:
                bus.emit("qoe_attainment", cell=b,
                         attainment=float(self._attainment[b]),
                         version=version)
        self.round_done.set()
        return rnd

    # ---- cell churn (coordinated join/leave) --------------------------
    @contextmanager
    def paused(self):
        """Hold the round lock: no admission round or churn runs inside
        the block (producers and serving stay live).  Lets callers compose
        a churn op with reads of the before/after engine state atomically
        — e.g. the launcher's version-continuity assertion."""
        with self._round_lock:
            yield

    def add_cell(self, scn, q_row, prof=None) -> int:
        """Admit a new cell with channel snapshot ``scn`` and per-user QoE
        thresholds ``q_row`` (scalar or (U,)).  Returns its lane index
        (always appended: ``B_old``).  ``prof``: the joiner's split
        profile — required when the scheduler carries per-cell profiles,
        ignored (with a loud error if given) for a shared profile.

        Coordinated, zero-downtime: the scheduler's stacked prep is
        remapped (survivors gathered device-side, the joiner concatenated),
        ONLY the new lane is solved (a 1-lane bucket, not a B-lane
        restack), and the engine's cell list + schedules swap in one
        versioned install where every surviving cell KEEPS its installed
        schedule object.  Drift references, warm-start state, posted/aged
        thresholds and queued work all survive untouched.  Serialised
        against admission rounds via ``_round_lock``; serving rounds in
        flight finish on the snapshot they grabbed."""
        with self._round_lock:
            if self._q is None:
                raise RuntimeError("bootstrap() before cell churn")
            n_users = self._q.shape[1]
            q_row = np.broadcast_to(
                np.asarray(q_row, np.float32), (n_users,)).copy()
            n_old = self.n_cells
            lane = n_old
            keep = {i: i for i in range(n_old)}
            per_cell_prof = isinstance(self.scheduler.prof, (list, tuple))
            if per_cell_prof and prof is None:
                raise ValueError("scheduler carries per-cell profiles — "
                                 "add_cell needs the joiner's prof=")
            if not per_cell_prof and prof is not None:
                raise ValueError("scheduler shares one profile across "
                                 "cells; per-cell prof= does not apply")
            # survivors keep the snapshots they were last SOLVED on (the
            # scheduler's own list); the joiner enters with its live one
            self.scheduler.resize(
                list(self.scheduler.scns) + [scn], keep=keep,
                prof=list(self.scheduler.prof) + [prof] if per_cell_prof
                else None)
            now = self.clock()
            with self._state_lock:
                self._q = np.concatenate([self._q, q_row[None]], axis=0)
                self._t_posted = np.concatenate(
                    [self._t_posted, np.full((1, n_users), now)], axis=0)
                self._live.append(scn)
                self._ref.append(scn)
                q = self._effective_q_locked(now)
            # bucket='exact': a join solves exactly its one lane even
            # under the 'full' admission policy (whose B-wide padding
            # would replicate the joiner B times for nothing)
            t_solve0 = time.perf_counter()
            sched = self.scheduler.schedule(q, warm=self.warm_start,
                                            cells=[lane],
                                            bucket="exact")[0]
            solve_s = time.perf_counter() - t_solve0
            # publish under the state lock: producers running concurrently
            # with the solve above see a consistent (state, engine) pair
            with self._state_lock:
                version = self.engine.resize(list(self._live),
                                             schedules={lane: sched},
                                             keep=keep)
                if self._attainment is not None:
                    self._attainment = np.append(
                        self._attainment, qoe_attainment(sched, q[lane]))
            rnd = AdmissionRound(
                version=version, cells=(lane,), n_arrivals=0, drift={},
                total_iters=sched.iters, t_start=now,
                t_installed=self.clock())
            with self._state_lock:
                self._last_round_t = rnd.t_installed
            self.rounds.append(rnd)
            if self.bus is not None:
                self.bus.emit("cell_join", lane=lane, version=version,
                              iters=sched.iters, solve_wall_s=solve_s)
                if self._attainment is not None:
                    self.bus.emit("qoe_attainment", cell=lane,
                                  attainment=float(self._attainment[lane]),
                                  version=version)
            self.round_done.set()
            return lane

    def remove_cell(self, lane: int) -> Dict[int, int]:
        """Evict cell ``lane``; surviving lanes shift down.  Returns the
        {old_lane: new_lane} remap the caller (``SplitInferenceCluster``)
        uses to move its stable CellId table.

        No solve at all: survivors' installed schedules, warm-start
        allocations, drift references and posted/aged thresholds are
        remapped in place (this is the fix for the latent positional-
        reference bug the ROADMAP noted — before this, references silently
        pointed at the wrong cell after a resize).  Queued arrivals/drift
        marks for the removed cell are dropped; the rest follow the remap."""
        with self._round_lock:
            lane = int(lane)
            n_old = self.n_cells
            if not 0 <= lane < n_old:
                raise ValueError(f"cell {lane} out of range [0, {n_old})")
            if n_old == 1:
                raise ValueError("cannot remove the last cell (the stacked "
                                 "solver needs >= 1 lane)")
            if self._q is None:
                raise RuntimeError("bootstrap() before cell churn")
            survivors = [i for i in range(n_old) if i != lane]
            keep = {new: old for new, old in enumerate(survivors)}
            old_to_new = {old: new for new, old in keep.items()}
            prof = self.scheduler.prof
            self.scheduler.resize(
                [self.scheduler.scns[i] for i in survivors], keep=keep,
                prof=[prof[i] for i in survivors]
                if isinstance(prof, (list, tuple)) else None)
            now = self.clock()
            # ONE state-lock hold over thresholds, live/ref snapshots,
            # queued work and the engine install: a producer observes
            # either the whole pre-remove world or the whole post-remove
            # one — its lane can never be half-remapped under it
            with self._state_lock:
                self._q = self._q[survivors]
                self._t_posted = self._t_posted[survivors]
                self._live = [self._live[i] for i in survivors]
                self._ref = [self._ref[i] for i in survivors]
                if self._attainment is not None:
                    self._attainment = self._attainment[survivors]
                self.queue.remap(old_to_new)
                version = self.engine.resize(list(self._live), schedules={},
                                             keep=keep)
            # per-lane governor/deferral state follows the same remap as
            # every other lane-indexed structure (under _round_lock, like
            # all its other mutators)
            self._deferred = {old_to_new[c] for c in self._deferred
                              if c in old_to_new}
            if self.governor is not None:
                self.governor.remap(old_to_new)
            rnd = AdmissionRound(
                version=version, cells=(), n_arrivals=0, drift={},
                total_iters=0, t_start=now, t_installed=self.clock())
            with self._state_lock:
                self._last_round_t = rnd.t_installed
            self.rounds.append(rnd)
            if self.bus is not None:
                self.bus.emit("cell_leave", lane=lane, version=version,
                              n_cells=len(survivors))
            self.round_done.set()
            return old_to_new

    def move_user(self, src_lane: int, dst_lane: int, user: int,
                  dst_user: Optional[int] = None) -> AdmissionRound:
        """Hand one user over from ``src_lane`` to ``dst_lane``: the
        user's per-(lane, user) admission state — posted QoE threshold,
        its ``_t_posted`` age, and any queued ``Arrival``s — transfers to
        slot ``dst_user`` (default: same user index) of the destination,
        then ONLY the receiving cell re-solves (a 1-lane ``bucket='exact'``
        warm solve, like a join), with the newcomer's allocation row
        seeded from its source-cell solved outcome so the GD solve starts
        from where the user's split/power already converged.

        The source cell is left alone — no solve on departure (like
        ``remove_cell``), its drift reference untouched.  Its vacated
        slot keeps the last posted threshold as a placeholder: QoE aging
        relaxes it like any idle user's, and the next arrival on the slot
        overwrites it — the solver never chases a departed user's tight
        deadline for long.  Survivors (every lane but ``dst_lane``) keep
        their installed schedules object-identical through the single
        version bump (``swap_schedules``).  Serialised against admission
        rounds and other churn via ``_round_lock``."""
        with self._round_lock:
            if self._q is None:
                raise RuntimeError("bootstrap() before cell churn")
            src_lane, dst_lane = int(src_lane), int(dst_lane)
            user = int(user)
            dst_user = user if dst_user is None else int(dst_user)
            n_cells, n_users = self._q.shape
            for name, lane in (("src", src_lane), ("dst", dst_lane)):
                if not 0 <= lane < n_cells:
                    raise ValueError(f"{name} cell {lane} out of range "
                                     f"[0, {n_cells})")
            if src_lane == dst_lane:
                raise ValueError(
                    f"move_user src and dst are the same cell ({src_lane})")
            for name, u in (("user", user), ("dst_user", dst_user)):
                if not 0 <= u < n_users:
                    raise ValueError(
                        f"{name} {u} out of range [0, {n_users})")
            now = self.clock()
            # ONE state-lock hold over the threshold transfer and the
            # queue rewrite: a producer's arrival is either queued before
            # the remap (and follows the user to its new slot) or
            # validated against the post-move world — never misdelivered
            # to whoever inherits the source slot
            with self._state_lock:
                self._q[dst_lane, dst_user] = self._q[src_lane, user]
                self._t_posted[dst_lane, dst_user] = \
                    self._t_posted[src_lane, user]
                self.queue.remap(
                    {b: b for b in range(n_cells)},
                    users={(src_lane, user): (dst_lane, dst_user)})
                solved = list(self._live)
                q = self._effective_q_locked(now)
            # seed the newcomer's warm-start row from its SOURCE cell's
            # last solved outcome (None-safe: no source history — e.g.
            # warm start disabled or the source never solved — just means
            # no override and the row warm-starts like any other)
            overrides = None
            src_out = self.scheduler.last_outcomes[src_lane]
            if src_out is not None:
                overrides = {dst_lane: {dst_user: (src_out.alloc, user)}}
            # outside the state lock, same as an admission round: the
            # solve must not stall producers.  The scatter is skipped
            # when the receiver's live snapshot IS the object the
            # scheduler last solved on (no drift since) — the common
            # case, and the scatter is the handover's dominant host cost
            if solved[dst_lane] is not self.scheduler.scns[dst_lane]:
                self.scheduler.update_scenarios(solved, cells=[dst_lane])
            t_solve0 = time.perf_counter()
            sched = self.scheduler.schedule(
                q, warm=self.warm_start, cells=[dst_lane],
                bucket="exact", warm_overrides=overrides)[0]
            solve_s = time.perf_counter() - t_solve0
            with self._state_lock:
                version = self.engine.swap_schedules({dst_lane: sched})
                self._ref[dst_lane] = solved[dst_lane]
                if self._attainment is not None:
                    self._attainment[dst_lane] = qoe_attainment(
                        sched, q[dst_lane])
            # the receiver just solved out of band: clear its carried
            # deferral and reset its governor streak so the starvation
            # bound measures rounds since its schedule was ACTUALLY fresh
            self._deferred.discard(dst_lane)
            if self.governor is not None:
                self.governor.note_solved(dst_lane)
            rnd = AdmissionRound(
                version=version, cells=(dst_lane,), n_arrivals=0,
                drift={}, total_iters=sched.iters, t_start=now,
                t_installed=self.clock())
            with self._state_lock:
                self._last_round_t = rnd.t_installed
            self.rounds.append(rnd)
            if self.bus is not None:
                self.bus.emit("handover", src=src_lane, dst=dst_lane,
                              user=user, dst_user=dst_user,
                              version=version, iters=sched.iters,
                              solve_wall_s=solve_s,
                              warm_seeded=overrides is not None)
                if self._attainment is not None:
                    self.bus.emit(
                        "qoe_attainment", cell=dst_lane,
                        attainment=float(self._attainment[dst_lane]),
                        version=version)
            self.round_done.set()
            return rnd

    # ---- background solver thread -------------------------------------
    def start(self) -> None:
        """Run admission rounds on a dedicated solver thread.  The thread
        blocks on the queue's condition variable between rounds (no
        polling); serving threads keep executing installed schedules."""
        if self._thread is not None:
            raise RuntimeError("admission loop already started")
        if self.queue.closed:
            # restart-after-stop footgun: stop() closes the queue, so a
            # relaunched loop would idle forever over a queue every
            # producer is rejected from — fail loudly instead
            raise RuntimeError(
                "admission queue is closed (controller was stopped); "
                "build a new controller instead of restarting this one")
        self._stopping.clear()
        self._thread = threading.Thread(
            target=self._run, name="admission-solver", daemon=True)
        self._thread.start()

    def _batching_wait_s(self) -> float:
        """Seconds left in the batching window (<= 0: solve now).  The
        ``_last_round_t`` snapshot is taken under ``_state_lock`` — every
        writer (step / add_cell / remove_cell) publishes under the same
        lock, so a churn op installing a round mid-read can never hand the
        window an in-between timestamp (the old torn-read race)."""
        if self.min_interval_s <= 0:
            return 0.0
        with self._state_lock:
            last = self._last_round_t
        if last is None:
            return 0.0
        return self.min_interval_s - (self.clock() - last)

    def _run(self) -> None:
        while True:
            has_work = self.queue.wait_for_work()
            if not has_work:
                if self.queue.closed or self._stopping.is_set():
                    # closed and fully drained -> exit
                    return
                continue
            if not self.queue.closed:
                # batching window: keep accumulating arrivals until the
                # interval elapses (interruptible so stop() drains promptly)
                remaining = self._batching_wait_s()
                if remaining > 0:
                    self._stopping.wait(remaining)
            try:
                self.step()
            except Exception as exc:   # noqa: BLE001 — loop must survive
                # a failed round must not kill the loop: serving would
                # silently run on stale schedules forever.  Record it
                # (bounded backlog + a round_error event, so failures are
                # LOUD on the bus instead of silent until polled) and
                # keep consuming (the queue was already drained, so the
                # failing work does not wedge the loop).
                self.errors.append(exc)
                if self.bus is not None:
                    self.bus.emit("round_error", kind=type(exc).__name__,
                                  error=repr(exc))
                self.round_done.set()

    def stop(self, drain: bool = True) -> None:
        """Shut the loop down.  ``drain=True`` (default) processes any
        still-queued arrivals/drift marks in a final round before the
        thread exits; ``drain=False`` discards them."""
        self._stopping.set()
        if not drain:
            self.queue.drain()
        self.queue.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain and self.queue.has_work():
            # loop never started (sync use) — drain inline
            self.step()

    def _effective_q_locked(self, now: float) -> np.ndarray:
        """Thresholds the solve sees: posted values, aged when enabled.
        Caller holds ``_state_lock``."""
        if self.qoe_half_life_s is None:
            return self._q.copy()
        return age_thresholds(self._q, self._t_posted, now,
                              self.qoe_half_life_s, self.q_age_cap)

    # ---- introspection -------------------------------------------------
    def current_q(self) -> np.ndarray:
        with self._state_lock:
            return None if self._q is None else self._q.copy()

    def effective_q(self) -> np.ndarray:
        """The aged thresholds a round starting now would solve with."""
        with self._state_lock:
            return None if self._q is None \
                else self._effective_q_locked(self.clock())

    def reference_scenario(self, cell: int):
        with self._state_lock:
            return self._ref[cell]

    def attainment(self) -> Optional[np.ndarray]:
        """Last measured per-cell QoE attainment (None pre-bootstrap).
        Updated for the cells each round touches; untouched cells keep
        the value from the round that last solved them."""
        with self._state_lock:
            return None if self._attainment is None \
                else self._attainment.copy()
