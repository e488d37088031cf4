"""``SplitInferenceCluster`` — the serving facade with first-class cell
lifecycle.

  * HOW solves run lives in ONE frozen ``SolverSpec`` (``core.ligd``);
  * WHO is being served lives behind stable ``CellId`` handles: the
    cluster owns scheduler + engine + admission controller and an
    id->lane remap table, so drift references, warm-start lanes, aged-QoE
    state and installed versioned schedules all survive churn.

Lifecycle::

    cluster = SplitInferenceCluster(model, cfg, prof, spec=SolverSpec())
    a = cluster.add_cell(scn_a, q0=0.4)        # before start: staged
    b = cluster.add_cell(scn_b, q0=0.4)
    cluster.start(threaded=False)              # bootstrap solve + install
    cluster.submit(a, user=3, q_s=0.25)        # arrivals by CellId
    cluster.observe(b, drifted_scn)            # drift marks by CellId
    cluster.step()                             # one admission round
    out = cluster.serve_round({a: toks_a, b: toks_b}, decode_steps=8)
    c = cluster.add_cell(scn_c, q0=0.4)        # mid-run join: 1-lane solve
    cluster.remove_cell(a)                     # leave: no solve
    cluster.stop()

``add_cell`` solves ONLY the joiner and ``remove_cell`` solves nothing;
both swap the engine's cell list + schedules in one versioned install
where surviving cells keep their installed ``Schedule`` objects, and every
piece of admission state follows the lane remap keyed by ``CellId``.

Devices: the cluster runs on ``device`` (default: the card; raises when
none is present).  Profiles move there at construction, and a scenario
given on another device moves there when it is added or observed.  A
served model must already lie on that device.  ``model``/``model_cfg``
may be None for solver-only use (scheduling without executing a model);
``serve_round`` then raises.

Threading: ``start(threaded=True)`` runs admission rounds on the
controller's background solver thread; ``threaded=False`` is the
deterministic sync mode (drive rounds with ``step()``).  Churn takes the
controller's round lock BEFORE the facade lock, so waiting out an
in-flight background solve never stalls producers.

Multi-process (``SolverSpec(backend='multihost')``, >1 process): each
process runs its OWN cluster over its contiguous slice of the cell fleet
(``multihost.lane_slice``).  Incremental rounds solve host-locally
(``MultiCellScheduler.host_local_rounds``), and live churn meets at a
named fence under the round lock (``_churn_fence``), so every process
changes its cell set at the same point between rounds.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, NewType, Optional

import numpy as np

from repro_torch.core import ligd
from repro_torch.core.era import Weights
from repro_torch.core.ligd import SolverSpec
from repro_torch.launch.platform import resolve_device
from repro_torch.serving.admission import AdmissionController, AdmissionRound
from repro_torch.serving.engine import MultiCellServeEngine, RequestResult
from repro_torch.serving.scheduler import MultiCellScheduler, Schedule
from repro_torch.telemetry import spans

# Stable handle for one cell, valid across join/leave for the cluster
# lifetime.  NEVER a lane index: lanes shift on churn, CellIds do not.
CellId = NewType("CellId", int)


class SplitInferenceCluster:
    """One object owning the whole serving stack for a fleet of cells.

    ``params`` is the served model (``models.transformer.init`` or
    ``interop.model_from_numpy``) with its ``model_cfg``, or None for
    solver-only scheduling; ``prof`` is one shared ``SplitProfile`` or a
    per-cell list.  ``bus``/``governor`` are duck-typed hooks (an event
    sink with ``emit(name, **fields)`` and a QoS governor), default
    None."""

    def __init__(self, params, model_cfg, prof, *,
                 spec: SolverSpec = None,
                 weights: Weights = Weights(),
                 drift_threshold: float = 0.15,
                 min_interval_s: float = 0.0,
                 qoe_half_life_s: Optional[float] = None,
                 q_age_cap: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic,
                 default_q_s: float = 0.4,
                 bus=None, governor=None, device=None):
        self.device = resolve_device(device)
        if params is not None and params.embed.device != self.device:
            raise ValueError(f"the model lies on {params.embed.device}, the "
                             f"cluster runs on {self.device}")
        self.params = params
        self.model_cfg = model_cfg
        self.prof = ([p.to(self.device) for p in prof]
                     if isinstance(prof, (list, tuple))
                     else prof.to(self.device))
        self.spec = spec if spec is not None else SolverSpec()
        self.weights = weights
        self.drift_threshold = float(drift_threshold)
        self.min_interval_s = float(min_interval_s)
        self.qoe_half_life_s = qoe_half_life_s
        self.q_age_cap = q_age_cap
        self.clock = clock
        self.default_q_s = float(default_q_s)
        self.bus = bus
        self.governor = governor

        # id->lane remap table; _ids is its inverse (lane -> id)
        self._lane_of: Dict[CellId, int] = {}
        self._ids: List[CellId] = []
        self._next_id = 0
        self._staged: List[tuple] = []          # (id, scn, q_row) pre-start
        self._lock = threading.RLock()          # serialises churn/lookup

        self.scheduler: Optional[MultiCellScheduler] = None
        self.engine: Optional[MultiCellServeEngine] = None
        self.controller: Optional[AdmissionController] = None

    # ---- introspection -------------------------------------------------
    @property
    def started(self) -> bool:
        return self.controller is not None

    @property
    def n_cells(self) -> int:
        with self._lock:
            return len(self._ids) if self.started else len(self._staged)

    def cell_ids(self) -> List[CellId]:
        """Live cell handles in lane order (stable snapshot)."""
        with self._lock:
            return list(self._ids) if self.started \
                else [cid for cid, _, _ in self._staged]

    def lane_of(self, cell_id: CellId) -> int:
        """Current lane of a cell; do not store it, it moves on churn."""
        with self._lock:
            return self._lane(cell_id)

    @property
    def schedule_version(self) -> int:
        return self.engine.schedule_version if self.started else 0

    @property
    def rounds(self) -> List[AdmissionRound]:
        """Completed admission rounds (bootstrap excluded), churn included."""
        self._require_started()
        return self.controller.rounds

    @property
    def errors(self):
        """Bounded deque of exceptions from failed background admission
        rounds (newest last)."""
        self._require_started()
        return self.controller.errors

    def _lane(self, cell_id: CellId) -> int:
        lane = self._lane_of.get(cell_id)
        if lane is None:
            raise KeyError(f"unknown or removed cell id {cell_id}")
        return lane

    def _churn_fence(self, tag: str) -> None:
        """Multi-process ``multihost`` churn coordination: live
        ``add_cell``/``remove_cell``/``move_user`` meet at a named fence
        INSIDE the round-lock hold (``controller.paused()``).  The tag
        names the op and its operands, so divergent churn across
        processes fails in the fence instead of desynchronising later
        rounds.  No-op for one process and for every other backend."""
        if self.spec.backend != "multihost":
            return
        from repro_torch.distributed import multihost
        multihost.churn_fence(tag)

    def _require_started(self) -> None:
        if not self.started:
            raise RuntimeError("cluster not started — call start() first")

    def _on_device(self, scn):
        return scn if scn.device == self.device else scn.to(self.device)

    # ---- lifecycle -----------------------------------------------------
    def _q_row(self, q0) -> np.ndarray:
        u = self.prof_n_users()
        q0 = self.default_q_s if q0 is None else q0
        return np.broadcast_to(np.asarray(q0, np.float32), (u,)).copy()

    def prof_n_users(self) -> int:
        """User-axis size, from the first cell's scenario config."""
        with self._lock:
            if self.started:
                return self.engine.scns[0].cfg.n_users
            if self._staged:
                return self._staged[0][1].cfg.n_users
        raise RuntimeError("no cells yet — add_cell() first")

    def add_cell(self, scn, q0=None, prof=None) -> CellId:
        """Admit a cell (channel snapshot ``scn``, per-user QoE thresholds
        ``q0``: scalar or (U,), default ``default_q_s``) and return its
        stable ``CellId``.  Before ``start()`` the cell is staged; after,
        it joins live: only ITS lane is solved.  ``prof``: the joiner's
        split profile, only for clusters built over a per-cell list."""
        scn = self._on_device(scn)
        with self._lock:
            if not self.started:
                if prof is not None:
                    raise ValueError("per-cell prof= applies to live joins "
                                     "only; stage profiles via the "
                                     "cluster's prof list")
                cid = CellId(self._next_id)
                self._next_id += 1
                self._staged.append((cid, scn, None if q0 is None
                                     else np.asarray(q0, np.float32)))
                return cid
            cid = CellId(self._next_id)
            self._next_id += 1
            q_row = self._q_row(q0)
        if prof is not None:
            prof = prof.to(self.device)
        # round lock FIRST, facade lock second: waiting out an in-flight
        # background solve must not hold the facade lock
        with self.controller.paused():
            self._churn_fence(f"add_cell:{cid}")
            with self._lock:
                lane = self.controller.add_cell(scn, q_row, prof=prof)
                if lane != len(self._ids):
                    raise RuntimeError(f"controller put the joiner on lane "
                                       f"{lane}, expected {len(self._ids)}")
                self._ids.append(cid)
                self._lane_of[cid] = lane
        return cid

    def remove_cell(self, cell_id: CellId) -> None:
        """Evict a cell.  Before ``start()``: unstage it.  After: drop its
        lane with NO solve — survivors' state follows the lane remap."""
        with self._lock:
            if not self.started:
                n = len(self._staged)
                self._staged = [e for e in self._staged if e[0] != cell_id]
                if len(self._staged) == n:
                    raise KeyError(f"unknown or removed cell id {cell_id}")
                return
            self._lane(cell_id)                  # fail fast on bad ids
        with self.controller.paused():
            self._churn_fence(f"remove_cell:{cell_id}")
            with self._lock:
                lane = self._lane(cell_id)
                old_to_new = self.controller.remove_cell(lane)
                self._ids = [i for ln, i in enumerate(self._ids)
                             if ln != lane]
                self._lane_of = {i: old_to_new[ln]
                                 for i, ln in self._lane_of.items()
                                 if ln in old_to_new}

    def move_user(self, src: CellId, dst: CellId, user: int,
                  dst_user: Optional[int] = None) -> AdmissionRound:
        """Hand a user over between live cells: its posted QoE threshold
        (and age) and queued arrivals move from slot ``user`` of ``src``
        to slot ``dst_user`` (default: same index) of ``dst``, then ONLY
        the receiving cell re-solves, warm-started with the user's row
        from its source-cell outcome.  Returns the churn round."""
        self._require_started()
        with self._lock:
            self._lane(src)
            self._lane(dst)
        with self.controller.paused():
            self._churn_fence(
                f"move_user:{src}->{dst}:{user}->"
                f"{user if dst_user is None else dst_user}")
            with self._lock:
                return self.controller.move_user(
                    self._lane(src), self._lane(dst), user,
                    dst_user=dst_user)

    def start(self, threaded: bool = True) -> int:
        """Build scheduler/engine/controller over the staged cells, run
        the bootstrap solve, install schedules, and (``threaded=True``)
        start the background admission loop.  Returns the installed
        schedule version (1)."""
        with self._lock:
            if self.started:
                raise RuntimeError("cluster already started")
            if not self._staged:
                raise RuntimeError("no cells staged — add_cell() first")
            ids, scns, q_rows = zip(*self._staged)
            q0 = np.stack([self._q_row(r) for r in q_rows])
            self.scheduler = MultiCellScheduler(
                list(scns), self.prof, self.weights, spec=self.spec)
            self.engine = MultiCellServeEngine(
                self.params, self.model_cfg, list(scns), self.scheduler,
                bus=self.bus, clock=self.clock)
            self.controller = AdmissionController(
                self.engine,
                drift_threshold=self.drift_threshold,
                clock=self.clock,
                warm_start=self.spec.warm,
                min_interval_s=self.min_interval_s,
                partial_batch=self.spec.bucket != "full",
                qoe_half_life_s=self.qoe_half_life_s,
                q_age_cap=self.q_age_cap,
                bus=self.bus, governor=self.governor)
            self._ids = list(ids)
            self._lane_of = {cid: lane for lane, cid in enumerate(ids)}
            self._staged = []
            version = self.controller.bootstrap(q0)
            if threaded:
                self.controller.start()
            return version

    def stop(self, drain: bool = True) -> None:
        """Shut the admission loop down (``drain=True`` runs one final
        round over still-queued work)."""
        if self.started:
            self.controller.stop(drain=drain)

    # ---- serving-side producers ---------------------------------------
    def submit(self, cell_id: CellId, user: int, q_s: float):
        """A user arrives (or renews its QoE deadline) in a cell."""
        self._require_started()
        with self._lock:
            lane = self._lane(cell_id)
            return self.controller.submit(lane, user, q_s)

    def observe(self, cell_id: CellId, scn) -> float:
        """Publish a cell's live channel snapshot; returns drift vs the
        snapshot its active schedule was solved on and marks it for
        re-scheduling past the threshold."""
        self._require_started()
        scn = self._on_device(scn)
        with self._lock:
            lane = self._lane(cell_id)
            return self.controller.observe_scenario(lane, scn)

    def step(self) -> Optional[AdmissionRound]:
        """Drive one admission round synchronously (sync mode / tests)."""
        self._require_started()
        return self.controller.step()

    def paused(self):
        """Context manager holding the admission round lock: no admission
        round or churn op runs inside the block."""
        self._require_started()
        return self.controller.paused()

    def serve_round(self, tokens_by_cell, *, decode_steps: int = 0
                    ) -> Dict[CellId, List[RequestResult]]:
        """Execute one round on the INSTALLED schedules (no solve).

        ``tokens_by_cell``: {CellId: (U, S) integers} covering every live
        cell, or a (B, U, S) array in lane order.  Results come back keyed
        by CellId.  The CellId list and the engine's snapshot are captured
        under one facade-lock acquisition, so a concurrent churn op can
        never pair this round's ids with a differently-shaped schedule
        set; the round then executes outside the lock, as the
        ``serve.round`` span (``telemetry.spans``)."""
        self._require_started()
        with self._lock:
            ids = list(self._ids)
            ss, scns, profs = self.engine.round_snapshot()
        if ss is None:
            raise RuntimeError("no schedules installed yet")
        if isinstance(tokens_by_cell, dict):
            missing = [c for c in ids if c not in tokens_by_cell]
            if missing:
                raise ValueError(f"missing tokens for cells {missing}")
            tokens = [tokens_by_cell[c] for c in ids]
        else:
            tokens = tokens_by_cell
            if len(tokens) != len(ids):
                raise ValueError(f"need tokens for {len(ids)} cells, "
                                 f"got {len(tokens)}")
        with spans.span("serve.round", n_cells=len(ids)) as round_span:
            rounds = self.engine.serve_snapshot(ss, scns, profs, tokens,
                                                decode_steps=decode_steps)
            if round_span:
                round_span.set(n_users=sum(len(r) for r in rounds))
        if self.bus is not None:
            self.bus.emit("serve_round", version=ss.version,
                          n_cells=len(ids),
                          n_users=sum(len(r) for r in rounds))
        return {cid: res for cid, res in zip(ids, rounds)}

    # ---- per-cell state, keyed by CellId -------------------------------
    def posted_q(self, cell_id: CellId) -> np.ndarray:
        """The cell's posted (un-aged) QoE thresholds."""
        self._require_started()
        with self._lock:
            return self.controller.current_q()[self._lane(cell_id)]

    def effective_q(self, cell_id: CellId) -> np.ndarray:
        """The aged thresholds a round starting now would solve with."""
        self._require_started()
        with self._lock:
            return self.controller.effective_q()[self._lane(cell_id)]

    def qoe_attainment(self, cell_id: CellId) -> float:
        """The cell's last measured QoE attainment."""
        self._require_started()
        with self._lock:
            att = self.controller.attainment()
            return float(att[self._lane(cell_id)])

    def drift_reference(self, cell_id: CellId):
        """The scenario snapshot the cell's active schedule was solved on."""
        self._require_started()
        with self._lock:
            return self.controller.reference_scenario(self._lane(cell_id))

    def last_outcome(self, cell_id: CellId) -> Optional[ligd.LiGDOutcome]:
        """The cell's most recent solver outcome (its warm-start seed)."""
        self._require_started()
        with self._lock:
            return self.scheduler.last_outcomes[self._lane(cell_id)]

    def installed_schedule(self, cell_id: CellId) -> Schedule:
        """The cell's currently installed schedule."""
        self._require_started()
        with self._lock:
            lane = self._lane(cell_id)
            ss = self.engine.current_schedules()
        if ss is None:
            raise RuntimeError("no schedules installed yet")
        return ss.schedules[lane]
