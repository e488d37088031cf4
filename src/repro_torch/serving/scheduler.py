"""ERA-driven admission / placement scheduler.

Given a scenario (channel state), a split profile for the served model,
and per-user QoE thresholds, run Li-GD and emit a Schedule: per-user split
point, subchannel, tx power, edge compute share, plus predicted latency /
energy / QoE.

  EraScheduler       — one cell, the paper's setting (``ligd.solve``).
  MultiCellScheduler — B cells in ONE batched solve (``ligd.solve_batch``);
                       emits one Schedule per cell.

Partial rounds (``schedule(cells=...)``) solve only the touched lanes,
padded up the 1/2/4/…/B ladder of ``bucket_sizes``; padding lanes repeat a
real cell and are dropped (lane independence keeps the real lanes' results
those of an exact-size solve).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import era, ligd, network, noma, profiles
from repro_torch.core.era import Weights
from repro_torch.kernels.noma_rate.ops import uplink_rates_kernel
from repro_torch.telemetry import spans


def bucket_sizes(n_cells: int) -> List[int]:
    """The padded-batch ladder for partial rounds: powers of two below
    n_cells, plus n_cells itself."""
    if n_cells < 1:
        raise ValueError("need at least one cell")
    sizes, p = [], 1
    while p < n_cells:
        sizes.append(p)
        p *= 2
    sizes.append(n_cells)
    return sizes


def bucket_for(k: int, n_cells: int, policy: str = "pow2") -> int:
    """Padded lane count for k dirty cells under ``SolverSpec.bucket``:
    'pow2' = smallest ladder size that fits, 'exact' = k itself, 'full' =
    always all B lanes."""
    if not 1 <= k <= n_cells:
        raise ValueError(f"k must be in [1, {n_cells}], got {k}")
    if policy == "exact":
        return k
    if policy == "full":
        return n_cells
    for n in bucket_sizes(n_cells):
        if n >= k:
            return n


@dataclass
class Schedule:
    split: np.ndarray            # (U,) block index
    subchannel_up: np.ndarray    # (U,)
    subchannel_dn: np.ndarray    # (U,)
    power_up: np.ndarray         # (U,) W
    power_dn: np.ndarray         # (U,) W
    compute_units: np.ndarray    # (U,) r_i
    pred_latency: np.ndarray     # (U,) s
    pred_energy: np.ndarray      # (U,) J
    uplink_rate: np.ndarray      # (U,) bit/s
    downlink_rate: np.ndarray    # (U,) bit/s
    gamma: float
    iters: int

    def groups(self) -> Dict[int, np.ndarray]:
        """Users grouped by split point (edge batches share a split)."""
        return {int(s): np.nonzero(self.split == s)[0]
                for s in np.unique(self.split)}


def _schedule_rates(scn, alloc):
    """Scheduled NOMA rates + hard channel picks.  The uplink goes through
    the noma_rate kernel (its plain version on the CPU); the downlink is
    plain ``noma.downlink_rates``."""
    with torch.no_grad():
        r_up = uplink_rates_kernel(scn, alloc.beta_up, alloc.p)
        r_dn = noma.downlink_rates(scn, alloc.beta_dn, alloc.p_ap)
        return (r_up, r_dn, torch.argmax(alloc.beta_up, dim=-1),
                torch.argmax(alloc.beta_dn, dim=-1))


def _np(x):
    return x.detach().cpu().numpy()


def build_schedule(scn, out: ligd.LiGDOutcome) -> Schedule:
    """Lower a solver outcome to the engine-facing Schedule."""
    alloc = out.alloc
    r_up, r_dn, ch_up, ch_dn = _schedule_rates(scn, alloc)
    return Schedule(
        split=np.asarray(out.s),
        subchannel_up=_np(ch_up),
        subchannel_dn=_np(ch_dn),
        power_up=_np(alloc.p),
        power_dn=_np(alloc.p_ap),
        compute_units=_np(alloc.r),
        pred_latency=_np(out.terms.t),
        pred_energy=_np(out.terms.e),
        uplink_rate=_np(r_up),
        downlink_rate=_np(r_dn),
        gamma=float(out.terms.gamma),
        iters=out.total_iters,
    )


def _ctor_spec(spec: Optional[ligd.SolverSpec], where: str, defaults: Dict,
               **legacy) -> ligd.SolverSpec:
    """Spec resolution for the scheduler constructors: exact ``spec=`` vs
    legacy-kwarg mix detection via ligd's unset sentinel (an explicitly
    passed kwarg always raises alongside ``spec=``, even at its default
    value), and the schedulers' own historical defaults — which differ
    from ``SolverSpec``'s (``per_user_split=True`` here) — applied only
    when no spec is given."""
    passed = {k: v for k, v in legacy.items() if v is not ligd._UNSET}
    if spec is not None:
        if passed:
            raise ValueError(f"{where}: pass either spec= or the legacy "
                             f"kwargs {sorted(passed)}, not both")
        return spec
    kw = dict(defaults)
    kw.update(passed)
    return ligd.spec_from_kwargs(**kw)


class EraScheduler:
    def __init__(self, scn, prof: profiles.SplitProfile,
                 weights: Weights = Weights(),
                 spec: ligd.SolverSpec = None, *,
                 per_user_split=ligd._UNSET, max_steps=ligd._UNSET,
                 lr=ligd._UNSET, tol=ligd._UNSET,
                 compiled_sweep=ligd._UNSET):
        """One-cell ERA scheduler.  ``spec`` describes the solve; the
        legacy kwargs fold onto one when no spec is given (the scheduler's
        historical policy, ERA+ per-user splits, as defaults).  Mixing
        ``spec=`` with a legacy kwarg raises, as ``ligd.solve`` does."""
        self.spec = _ctor_spec(spec, "EraScheduler",
                               dict(per_user_split=True, max_steps=400,
                                    lr=0.05, tol=1e-5, compiled_sweep=True),
                               per_user_split=per_user_split,
                               max_steps=max_steps, lr=lr, tol=tol,
                               compiled_sweep=compiled_sweep)
        self.scn = scn
        self.prof = prof
        self.weights = weights

    def schedule(self, q_thresholds) -> Schedule:
        out = ligd.solve(self.scn, self.prof, q_thresholds, self.weights,
                         spec=self.spec)
        return build_schedule(self.scn, out)


class MultiCellScheduler:
    """Schedules B independent cells from ONE batched Li-GD solve.

    ``scns``: per-cell Scenarios (stacked once at construction).  ``prof``:
    one shared SplitProfile, or a per-cell list with equal layer counts.
    ``schedule`` takes (B, U) QoE thresholds and returns one Schedule per
    cell."""

    def __init__(self, scns: Sequence, prof,
                 weights: Weights = Weights(),
                 spec: ligd.SolverSpec = None, *,
                 per_user_split=ligd._UNSET, max_steps=ligd._UNSET,
                 lr=ligd._UNSET, tol=ligd._UNSET, gd_chunk=ligd._UNSET,
                 mesh=ligd._UNSET):
        """``spec`` describes every solve this scheduler runs; the legacy
        kwargs fold onto one when no spec is given (``gd_chunk``/``mesh``
        select the chunked/sharded backends as ``ligd.spec_from_kwargs``
        does).  Mixing ``spec=`` with a legacy kwarg raises."""
        spec = _ctor_spec(spec, "MultiCellScheduler",
                          dict(per_user_split=True, max_steps=400, lr=0.05,
                               tol=1e-5, gd_chunk=0, mesh=None),
                          per_user_split=per_user_split,
                          max_steps=max_steps, lr=lr, tol=tol,
                          gd_chunk=gd_chunk, mesh=mesh)
        if spec.backend in ("sharded", "multihost") and spec.mesh is None:
            # resolve the all-devices default ONCE: every schedule() then
            # runs on the same mesh object
            spec = spec.replace(mesh=spec.run_mesh())
        self.spec = spec
        # multihost across >1 process: partial rounds and churn solves are
        # per-process events (arrivals and drift land on one process's
        # queue), so they run on a sharded spec over the same local mesh
        # with the same GD statics — per-lane results equal the multihost
        # backend's, and no round waits for another process.
        self._host_spec = None
        if spec.backend == "multihost":
            from repro_torch.distributed import multihost
            if multihost.process_count() > 1:
                self._host_spec = spec.replace(backend="sharded")
        self.scns = list(scns)
        self.prep = ligd.prepare_batch(self.scns, prof, self.spec.warm_start)
        self.prof = prof
        self.weights = weights
        self.last_outcomes: List[Optional[ligd.LiGDOutcome]] = []

    @property
    def n_cells(self) -> int:
        return len(self.scns)

    @property
    def host_local_rounds(self) -> bool:
        """True under a multi-process ``multihost`` spec: incremental
        rounds stay on this process's lanes, and the admission loop routes
        every non-bootstrap round through the subset path."""
        return self._host_spec is not None

    @property
    def device(self) -> torch.device:
        return self.prep.scn_b.device

    def profile_for(self, cell: int) -> profiles.SplitProfile:
        return self.prof[cell] if isinstance(self.prof, (list, tuple)) \
            else self.prof

    def update_scenarios(self, scns: Sequence,
                         cells: Sequence[int] = None) -> None:
        """Swap in drifted channel snapshots without re-deriving the
        round-invariant prep.  ``cells``: update only these lanes, writing
        them into the stacked batch in place of a full restack; lanes
        outside ``cells`` keep the snapshot they were last solved on."""
        scns = list(scns)
        if len(scns) != self.n_cells:
            raise ValueError(f"need {self.n_cells} scenarios, "
                             f"got {len(scns)}")
        if cells is None:
            self.scns = scns
            self.prep = self.prep._replace(
                scn_b=network.stack_scenarios(scns), scn_list=tuple(scns),
                hetero=network.envs_differ(scns))
            return
        cells = [int(b) for b in cells]
        for b in cells:
            if not network.struct_compatible(scns[b].cfg,
                                             self.prep.scn_list[0].cfg):
                raise ValueError(f"scenario for cell {b} is structurally "
                                 "incompatible with the stacked batch")
            self.scns[b] = scns[b]
        scn_b = self.prep.scn_b
        if cells:
            idx = torch.as_tensor(cells, device=scn_b.device)
            lanes = network.stack_scenarios([scns[b] for b in cells])
            scn_b = network.tree_map(
                lambda xb, xl: xb.index_copy(0, idx, xl), scn_b, lanes)
        self.prep = self.prep._replace(
            scn_b=scn_b, scn_list=tuple(self.scns),
            hetero=network.envs_differ(self.scns))

    def resize(self, scns: Sequence, prof=None, keep: Dict[int, int] = None
               ) -> None:
        """Cell churn: remap the stacked scenarios/profiles to a new cell
        list without dropping warm-start state for surviving cells.
        ``keep`` maps new lane -> old lane (default: identity over the
        overlapping prefix); unmapped new lanes start cold.  With a shared
        profile and survivors carrying the scenario object they were last
        solved on, the stacked prep is remapped (``_remap_prep``), else
        rebuilt."""
        old_prep = self.prep
        old_outs = self.last_outcomes
        scns = list(scns)
        if keep is None:
            keep = {i: i for i in range(min(len(scns), len(old_outs)))}
        keep = {n: o for n, o in keep.items()
                if 0 <= n < len(scns) and 0 <= o < len(old_prep.scn_list)}
        new_prep = None
        if prof is None and not old_prep.prof_batched and scns:
            new_prep = self._remap_prep(scns, keep, old_prep)
        if new_prep is None:
            new_prep = ligd.prepare_batch(
                scns, self.prof if prof is None else prof,
                self.spec.warm_start)
        self.scns = scns
        if prof is not None:
            self.prof = prof
        self.prep = new_prep
        outs: List[Optional[ligd.LiGDOutcome]] = [None] * len(scns)
        for new_i, old_i in keep.items():
            if old_i < len(old_outs):
                outs[new_i] = old_outs[old_i]
        self.last_outcomes = outs

    def _remap_prep(self, scns, keep: Dict[int, int],
                    prep: ligd.BatchPrep) -> Optional[ligd.BatchPrep]:
        """Gather-survivors + concat-joiners prep for ``resize``; None when
        the mapping needs a full rebuild.  A survivor must carry the
        IDENTICAL scenario object it was last solved on."""
        ref_cfg = prep.scn_list[0].cfg
        lanes, fresh = [], []
        for i, scn in enumerate(scns):
            o = keep.get(i)
            if o is not None and scn is prep.scn_list[o]:
                lanes.append(("old", o))
            else:
                if not network.struct_compatible(scn.cfg, ref_cfg):
                    return None
                lanes.append(("new", len(fresh)))
                fresh.append(scn)
        old_idx = [o for kind, o in lanes if kind == "old"]
        parts, pred_parts = [], []
        if old_idx:
            parts.append(network.take_cells(prep.scn_b, old_idx))
            pred_parts.append(prep.pred_b[old_idx])
        if fresh:
            parts.append(network.stack_scenarios(fresh))
            pred_row = ligd.warm_start_predecessors(
                prep.prof_list[0].uplink_bits, self.spec.warm_start)
            pred_parts.append(np.stack([pred_row] * len(fresh)))
        scn_b = network.concat_cells(*parts)
        pred_b = np.concatenate(pred_parts, axis=0)
        # parts are ordered [survivors..., joiners...]; permute back to
        # lane order (identity for the common append-joiners case)
        n_old = len(old_idx)
        pos, n_seen_old = [], 0
        for kind, j in lanes:
            pos.append(n_seen_old if kind == "old" else n_old + j)
            if kind == "old":
                n_seen_old += 1
        if pos != list(range(len(lanes))):
            scn_b = network.take_cells(scn_b, pos)
            pred_b = pred_b[pos]
        return ligd.BatchPrep(
            scn_b=scn_b,
            scn_list=tuple(scns),
            prof_b=prep.prof_b,
            prof_list=(prep.prof_list[0],) * len(scns),
            prof_batched=False,
            pred_b=pred_b,
            hetero=network.envs_differ(scns),
        )

    def _warm_init(self, lanes: Sequence[int],
                   overrides: Dict[int, Dict] = None):
        """Warm-start Allocation for ``lanes`` from the previous outcomes;
        lanes without history seed from the uninformed point.  None when
        no lane has history (and no overrides).

        ``overrides``: per-user row grafts for handover —
        ``{lane: {dst_user: (src_alloc, src_user)}}`` replaces the lane's
        warm-start row ``dst_user`` with row ``src_user`` of ``src_alloc``."""
        outs = self.last_outcomes
        has_hist = bool(outs) and any(outs[i] is not None for i in lanes)
        if not has_hist and not overrides:
            return None
        outs = outs if outs else [None] * self.n_cells
        allocs = [outs[i].alloc if outs[i] is not None
                  else era.uniform_alloc(self.scns[i]) for i in lanes]
        if overrides:
            for j, lane in enumerate(lanes):
                for dst_u, (src_alloc, src_u) in \
                        (overrides.get(lane) or {}).items():
                    grafted = []
                    for x, s in zip(allocs[j], src_alloc):
                        x = x.clone()
                        x[int(dst_u)] = s[int(src_u)].to(x.device)
                        grafted.append(x)
                    allocs[j] = era.Allocation(*grafted)
        return ligd.stack_allocs(allocs)

    def _prep_subset(self, lanes: Sequence[int]) -> ligd.BatchPrep:
        """BatchPrep for a padded lane subset, gathered out of the full
        prep (the warm-start predecessor rows are reused)."""
        prep = self.prep
        scn_list = tuple(prep.scn_list[i] for i in lanes)
        prof_b = network.take_cells(prep.prof_b, lanes) \
            if prep.prof_batched else prep.prof_b
        return ligd.BatchPrep(
            scn_b=network.take_cells(prep.scn_b, lanes),
            scn_list=scn_list,
            prof_b=prof_b,
            prof_list=tuple(prep.prof_list[i] for i in lanes),
            prof_batched=prep.prof_batched,
            pred_b=prep.pred_b[list(lanes)],
            hetero=network.envs_differ(scn_list),
        )

    def schedule(self, q_per_cell, *, warm: bool = False,
                 init_alloc=None, cells: Sequence[int] = None,
                 bucket: str = None,
                 warm_overrides: Dict[int, Dict] = None) -> List[Schedule]:
        """One batched solve -> one Schedule per cell.

        ``warm=True`` seeds the solve from the previous call's solved
        allocations; ``init_alloc`` overrides the seed explicitly;
        ``warm_overrides`` grafts individual users' rows into the warm
        seed (handover).  ``cells``: solve only this cell subset, padded
        per the ``bucket`` policy (default: the spec's); returns Schedules
        aligned with ``cells`` order."""
        q = torch.as_tensor(q_per_cell, dtype=torch.float32,
                            device=self.device)
        if cells is not None:
            return self._schedule_subset(q, list(cells), warm=warm,
                                         init_alloc=init_alloc,
                                         bucket=bucket,
                                         warm_overrides=warm_overrides)
        if init_alloc is None and warm:
            init_alloc = self._warm_init(range(self.n_cells),
                                         overrides=warm_overrides)
        outs = ligd.solve_batch(self.scns, self.prof, q, self.weights,
                                spec=self.spec, prep=self.prep,
                                init_alloc=init_alloc)
        self.last_outcomes = list(outs)
        with spans.span("admission.build"):
            return [build_schedule(scn, out)
                    for scn, out in zip(self.scns, outs)]

    def _schedule_subset(self, q, cells: List[int], *, warm: bool,
                         init_alloc=None, bucket: str = None,
                         warm_overrides: Dict[int, Dict] = None
                         ) -> List[Schedule]:
        if not cells:
            return []
        if sorted(set(cells)) != sorted(cells) or \
                not all(0 <= c < self.n_cells for c in cells):
            raise ValueError(f"cells must be distinct indices in "
                             f"[0, {self.n_cells}), got {cells}")
        # q is ALWAYS the full (B, U) matrix, indexed by `cells` here
        if q.dim() != 2 or q.shape[0] != self.n_cells:
            raise ValueError(f"q must be the full (B={self.n_cells}, U) "
                             f"threshold matrix, got {tuple(q.shape)}")
        k = len(cells)
        n = bucket_for(k, self.n_cells, bucket or self.spec.bucket)
        lanes = cells + [cells[-1]] * (n - k)      # pad: repeat last cell
        prep = self.prep if lanes == list(range(self.n_cells)) \
            else self._prep_subset(lanes)
        q_sub = q[torch.as_tensor(lanes, device=q.device)]
        if init_alloc is None and warm:
            init_alloc = self._warm_init(lanes, overrides=warm_overrides)
        # host-local under a multi-process multihost spec
        outs = ligd.solve_batch(None, None, q_sub, self.weights,
                                spec=self._host_spec or self.spec,
                                prep=prep, init_alloc=init_alloc)
        if not self.last_outcomes:
            self.last_outcomes = [None] * self.n_cells
        for j, c in enumerate(cells):              # real lanes only
            self.last_outcomes[c] = outs[j]
        with spans.span("admission.build"):
            return [build_schedule(self.scns[c], outs[j])
                    for j, c in enumerate(cells)]
