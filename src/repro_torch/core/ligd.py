"""Li-GD — Loop-iteration Gradient Descent (paper §III, Table I) and the
cold-start GD baseline it is compared against (Corollary 4).

Structure per the paper:
  1. relax β ∈ {0,1} -> [0,1] (Corollary 1 makes Γ differentiable);
  2. for each candidate split point s: run projected GD on (β_up, β_dn, p,
     P, r) to minimise Γ_s (eq. 27);
  3. WARM START: layer j's GD starts from the solved layer whose
     intermediate data size w is closest to w_j (Table I lines 13–16);
  4. pick s* = argmin_s Γ_s, round β to one-hot (≤3 users/channel); SIC-
     infeasible users fall back to device-only (paper §II.B).

GD details: plain descent with a fixed per-variable diagonal preconditioner
(each variable's step is scaled by its feasible range), projection = box
clip + β row renormalisation.  Stops when ‖g‖<ε, |ΔΓ|<ε, or k = max_steps.

The port runs every solve over a leading cell axis B (a single cell is a
batch of one).  ``_gd_core`` steps all B lanes at once and freezes each
converged lane with ``torch.where``, so every lane's iterates and ``iters``
equal an isolated solve's — and equal the JAX package's vmapped
while-loop.  The warm-start predecessor graph depends only on the profile,
so ``_sweep_core`` is a Python loop over the F+1 layers with the fused
step's static operands (``build_aux``) built once per sweep.

Compiled sweep (``SolverSpec.compiled_sweep``, the default): the JAX
package compiles the sweep into one XLA program; the port captures
``check_every`` select-frozen GD steps as a CUDA graph and replays it until
the device's done flag says every lane has stopped (``core/sweep_graph``;
on the CPU the same steps run eagerly on the runner's buffers).  A frozen
lane's carry is selected away, so results equal the eager loop's.
``solve(compiled_sweep=False)`` runs that eager loop, dispatched from the
host step by step: the counterpart of the JAX package's per-layer
reference loop.  How a solve runs is one ``SolverSpec``; the legacy kwarg
sprawl (``compiled_sweep``/``gd_chunk``/``mesh`` and the numeric knobs)
still works through the JAX package's deprecation shim.

``SolverSpec.backend``:
  ``reference`` — reads the device-side "all lanes done" flag every step;
  ``chunked``   — reads it every ``gd_chunk`` steps (one host sync per
                  chunk); the extra steps a done lane takes are selected
                  away, so results equal ``reference``'s exactly.
  ``sharded``   — cuts the cell axis into contiguous shards over a
                  ``cells`` mesh (``distributed.solver_mesh``) and sweeps
                  each shard on its own device; each shard stops when
                  its own lanes converge;
  ``multihost`` — the sharded sweep of THIS process's lanes inside a
                  ``torch.distributed`` group (``distributed.multihost``):
                  one process, bitwise ``sharded``.
``step_impl``: ``fused`` (the port's default — the era_step CUDA kernel on
the card, its plain version on the CPU) or ``autograd`` (torch.autograd of
``era.utility``, the counterpart of the JAX package's ``xla``).

Beyond-paper extension (``per_user_split=True``, "ERA+"): reuse the F+1
solved GD problems to pick per-user s_i = argmin_s of user i's utility
contribution, then re-polish the allocation with the mixed split vector.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass
from dataclasses import replace as _dc_replace
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import network, noma, profiles, qoe, sweep_graph
from repro_torch.core.era import (Allocation, Terms, Weights, delay_terms,
                                  energy, lam, round_beta, uniform_alloc,
                                  utility)
# SWEEP_STATS is read here by the solver's callers
from repro_torch.core.gd_loop import (SWEEP_STATS, GDResult, active,
                                      advance, gd_step, init_carry, tally)
from repro_torch.core.network import tree_map
from repro_torch.kernels.era_step import kernel as era_step_kernel
from repro_torch.telemetry import spans

_BACKENDS = ("reference", "chunked", "sharded", "multihost")
_CELL_SHARDED = ("sharded", "multihost")
_BUCKETS = ("pow2", "exact", "full")
_STEP_IMPLS = ("autograd", "fused")
_PLACEMENTS = ("none", "sorted")

# gd_chunk a `backend="chunked"` spec defaults to when none is given
DEFAULT_GD_CHUNK = 8

@dataclass(frozen=True)
class SolverSpec:
    """Frozen, validated description of HOW a Li-GD solve runs.

    Fields:
      backend         'reference' | 'chunked' | 'sharded' | 'multihost'
                      (module docs).
      gd_chunk        steps between done-flag reads; 0 on 'reference'
                      (enforced), ``DEFAULT_GD_CHUNK`` when 'chunked'
                      leaves it at 0; 'sharded' and 'multihost' take
                      either (0 = read it every step, in each shard).
      lr / tol /
      max_steps       the GD knobs of Table I.
      warm_start      Table I's nearest-w predecessor warm start inside
                      one sweep (False = the cold-start GD baseline).
      warm            cross-ROUND warm start, consumed by the serving layer.
      per_user_split  ERA+ per-user split pick + polish (beyond paper).
      adaptive        backtracking step-size control (beyond paper).
      compiled_sweep  True (default): the GD chunk runs as a captured CUDA
                      graph on the card (``core/sweep_graph``); False:
                      the eager per-layer loop, 'reference' backend and
                      ``solve`` only.
      bucket          partial-round padding policy: 'pow2' | 'exact' |
                      'full'.
      mesh            a ``solver_mesh.cells_mesh`` for 'sharded'/
                      'multihost' (None = resolve one at use:
                      ``run_mesh``).
      step_impl       'fused' (default) | 'autograd'.
      lane_placement  'none' | 'sorted': 'sorted' deals lanes to shards
                      by the previous same-size round's iteration counts
                      (hardest first, round-robin) and inverts the
                      permutation on every output, so outcomes equal
                      'none''s (on the card, Γ of a lane that moves
                      within its shard up to its last bits: CUDA
                      reductions round by a row's alignment).  'sharded'
                      only.
    """
    backend: str = "reference"
    gd_chunk: int = 0
    lr: float = 0.05
    tol: float = 1e-5
    max_steps: int = 400
    warm_start: bool = True
    warm: bool = True
    per_user_split: bool = False
    adaptive: bool = False
    compiled_sweep: bool = True
    bucket: str = "pow2"
    mesh: Optional[tuple] = None           # solver_mesh.cells_mesh
    step_impl: str = "fused"
    lane_placement: str = "none"

    def __post_init__(self):
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, "
                             f"got {self.backend!r}")
        if self.bucket not in _BUCKETS:
            raise ValueError(f"bucket must be one of {_BUCKETS}, "
                             f"got {self.bucket!r}")
        if self.gd_chunk < 0:
            raise ValueError(f"gd_chunk must be >= 0, got {self.gd_chunk}")
        if self.backend == "chunked" and self.gd_chunk == 0:
            object.__setattr__(self, "gd_chunk", DEFAULT_GD_CHUNK)
        if self.backend == "reference" and self.gd_chunk:
            raise ValueError("backend='reference' reads the done flag every "
                             "step; use backend='chunked' for gd_chunk>0")
        if self.mesh is not None and self.backend not in _CELL_SHARDED:
            raise ValueError("mesh= only applies to backend='sharded' "
                             "or 'multihost'")
        if not self.compiled_sweep and self.backend != "reference":
            raise ValueError("compiled_sweep=False (per-layer reference "
                             "loop) only composes with backend='reference'")
        if self.step_impl not in _STEP_IMPLS:
            raise ValueError(f"step_impl must be one of {_STEP_IMPLS}, "
                             f"got {self.step_impl!r}")
        if self.lane_placement not in _PLACEMENTS:
            raise ValueError(f"lane_placement must be one of {_PLACEMENTS},"
                             f" got {self.lane_placement!r}")
        if self.lane_placement == "sorted" and self.backend != "sharded":
            # multihost rejects it too: a global permutation would need
            # every process to see every lane's iteration history
            raise ValueError("lane_placement='sorted' permutes lanes "
                             "across mesh shards — it only applies to "
                             "backend='sharded'")
        if not self.lr > 0:
            raise ValueError(f"lr must be > 0, got {self.lr}")
        if self.tol < 0:
            raise ValueError(f"tol must be >= 0, got {self.tol}")
        if self.max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {self.max_steps}")

    def replace(self, **kw) -> "SolverSpec":
        """Functional update (re-validated)."""
        return _dc_replace(self, **kw)

    @property
    def check_every(self) -> int:
        """Steps between reads of the device-side done flag."""
        return self.gd_chunk or 1

    def run_mesh(self):
        """The mesh a 'sharded'/'multihost' solve runs on (None for the
        single-device backends).  An unset mesh resolves to a ``cells``
        mesh over every visible CUDA device ('sharded') or this
        process's part of the global mesh ('multihost').  Both resolvers
        memoise, so repeated resolution returns the identical object."""
        if self.backend not in _CELL_SHARDED:
            return None
        if self.mesh is not None:
            return self.mesh
        if self.backend == "multihost":
            from repro_torch.distributed import multihost
            return multihost.global_cells_mesh()
        from repro_torch.distributed import solver_mesh
        return solver_mesh.cells_mesh()


class _Unset:
    def __repr__(self):
        return "<unset>"


_UNSET = _Unset()

# legacy kwargs that warn (the sprawl SolverSpec replaces); plain numeric
# knobs (lr/tol/max_steps/...) fold into the spec silently
_SPEC_DEPRECATED = ("compiled_sweep", "gd_chunk", "mesh")
# passing a deprecated kwarg at its no-op value is vacuous — fold it
# without warning (and without conflicting with an explicit spec=)
_VACUOUS = {"compiled_sweep": True, "gd_chunk": 0, "mesh": None}


def spec_from_kwargs(**kw) -> SolverSpec:
    """Map the legacy kwarg sprawl onto a ``SolverSpec``: ``mesh`` selects
    the sharded backend, else ``gd_chunk>0`` selects chunked, else
    reference.  Shared by the ``solve``/``solve_batch`` deprecation shims
    and the serving constructors' legacy signatures."""
    gd_chunk = int(kw.pop("gd_chunk", 0) or 0)
    mesh = kw.pop("mesh", None)
    if mesh is not None:
        kw.update(backend="sharded", mesh=mesh, gd_chunk=gd_chunk)
    elif gd_chunk:
        kw.update(backend="chunked", gd_chunk=gd_chunk)
    return SolverSpec(**kw)


def _resolve_spec(spec: Optional[SolverSpec], where: str,
                  **legacy) -> SolverSpec:
    """Either take the explicit ``spec=`` or build one from legacy kwargs.
    Mixing the two is rejected; deprecated structural kwargs
    (``compiled_sweep``/``gd_chunk``/``mesh``) warn."""
    passed = {k: v for k, v in legacy.items()
              if v is not _UNSET and _VACUOUS.get(k, _UNSET) != v}
    if spec is not None:
        if passed:
            raise ValueError(
                f"{where}: pass either spec= or the legacy kwargs "
                f"{sorted(passed)}, not both")
        return spec
    dep = sorted(k for k in passed if k in _SPEC_DEPRECATED)
    if dep:
        warnings.warn(
            f"{where}({', '.join(dep)}=...) is deprecated; build a "
            "SolverSpec and pass spec= (README.md has the migration "
            "table)", DeprecationWarning, stacklevel=3)
    return spec_from_kwargs(**passed)


class LiGDOutcome(NamedTuple):
    s: np.ndarray                 # (U,) chosen split per user
    alloc: Allocation             # rounded allocation
    terms: Terms                  # evaluated at the rounded solution
    gamma_by_layer: np.ndarray    # (F+1,) Γ_s landscape
    iters_by_layer: np.ndarray    # (F+1,) GD iterations (Corollary 4 data)
    total_iters: int


def _gd_core(scn, s_vec, q, x0, lr, tol, max_steps, w, prof,
             adaptive=False, step_impl="fused", step_aux=None,
             check_every=1, graphed=True) -> GDResult:
    """Projected, preconditioned GD on Γ over B lanes at once
    (``gd_loop.gd_step``).

    ``scn``/``s_vec``/``q``/``x0`` carry the leading cell axis B.  Each
    lane steps until its own stop test fires or it reaches ``max_steps``;
    a stopped lane's carry (iterate, last Γ, count, done flag, step size)
    is frozen by select while the others go on, so per-lane results are
    those of an isolated solve.  The host reads the "all lanes stopped"
    flag every ``check_every`` steps.

    ``graphed`` (the compiled sweep): the steps run through
    ``sweep_graph``'s cached runner, ``check_every`` of them a CUDA graph
    replay on the card; False: the loop below, every step dispatched from
    the host.  Both return the same iterates, counts and Γ."""
    if graphed:
        with sweep_graph.staged(scn, prof, q, w, lr=lr, tol=tol,
                                max_steps=max_steps, adaptive=adaptive,
                                step_impl=step_impl, check_every=check_every,
                                aux=step_aux) as runner:
            return runner.run(s_vec, x0)
    loss, body = gd_step(scn, s_vec, q, lr, tol, w, prof, adaptive=adaptive,
                         step_impl=step_impl, step_aux=step_aux)
    c = init_carry(loss, x0, lr, adaptive)
    steps = 0
    for it in range(max_steps):
        if it % check_every == 0:
            t0 = time.perf_counter()
            still = bool(active(c, max_steps).any())
            spans.add(flag_wait_s=time.perf_counter() - t0)
            tally(flag_reads=1)
            if not still:
                break
        c = advance(body, c, max_steps)
        steps += 1
    spans.add(steps=steps)
    return GDResult(c.alloc, loss(c.alloc), c.k)


def _gd_solve(scn, s_vec, q, x0, lr, tol, max_steps, w, prof,
              adaptive=False, step_impl="fused", check_every=1) -> GDResult:
    """Single-cell GD at one split vector: ``_gd_core`` (graphed) on a
    batch of one.  ``scn``/``s_vec`` (U,)/``q`` (U,)/``x0``
    carry no cell axis, nor does the result.  The baselines' entry
    point."""
    one = lambda x: x[None]
    with torch.no_grad():
        res = _gd_core(tree_map(one, scn), one(s_vec), one(q),
                       tree_map(one, x0), lr, tol, max_steps, w, prof,
                       adaptive=adaptive, step_impl=step_impl,
                       check_every=check_every)
    return GDResult(tree_map(lambda x: x[0], res.alloc), res.gamma[0],
                    res.iters[0])


def warm_start_predecessors(uplink_bits, warm_start: bool = True
                            ) -> np.ndarray:
    """Host-side precompute of Table I's nearest-w warm-start rule.

    Returns ``pred`` (F+1,) int32: the GD for split point s starts from
    the solved allocation of split ``pred[s]`` — the already-visited split
    whose intermediate data size is nearest ``w_s`` (first index wins
    ties).  ``pred[s] == s`` means "start cold" (s = 0, or the
    ``warm_start=False`` baseline)."""
    if isinstance(uplink_bits, torch.Tensor):
        uplink_bits = uplink_bits.detach().cpu().numpy()
    wbits = np.asarray(uplink_bits)
    n = wbits.shape[0]
    pred = np.arange(n, dtype=np.int32)
    if warm_start:
        for s in range(1, n):
            pred[s] = np.argmin(np.abs(wbits[s] - wbits[:s]))
    return pred


def _sweep_core(scn, q, x_init, pred, lr, tol, max_steps, w, prof,
                adaptive=False, step_impl="fused", check_every=1,
                graphed=True) -> GDResult:
    """The whole F+1 split sweep over B lanes: a loop over layers whose
    slot buffer (leading axis F+1, then B) starts as ``x_init`` in every
    slot; layer s reads slot ``pred[b, s]`` per lane, runs GD, and writes
    slot s.  Returns a GDResult whose leaves carry (B, F+1, ...).

    ``graphed``: one ``sweep_graph`` runner serves every layer, its
    scenario, profile, ``q`` and ``build_aux`` pack staged once a sweep;
    False: ``_gd_core``'s eager loop a layer.

    The sweep is the ``solver.sweep`` span (``telemetry.spans``), whose
    ``launches`` are the era_step launches this thread ran in it."""
    with spans.span("solver.sweep") as sweep:
        ran = era_step_kernel.thread_launches()[0]
        out = _sweep_layers(scn, q, x_init, pred, lr, tol, max_steps, w,
                            prof, adaptive, step_impl, check_every, graphed)
        if sweep:
            sweep.set(launches=era_step_kernel.thread_launches()[0] - ran)
        return out


def _sweep_layers(scn, q, x_init, pred, lr, tol, max_steps, w, prof,
                  adaptive, step_impl, check_every, graphed) -> GDResult:
    """``_sweep_core``'s work: a ``solver.layer`` span a layer, which the
    GD loop's counts (``gd_loop.tally``) land in."""
    n_lanes, n_s = pred.shape
    u = q.shape[-1]
    dev = q.device
    lanes = torch.arange(n_lanes, device=dev)
    buf = tree_map(lambda x: x[None].repeat((n_s,) + (1,) * x.dim()),
                   x_init)
    step_aux = None
    if step_impl == "fused":
        from repro_torch.kernels.era_step import ops as _era_step_ops
        step_aux = _era_step_ops.build_aux(scn)
    pred_t = torch.as_tensor(np.asarray(pred), dtype=torch.int64, device=dev)
    staging = contextlib.nullcontext()
    if graphed:
        staging = sweep_graph.staged(scn, prof, q, w, lr=lr, tol=tol,
                                     max_steps=max_steps, adaptive=adaptive,
                                     step_impl=step_impl,
                                     check_every=check_every, aux=step_aux)
    gammas, iters = [], []
    with staging as runner:
        for s in range(n_s):
            with spans.span("solver.layer", split=s):
                x0 = tree_map(lambda b: b[pred_t[:, s], lanes], buf)
                s_vec = torch.full((n_lanes, u), s, dtype=torch.int64,
                                   device=dev)
                if runner is not None:
                    res = runner.run(s_vec, x0)
                else:
                    res = _gd_core(scn, s_vec, q, x0, lr, tol, max_steps, w,
                                   prof, adaptive=adaptive,
                                   step_impl=step_impl, step_aux=step_aux,
                                   check_every=check_every, graphed=False)
                for b, a in zip(buf, res.alloc):
                    b[s] = a
            gammas.append(res.gamma)
            iters.append(res.iters)
    return GDResult(tree_map(lambda b: b.transpose(0, 1), buf),
                    torch.stack(gammas, dim=1), torch.stack(iters, dim=1))


def _per_user_cost(scn, prof, s_vec, alloc, q, w: Weights):
    """User i's summand of Γ (for the ERA+ per-user split pick)."""
    t_dev, t_srv, t_up, t_dn, r_up, r_dn = delay_terms(scn, prof, s_vec, alloc)
    t = t_dev + t_srv + t_up + t_dn
    e = energy(scn, prof, s_vec, alloc, r_up, r_dn)
    r_ind = qoe.indicator(t, q, w.qoe_a)
    c_i = (t - q) * r_ind
    return (w.w_t * t * w.t_scale + w.w_q * (c_i * w.t_scale + r_ind)
            + w.w_r * (e * w.e_scale + lam(alloc.r, scn.env) * w.r_cost_scale))


def _cost_table(scn, prof, stacked, q, w):
    """(B, F+1, U) table of each user's Γ summand at every solved split;
    one layer at a time (each evaluation holds the (B, M, U, U) SIC
    masks)."""
    n_lanes, n_s = stacked.p.shape[:2]
    u = q.shape[-1]
    cols = []
    for s in range(n_s):
        s_vec = torch.full((n_lanes, u), s, dtype=torch.int64,
                           device=q.device)
        cols.append(_per_user_cost(scn, prof, s_vec,
                                   tree_map(lambda x: x[:, s], stacked),
                                   q, w))
    return torch.stack(cols, dim=1)


def _discretize(scn, prof, s_user, hard, q, w, f):
    """SIC feasibility fallback + final Γ at the rounded allocation."""
    feasible = noma.sic_feasible(scn, hard.beta_up, hard.p)
    s_final = torch.where(feasible, s_user, torch.full_like(s_user, f))
    return s_final, utility(scn, prof, s_final, hard, q, w)


def stack_allocs(allocs) -> Allocation:
    """Stack per-cell Allocations along a new leading cell axis B."""
    allocs = list(allocs)
    if not allocs:
        raise ValueError("need at least one allocation")
    return tree_map(lambda *xs: torch.stack(xs), *allocs)


def warm_start_from(outcomes) -> Allocation:
    """Batched warm-start point from the previous round's outcomes."""
    return stack_allocs([o.alloc for o in outcomes])


def soften_beta(scn, alloc: Allocation, eps: float = 0.1) -> Allocation:
    """Blend a hard one-hot β back into the simplex interior so a previous
    outcome can seed a new GD run (gradients at exact vertices are brittle)."""
    m = scn.cfg.n_subchannels

    def mix(b):
        return (1.0 - eps) * b + eps / m

    return alloc._replace(beta_up=mix(alloc.beta_up),
                          beta_dn=mix(alloc.beta_dn))


def _finalize(prep, q, w, swept, spec: SolverSpec) -> List[LiGDOutcome]:
    """Shared post-sweep discretisation over B lanes: s* pick (+ ERA+
    per-user split & polish), per-cell β rounding on the host, SIC
    fallback and final Γ.  Inside the ``solver.finalize`` span its caller
    opens, each of the three is a span: ``finalize.per_user_gd`` (which
    the GD loop's counts land in), ``finalize.round_beta`` and
    ``finalize.discretize``."""
    scn_b, scn_list, prof_b = prep.scn_b, prep.scn_list, prep.prof_b
    n_cells = len(scn_list)
    f = prep.prof_list[0].n_layers
    u = q.shape[-1]
    dev = q.device
    gammas = swept.gamma.cpu().numpy()                      # (B, F+1)
    iters = swept.iters.cpu().numpy()
    s_star = torch.as_tensor(np.argmin(gammas, axis=1), device=dev)
    lanes = torch.arange(n_cells, device=dev)
    x_star = tree_map(lambda x: x[lanes, s_star], swept.alloc)

    if spec.per_user_split:
        with spans.span("finalize.per_user_gd") as gd:
            ran = era_step_kernel.thread_launches()[0]
            # (B, F+1, U)
            costs = _cost_table(scn_b, prof_b, swept.alloc, q, w)
            s_user = torch.argmin(costs, dim=1)
            alloc_b = _gd_core(scn_b, s_user, q, x_star, spec.lr, spec.tol,
                               spec.max_steps, w, prof_b,
                               adaptive=spec.adaptive,
                               step_impl=spec.step_impl,
                               check_every=spec.check_every,
                               graphed=spec.compiled_sweep).alloc
            if gd:
                gd.set(launches=era_step_kernel.thread_launches()[0] - ran)
    else:
        s_user = s_star[:, None].expand(n_cells, u)
        alloc_b = x_star

    # discretise per cell (host greedy), then one batched SIC+Γ evaluation
    with spans.span("finalize.round_beta"):
        hard_list = [round_beta(scn_list[b],
                                tree_map(lambda x: x[b], alloc_b))
                     for b in range(n_cells)]
        hard_b = stack_allocs(hard_list)
    with spans.span("finalize.discretize"):
        s_final_b, terms_b = _discretize(scn_b, prof_b, s_user, hard_b, q,
                                         w, f)
        s_final_np = s_final_b.cpu().numpy()
    return [
        LiGDOutcome(
            s=s_final_np[b],
            alloc=hard_list[b],
            terms=Terms(*(leaf[b] for leaf in terms_b)),
            gamma_by_layer=gammas[b],
            iters_by_layer=iters[b],
            total_iters=int(iters[b].sum()),
        )
        for b in range(n_cells)
    ]


# lane_placement='sorted' history: padded batch size -> (B,) per-lane total
# GD iterations of the latest sharded solve at that size.  Advisory only:
# the permutation it induces is inverted on every output, so it changes
# which shard works hardest, never what a solve returns.
_LANE_ITERS: dict = {}


def reset_lane_history():
    """Drop the lane_placement='sorted' history (on cell churn, where lane
    indices change meaning, or between unrelated solves)."""
    _LANE_ITERS.clear()


def _lane_permutation(n_lanes: int, n_shards: int):
    """Slot->lane permutation for ``lane_placement='sorted'``, or None when
    there is nothing to sort (no history at this size, or one shard).

    Lanes ranked by the previous same-size round's total iterations are
    dealt round-robin over the mesh's contiguous shard blocks — hardest
    lane to shard 0, the next to shard 1, … .  ``permuted[k] =
    original[perm[k]]``; invert with ``np.argsort(perm)``."""
    hist = _LANE_ITERS.get(n_lanes)
    if hist is None or n_shards <= 1 or n_lanes <= 1:
        return None
    order = np.argsort(-np.asarray(hist), kind="stable")
    block = -(-n_lanes // n_shards)              # shard block length (ceil)
    slots = [s * block + t
             for t in range(block) for s in range(n_shards)
             if s * block + t < n_lanes]         # round-robin slot order
    perm = np.empty(n_lanes, dtype=np.int64)
    perm[np.asarray(slots)] = order
    return perm


class BatchPrep(NamedTuple):
    """Round-invariant inputs of ``solve_batch`` (stacked scenarios,
    stacked/per-cell profiles, warm-start predecessor matrix)."""
    scn_b: object                 # batched Scenario (leading cell axis)
    scn_list: tuple               # per-cell Scenarios
    prof_b: object                # shared or stacked SplitProfile
    prof_list: tuple              # per-cell SplitProfiles
    prof_batched: bool
    pred_b: np.ndarray            # (B, F+1) warm-start predecessors
    hetero: bool = False          # cells carry different numeric params


def prepare_batch(scns, prof, warm_start: bool = True) -> BatchPrep:
    """Precompute everything about (cells, profiles) that does not change
    between solves.  ``scns``: list of Scenarios or an already-stacked
    batched Scenario; ``prof``: shared profile or per-cell list."""
    if isinstance(scns, (list, tuple)):
        scn_list = tuple(scns)
        scn_b = network.stack_scenarios(scn_list)
    else:
        scn_b = scns
        scn_list = tuple(tree_map(lambda x, b=b: x[b], scn_b)
                         for b in range(scn_b.assoc.shape[0]))
    n_cells = len(scn_list)

    if isinstance(prof, (list, tuple)):
        prof_list = tuple(prof)
        if len(prof_list) != n_cells:
            raise ValueError("need one profile per cell")
        prof_b = profiles.stack_profiles(prof_list)
        prof_batched = True
    else:
        prof_list = (prof,) * n_cells
        prof_b = prof
        prof_batched = False

    pred_b = np.stack([warm_start_predecessors(p.uplink_bits, warm_start)
                       for p in prof_list])
    hetero = network.envs_differ(scn_list)
    return BatchPrep(scn_b, scn_list, prof_b, prof_list, prof_batched,
                     pred_b, hetero)


def solve_batch(scns, prof, q, w: Weights = Weights(), *,
                spec: SolverSpec = None, lr=_UNSET, tol=_UNSET,
                max_steps=_UNSET, warm_start=_UNSET, per_user_split=_UNSET,
                adaptive=_UNSET, prep: BatchPrep = None,
                init_alloc: Allocation = None, gd_chunk=_UNSET,
                mesh=_UNSET, compiled_sweep=_UNSET) -> List[LiGDOutcome]:
    """Schedule B independent cells with one batched sweep.

      scns: a list/tuple of structurally compatible ``Scenario``s, or an
        already-stacked batched Scenario.
      prof: one shared ``SplitProfile``, or a list of per-cell profiles
        with equal layer counts.
      q: (B, U) per-cell QoE thresholds.
      prep: a ``prepare_batch`` result (``scns``/``prof``/
        ``spec.warm_start`` are then ignored in its favour).
      init_alloc: a batched Allocation with leading axis B (typically
        ``warm_start_from(previous_outcomes)``) or a list of per-cell
        Allocations; hard one-hot β rows are softened (``soften_beta``).

    ``spec.backend='sharded'`` sweeps contiguous lane shards over
    ``spec.run_mesh()``, padding the lanes (repeat-last) to a multiple of
    the shard count and dropping the padding; ``'multihost'`` does so for
    THIS process's lanes: every process passes its own lanes, the same
    local count and statics, and gets back outcomes for its own lanes.
    The sweep is always the compiled one (``compiled_sweep=False`` is
    ``solve``'s single-cell loop and raises here).

    Legacy kwargs (``gd_chunk=``/``mesh=``/``compiled_sweep=`` plus the
    numeric knobs) fold onto the equivalent spec through the deprecation
    shim; mixing them with ``spec=`` raises.

    Returns one ``LiGDOutcome`` per cell."""
    spec = _resolve_spec(spec, "ligd.solve_batch", lr=lr, tol=tol,
                         max_steps=max_steps, warm_start=warm_start,
                         per_user_split=per_user_split, adaptive=adaptive,
                         gd_chunk=gd_chunk, mesh=mesh,
                         compiled_sweep=compiled_sweep)
    if not spec.compiled_sweep:
        raise ValueError(
            "compiled_sweep=False is the per-layer sequential reference "
            "loop, a single-cell path — use ligd.solve; solve_batch "
            "always runs the compiled sweep")
    return _solve_lanes(scns, prof, q, w, spec, prep, init_alloc)


def _solve_lanes(scns, prof, q, w, spec: SolverSpec, prep: BatchPrep,
                 init_alloc) -> List[LiGDOutcome]:
    """``solve_batch`` past its argument checks, and ``solve``'s batch of
    one: the sweep is graphed unless ``spec.compiled_sweep`` is False."""
    if prep is None:
        prep = prepare_batch(scns, prof, spec.warm_start)
    scn_b = prep.scn_b
    n_cells = len(prep.scn_list)
    q = torch.as_tensor(q, dtype=torch.float32, device=scn_b.device)
    if q.dim() != 2 or q.shape[0] != n_cells:
        raise ValueError(f"q must be (B, U) with B={n_cells}, "
                         f"got {tuple(q.shape)}")
    if init_alloc is not None:
        if not isinstance(init_alloc, Allocation) \
                and isinstance(init_alloc, (list, tuple)):
            init_alloc = stack_allocs(init_alloc)
        if init_alloc.p.shape[0] != n_cells:
            raise ValueError(f"init_alloc must carry a leading B={n_cells} "
                             f"axis, got {tuple(init_alloc.p.shape)}")
        x_init = soften_beta(scn_b, tree_map(
            lambda x: x.to(device=scn_b.device, dtype=torch.float32),
            init_alloc))
    else:
        x_init = uniform_alloc(scn_b)
    run_mesh = spec.run_mesh()
    sweep_kw = dict(adaptive=spec.adaptive, step_impl=spec.step_impl,
                    check_every=spec.check_every,
                    prof_batched=prep.prof_batched)
    with torch.no_grad():
        if spec.backend == "multihost":
            from repro_torch.distributed import multihost
            # this process's lanes in, this process's lanes out; no
            # _LANE_ITERS record, since 'sorted' is rejected here
            swept = multihost.multihost_sweep(
                run_mesh, scn_b, q, x_init, prep.pred_b, spec.lr, spec.tol,
                spec.max_steps, w, prep.prof_b, **sweep_kw)
        elif run_mesh is not None:
            swept = _placed_sweep(run_mesh, scn_b, q, x_init, prep, spec, w,
                                  sweep_kw)
            # this round's per-lane effort, for the next same-size round
            _LANE_ITERS[n_cells] = swept.iters.sum(dim=1).cpu().numpy()
        else:
            swept = _sweep_core(scn_b, q, x_init, prep.pred_b, spec.lr,
                                spec.tol, spec.max_steps, w, prep.prof_b,
                                adaptive=spec.adaptive,
                                step_impl=spec.step_impl,
                                check_every=spec.check_every,
                                graphed=spec.compiled_sweep)
        with spans.span("solver.finalize"):
            return _finalize(prep, q, w, swept, spec)


def _placed_sweep(mesh, scn_b, q, x_init, prep, spec, w, sweep_kw):
    """The sharded sweep, with the lanes permuted first and the outputs
    permuted back under ``lane_placement='sorted'``.  A lane's GD is
    frozen by select, so its result does not depend on the lanes beside
    it: the inverse permutation restores the 'none' placement's outputs
    (SolverSpec's docs name the last-bit exception on the card)."""
    from repro_torch.distributed import solver_mesh
    perm = None
    if spec.lane_placement == "sorted":
        perm = _lane_permutation(q.shape[0], len(mesh))
    prof_b, pred_b = prep.prof_b, prep.pred_b
    if perm is not None:
        take = lambda x: network.take_cells(x, perm)
        scn_b, q, x_init = take(scn_b), take(q), take(x_init)
        pred_b = pred_b[perm]
        if prep.prof_batched:
            prof_b = take(prof_b)
    swept = solver_mesh.sharded_sweep(mesh, scn_b, q, x_init, pred_b,
                                      spec.lr, spec.tol, spec.max_steps, w,
                                      prof_b, **sweep_kw)
    if perm is not None:
        swept = network.take_cells(swept, np.argsort(perm))
    return swept


def solve(scn, prof, q, w: Weights = Weights(), *, spec: SolverSpec = None,
          lr=_UNSET, tol=_UNSET, max_steps=_UNSET, warm_start=_UNSET,
          per_user_split=_UNSET, init_alloc: Allocation = None,
          adaptive=_UNSET, compiled_sweep=_UNSET,
          gd_chunk=_UNSET) -> LiGDOutcome:
    """Run Li-GD (``spec.warm_start=True``) or the cold-start GD baseline
    over every candidate split point for one cell: a batch of one.
    ``spec.compiled_sweep=False`` runs the eager per-layer loop.

    Legacy kwargs (``lr``/``tol``/… and the deprecated structural pair
    ``compiled_sweep``/``gd_chunk``) fold onto the equivalent spec;
    mixing them with ``spec=`` raises.

    ``init_alloc`` (online ERA): seed layer 1's GD from a previous time
    step's solution instead of the uninformed start."""
    spec = _resolve_spec(spec, "ligd.solve", lr=lr, tol=tol,
                         max_steps=max_steps, warm_start=warm_start,
                         per_user_split=per_user_split, adaptive=adaptive,
                         compiled_sweep=compiled_sweep, gd_chunk=gd_chunk)
    if spec.backend in _CELL_SHARDED:
        raise ValueError(f"backend={spec.backend!r} shards a CELL axis — "
                         "use solve_batch (single-cell solve has no cell "
                         "axis)")
    q = torch.as_tensor(q, dtype=torch.float32, device=scn.device)
    init = None if init_alloc is None else stack_allocs([init_alloc])
    return _solve_lanes([scn], prof, q[None], w, spec, None, init)[0]
