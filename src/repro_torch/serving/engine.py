"""Split-serving engine: executes scheduled requests end to end.

Pipeline per admission round:
  1. scheduler -> per-user (split, channel, power, r) assignments
  2. users are grouped by split point; each group's device-side prefix runs
     on its users' tokens, the crossing activations are "transmitted" over
     the simulated NOMA link (latency = bits / scheduled rate), and the edge
     side runs as one batched forward per group
  3. decode continues on the edge from one decode state, a model's
     static ``DecodeBuffers`` (kept across rounds and cells of one
     shape): the split groups' blocks put their KV/state caches there at
     their users' rows as they make them, so the prompt runs once, and
     every step updates the buffers in place.  The one exception, a
     model with a capacity-bound MoE FFN whose cell has more than one
     split group, runs the whole cell once more into the same buffers:
     an expert's capacity depends on which rows share a batch, so there
     the groups' forward is not the whole cell's.  A dropless MoE
     (``capacity_factor=None``) computes each row on its own and fills
     the buffers from the groups like every other FFN.  One decision,
     ``graphed``, made when the buffers are built: on a card, for a
     model without an MoE FFN, the step is captured once as a CUDA
     graph and replayed; elsewhere it runs step by step

The radio and edge-compute times are simulated from the schedule and the
split profile; the numerical path (device prefix -> crossing tensor ->
edge suffix) is the real model on the model's device.

The model runs with ``impl="kernel"``, the model stack's default:
attention through the hand-written flash-attention kernel, the RG-LRU
recurrence through the hand-written scan kernel and Mamba-2's SSD through
the hand-written ssd kernel on a CUDA model, their plain versions on a
CPU one.  This is the one deliberate difference from
the JAX package, whose serving path takes ``impl="naive"`` because its
Pallas kernels compile only for a TPU.

``SplitServeEngine`` serves one cell; ``MultiCellServeEngine`` serves B
cells whose schedules come from ONE batched solve and keeps the installed
per-cell ``Schedule``s as one immutable, versioned ``ScheduleSet``,
swapped as a single reference under a lock: a reader sees the whole
previous round's schedules or the whole new one, never a mix.  The
admission loop installs and swaps schedules; the cluster facade snapshots
them.  Built with ``params=None`` the engine is a solver-only schedule
store and must not execute rounds.
"""
from __future__ import annotations

import threading
import time
import weakref
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.era import lam
from repro_torch.core.sweep_graph import CAPTURE_LOCK
from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serving import split_runtime
from repro_torch.serving.scheduler import (EraScheduler, MultiCellScheduler,
                                           Schedule)
from repro_torch.telemetry import spans


@dataclass
class RequestResult:
    user: int
    tokens_out: np.ndarray
    latency_s: float
    t_device: float
    t_uplink: float
    t_edge: float
    t_downlink: float


def _np(x):
    return x.detach().cpu().numpy()


def execute_schedule(params, cfg, netcfg, prof, sched: Schedule,
                     tokens_per_user, *, decode_steps=0
                     ) -> List[RequestResult]:
    """Run one cell's scheduled admission round (steps 2–3 above), the
    ``serve.cell`` span (``telemetry.spans``).  ``tokens_per_user``: (U,
    S) integers (numpy or a tensor), one request per user."""
    dev = params.embed.device
    tokens = torch.as_tensor(tokens_per_user).to(dev)
    dev_flops = prof.device_flops.tolist()
    edge_flops = prof.edge_flops.tolist()
    results: Dict[int, RequestResult] = {}
    groups = sched.groups()
    # Sequence length is the LAST axis — multi-codebook models carry (U,
    # n_codebooks, S) tokens, where shape[1] would be n_codebooks
    bufs = _decode_buffers(params, cfg, tokens.shape[0],
                           tokens.shape[-1] + decode_steps + 1) \
        if decode_steps else None
    # the groups fill decode's buffers (step 3), except where a
    # capacity-bound MoE FFN sees other batches than the whole cell's
    refill = bufs is not None and len(groups) > 1 \
        and _has_moe(cfg) and not moe.dropless(cfg)
    starts = []

    with spans.span("serve.cell", groups=len(groups)):
        for split, users in groups.items():
            next_tok, crossing_bits, start = _split_group(
                params, cfg, tokens, split, users,
                None if refill else bufs)
            if start is not None:
                starts.append(start)
            dev_fl = float(dev_flops[split])
            edge_fl = float(edge_flops[split])
            for row, u in enumerate(users):
                r_up = max(float(sched.uplink_rate[u]), 1.0)
                r_dn = max(float(sched.downlink_rate[u]), 1.0)
                t_dev = dev_fl / netcfg.c_device_flops
                t_up = (crossing_bits / r_up) if split < prof.n_layers \
                    else 0.0
                eff = lam(float(sched.compute_units[u]), netcfg) \
                    * netcfg.c_min_flops
                t_edge = edge_fl / eff
                t_dn = (float(prof.result_bits) / r_dn) \
                    if split < prof.n_layers else 0.0
                results[int(u)] = RequestResult(
                    user=int(u),
                    tokens_out=next_tok[row:row + 1],
                    latency_s=t_dev + t_up + t_edge + t_dn,
                    t_device=t_dev, t_uplink=t_up,
                    t_edge=t_edge, t_downlink=t_dn,
                )

        if decode_steps:
            _continue_decode(params, cfg,
                             _decode_start(params, cfg, tokens, bufs,
                                           starts),
                             results, decode_steps)
    return [results[u] for u in sorted(results)]


def _split_group(params, cfg, tokens, split, users, bufs=None):
    """One split group's forward, the ``serve.split_group`` span: the
    device side on the group's rows, the edge side, and the first greedy
    token's copy to the host.  Returns the tokens, the crossing tensor's
    bits per user and, given decode's ``bufs`` (``DecodeBuffers``), the
    group's rows and first tokens on the device, its blocks' decode
    caches put into the buffers at those rows as both sides run
    (``split_runtime``, ``_CacheSink``); else None."""
    with spans.span("serve.split_group", split=int(split), rows=len(users)):
        rows = torch.as_tensor(users, device=tokens.device)
        toks = tokens[rows]
        logits, crossing_bits = split_runtime.split_inference(
            params, cfg, toks, split,
            max_seq=None if bufs is None else bufs.max_seq,
            caches=None if bufs is None else _CacheSink(bufs, rows))
        first = torch.argmax(logits[:, -1], -1)
        start = None if bufs is None else (rows, first)
        return _np(first), crossing_bits / len(users), start


@dataclass
class DecodeStart:
    """Where a cell's greedy decode begins: the prompt ``tokens`` (U, S)
    or (U, n_codebooks, S), each row's ``first`` generated token on the
    device, and every block's decode ``caches``.  Rows index as on the
    tokens: ``start[rows]`` is those rows' start (views of the caches'
    rows; an attention cache's ``pos``, which every row shares, copied, so
    that each part decodes on its own)."""
    tokens: torch.Tensor
    first: torch.Tensor
    caches: List[dict]

    @property
    def shape(self):
        return self.tokens.shape

    def __getitem__(self, rows):
        return DecodeStart(
            self.tokens[rows], self.first[rows],
            [{k: v.clone() if k == "pos" else v[rows] for k, v in c.items()}
             for c in self.caches])


def _decode_start(params, cfg, tokens, bufs, starts) -> DecodeStart:
    """Decode's start for every row of the cell in ``bufs``, the
    ``serve.prefill`` span: each split group's ``(rows, first tokens)``
    (``_split_group``, whose blocks already put their caches there)
    written at its rows, or, with none, the whole cell run once more into
    the buffers, the computation of ``transformer.prefill``.  The span's
    fields count the rows each way: ``reused_rows``, ``prefilled_rows``."""
    n_users = tokens.shape[0]
    reused = sum(len(rows) for rows, _ in starts)
    with spans.span("serve.prefill", reused_rows=reused,
                    prefilled_rows=n_users - reused):
        if not starts:
            rows = torch.arange(n_users, device=tokens.device)
            logits, _ = split_runtime.split_inference(
                params, cfg, tokens, 0, max_seq=bufs.max_seq,
                caches=_CacheSink(bufs, rows))
            starts = [(rows, torch.argmax(logits[:, -1], -1))]
            del logits
        for rows, first in starts:
            bufs.tokens.index_copy_(0, rows, first)
    return DecodeStart(tokens, bufs.tokens, bufs.caches)


def _continue_decode(params, cfg, start, results, n_steps):
    """Greedy decode continuation on the edge (full model, cached) from
    ``start`` (a ``DecodeStart``), the ``serve.decode`` span: the further
    steps on the model's ``DecodeBuffers``, then each user's tokens into
    its result.  The span's fields: ``steps``, ``graphed`` (whether the
    steps replay a CUDA graph), the graph's ``captures`` and ``replays``
    in it, ``attn_launches``, the decode-attention kernel's calls that
    launched in it (``decode_attention.launches``; a replayed step adds
    none), and the buffers' two kinds of decode state,
    ``ssm_state_bytes`` and ``kv_bytes`` (``DecodeBuffers``)."""
    s = start.shape[-1]
    bufs = _decode_buffers(params, cfg, start.shape[0], s + n_steps + 1)
    launches = decode_attention.launches
    with spans.span("serve.decode", steps=n_steps - 1,
                    graphed=bufs.graphed, captures=0, replays=0,
                    ssm_state_bytes=bufs.ssm_state_bytes,
                    kv_bytes=bufs.kv_bytes) as span:
        seq = bufs.run(params, cfg, start, n_steps)
        span.set(attn_launches=decode_attention.launches - launches)
    for u, r in results.items():
        r.tokens_out = seq[u]


def _step(params, cfg, tokens, pos, caches, out):
    """One greedy decode step on buffers that it updates in place: the
    ``tokens`` at position ``pos`` (0-d, on the device) through
    ``transformer.decode_step``, their argmax written back to ``tokens``
    and to ``out`` (rows, positions) at the next position, ``pos``
    advanced.  It reads nothing on the host, so it is the step a
    graphed ``DecodeBuffers`` captures."""
    logits, _ = T.decode_step(params, cfg, tokens, pos, caches)
    nxt = torch.argmax(logits, -1)
    tokens.copy_(nxt)
    pos.add_(1)
    out.index_copy_(1, pos.view(1), nxt.unsqueeze(1))


# How often decode's CUDA graph engages in this process: graphs captured
# and decode steps replayed (``DecodeBuffers.step``)
DECODE_GRAPH = SimpleNamespace(captures=0, replays=0)

# each model's decode buffers, of the shape it served last; a model that
# is let go takes its buffers with it
_BUFFERS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _has_moe(cfg):
    return any(ffn == "moe" for _, ffn in cfg.layer_specs)


def _graphed(cfg, device):
    """Whether decode's step is captured as a CUDA graph: on a card, for
    a model without an MoE FFN.  An MoE's ``moe`` spans time each call (a
    replay runs none) and its capacity dispatch reads counts on the
    host."""
    return device.type == "cuda" and not _has_moe(cfg)


def _decode_buffers(params, cfg, rows, max_seq):
    """The ``DecodeBuffers`` that decode ``rows`` users of ``params`` up
    to ``max_seq`` positions.  A model keeps one set: a shape other than
    its buffers' (the config, device, rows, ``max_seq`` or cache dtype)
    replaces them with new ones (and a graph captured anew on their first
    step)."""
    key = (cfg, params.embed.device, rows, max_seq, params.embed.dtype)
    bufs = _BUFFERS.get(params)
    if bufs is None or bufs.key != key:
        _BUFFERS.pop(params, None)        # the old buffers go before the new
        bufs = _BUFFERS[params] = DecodeBuffers(key)
    return bufs


def _nbytes(caches):
    """The bytes of the tensors of the cache dicts ``caches``."""
    return sum(v.numel() * v.element_size() for c in caches
               for v in c.values())


class DecodeBuffers:
    """A cell's decode state, the static buffers that its greedy decode
    steps read and write in place: every block's decode ``caches`` for
    ``rows`` users and ``max_seq`` positions, the ``tokens`` each step
    feeds (then its argmax), their position ``pos`` (0-d, on the device)
    and ``out`` (rows, max_seq) with each token at its position; the
    caches' bytes by kind: ``kv_bytes`` the attention layers' key/value
    rings, ``ssm_state_bytes`` the recurrent layers' (Mamba-2's SSD state
    and conv history, the RG-LRU's).  Where
    ``graphed`` (``_graphed``), the first ``step`` runs eagerly on a side
    stream, then captures the same step as a CUDA graph, and every later
    one replays it; elsewhere each step runs eagerly.  One thread serves a
    model at a time: its rounds share these buffers."""

    def __init__(self, key):
        cfg, device, rows, self.max_seq, dtype = self.key = key
        self.graphed = _graphed(cfg, device)
        self.caches = T.init_caches(cfg, rows, self.max_seq, dtype=dtype,
                                    device=device)
        kv = [c for c in self.caches if "k" in c]
        self.kv_bytes = _nbytes(kv)
        self.ssm_state_bytes = _nbytes(self.caches) - self.kv_bytes
        shape = (rows, cfg.n_codebooks) if cfg.n_codebooks > 1 else (rows,)
        self.tokens = torch.zeros(shape, dtype=torch.int64, device=device)
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.out = torch.zeros((rows, self.max_seq) + shape[1:],
                               dtype=torch.int64, device=device)
        self._graph = None

    def run(self, params, cfg, start, n_steps):
        """``n_steps - 1`` steps from ``start`` (its tokens and caches
        copied in where they are not these buffers' own); returns the
        tokens (rows, n_steps) on the host."""
        if start.first is not self.tokens:
            self.tokens.copy_(start.first)
        if start.caches is not self.caches:
            for mine, theirs in zip(self.caches, start.caches):
                for k, v in theirs.items():
                    mine[k].copy_(v)
        s = start.shape[-1]
        self.pos.fill_(s)
        self.out[:, s] = self.tokens
        for _ in range(n_steps - 1):
            self.step(params, cfg)
        # a copy: the next run writes these buffers again
        return _np(self.out[:, s:s + n_steps]).copy()

    def step(self, params, cfg):
        """One decode step: eager where not ``graphed``; else a replay, or
        the first step and the capture."""
        if not self.graphed:
            _step(params, cfg, self.tokens, self.pos, self.caches, self.out)
            return
        dev = self.pos.device
        with torch.cuda.device(dev):
            if self._graph is not None:
                self._graph.replay()
                DECODE_GRAPH.replays += 1
                spans.add(replays=1)
                return
            # this step eagerly on the capture's stream first: libraries
            # make their workspaces outside the capture, and the graph's
            # first replay is the next step
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _step(params, cfg, self.tokens, self.pos, self.caches,
                      self.out)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with CAPTURE_LOCK, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                _step(params, cfg, self.tokens, self.pos, self.caches,
                      self.out)
        self._graph = graph
        DECODE_GRAPH.captures += 1
        spans.add(captures=1)


class _CacheSink:
    """Where a split group's blocks put their decode caches as they run
    (``split_runtime``'s ``caches``): each block's cache, as it is
    appended, copied into the ``DecodeBuffers``' caches at the group's
    ``rows`` (an attention cache's shared ``pos`` whole) and let go, so
    that a cell's decode caches exist once."""

    def __init__(self, bufs, rows):
        self.bufs, self.rows, self._layer = bufs, rows, 0

    def append(self, cache):
        for k, v in cache.items():
            mine = self.bufs.caches[self._layer][k]
            if k == "pos":
                mine.copy_(v)
            else:
                mine.index_copy_(0, self.rows, v)
        # emptied: the blocks' loop holds the dict while the next block
        # runs, which would keep two layers' fresh caches beside the
        # buffers at once
        cache.clear()
        self._layer += 1


class SplitServeEngine:
    def __init__(self, params, cfg, scn, prof, scheduler: EraScheduler):
        self.params = params
        self.cfg = cfg
        self.scn = scn
        self.prof = prof
        self.scheduler = scheduler

    def serve_round(self, tokens_per_user, q_thresholds, *,
                    decode_steps=0) -> List[RequestResult]:
        """tokens_per_user: (U, S) integers (each user one request)."""
        sched = self.scheduler.schedule(q_thresholds)
        return execute_schedule(self.params, self.cfg, self.scn.cfg,
                                self.prof, sched, tokens_per_user,
                                decode_steps=decode_steps)


@dataclass(frozen=True)
class ScheduleSet:
    """Immutable installed-schedule snapshot (one per cell, one version)."""
    version: int
    schedules: Tuple[Schedule, ...]


class MultiCellServeEngine:
    """Serves B cells per round: one batched schedule, per-cell execution,
    on the same model (``params=None``: a solver-only schedule store).

    ``serve_round`` is lockstep (solve, install, execute);
    ``serve_scheduled_round`` executes the installed ``ScheduleSet``
    without touching the solver, while the admission loop installs fresh
    schedules concurrently.  ``bus`` is an optional duck-typed event sink
    (anything with ``emit(name, **fields)``); every install/swap/resize records its
    version's install time, and the first ``round_snapshot`` of a version
    emits ``swap_to_serve`` with the lag."""

    def __init__(self, params, cfg, scns, scheduler: MultiCellScheduler,
                 *, bus=None, clock=time.monotonic):
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

    # ---- serving -------------------------------------------------------
    def serve_snapshot(self, ss: ScheduleSet, scns, profs,
                       tokens_per_cell, *, decode_steps=0
                       ) -> List[List[RequestResult]]:
        """Execute one round on an explicit ``round_snapshot`` triple."""
        if self.params is None:
            raise RuntimeError("this engine is a solver-only schedule store "
                               "(params=None): it has no model to serve")
        return [execute_schedule(self.params, self.cfg, scns[b].cfg, profs[b],
                                 sched, tokens_per_cell[b],
                                 decode_steps=decode_steps)
                for b, sched in enumerate(ss.schedules)]

    def serve_scheduled_round(self, tokens_per_cell, *, decode_steps=0
                              ) -> List[List[RequestResult]]:
        """Execute one round with the installed schedules — no solve."""
        ss, scns, profs = self.round_snapshot()
        if ss is None:
            raise RuntimeError("no schedules installed yet "
                               "(bootstrap with install_schedules)")
        return self.serve_snapshot(ss, scns, profs, tokens_per_cell,
                                   decode_steps=decode_steps)

    def serve_round(self, tokens_per_cell, q_per_cell, *,
                    decode_steps=0) -> List[List[RequestResult]]:
        """Lockstep solve -> install -> execute.
        tokens_per_cell: (B, U, S) integers; q_per_cell: (B, U) seconds."""
        self.install_schedules(self.scheduler.schedule(q_per_cell))
        return self.serve_scheduled_round(tokens_per_cell,
                                          decode_steps=decode_steps)
