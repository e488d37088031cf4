"""The compiled sweep on the card: Li-GD's GD chunk captured as a CUDA graph.

The JAX package compiles the whole F+1 split sweep into one XLA program
(``SolverSpec.compiled_sweep=True``, its default): a ``lax.scan`` over the
layers whose GD is a ``lax.while_loop`` with the stop test on the device,
so no step is dispatched from the host and the host waits on nothing
between steps.  The port's counterpart is a ``SweepRunner``:
``check_every`` select-frozen GD steps (``gd_loop.advance`` of
``gd_loop.gd_step``'s body) captured once with ``torch.cuda.graph`` and
replayed until the device's "some lane is still active" flag, which the
graph copies to a pinned host scalar, is read false after a replay.  A
frozen lane's carry is selected away, so a graphed solve returns the eager
loop's iterates, counts and Γ.  When ``max_steps`` is not a multiple of
``check_every``, a second graph of the remaining steps ends the budget, so
the graphs run exactly the steps the eager loop runs.

Everything the captured steps read lives in a buffer the runner owns and
refills with ``copy_``: the carry (iterate, last Γ, count, done flag, step
size), the scenario (gains, SIC orders, ``CellEnv``), the profile's split
tables (``ProfileTables``), ``q``, the split vector, and for the fused step
``build_aux``'s pack and ``layer_operands``' rows.  ``staged`` fills the
per-sweep ones once; ``SweepRunner.run`` fills the per-layer ones and the
carry, replays, and returns the layer's result.  The layer's operands and
its final Γ run eagerly.

``era_step_fused.launches`` is a Python counter, which a replay does not
run.  The kernel's wrapper counts a call made under capture in the calling
thread's tally of captured calls, not as a launch; the runner reads that
tally around its capture, so another thread's launches never enter a
graph's count, and adds the graph's count once a replay.  The warm-up's
launches ran and are counted (``SWEEP_STATS["warmup_launches"]`` has
them), so the count is the launches the device ran.

Runners are cached by everything a capture bakes in — (device, B, U, M, N,
F, ``Weights``, adaptive, step_impl, check_every, max_steps, lr, tol) — at
most ``MAX_RUNNERS``, the least recently used dropped first.  The bound is
a count, not bytes: a runner holds its staged buffers and its graphs'
working set in the pool until it is dropped, which for the ``autograd`` or
``adaptive`` body at the paper's width includes ``utility``'s (B, M, U, U)
SIC masks (about 3.1 GB at B=2).  ``pool_reserved_bytes`` reads what a
device's pool holds; a process that also serves a model or trains on the
card frees it with ``clear_cache()`` first.  Every graph on a device
allocates from that one pool (``torch.cuda.graph_pool_handle``), so a
device runs one staged sweep at a time (``staged`` holds its lock), and
the process captures one graph at a time, each in ``thread_local`` mode on
a stream of its own device (a shard's thread of
``distributed.solver_mesh`` captures on its card).

On the CPU (tensors the caller put there) a runner runs the same steps
eagerly on its buffers: the plain version, which the tests hold against
the eager loop, and which would read a stale operand if one were not
staged.  On the card a failed capture or replay raises; nothing falls back
to the eager loop (``SolverSpec(compiled_sweep=False)`` is the way to run
that).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import torch

from repro_torch.core import gd_loop
from repro_torch.core.era import utility
from repro_torch.core.network import tree_map
from repro_torch.kernels.era_step import kernel as era_step_kernel
from repro_torch.kernels.era_step import ops as era_step_ops
from repro_torch.telemetry import spans

MAX_RUNNERS = 16

_RUNNERS: "OrderedDict[tuple, SweepRunner]" = OrderedDict()
_CACHE_LOCK = threading.Lock()       # _RUNNERS, _DEVICE_LOCKS, _POOLS
# one capture at a time in the process (the serving engine's decode graph
# takes it too)
CAPTURE_LOCK = threading.Lock()
_DEVICE_LOCKS: dict = {}
_POOLS: dict = {}


class ProfileTables(NamedTuple):
    """A profile's split-indexed tables as (B, F+1) tensors: all that
    ``era.utility`` reads of a ``SplitProfile``."""
    device_flops: torch.Tensor
    edge_flops: torch.Tensor
    uplink_bits: torch.Tensor
    downlink_bits: torch.Tensor

    @classmethod
    def of(cls, prof, n_lanes: int) -> "ProfileTables":
        return cls(*(t.expand(n_lanes, t.shape[-1]) for t in (
            prof.device_flops, prof.edge_flops, prof.uplink_bits,
            prof.downlink_bits)))


def _fill(dst, src):
    """Copy ``src`` (a tensor or a container of them) into the buffers
    ``dst``, or make them: a contiguous clone when ``dst`` is None.  A
    captured graph reads its buffers by address, so once made they are
    only ever copied into; shapes and types must match."""
    if type(src) is tuple:                      # layer_operands' rows
        return tuple(_fill(d, x) for d, x in
                     zip(dst or (None,) * len(src), src))
    if dst is None:
        return tree_map(
            lambda x: x.clone(memory_format=torch.contiguous_format), src)

    def put(d, s):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"staged buffer {tuple(d.shape)} {d.dtype} "
                             f"cannot take {tuple(s.shape)} {s.dtype}")
        return d.copy_(s)

    tree_map(put, dst, src)
    return dst


def runner_key(scn, prof, q, w, *, lr, tol, max_steps, adaptive, step_impl,
               check_every) -> tuple:
    """What a capture bakes in: the device, the shapes (B, U, M, N, F) and
    the constants of the step's arithmetic and loop."""
    n_lanes, u, n, m = scn.h_up.shape
    return (q.device, n_lanes, u, m, n, prof.n_layers, w, bool(adaptive),
            step_impl, int(check_every), int(max_steps), float(lr),
            float(tol))


class SweepRunner:
    """The staged buffers of one problem shape and the graphs captured on
    them (module docs)."""

    def __init__(self, key, w, *, lr, tol, max_steps, adaptive, step_impl,
                 check_every):
        self.key = key
        self.device = key[0]
        self.w, self.lr, self.tol = w, lr, tol
        self.max_steps, self.check_every = max_steps, check_every
        # full replays of check_every steps, then the budget's remainder
        self.n_full, self.tail = divmod(max_steps, check_every)
        self.adaptive, self.step_impl = adaptive, step_impl
        self.scn = self.prof = self.q = self.aux = None
        self.s_vec = self.consts = self.carry = None
        self.graphs = None            # steps a replay -> (graph, launches)
        cuda = self.device.type == "cuda"
        self.flag = torch.zeros((), dtype=torch.bool, pin_memory=cuda)

    def stage(self, scn, prof, q, aux=None):
        """Copy a sweep's scenario, profile tables, ``q`` and (fused step)
        ``build_aux`` pack into the buffers."""
        self.scn = _fill(self.scn, scn)
        self.prof = _fill(self.prof, ProfileTables.of(prof, q.shape[0]))
        self.q = _fill(self.q, q)
        if self.step_impl == "fused":
            if aux is None:
                aux = era_step_ops.build_aux(scn)
            self.aux = _fill(self.aux, aux)

    def _loss(self, alloc):
        return utility(self.scn, self.prof, self.s_vec, alloc, self.q,
                       self.w).gamma

    def _steps(self, n: int):
        """``n`` GD steps on the buffers — the work of one replay: the carry
        is written back and the flag set to "some lane still active"."""
        _, body = gd_loop.gd_step(self.scn, self.s_vec, self.q, self.lr,
                                  self.tol, self.w, self.prof,
                                  adaptive=self.adaptive,
                                  step_impl=self.step_impl, step_aux=self.aux,
                                  consts=self.consts)
        c = self.carry
        for _ in range(n):
            c = gd_loop.advance(body, c, self.max_steps)
        _fill(self.carry, c)
        self.flag.copy_(gd_loop.active(c, self.max_steps).any(),
                        non_blocking=True)

    def _capture(self):
        """Warm up and capture a graph of each replay size on a stream of
        the runner's device.  The warm-up runs eagerly on that stream first:
        it loads the kernel library and sets its attributes, and lets every
        library make its workspace, outside the capture.  Both change the
        carry, which ``run`` stages afresh afterwards.  A graph's era_step
        launches are the calls this thread recorded while capturing it."""
        dev = self.device
        sizes = (([self.check_every] if self.n_full else [])
                 + ([self.tail] if self.tail else []))
        graphs = {}
        side = torch.cuda.Stream(dev)
        with torch.cuda.device(dev):
            for n in sizes:
                ran = era_step_kernel.thread_launches()[0]
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._steps(n)
                torch.cuda.current_stream(dev).wait_stream(side)
                gd_loop.tally(warmup_launches=(
                    era_step_kernel.thread_launches()[0] - ran))
                graph = torch.cuda.CUDAGraph()
                recorded = era_step_kernel.thread_launches()[1]
                with CAPTURE_LOCK:
                    with torch.cuda.graph(graph, pool=_pool(dev), stream=side,
                                          capture_error_mode="thread_local"):
                        self._steps(n)
                graphs[n] = (graph,
                             era_step_kernel.thread_launches()[1] - recorded)
                gd_loop.tally(captures=1)
        self.graphs = graphs

    def _replay(self, n: int):
        gd_loop.tally(replays=1)
        t0 = time.perf_counter()
        if self.graphs is None:               # the CPU: the same steps
            self._steps(n)
        else:
            graph, launches = self.graphs[n]
            with torch.cuda.device(self.device):
                graph.replay()
            if launches:
                era_step_kernel.count_launches(launches)
        spans.add(steps=n, replay_s=time.perf_counter() - t0)

    def _still_active(self) -> bool:
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        flag = bool(self.flag)
        spans.add(flag_wait_s=time.perf_counter() - t0)
        gd_loop.tally(flag_reads=1)
        return flag

    def _start(self, x0):
        self.carry = _fill(self.carry, gd_loop.init_carry(
            self._loss, x0, self.lr, self.adaptive))

    def run(self, s_vec, x0) -> gd_loop.GDResult:
        """GD of one layer of the staged sweep from ``x0`` (B lanes) at
        split vector ``s_vec`` (B, U): the replays of ``check_every`` steps
        until no lane is active, then the rest of the budget if a lane
        still is."""
        self.s_vec = _fill(self.s_vec, s_vec)
        if self.step_impl == "fused":
            self.consts = _fill(self.consts, era_step_ops.layer_operands(
                self.scn, self.prof, self.s_vec, self.q, self.w))
        self._start(x0)
        if self.graphs is None and self.device.type == "cuda":
            self._capture()
            self._start(x0)
        for _ in range(self.n_full):
            self._replay(self.check_every)
            if not self._still_active():
                break
        else:
            if self.tail:
                self._replay(self.tail)
        c = self.carry
        return gd_loop.GDResult(tree_map(torch.clone, c.alloc),
                             self._loss(c.alloc), c.k.clone())


def _pool(dev):
    with _CACHE_LOCK:
        pool = _POOLS.get(dev)
        if pool is None:
            with torch.cuda.device(dev):
                pool = _POOLS[dev] = torch.cuda.graph_pool_handle()
    return pool


def _device_lock(dev):
    with _CACHE_LOCK:
        return _DEVICE_LOCKS.setdefault(dev, threading.RLock())


def _runner(key, w, **kw) -> SweepRunner:
    with _CACHE_LOCK:
        runner = _RUNNERS.pop(key, None)
        if runner is None:
            runner = SweepRunner(key, w, **kw)
        _RUNNERS[key] = runner
        while len(_RUNNERS) > MAX_RUNNERS:
            _RUNNERS.popitem(last=False)
    return runner


@contextlib.contextmanager
def staged(scn, prof, q, w, *, lr, tol, max_steps, adaptive=False,
           step_impl="fused", check_every=1, aux=None):
    """The cached runner for this problem, holding its device's lock, with
    the sweep's scenario (batched, leading axis B), profile, ``q`` (B, U)
    and fused-step pack (``aux``, built when None) staged."""
    kw = dict(lr=lr, tol=tol, max_steps=max_steps, adaptive=adaptive,
              step_impl=step_impl, check_every=check_every)
    key = runner_key(scn, prof, q, w, **kw)
    with _device_lock(key[0]):
        runner = _runner(key, w, **kw)
        runner.stage(scn, prof, q, aux)
        yield runner


def cached_keys() -> list:
    """The cached runners' keys, least recently used first."""
    with _CACHE_LOCK:
        return list(_RUNNERS)


def clear_cache():
    """Drop every cached runner and its graphs (their memory goes back to
    the device's pool, which the allocator releases once no graph holds
    it)."""
    with _CACHE_LOCK:
        _RUNNERS.clear()


def pool_reserved_bytes(device) -> int:
    """Bytes the caching allocator holds for ``device``'s graph pool."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    pool = _POOLS.get(dev)
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == dev.index
               and tuple(seg.get("segment_pool_id", ())) == tuple(pool))
