"""Cell-sharded Li-GD solves: ``SolverSpec(backend='sharded')``.

``ligd.solve_batch`` sweeps the F+1 splits over a leading cell axis B.
This module cuts that axis into contiguous shards over a ``cells`` mesh
and sweeps each shard with the same ``ligd._sweep_core``, so a shard's
chunked GD stops when ITS lanes converge: a slow cell holds back only
the shard it lives on.  The sweep has no cross-cell reduction (every sum
in noma.py/era.py runs over one cell's users and channels), so the shards
never exchange data until their results are gathered in lane order.

A mesh is an ordered, hashable tuple of ``torch.device``s, one entry a
shard; a device may appear more than once.  Shards on distinct devices
run in one host thread each; shards that share a device run one after
another in lane order, so no result depends on how threads interleave.
Each shard's sweep is the compiled one (``core/sweep_graph``): its thread
captures and replays the graphs of its own card, in ``thread_local``
capture mode, from a runner cached per device.
``cells_mesh(n, device="cpu")`` is n shards on the host, which is how the
CPU tests exercise a real split (the counterpart of the JAX package's
forced host device count).
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import ligd, network
from repro_torch.launch.platform import resolve_device

CELL_AXIS = "cells"

_MESH_CACHE = {}


def cells_mesh(n_devices: int = None, device=None) -> tuple:
    """1-D ``cells`` mesh of THIS process.

    ``device=None``: a prefix of the visible CUDA devices, every one when
    ``n_devices`` is None (a larger request is clamped); raises without a
    card.  An explicit ``device`` (``"cpu"``, ``"cuda:0"``): ``n_devices``
    shards (default 1) on that device.  Memoised per request, so
    ``SolverSpec.run_mesh()``'s default resolves to the identical tuple on
    every call."""
    if device is None:
        resolve_device()                      # raises without a card
        n_avail = torch.cuda.device_count()
        n = n_avail if n_devices is None else max(1, min(n_devices, n_avail))
        key = (n, None)
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        dev = resolve_device(device)
        n = 1 if n_devices is None else max(1, int(n_devices))
        key = (n, dev)
        devices = [dev] * n
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = tuple(devices)
    return mesh


def pad_lanes(n_lanes: int, n_shards: int):
    """Gather indices that pad a B-lane batch up to a multiple of the shard
    count by repeating the last lane (None when no padding is needed).
    Padding lanes re-solve a real cell and are dropped from the output."""
    rem = n_lanes % n_shards
    if rem == 0:
        return None
    pad = n_shards - rem
    return np.concatenate([np.arange(n_lanes), np.full(pad, n_lanes - 1)])


def _run_shards(mesh, sweep_shard):
    """``sweep_shard(k)`` for every shard k, in lane order per device;
    one thread per distinct device when there are several."""
    by_dev = {}
    for k, dev in enumerate(mesh):
        by_dev.setdefault(dev, []).append(k)

    def run_device(dev, ks):
        ctx = (torch.cuda.device(dev) if dev.type == "cuda"
               else contextlib.nullcontext())
        with ctx, torch.no_grad():
            return {k: sweep_shard(k) for k in ks}

    if len(by_dev) == 1:
        ((dev, ks),) = by_dev.items()
        out = run_device(dev, ks)
    else:
        out = {}
        with ThreadPoolExecutor(max_workers=len(by_dev)) as pool:
            futures = [pool.submit(run_device, dev, ks)
                       for dev, ks in by_dev.items()]
            for f in futures:
                out.update(f.result())
    return [out[k] for k in range(len(mesh))]


def sharded_sweep(mesh, scn_b, q_b, x_init, pred_b, lr, tol, max_steps, w,
                  prof, *, adaptive=False, step_impl="fused", check_every=1,
                  prof_batched=False) -> ligd.GDResult:
    """``ligd._sweep_core`` over ``mesh``'s shards.  Pads the lanes to a
    multiple of the shard count (``pad_lanes``), gives shard k the k-th
    contiguous block (copied onto its device), gathers the shards' results
    in lane order on the batch's device and drops the padding."""
    n_lanes = int(q_b.shape[0])
    n_shards = len(mesh)
    pred_b = np.asarray(pred_b)
    idx = pad_lanes(n_lanes, n_shards)
    if idx is not None:
        take = lambda x: network.take_cells(x, idx)
        scn_b, q_b, x_init = take(scn_b), take(q_b), take(x_init)
        pred_b = pred_b[idx]
        if prof_batched:
            prof = take(prof)
    per = pred_b.shape[0] // n_shards
    out_dev = q_b.device

    def sweep_shard(k):
        dev = mesh[k]
        lanes = slice(k * per, (k + 1) * per)
        part = lambda x: network.tree_map(
            lambda t: t[lanes].to(dev, copy=True), x)
        prof_k = part(prof) if prof_batched else prof.to(dev)
        return ligd._sweep_core(part(scn_b), part(q_b), part(x_init),
                                pred_b[lanes], lr, tol, max_steps, w, prof_k,
                                adaptive=adaptive, step_impl=step_impl,
                                check_every=check_every)

    shards = _run_shards(mesh, sweep_shard)
    return network.tree_map(
        lambda *xs: torch.cat([x.to(out_dev) for x in xs])[:n_lanes],
        *shards)


def solve_batch_sharded(scns, prof, q, w=None, *, mesh=None, spec=None,
                        **kw):
    """``ligd.solve_batch`` on a cells mesh (every visible CUDA device
    when ``mesh`` is None), with ``spec`` (default ``SolverSpec()``)
    re-pinned to ``backend='sharded'`` on that mesh."""
    mesh = cells_mesh() if mesh is None else mesh
    spec = ligd.SolverSpec() if spec is None else spec
    spec = spec.replace(backend="sharded", mesh=mesh)
    w = ligd.Weights() if w is None else w
    return ligd.solve_batch(scns, prof, q, w, spec=spec, **kw)
