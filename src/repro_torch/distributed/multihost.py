"""Multi-process solver: ``SolverSpec(backend='multihost')``.

``solver_mesh`` shards the cells axis over ONE process's devices; this
module runs that sweep in every process of a ``torch.distributed`` group,
each process on its own lanes.  The sweep has no cross-cell reduction, so
it needs no collective: each process pads its own lanes to a multiple of
its shard count (``solver_mesh.pad_lanes``), sweeps them on its own
devices and keeps its own results.  ``sweep_collective_cost`` audits that
claim at run time: it counts every c10d collective the sweep issues.

SPMD contract: every process calls ``ligd.solve_batch(backend=
'multihost')`` with its OWN lanes — the same local lane count, shard
count and statics on every process — and process p's lanes are the
contiguous global slice ``lane_slice(n_local)``.  Single process, the
global mesh IS ``solver_mesh.cells_mesh()`` and ``multihost_sweep``
delegates to ``sharded_sweep``, so the backend is bitwise 'sharded'.
With several processes a process's part of the global mesh is still its
local cells mesh: no process can address another's devices, and none
needs to.  The spec travels whole, ``compiled_sweep`` with the rest (a
cell-sharded spec is always the compiled sweep), and each process
captures its own graphs (``core/sweep_graph``).

The process group is gloo, on the card too.  The only collectives are
``churn_fence``'s tag exchange (coordinated cell join/leave,
``serving/cluster.py``), and it carries host data.  NCCL would need a
card of its own for each rank.  Bring-up (``initialize_from_env``) reads::

    REPRO_MH_COORDINATOR=localhost:<port>   # process 0 hosts the store
    REPRO_MH_NUM_PROCESSES=N
    REPRO_MH_PROCESS_ID=<0..N-1>

and passes ``init_process_group`` an explicit timeout, so a missing peer
fails the run instead of hanging it.
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import ligd
from repro_torch.distributed import solver_mesh

ENV_COORDINATOR = "REPRO_MH_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_MH_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_MH_PROCESS_ID"

# how long a collective (or the group's rendezvous) waits for a peer
PG_TIMEOUT_S = 60

# bytes of the element types the profiler names in a collective's record
_ELEM_BYTES = {"float": 4, "double": 8, "c10::Half": 2, "c10::BFloat16": 2,
               "long int": 8, "int": 4, "short int": 2, "signed char": 1,
               "unsigned char": 1, "bool": 1}


class HostInfo(NamedTuple):
    process_id: int
    n_processes: int
    n_local_devices: int


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_info() -> HostInfo:
    n_local = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return HostInfo(process_index(), process_count(), n_local)


def initialize_from_env(backend: str = "gloo") -> HostInfo:
    """Join (or host) the process group the ``REPRO_MH_*`` variables
    describe; a no-op single-process ``HostInfo`` when the coordinator
    variable is unset.  Idempotent.  ``backend`` as
    ``init_process_group`` takes it (the sharded launcher passes
    ``"cpu:gloo,cuda:nccl"`` when every rank has a card of its own)."""
    coord = os.environ.get(ENV_COORDINATOR)
    if coord is None or dist.is_initialized():
        return host_info()
    n_procs = int(os.environ[ENV_NUM_PROCESSES])
    pid = int(os.environ[ENV_PROCESS_ID])
    if not 0 <= pid < n_procs:
        raise ValueError(f"{ENV_PROCESS_ID}={pid} outside "
                         f"[0, {ENV_NUM_PROCESSES}={n_procs})")
    if n_procs > 1:
        dist.init_process_group(
            backend, init_method=f"tcp://{coord}", world_size=n_procs,
            rank=pid, timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    return host_info()


def lane_slice(n_local: int):
    """Global lane interval ``[lo, hi)`` of this process's ``n_local``
    cells, given that every process holds ``n_local`` lanes."""
    pid = process_index()
    return pid * n_local, (pid + 1) * n_local


def global_cells_mesh(n_devices: int = None, device=None) -> tuple:
    """This process's part of the global ``cells`` mesh: its local
    ``solver_mesh.cells_mesh(n_devices, device)``, the identical memoised
    object, with one process or several (module docs)."""
    return solver_mesh.cells_mesh(n_devices, device)


def churn_fence(tag: str) -> None:
    """Named cross-process barrier for coordinated moments (cell join and
    leave).  Every process contributes its tag and none leaves before all
    have: the all-gather is the barrier.  Raises on every process when the
    tags differ, so a divergent churn sequence fails here, within the
    group's timeout, instead of desynchronising a later round.  No-op
    with one process."""
    if process_count() == 1:
        return
    data = torch.tensor(list(tag.encode()), dtype=torch.uint8)
    n = torch.tensor([data.numel()], dtype=torch.int64)
    sizes = [torch.zeros_like(n) for _ in range(process_count())]
    dist.all_gather(sizes, n)
    width = int(max(s.item() for s in sizes))
    padded = torch.zeros(width, dtype=torch.uint8)
    padded[:data.numel()] = data
    tags = [torch.zeros_like(padded) for _ in sizes]
    dist.all_gather(tags, padded)
    got = [bytes(t[:int(s.item())].tolist()).decode()
           for t, s in zip(tags, sizes)]
    if len(set(got)) != 1:
        raise RuntimeError(f"churn fence: processes disagree on the tag, "
                           f"{got} (process {process_index()} at {tag!r})")


def multihost_sweep(mesh, scn_b, q_b, x_init, pred_b, lr, tol, max_steps, w,
                    prof, *, adaptive=False, step_impl="fused",
                    check_every=1, prof_batched=False) -> ligd.GDResult:
    """``solver_mesh.sharded_sweep`` of THIS process's lanes over its part
    of the global mesh: local lanes in, local lanes out, padding per
    process.  The shards' arithmetic is the sharded backend's, so a lane
    equals the lane of a single-process sharded solve whose shards have
    the same shape."""
    return solver_mesh.sharded_sweep(
        mesh, scn_b, q_b, x_init, pred_b, lr, tol, max_steps, w, prof,
        adaptive=adaptive, step_impl=step_impl, check_every=check_every,
        prof_batched=prof_batched)


class CollectiveCost(NamedTuple):
    coll_bytes: Dict[str, float]   # record name -> bytes it carried
    total_coll_bytes: float


def collective_cost(fn) -> CollectiveCost:
    """Run ``fn()`` under ``torch.profiler`` with shapes recorded and
    count the bytes of every c10d collective record (names beginning
    ``gloo:`` or ``nccl:``); a barrier counts with 0 bytes."""
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
    coll: Dict[str, float] = {}
    # the raw records: building ``prof.events()``' tree takes minutes for
    # a sweep's hundreds of thousands of operator records
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if not name.startswith(("gloo:", "nccl:")):
            continue
        n_bytes = 0.0
        for shape, dtype in zip(e.shapes(), e.dtypes()):
            if not shape:
                continue
            if dtype not in _ELEM_BYTES:
                raise ValueError(f"{name}: unknown element type {dtype!r}")
            n_bytes += float(torch.Size(shape).numel()) * _ELEM_BYTES[dtype]
        coll[name] = coll.get(name, 0.0) + n_bytes
    return CollectiveCost(coll, float(sum(coll.values())))


def sweep_collective_cost(mesh, scn_b, q_b, x_init, pred_b, lr, tol,
                          max_steps, w, prof, **kw) -> CollectiveCost:
    """The cross-process byte audit of ``multihost_sweep`` on these
    inputs: the collectives the runtime records while it runs.  The sweep
    makes none, so this must be 0 bytes and no record."""
    return collective_cost(lambda: multihost_sweep(
        mesh, scn_b, q_b, x_init, pred_b, lr, tol, max_steps, w, prof,
        **kw))
