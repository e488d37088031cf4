"""One rank's cost of a torch program, counted as it dispatches (the port
of the JAX package's ``launch/hlo_cost.py``; the name is kept so the two
are easy to pair).

There is no HLO in the port: a program runs eagerly, so every operator it
issues passes the dispatcher, loops and all, and needs no trip-count
recovery.  ``CostMode`` is a ``TorchDispatchMode`` that sees each aten
operator on the tensors a rank holds: on a DTensor program it steps aside
at the DTensor level (returns ``NotImplemented``), so DTensor lowers the
op to its local operators and collectives, which the mode then counts —
one rank's share, never the global op (``FlopCounterMode`` around DTensor
code counts the global one).  The shape-only reruns DTensor's sharding
propagation makes are not counted.  ``meta`` or fake tensors are enough:
nothing here reads a value.

Counted:
  flops            2·prod(out)·prod(contracted dims) for products and
                   convolutions (torch's own flop formulas,
                   ``torch.utils.flop_counter``)
  coll_bytes       output bytes of all-gather / all-reduce /
                   reduce-scatter / all-to-all / collective-permute (the
                   ``_c10d_functional`` and DTensor collective ops)
  write_bytes      output bytes of the aten counterparts of JAX's
                   ``MATERIALIZE`` set (products, reductions, scatters,
                   gathers, copies, concatenation, padding, sorts, random
                   fills, collectives): an HBM-traffic proxy
  write_bytes_raw  output bytes of every operator that is not a view
                   (an upper bound)

``CostMode(track_memory=True)`` also keeps the peak of live bytes the
program's outputs hold (``peak_bytes``): each non-view output's storage
is counted from its creation to its release (a weak reference's
callback), above whatever was live when the mode was entered.

Not carried: ``analyze(hlo_text)`` and ``parse_computations``, which read
XLA's compiled text; the port has none.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

# collective operator name -> JAX's collective kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
    # c10d's own ops (launch.mesh.gloo_all_gather's transport)
    "_allgather_base_": "all-gather",
    "allreduce_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
}
COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                         "_dtensor", "c10d")

# the aten counterparts of JAX's MATERIALIZE set: ops whose outputs an
# accelerator pipeline writes to HBM (elementwise chains fuse away)
MATERIALIZE = {
    # dot / convolution
    "mm", "addmm", "bmm", "baddbmm", "convolution", "convolution_backward",
    "_scaled_dot_product_efficient_attention",
    "_scaled_dot_product_flash_attention",
    # reduce / reduce-window
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "cumsum", "var_mean", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "norm", "linalg_vector_norm", "any", "all",
    # scatter / gather / dynamic slices
    "scatter", "scatter_add", "scatter_reduce", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "gather", "index", "index_select",
    "embedding", "embedding_dense_backward", "slice_scatter",
    "select_scatter", "masked_scatter", "nonzero",
    # copy / transpose / concatenate / pad / sort / rng
    "copy_", "clone", "_to_copy", "contiguous", "cat", "stack",
    "constant_pad_nd", "sort", "topk", "normal_", "uniform_", "bernoulli_",
}


@dataclass
class Cost:
    flops: float = 0.0
    write_bytes: float = 0.0        # MATERIALIZE set (fused approximation)
    write_bytes_raw: float = 0.0    # every non-view output — upper bound
    coll_bytes: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Cost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.write_bytes += other.write_bytes * mult
        self.write_bytes_raw += other.write_bytes_raw * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult

    @property
    def total_coll_bytes(self):
        return sum(self.coll_bytes.values())


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _fake_mode():
    """The fake-tensor mode active in this thread's dispatch, or None."""
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)


class CostMode(TorchDispatchMode):
    """Counts one rank's ``Cost`` of everything dispatched inside it (the
    module docstring); ``peak_bytes`` with ``track_memory=True``."""

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.cost = Cost()
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = set()
        self._outer_fake = None

    def __enter__(self):
        # DTensor's sharding propagation reruns an op under a fake-tensor
        # mode of its own to learn the output's shape; a program that is
        # itself run under a fake mode keeps that one
        self._outer_fake = _fake_mode()
        return super().__enter__()

    def _release(self, key, nbytes):
        self._seen.discard(key)
        self.live_bytes -= nbytes

    def _track(self, t):
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        self._seen.add(key)
        n = st.nbytes()
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # count the local ops DTensor issues
        out = func(*args, **kwargs)
        if _fake_mode() not in (None, self._outer_fake):
            return out              # a shape-only propagation run
        outs = _tensors(out)
        ns = func.namespace
        name = func._overloadpacket.__name__
        out_bytes = float(sum(_nbytes(t) for t in outs))
        if ns in COLLECTIVE_NAMESPACES and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            c = self.cost.coll_bytes
            c[kind] = c.get(kind, 0.0) + out_bytes
            self.cost.write_bytes += out_bytes
        else:
            packet = func._overloadpacket
            if packet in flop_registry:
                self.cost.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            if name in MATERIALIZE:
                self.cost.write_bytes += out_bytes
        if not func.is_view:
            self.cost.write_bytes_raw += out_bytes
            if self.track_memory:
                for t in outs:
                    self._track(t)
        return out


def cost_of_callable(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under ``CostMode`` and return one
    rank's ``Cost`` of it."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return mode.cost
