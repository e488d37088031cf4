"""Production mesh (the port of the JAX package's ``launch/mesh.py``).

Functions, not module-level meshes: importing this module starts no
process group.  A ``DeviceMesh`` is built over whatever default group is
up — the dry run starts a ``fake`` group of 256 or 512 ranks inside its
entry point, as JAX's dry run forces its host device count before
importing jax; the sharded launcher a gloo group of ``data x model``
ranks.  ``AbstractMesh`` describes a mesh by its axis names and sizes
alone, which is all ``distributed.sharding.ShardingRules`` reads to
decide its specs.
"""
from __future__ import annotations

import contextlib
import inspect
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.distributed as dist

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh(NamedTuple):
    """A mesh's axis sizes and names, with no ranks behind it."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    return AbstractMesh(*(MULTI_POD if multi_pod else SINGLE_POD))


def _device_mesh(abstract: AbstractMesh, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n != abstract.size:
        raise RuntimeError(
            f"a {abstract.axis_sizes} mesh needs a process group of "
            f"{abstract.size} ranks, and {n} are up")
    return init_device_mesh(device_type, abstract.axis_sizes,
                            mesh_dim_names=abstract.axis_names)


def make_production_mesh(*, multi_pod: bool = False):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), over the default process group (which must have as
    many ranks; the dry run's fake group of host ranks)."""
    return _device_mesh(production_mesh_shape(multi_pod=multi_pod), "cpu")


def make_host_mesh(data: int = 1, model: int = 1, device_type="cpu"):
    """A ("data", "model") mesh over the real group's ranks (tests,
    ``launch/train.py``): ``data`` is clamped to the group's size and
    ``model`` to what is left, as JAX's clamps to its local devices."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return _device_mesh(AbstractMesh((data, model), ("data", "model")),
                        device_type)


def checked_private(owner, name, params):
    """``owner.<name>``, a private torch function that the port replaces
    inside a block, after checking that it exists and that its
    parameters lead with ``params``; raises naming the torch version
    where either is not so, never patches blindly."""
    fn = getattr(owner, name, None)
    got = None if fn is None else \
        tuple(inspect.signature(fn).parameters)[:len(params)]
    if got != tuple(params):
        raise RuntimeError(
            f"torch {torch.__version__}: {owner.__name__}.{name} "
            f"{'is missing' if got is None else f'takes {got}'}; the port "
            f"replaces it expecting the parameters {tuple(params)}")
    return fn


def ranks_share_a_card(n_ranks: int) -> bool:
    """Whether ``n_ranks`` CUDA ranks on this host must share cards (more
    ranks than cards).  Such a group runs over gloo, which NCCL refuses;
    with a card a rank the group is NCCL's."""
    return n_ranks > torch.cuda.device_count()


# the one-card mesh's all-gather transport (``gloo_all_gather``)
GLOO_ALL_GATHER = ("gloo c10d all_gather_into_tensor in place of the "
                   "functional all-gather")


@contextlib.contextmanager
def gloo_all_gather():
    """The transport of a mesh whose ranks share a card over gloo
    (``ranks_share_a_card``): on CUDA tensors gloo's functional
    all-gather (the op DTensor issues) crashes the process, while the
    same group's c10d ``all_gather_into_tensor`` works (gloo stages CUDA
    tensors through the host in both).  Inside the block DTensor's
    all-gathers take the c10d op; every other collective is unchanged.
    Named ``GLOO_ALL_GATHER`` wherever a run uses it."""
    from unittest import mock

    import torch.distributed._functional_collectives as funcol
    checked_private(funcol, "all_gather_tensor",
                    ("self", "gather_dim", "group", "tag"))

    def all_gather_tensor(x, gather_dim, group, tag=""):
        mesh_dim = None
        if isinstance(group, tuple):
            group, mesh_dim = group
        pg = group.get_group(mesh_dim or 0) if hasattr(group, "get_group") \
            else group
        n = dist.get_world_size(pg)
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pg)
        if gather_dim != 0:
            out = torch.cat(out.chunk(n), dim=gather_dim)
        return out

    with mock.patch.object(funcol, "all_gather_tensor", all_gather_tensor):
        yield


# H100 SXM roofline constants (one card), from NVIDIA's data sheet at the
# full 700 W power limit, as the hopper-kernels guide tabulates them
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s of HBM3
ICI_BW = 450e9                  # bytes/s each way of NVLink to the other cards
