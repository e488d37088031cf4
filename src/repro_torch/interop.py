"""Carry the JAX package's state into the port.

The system has no model weights: the state two implementations must share
is the channel ``Scenario`` (its seven array fields plus the 15 ``CellEnv``
leaves), the ``SplitProfile`` tables, an ``Allocation`` and the
``Weights``.  Each function here takes that state as numpy arrays and plain
Python values — what ``np.asarray`` gives on the JAX side — and returns the
port's object on ``device`` (default: the card).  Nothing here imports JAX.

A batched value (a leading cell axis B on every array, (B,) env leaves)
converts the same way as a single cell.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch

from repro_torch.core.era import Allocation, Weights
from repro_torch.core.network import (_SCN_FIELDS, CellEnv, NetworkConfig,
                                      Scenario)
from repro_torch.core.profiles import SplitProfile
from repro_torch.launch.platform import resolve_device

_INDEX_FIELDS = ("assoc", "up_order", "up_group_end", "dn_order",
                 "dn_group_end")


def _f32(x, dev):
    return torch.as_tensor(np.array(x, np.float32), device=dev)


def scenario_from_numpy(cfg_fields: Mapping, arrays: Mapping,
                        device=None) -> Scenario:
    """A ``Scenario`` from its config fields and arrays.

    ``cfg_fields``: the ``NetworkConfig`` fields as a mapping.  ``arrays``:
    ``assoc``, ``h_up``, ``h_dn``, ``up_order``, ``up_group_end``,
    ``dn_order``, ``dn_group_end``, and optionally ``env`` (the 15
    ``CellEnv`` values in field order, or a mapping by name; default: the
    config's own)."""
    dev = resolve_device(device)
    cfg = NetworkConfig(**dict(cfg_fields))
    kids = {}
    for f in _SCN_FIELDS:
        x = np.asarray(arrays[f])
        kids[f] = (torch.as_tensor(x.astype(np.int64), device=dev)
                   if f in _INDEX_FIELDS else _f32(x, dev))
    env = arrays.get("env")
    if env is not None:
        if isinstance(env, Mapping):
            env = [env[f] for f in CellEnv._fields]
        env = CellEnv(*(_f32(v, dev) for v in env))
    return Scenario(cfg, env=env, **kids)


def profile_from_numpy(name: str, layer_flops, out_bits,
                       input_bits: Union[float, np.ndarray],
                       result_bits: Union[float, np.ndarray],
                       device=None) -> SplitProfile:
    """A ``SplitProfile`` from its four tables.  Endpoint sizes stay Python
    floats for a single profile and become (B,) tensors for a stacked
    one, as ``profiles.stack_profiles`` makes them."""
    dev = resolve_device(device)

    def endpoint(v):
        v = np.asarray(v, np.float32)
        return float(v) if v.ndim == 0 else _f32(v, dev)

    return SplitProfile(name=name, layer_flops=_f32(layer_flops, dev),
                        out_bits=_f32(out_bits, dev),
                        input_bits=endpoint(input_bits),
                        result_bits=endpoint(result_bits))


def allocation_from_numpy(arrays: Union[Sequence, Mapping],
                          device=None) -> Allocation:
    """An ``Allocation`` from its five leaves, in field order or by name."""
    dev = resolve_device(device)
    if isinstance(arrays, Mapping):
        arrays = [arrays[f] for f in Allocation._fields]
    return Allocation(*(_f32(x, dev) for x in arrays))


def weights_from_fields(fields: Mapping) -> Weights:
    """``Weights`` from its fields (``dataclasses.asdict`` on the JAX
    side)."""
    return Weights(**{k: float(v) for k, v in dict(fields).items()})
