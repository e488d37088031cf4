"""Carry the JAX package's state into the port.

The state two implementations must share is the channel ``Scenario`` (its
seven array fields plus the 15 ``CellEnv`` leaves), the ``SplitProfile``
tables, an ``Allocation``, the ``Weights``, the served model's weights,
and a train state (weights plus the AdamW step and moments).
Each function here takes that state as numpy arrays and plain Python
values — what ``np.asarray`` gives on the JAX side — and returns the port's
object on ``device`` (default: the card).  Nothing here imports JAX.

A batched value (a leading cell axis B on every array, (B,) env leaves)
converts the same way as a single cell.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.era import Allocation, Weights
from repro_torch.core.network import (_SCN_FIELDS, CellEnv, NetworkConfig,
                                      Scenario)
from repro_torch.core.profiles import SplitProfile
from repro_torch.launch.platform import resolve_device
from repro_torch.models.common import Params
from repro_torch.training.optim import OptState

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


def _tensor(x, dev):
    """A numpy leaf as a tensor; bfloat16 leaves (ml_dtypes) keep their
    bits."""
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.as_tensor(x, device=dev)


def _params(tree: Mapping, dev) -> Params:
    return Params(**{k: _params(v, dev) if isinstance(v, Mapping)
                     else _tensor(v, dev) for k, v in tree.items()})


def model_from_numpy(cfg, tree: Mapping, device=None) -> Params:
    """The port's model (``models.transformer``'s layout) from the JAX
    params pytree with numpy leaves: ``embed``, ``units`` (one subtree per
    pattern position, leaves stacked on axis 0 over the scanned units),
    ``tail``, ``final_norm`` and, untied, ``lm_head``.  Layer ``i`` is unit
    ``i // len(pattern)`` at position ``i % len(pattern)``, or a tail
    block past the units."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        u, pos = divmod(i, cfg.pattern_len)
        if u < cfg.n_units:
            sub = _index(tree["units"][pos], u)
        else:
            sub = tree["tail"][i - cfg.n_units * cfg.pattern_len]
        layers.append(_params(sub, dev))
    p = {"embed": _tensor(tree["embed"], dev), "layers": nn.ModuleList(layers),
         "final_norm": _tensor(tree["final_norm"], dev)}
    if "lm_head" in tree:
        p["lm_head"] = _tensor(tree["lm_head"], dev)
    return Params(**p)


def _index(tree: Mapping, u: int) -> dict:
    """Unit ``u`` of a subtree whose leaves are stacked on axis 0."""
    return {k: _index(v, u) if isinstance(v, Mapping) else np.asarray(v)[u]
            for k, v in tree.items()}


def _named(cfg, tree: Mapping, dev) -> dict:
    """{parameter name: tensor} of a params-shaped pytree."""
    return {k: p.data for k, p in
            model_from_numpy(cfg, tree, dev).named_parameters()}


def train_state_from_numpy(cfg, state_tree: Mapping, device=None) -> dict:
    """The port's train state ``{"params", "opt"}`` from the JAX package's
    (``launch.steps.init_train_state``'s layout, numpy leaves):
    ``params`` as ``model_from_numpy`` takes it, made trainable, and
    ``opt`` an ``OptState`` (``step``, ``m``, ``v``, in field order) whose
    moments mirror ``params``."""
    dev = resolve_device(device)
    model = model_from_numpy(cfg, state_tree["params"], dev)
    model.requires_grad_(True)
    step, m, v = state_tree["opt"]
    step = torch.as_tensor(np.array(step, np.int32), device=dev)
    return {"params": model,
            "opt": OptState(step, _named(cfg, m, dev), _named(cfg, v, dev))}


def _numpy(x):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes  # only the JAX side's numpy has a bfloat16
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def params_to_numpy(cfg, named: Mapping) -> dict:
    """The JAX params pytree, numpy leaves, of {parameter name: tensor}
    (``named_parameters()``, or moments and gradients keyed the same
    way): ``units`` (one subtree per pattern position, leaves stacked
    over the units), ``tail`` and the top-level leaves; the inverse of
    ``model_from_numpy``."""
    per_layer = [dict() for _ in range(cfg.n_layers)]
    tree = {}
    for name, x in named.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            per_layer[int(i)][rest] = _numpy(x)
        else:
            tree[name] = _numpy(x)

    def nest(flat):
        out = {}
        for key, x in flat.items():
            *path, leaf = key.split(".")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = x
        return out

    n_unit = cfg.n_units * cfg.pattern_len
    if cfg.n_units > 0:
        tree["units"] = tuple(
            nest({k: np.stack([per_layer[u * cfg.pattern_len + pos][k]
                               for u in range(cfg.n_units)])
                  for k in per_layer[pos]})
            for pos in range(cfg.pattern_len))
    tree["tail"] = tuple(nest(per_layer[i])
                         for i in range(n_unit, cfg.n_layers))
    return tree


def train_state_to_numpy(cfg, state: Mapping) -> dict:
    """The inverse of ``train_state_from_numpy``: ``{"params": tree,
    "opt": (step, m_tree, v_tree)}`` in the JAX package's layout, numpy
    leaves (``OptState(*opt)`` on the JAX side)."""
    opt = state["opt"]
    params = dict(state["params"].named_parameters())
    return {"params": params_to_numpy(cfg, params),
            "opt": (_numpy(opt.step), params_to_numpy(cfg, opt.m),
                    params_to_numpy(cfg, opt.v))}
