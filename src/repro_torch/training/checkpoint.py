"""Train-state checkpoints in the JAX package's file format:
``arrays.npz`` (one ``leaf_<i>`` array per leaf) plus ``manifest.json``
(``step``, ``n_leaves``, ``dtypes``, ``shapes``, ``extra``, and the
leaves' ``names``).

The leaves are the port's state in a fixed order (``leaves``): the
parameters, the optimiser step, then ``m`` and ``v``, each in the
parameters' order.  bfloat16 leaves are stored as their int16 bits and
read back bit for bit, as ``interop`` carries them.

A sharded state (DTensor leaves) is saved whole: every rank gathers each
leaf (``save`` is collective then) and rank 0 writes, so the files are
those of an unsharded run and restore into either layout.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def leaves(state):
    """[(name, tensor)] of a train state ``{"params", "opt"}``."""
    opt = state["opt"]
    out = list(state["params"].named_parameters())
    out.append(("opt.step", opt.step))
    out += [(f"opt.m.{k}", x) for k, x in opt.m.items()]
    out += [(f"opt.v.{k}", x) for k, x in opt.v.items()]
    return out


def _to_numpy(x):
    if hasattr(x, "full_tensor"):          # a DTensor: gathered whole
        x = x.full_tensor()
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy()
    return x.numpy()


def save(path, state, step: int = 0, extra: dict | None = None):
    path = Path(path)
    items = leaves(state)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, (_, x) in enumerate(items)}
    if dist.is_initialized() and dist.get_rank() != 0:
        return
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(items),
        "names": [n for n, _ in items],
        "dtypes": [str(x.dtype).removeprefix("torch.") for _, x in items],
        "shapes": [list(x.shape) for _, x in items],
        "extra": extra or {},
    }
    (path / "manifest.json").write_text(json.dumps(manifest, indent=2))


@torch.no_grad()
def restore(path, state):
    """Read a checkpoint into ``state``'s tensors in place (each cast to
    its dtype); the leaf count and every shape must match.  Returns
    (state, step)."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    items = leaves(state)
    if len(items) != manifest["n_leaves"]:
        raise ValueError(
            f"leaf count mismatch: ckpt {manifest['n_leaves']} vs "
            f"model {len(items)}")
    with np.load(path / "arrays.npz") as data:
        for i, (name, ref) in enumerate(items):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i} ({name}) shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            x = torch.from_numpy(arr)
            if manifest["dtypes"][i] == "bfloat16":
                x = x.view(torch.bfloat16)
            ref.copy_(x)
    return state, manifest["step"]


def latest_step_dir(root):
    root = Path(root)
    if not root.exists():
        return None
    steps = sorted(int(p.name.split("_")[-1]) for p in root.glob("step_*"))
    return root / f"step_{steps[-1]}" if steps else None
