"""Training loop: data pipeline -> train step -> metrics/checkpoints.

Used by ``launch/train.py`` and ``chip_smoke.py``.  ``data_ms`` and
``step_ms`` in each history entry are host milliseconds of the batch
draw and of the step, each ended by a device sync.

With ``rules`` (a ``distributed.sharding.ShardingRules`` on a mesh of
real ranks) the loop trains sharded: every rank builds the same state
and batches from the seed, the state is placed by the rules after any
restore, each batch by ``batch_spec``, and the step runs with the rules'
``constrain``.  Checkpoints hold the full tensors either way (rank 0
writes them), so a run resumes across layouts; rank 0 alone prints.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.data import pipeline
from repro_torch.launch.platform import resolve_device
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.training import checkpoint, optim


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train(cfg, *, steps=50, seq_len=128, global_batch=8,
          opt_cfg: Optional[optim.AdamWConfig] = None,
          ckpt_dir: Optional[str] = None, ckpt_every=0, log_every=10,
          impl="naive", microbatches=1, seed=0, resume=False, device=None,
          rules=None):
    """Returns (final_state, history); ``device`` defaults to the card."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import full_tensor
    dev = resolve_device(device)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    opt_cfg = opt_cfg or optim.AdamWConfig(
        lr=1e-3, warmup_steps=max(steps // 10, 1), total_steps=steps)
    data = pipeline.for_config(cfg, seq_len, global_batch, seed=seed,
                               device=dev)
    last = checkpoint.latest_step_dir(ckpt_dir) if resume and ckpt_dir \
        else None
    # a fresh sharded state is placed as it is made; a restored one whole
    # first, as its files hold it
    state = init_train_state(cfg, torch.Generator().manual_seed(seed), dev,
                             rules=rules if last is None else None)
    start = 0
    if last is not None:
        state, start = checkpoint.restore(last, state)
        if rules is not None:
            rules.distribute_state(state)
    place = lambda batch: batch
    if rules is not None:
        place = lambda batch: {k: rules.place(x, rules.batch_spec(x.shape))
                               for k, x in batch.items()}

    step_fn = make_train_step(
        cfg, opt_cfg, impl=impl, microbatches=microbatches,
        **({} if rules is None else {"constrain": rules.constrain}))
    on_mesh = implicit_replication if rules is not None \
        else contextlib.nullcontext
    history = []
    t0 = time.time()
    for i in range(start, steps):
        _sync(dev)
        t1 = time.perf_counter()
        batch = place(data.batch(0, i))
        _sync(dev)
        t2 = time.perf_counter()
        with on_mesh():
            state, metrics = step_fn(state, batch)
        _sync(dev)
        t3 = time.perf_counter()
        if log_every and (i % log_every == 0 or i == steps - 1):
            m = {k: float(full_tensor(v)) for k, v in metrics.items()}
            m["step"] = i
            m["wall_s"] = round(time.time() - t0, 2)
            m["data_ms"] = (t2 - t1) * 1e3
            m["step_ms"] = (t3 - t2) * 1e3
            history.append(m)
            if lead:
                print(f"step {i:5d} loss {m['loss']:.4f} "
                      f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}",
                      flush=True)
        if ckpt_dir and ckpt_every and (i + 1) % ckpt_every == 0:
            checkpoint.save(Path(ckpt_dir) / f"step_{i+1}", state, step=i + 1)
    if ckpt_dir:
        checkpoint.save(Path(ckpt_dir) / f"step_{steps}", state, step=steps)
    return state, history
