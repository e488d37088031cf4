"""Training launcher (the port of the JAX package's ``launch/train.py``,
with the same flags plus ``--device``: the card by default, and it
raises without one; ``--device cpu`` trains on the host).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --tiny --steps 20 --seq-len 128 --batch 8 --device cpu

The models run their plain paths (``impl="naive"``, as the JAX loop
runs them): the kernels refuse gradients.  A mesh (``--data-axis`` x
``--model-axis`` above 1) and ``--dry-run`` are not ported yet
(ROADMAP.md): they raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: the CUDA "
                         "card; raises without one)")
    args = ap.parse_args(argv)

    if args.dry_run:
        raise NotImplementedError(
            "--dry-run is not ported: it lowers against the JAX mesh "
            "(ROADMAP.md, queue 1: launch/dryrun.py)")
    if args.data_axis * args.model_axis > 1:
        raise NotImplementedError(
            "a data x model mesh is not ported: the sharding rules wait "
            "for distributed/sharding.py (ROADMAP.md, queue 1)")

    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.launch.platform import resolve_device
    from repro_torch.training import optim
    from repro_torch.training.loop import train

    dev = resolve_device(args.device)
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    opt_cfg = optim.AdamWConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    _, history = train(
        cfg, steps=args.steps, seq_len=args.seq_len,
        global_batch=args.batch, opt_cfg=opt_cfg,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, device=dev)
    print(f"final loss: {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
