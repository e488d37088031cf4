"""Training launcher (the port of the JAX package's ``launch/train.py``,
with the same flags plus ``--device``: the card by default, and it
raises without one; ``--device cpu`` trains on the host).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --tiny --steps 20 --seq-len 128 --batch 8 --device cpu

The models run their plain paths (``impl="naive"``, as the JAX loop
runs them): the kernels refuse gradients.

``--data-axis D --model-axis M`` with D·M > 1 trains sharded on a (D, M)
("data", "model") mesh of D·M ranks in one gloo group, as JAX's launcher
lays its local devices out: the command starts the ranks itself (each a
``python -m repro_torch.launch.train`` with the same flags and
``distributed.multihost``'s ``REPRO_MH_*`` variables; a process started
with them set is one rank), and rank 0 prints the losses.  On CUDA rank r
takes card ``r mod cards`` (unless ``--device`` names one).  With a card
a rank the group is NCCL's (gloo for host tensors); where ranks share
cards it is gloo's, since NCCL refuses two ranks on one card, with
``launch.mesh.gloo_all_gather`` as the mesh's all-gather transport.

``--dry-run`` lays the full configuration's ``train_4k`` step out on the
production mesh instead (``launch/dryrun.py`` for one pair).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence


def _spawn_ranks(argv: Sequence[str], n: int) -> int:
    """Run this command as ``n`` ranks of one gloo group; returns the
    first non-zero exit code, or 0.  Rank 0 writes to this process's
    stdout and stderr; a failing rank's stderr is printed, and the other
    ranks are stopped then."""
    from repro_torch.distributed import multihost
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    src = str(Path(__file__).resolve().parents[2])
    path = os.pathsep.join(p for p in (src, os.environ.get("PYTHONPATH"))
                           if p)
    procs = []
    try:
        for rank in range(n):
            env = dict(os.environ, PYTHONPATH=path, **{
                multihost.ENV_COORDINATOR: f"localhost:{port}",
                multihost.ENV_NUM_PROCESSES: str(n),
                multihost.ENV_PROCESS_ID: str(rank)})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv],
                env=env,
                stdout=None if rank == 0 else subprocess.DEVNULL,
                stderr=None if rank == 0 else subprocess.PIPE, text=True))
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c]
            if failed or all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, code in failed:
        err = procs[rank].stderr.read() if procs[rank].stderr else ""
        print(f"rank {rank} exited {code}\n{err[-4000:]}", file=sys.stderr)
    return failed[0][1] if failed else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
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
        from repro_torch.launch import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", "train_4k",
                            "--force"])

    import torch.distributed as dist

    from repro_torch.configs import get_config, get_tiny_config
    from repro_torch.distributed import multihost
    from repro_torch.launch.platform import resolve_device
    from repro_torch.training import optim
    from repro_torch.training.loop import train

    dev = resolve_device(args.device)
    cfg = get_tiny_config(args.arch) if args.tiny else get_config(args.arch)
    n_ranks = args.data_axis * args.model_axis
    rules, transport, lead = None, contextlib.nullcontext(), True
    if n_ranks > 1:
        if os.environ.get(multihost.ENV_COORDINATOR) is None:
            return _spawn_ranks(argv, n_ranks)
        import torch

        from repro_torch.distributed.sharding import ShardingRules
        from repro_torch.launch import mesh
        cuda = dev.type == "cuda"
        # one card a rank unless --device names a card for all of them
        spread = cuda and (args.device is None
                           or torch.device(args.device).index is None)
        shared = cuda and (not spread or mesh.ranks_share_a_card(n_ranks))
        backend = "cpu:gloo,cuda:nccl" if cuda and not shared else "gloo"
        rank = multihost.initialize_from_env(backend).process_id
        lead = rank == 0
        if spread:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        if cuda:
            torch.cuda.set_device(dev)
        rules = ShardingRules(cfg, mesh.make_host_mesh(
            args.data_axis, args.model_axis, device_type=dev.type),
            mode="train")
        if shared:
            transport = mesh.gloo_all_gather()
    opt_cfg = optim.AdamWConfig(lr=args.lr,
                                warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    try:
        with transport:
            _, history = train(
                cfg, steps=args.steps, seq_len=args.seq_len,
                global_batch=args.batch, opt_cfg=opt_cfg,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, device=dev, rules=rules)
    finally:
        if rules is not None:
            dist.destroy_process_group()
    if lead:
        print(f"final loss: {history[-1]['loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
