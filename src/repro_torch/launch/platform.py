"""Device policy and platform description for the port.

``resolve_device`` is the one place an entry point picks its device: the
card unless the caller names another, and never a silent fall back to the
CPU — a measurement that quietly ran on the host would be reported under
the card's name.  ``describe`` records what a run actually ran on (the
twin of the JAX package's ``launch/platform.describe``).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Dict, Optional

import torch

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16


def resolve_device(device=None) -> torch.device:
    """``device=None`` means the CUDA card; raises when none is present.
    An explicit device (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is
    taken as given, and a CUDA one is still checked for a card.  A CUDA
    device comes back indexed (``"cuda"`` is the current card,
    ``cuda:<n>``), as tensors report theirs, so devices compare equal
    with ``==``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def nvidia_smi() -> Optional[str]:
    """``name, power.limit`` of every card as nvidia-smi reports them, or
    None where the command does not exist."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=False)
    return out.stdout.strip() if out.returncode == 0 else None


def describe() -> Dict:
    """What this process runs on: torch and CUDA versions, the card's name
    and count, the TF32 flags, and nvidia-smi's name and power limit."""
    cuda = torch.cuda.is_available()
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
        "nvidia_smi": nvidia_smi(),
    }


def roofline_peaks() -> Dict:
    """Peak FLOP/s and memory bandwidth for roofline ratios: the H100's
    data-sheet constants (``launch/mesh.py``) where a card is present,
    else the JAX package's CPU class figures — good enough to CLASSIFY a
    step as compute- or memory-bound, not to predict its time."""
    if torch.cuda.is_available():
        return {"peak_flops": PEAK_FLOPS_BF16, "mem_bw": HBM_BW,
                "basis": "h100-sxm"}
    return {"peak_flops": 5e11, "mem_bw": 5e10, "basis": "cpu-class"}
