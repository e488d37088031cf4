"""Wrapper of the hand-written CUDA era_step kernel (csrc/era_step.cu).

``era_step_fused`` takes the 18 channel-major operands of
``ref.fused_step_math`` with a leading cell axis B and returns
``(gamma (B,), d_beta_up_t (B, M, U), d_beta_dn_t, d_p (B, 1, U), d_pap,
d_r)``.  CUDA tensors launch the kernel (one launch covers every cell);
CPU tensors take the plain version; inputs that require grad raise (the
kernel returns ∂Γ itself and has no backward).
``era_step_fused.launches`` counts kernel launches.  A call made while its
stream is captured into a CUDA graph launches nothing: it adds to the
calling thread's ``thread_launches()[1]`` instead, and whoever replays the
graph counts its launches (``count_launches``).
"""
from __future__ import annotations

import math
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.era_step import ref as _ref

MAX_APS = 8                       # kMaxAps in era_step.cu
SMEM_ROWS = 11                    # pass1's dynamic shared rows of U words
SMEM_STATIC = 2 * MAX_APS * 32 * 4  # pass1's block-reduction buffer
SMEM_LIMIT = 232448               # bytes a block may use on sm_90

_NAMES = ("beta_up_t", "beta_dn_t", "p", "p_ap", "r", "q", "dev_fl",
          "edge_fl", "wup", "wdn", "envp", "h_up_r", "h_dn_r", "onehot", "up_rank", "up_gid", "dn_rank", "dn_gid")
_INT_OPERANDS = {"up_rank", "up_gid", "dn_rank", "dn_gid"}


def _expected_shapes(b, m, u, n):
    mu, row = (b, m, u), (b, 1, u)
    return {"beta_up_t": mu, "beta_dn_t": mu, "p": row, "p_ap": row,
            "r": row, "q": row, "dev_fl": row, "edge_fl": row, "wup": row,
            "wdn": row, "envp": (b, 1, _ref.ENV_LANES),
            "h_up_r": (b, n, m, u), "h_dn_r": (b, n, m, u),
            "onehot": (b, n, u), "up_rank": mu, "up_gid": mu,
            "dn_rank": mu, "dn_gid": mu}


def _check(operands):
    if len(operands) != len(_NAMES):
        raise ValueError(f"expected {len(_NAMES)} operands, "
                         f"got {len(operands)}")
    b, m, u = operands[0].shape
    n = operands[_NAMES.index("onehot")].shape[1]
    if n > MAX_APS:
        raise ValueError(f"era_step kernel takes at most {MAX_APS} APs, "
                         f"got {n}")
    smem = SMEM_ROWS * u * 4 + SMEM_STATIC
    if smem > SMEM_LIMIT:
        raise ValueError(f"U={u} needs {smem} bytes of shared memory per "
                         f"block, above {SMEM_LIMIT}")
    want = _expected_shapes(b, m, u, n)
    dev = operands[0].device
    for name, x in zip(_NAMES, operands):
        dtype = torch.int32 if name in _INT_OPERANDS else torch.float32
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
        if x.shape != want[name]:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return b, m, u, n


def _layout(b, m, u):
    """Offsets (in floats) of the outputs and the kernel's scratch in the
    one buffer a call allocates: gamma (B,), d_beta_up_t and d_beta_dn_t
    (B, M, U), d_p and d_pap (2, B, 1, U), d_r (B, 1, U), then the scratch
    parts (2, B, M, U), rates (2, B, U) and rows (4, B, U)."""
    sizes = (b, b * m * u, b * m * u, 2 * b * u, b * u, 2 * b * m * u,
             2 * b * u, 4 * b * u)
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + -(-n // 4) * 4)   # 16-byte aligned
    return offsets


_COUNT_LOCK = threading.Lock()
_THREAD = threading.local()       # this thread's counted and captured calls


def count_launches(n: int = 1):
    """Add ``n`` launches the device ran to ``era_step_fused.launches``
    and to the calling thread's tally."""
    with _COUNT_LOCK:
        era_step_fused.launches += n
    _THREAD.ran = thread_launches()[0] + n


def thread_launches() -> tuple:
    """``(ran, captured)`` of the calling thread: the launches it
    counted, and the calls it recorded into a CUDA graph under capture."""
    return getattr(_THREAD, "ran", 0), getattr(_THREAD, "captured", 0)


def era_step_fused(*operands):
    """One fused forward+backward GD step for B cells."""
    _build.refuse_grad("era_step_fused", "the solver's step_impl='autograd'",
                       *operands)
    b, m, u, n = _check(operands)
    if operands[0].device.type == "cpu":
        gamma, grads = _ref.fused_step_math(*operands)
        return (gamma,) + tuple(grads)
    lib = _build.library()
    dev = operands[0].device
    off = _layout(b, m, u)
    # one allocation a call holds the outputs and the kernel's scratch
    buf = torch.empty((off[-1],), dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
    status = lib.era_step_launch(
        *(x.data_ptr() for x in operands),
        *(base + 4 * o for o in off[:8]), b, m, u, n, stream)
    _build.check(status, "era_step_launch")
    if capturing:                # recorded: a replay of the graph runs it
        _THREAD.captured = thread_launches()[1] + 1
    else:
        count_launches()
    view = lambda i, shape: buf[off[i]:off[i] + math.prod(shape)].view(shape)
    d_pp = view(3, (2, b, 1, u))
    return (view(0, (b,)), view(1, (b, m, u)), view(2, (b, m, u)),
            d_pp[0], d_pp[1], view(4, (b, 1, u)))


era_step_fused.launches = 0
