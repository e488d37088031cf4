"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands under ``build/repro_torch/<hash>/`` at the repository root,
keyed by a hash of the sources, the headers they share (``csrc/*.cuh``)
and the flags, so a checkout builds it at first use and reuses it after.  The sources compile in parallel, one ``nvcc`` per
file, then link.  No ``--use_fast_math``: ``log2f``, ``expf`` and division
must stay accurate for the kernels' 1e-5 agreement with their plain
versions.  The one exception is ``ssm_mixer.cu``'s SiLU, which calls the
intrinsic ``__expf`` and ``__fdividef`` itself: each is within a few
float32 ulp, far under its bf16 output's half ulp, and the IEEE versions
cost the memory-bound conv about as many instructions as its bytes allow.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "repro_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"] + ARCH
LIB_NAME = "librepro_torch_kernels.so"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.exists():
            exe = str(cand)
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return exe


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _headers():
    return sorted(CSRC.glob("*.cuh"))


def _key(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where the library of the current sources lives, built or not."""
    return BUILD_ROOT / _key(_sources() + _headers()) / LIB_NAME


def build() -> Path:
    """Compile the sources (if this hash is not built yet) and return the
    library's path."""
    sources = _sources()
    lib = lib_path()
    out_dir = lib.parent
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        for src, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            (out_dir / (src.stem + ".ptxas.txt")).write_text(out)
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, lib)
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict:
    """``{entry: (registers, spill store bytes, spill load bytes)}`` from
    the ``-Xptxas -v`` report of one source."""
    usage, entry, spills = {}, None, (0, 0)
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            entry, spills = m.group(1), (0, 0)
        elif entry and (m := _SPILLS.search(line)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif entry and (m := _REGS.search(line)):
            usage[entry] = (int(m.group(1)),) + spills
            entry = None
    return usage


def ptxas_usage(stem: str) -> dict:
    """``parse_ptxas`` of ``csrc/<stem>.cu``'s report in the current build."""
    return parse_ptxas((build().parent / f"{stem}.ptxas.txt").read_text())


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call), with every entry
    point's argument types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # 18 operands, 5 outputs, 3 scratch buffers; B, M, U, N; the stream
    lib.era_step_launch.argtypes = [ptr] * 26 + [i32] * 4 + [ptr]
    lib.era_step_launch.restype = i32
    # contrib, sig, key, inter, bw, out; B, M, U; the stream
    lib.noma_rate_launch.argtypes = [ptr] * 6 + [i32] * 3 + [ptr]
    lib.noma_rate_launch.restype = i32
    # q, k, v, o; B, H, KH, S, T, D, causal, window, dtype; scale; the
    # (batch, seq, head) strides of q, k, v, o; the stream
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 9
        + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong), ptr])
    lib.flash_attention_launch.restype = i32
    # a, b, h; B, L, D; the stream
    lib.rglru_scan_launch.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
    lib.rglru_scan_launch.restype = i32
    # x, dt, A, B, C, D, y, state, the bf16 path's scratch; Bt, L, H, P,
    # N, Q; the batch and row strides of x, B and C; dtype; the stream
    i64 = ctypes.c_longlong
    lib.ssd_launch.argtypes = ([ptr] * 9 + [i32] * 6 + [i64] * 6
                               + [i32, ptr])
    lib.ssd_launch.restype = i32
    # q, k, v, pos, position, scratch, o; B, H, KH, T, D, window, splits,
    # tiles per split; scale; q's two strides, k's and v's three; the
    # stream
    lib.decode_attention_launch.argtypes = (
        [ptr] * 7 + [i32] * 8
        + [ctypes.c_float, ctypes.POINTER(i64), ctypes.POINTER(i64), ptr])
    lib.decode_attention_launch.restype = i32
    # x, w, bias, o; B, L, C; x's batch and row strides; vec, dtype; the
    # stream
    lib.ssm_conv_silu_launch.argtypes = ([ptr] * 4 + [i32] * 3 + [i64] * 2
                                         + [i32] * 2 + [ptr])
    lib.ssm_conv_silu_launch.restype = i32
    # y, z, w, o; B, L, C; y's and z's batch and row strides; eps; vec,
    # vectors a thread, threads a block, dtype; the stream
    lib.ssm_gated_norm_launch.argtypes = (
        [ptr] * 4 + [i32] * 3 + [i64] * 4 + [ctypes.c_float] + [i32] * 4
        + [ptr])
    lib.ssm_gated_norm_launch.restype = i32
    return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry returned a non-zero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def refuse_grad(what: str, instead: str, *tensors) -> None:
    """Raise when autograd would record a call of kernel ``what``.

    The kernels write their outputs through raw pointers, so an output
    has no ``grad_fn``: a gradient through one would be silently zero.
    The check holds on every device (the CPU dispatch to the plain
    version is differentiable, but would hide the fault a CUDA run has).
    ``instead`` names the path to train through."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward and refuses inputs that require "
            f"grad; train through {instead}")
