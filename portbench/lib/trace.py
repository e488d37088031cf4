"""The device trace of a traced run: ``torch.profiler`` over a bounded
stretch of the window, reduced to kernel intervals.

The stretch is short on purpose (a profile of some 4e5 records can lose
its tail), records the device activity alone (kernels, copies and the
CUDA runtime calls that issued them), and is opened and closed by the
thread that drives the device, between two of its rounds: a profiler
started or stopped while another thread replays CUDA graphs hung the
process on the H100.
"""
from __future__ import annotations

import re
import time

import torch

# idle gaps labelled by the host op over them, longest first
LABELLED_GAPS = 300


def short_name(name: str) -> str:
    """"void (anonymous namespace)::ssd_out_kernel<64, 128>(...)" ->
    "ssd_out_kernel"."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return m.group(1) if m else name[:60]


class Stretch:
    """One profiled stretch: ``start()``, the work, ``stop()``."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> dict:
        """Kernel records of the stretch and what they add up to."""
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        ker = sorted(((e.time_range.start, e.time_range.end,
                       short_name(e.name)) for e in events
                      if e.device_type == DeviceType.CUDA),
                     key=lambda k: k[0])
        host = [(e.time_range.start, e.time_range.end, e.name)
                for e in events if e.device_type == DeviceType.CPU]
        return reduce_kernels(ker, host, self.t1 - self.t0)


def reduce_kernels(ker, host, window_s: float) -> dict:
    """``ker``: sorted (start_us, end_us, name) device records; ``host``:
    (start_us, end_us, name) host records (the CUDA runtime calls).
    Returns the union of the kernel intervals (``busy_s``), the top device
    ops by time, the idle gaps between kernels by the runtime call that
    covers each gap's middle ("host work" where none does), and the
    records themselves."""
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in ker:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy_us += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_op = {}
    for s, e, name in ker:
        by_op[name] = by_op.get(name, 0.0) + (e - s) / 1e6
    # the innermost host op over each gap's middle says what the host did;
    # the longest LABELLED_GAPS gaps are labelled, the rest summed apart
    import numpy as np
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    by_gap = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for k, (gs, ge) in enumerate(gaps):
        name = "shorter gaps"
        if k < LABELLED_GAPS:
            mid = 0.5 * (gs + ge)
            inner = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = "host work" if inner.size == 0 else \
                host[inner[np.argmin(he[inner] - hs[inner])]][2]
        by_gap[name] = by_gap.get(name, 0.0) + (ge - gs) / 1e6
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy_us / 1e6, window_s=window_s, kernels=ker,
                device_ops=top(by_op), idle_gaps=top(by_gap))


def calls(kernels, names) -> list:
    """Device seconds of each complete call of a kernel whose launches are
    ``names`` in order (records of other kernels in between are skipped;
    a run of ``names`` broken by a missing record is not counted)."""
    seq = [(n, (e - s) / 1e6) for s, e, n in kernels if n in names]
    out, i, k = [], 0, len(names)
    while i + k <= len(seq):
        if [n for n, _ in seq[i:i + k]] == list(names):
            out.append(sum(t for _, t in seq[i:i + k]))
            i += k
        else:
            i += 1
    return out
