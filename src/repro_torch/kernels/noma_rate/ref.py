"""Plain PyTorch version of the NOMA SIC rate kernel.

Works on pre-sorted per-subchannel tensors (the static SIC ordering of
``core.network.Scenario``), with an optional leading cell axis:
  contrib (M, U)     β·p·|h|² sorted in SIC decode order, grouped by AP
  sig     (M, U)     p·|h|² (signal power) in the same order
  group_end (M, U)   group key per position (the index of the last
                     same-AP entry, constant within a group)
  inter   (M, U)     inter-cell interference + noise (already summed)
  bw                 subchannel bandwidth: a scalar, or (B,) per cell

Returns per-(channel, sorted-user) rate contribution:
  rate = bw · log2(1 + sig / (suffix_intra + inter))
with suffix_intra[i] = Σ_j contrib[j] over same-group positions j > i,
as a masked matvec (an empty suffix is exactly 0.0, no cancellation).
"""
from __future__ import annotations

import torch


def suffix_mask(group_end):
    """(..., U) group keys -> (..., U, U) f32 mask of same-group later
    positions."""
    u = group_end.shape[-1]
    idx = torch.arange(u, device=group_end.device)
    same = group_end[..., :, None] == group_end[..., None, :]
    later = idx[None, :] > idx[:, None]
    return (same & later).to(torch.float32)


def noma_rate_ref(contrib, sig, group_end, inter, bw):
    intra = torch.einsum("...ij,...j->...i", suffix_mask(group_end), contrib)
    sinr = sig / (intra + inter)
    if isinstance(bw, torch.Tensor) and bw.dim() > 0:
        bw = bw.reshape(bw.shape + (1,) * (sinr.dim() - bw.dim()))
    return bw * torch.log2(1.0 + sinr)
