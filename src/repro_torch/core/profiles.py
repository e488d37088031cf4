"""Per-layer model split profiles: FLOPs per layer, intermediate activation
bits per candidate split point, input/result sizes (paper §II.A Fig. 4).

Split semantics (s ∈ {0..F}):
  device computes layers 1..s, edge computes s+1..F.
  s = 0  -> edge-only  (uplink carries the raw input)
  s = F  -> device-only (nothing crosses the radio)
  else   -> uplink carries out_bits[s-1] (output of layer s)

The paper's own CNN benchmarks (NiN / tiny-YOLOv2 / VGG16) are built from
published layer shapes; transformer profiles derive analytically from a
``ModelConfig`` (per-block FLOPs + residual-stream bits, plus recurrent
state bits for rec/ssd blocks, one split point per block boundary).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import torch

from repro_torch.configs import get_config
from repro_torch.launch.platform import resolve_device


@dataclass(frozen=True)
class SplitProfile:
    """A profile's four tables.  A stacked profile (``stack_profiles``)
    carries a leading cell axis on every numeric field, its endpoint sizes
    as (B,) tensors; the split-indexed properties then come out (B, F+1)."""
    name: str
    layer_flops: torch.Tensor                  # (F,) FLOPs of layer i
    out_bits: torch.Tensor                     # (F,) bits leaving layer i
    input_bits: Union[float, torch.Tensor]     # raw input size
    result_bits: Union[float, torch.Tensor]    # final-result downlink size

    @property
    def n_layers(self) -> int:
        return int(self.layer_flops.shape[-1])

    @property
    def batched(self) -> bool:
        return self.layer_flops.dim() == 2

    def _endpoint(self, v):
        """An endpoint size as a (..., 1) column matching the tables."""
        lf = self.layer_flops
        v = torch.as_tensor(v, dtype=torch.float32, device=lf.device)
        return v.reshape(lf.shape[:-1] + (1,))

    # ---- split-indexed tables (length F+1, index = s) ----
    @property
    def device_flops(self):
        lf = self.layer_flops
        zero = torch.zeros(lf.shape[:-1] + (1,), dtype=lf.dtype,
                           device=lf.device)
        return torch.cat([zero, torch.cumsum(lf, dim=-1)], dim=-1)

    @property
    def edge_flops(self):
        total = torch.sum(self.layer_flops, dim=-1, keepdim=True)
        return total - self.device_flops

    @property
    def uplink_bits(self):
        w = torch.cat([self._endpoint(self.input_bits), self.out_bits],
                      dim=-1)
        w[..., -1] = 0.0                  # device-only: nothing uplinked
        return w

    @property
    def downlink_bits(self):
        d = self._endpoint(self.result_bits).expand(
            self.layer_flops.shape[:-1] + (self.n_layers + 1,)).clone()
        d[..., -1] = 0.0                  # device-only: result already local
        return d

    def _tree_map(self, fn, *others):
        kids = [fn(*(getattr(p, f) for p in (self,) + others))
                for f in ("layer_flops", "out_bits", "input_bits",
                          "result_bits")]
        return SplitProfile(self.name, *kids)

    def to(self, device) -> "SplitProfile":
        move = lambda x: x.to(device) if isinstance(x, torch.Tensor) else x
        return SplitProfile(self.name, move(self.layer_flops),
                            move(self.out_bits), move(self.input_bits),
                            move(self.result_bits))


def take_split(table, s):
    """``table[s]`` per user: a shared (F+1,) table indexed by (..., U)
    split points, or a stacked (B, F+1) table gathered per lane."""
    if table.dim() == 1:
        return table[s]
    return torch.gather(table, -1, s)


def stack_profiles(profs) -> SplitProfile:
    """Stack per-cell profiles (equal layer count F) into one batched
    SplitProfile with a leading cell axis on every numeric field."""
    profs = list(profs)
    fs = {p.n_layers for p in profs}
    if len(fs) != 1:
        raise ValueError(f"profiles must share a layer count, got {fs}")
    name = profs[0].name if len({p.name for p in profs}) == 1 \
        else "batch(" + ",".join(p.name for p in profs) + ")"
    dev = profs[0].layer_flops.device
    as_scalar = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    return SplitProfile(
        name=name,
        layer_flops=torch.stack([p.layer_flops for p in profs]),
        out_bits=torch.stack([p.out_bits for p in profs]),
        input_bits=torch.stack([as_scalar(p.input_bits) for p in profs]),
        result_bits=torch.stack([as_scalar(p.result_bits) for p in profs]),
    )


# --------------------------------------------------------------------------- #
# CNN profiles (the paper's benchmark models)
# --------------------------------------------------------------------------- #
def _conv(h, w, cin, cout, k, stride=1, pool=False):
    """Returns (out_h, out_w, cout, flops, out_activations)."""
    oh, ow = h // stride, w // stride
    flops = 2.0 * oh * ow * cout * cin * k * k
    if pool:
        oh, ow = oh // 2, ow // 2
        flops += oh * ow * cout * 4  # pooling compares
    return oh, ow, cout, flops, oh * ow * cout


def _chain(name, input_hw, cin, spec, device, result_bits=32 * 10,
           act_bits=16):
    """spec: list of (cout, k, stride, pool)."""
    h = w = input_hw
    c = cin
    flops_l, out_l = [], []
    for cout, k, stride, pool in spec:
        h, w, c, fl, act = _conv(h, w, c, cout, k, stride, pool)
        flops_l.append(fl)
        out_l.append(act * act_bits)
    input_bits = input_hw * input_hw * cin * 8  # 8-bit raw image
    return SplitProfile(
        name=name,
        layer_flops=torch.tensor(flops_l, dtype=torch.float32, device=device),
        out_bits=torch.tensor(out_l, dtype=torch.float32, device=device),
        input_bits=float(input_bits),
        result_bits=float(result_bits),
    )


def nin_profile(device):
    """NiN, 9 conv layers, profiled at 224×224 (Neurosurgeon's setting) so
    the split landscape is non-trivial."""
    spec = [
        (192, 5, 1, False), (160, 1, 1, False), (96, 1, 1, True),
        (192, 5, 1, False), (192, 1, 1, False), (192, 1, 1, True),
        (192, 3, 1, False), (192, 1, 1, False), (10, 1, 1, True),
    ]
    return _chain("nin", 224, 3, spec, device)


def yolov2_profile(device):
    """tiny-YOLOv2 backbone at its native 416×416, 9 conv outputs."""
    spec = [
        (16, 3, 1, True), (32, 3, 1, True), (64, 3, 1, True),
        (128, 3, 1, True), (256, 3, 1, True), (512, 3, 1, True),
        (1024, 3, 1, False), (1024, 3, 1, False), (125, 1, 1, False),
    ]
    return _chain("yolov2", 416, 3, spec, device,
                  result_bits=13 * 13 * 125 * 16)


def vgg16_profile(device):
    """VGG16 conv stack at 224×224."""
    spec = [
        (64, 3, 1, False), (64, 3, 1, True),
        (128, 3, 1, False), (128, 3, 1, True),
        (256, 3, 1, False), (256, 3, 1, False), (256, 3, 1, True),
        (512, 3, 1, False), (512, 3, 1, False), (512, 3, 1, True),
        (512, 3, 1, False), (512, 3, 1, False), (512, 3, 1, True),
    ]
    return _chain("vgg16", 224, 3, spec, device)


CNN_PROFILES = {
    "nin": nin_profile,
    "yolov2": yolov2_profile,
    "vgg16": vgg16_profile,
}


# --------------------------------------------------------------------------- #
# transformer profiles from ModelConfig
# --------------------------------------------------------------------------- #
def block_flops(cfg, spec, seq):
    """Analytic forward FLOPs of one block on ``seq`` tokens."""
    mixer, ffn_kind = spec
    d, hd = cfg.d_model, cfg.resolved_head_dim
    fl = 0.0
    if mixer in ("attn", "local"):
        h, k = cfg.n_heads, cfg.n_kv_heads
        fl += 2.0 * seq * d * (h + 2 * k) * hd          # qkv proj
        ctx = min(seq, cfg.window) if mixer == "local" else seq
        fl += 2.0 * 2.0 * seq * ctx * h * hd * 0.5      # scores+values, causal
        fl += 2.0 * seq * h * hd * d                    # out proj
    elif mixer == "rec":
        dr = cfg.resolved_d_rnn
        fl += 2.0 * seq * d * dr * 3                    # rec/gate/out proj
        fl += 2.0 * seq * dr * dr * 2                   # gates
        fl += seq * dr * cfg.conv_width * 2
    elif mixer == "ssd":
        di, n, hh = cfg.d_inner, cfg.d_state, cfg.n_ssd_heads
        p = cfg.ssd_head_dim
        fl += 2.0 * seq * d * (2 * di + 2 * n + hh)     # in proj
        fl += 2.0 * seq * di * d                        # out proj
        q = min(cfg.ssd_chunk, seq)
        fl += 2.0 * seq * q * n + 2.0 * seq * q * hh * p  # intra-chunk
        fl += 4.0 * seq * hh * p * n                    # states in/out
    if ffn_kind == "dense":
        mult = 3 if cfg.activation in ("silu", "geglu") else 2
        fl += 2.0 * seq * d * cfg.d_ff * mult
    elif ffn_kind == "moe":
        mult = 3 if cfg.activation in ("silu", "geglu") else 2
        fl += 2.0 * seq * d * cfg.d_ff * mult * cfg.top_k
        fl += 2.0 * seq * d * cfg.n_experts             # router
        fl += 2.0 * seq * d * cfg.shared_d_ff * mult    # shared expert
    return fl


def transformer_profile(cfg, seq=128, batch=1, act_bits=16,
                        device=None) -> SplitProfile:
    """Split profile for a per-user inference request of ``seq`` tokens,
    on ``device`` (default: the card).

    Each block boundary is a split point; the crossing tensor is the
    residual stream (B,S,d) plus any recurrent state (rec: d_rnn; ssd:
    H·P·N f32)."""
    specs = cfg.layer_specs
    flops_l = [batch * block_flops(cfg, sp, seq) for sp in specs]

    stream_bits = batch * seq * cfg.d_model * act_bits
    out_l = []
    for mixer, _ in specs:
        extra = 0.0
        if mixer == "rec":
            extra = batch * cfg.resolved_d_rnn * 32.0
        elif mixer == "ssd":
            extra = (batch * cfg.n_ssd_heads * cfg.ssd_head_dim
                     * cfg.d_state * 32.0)
        out_l.append(stream_bits + extra)

    # endpoints: raw input = token ids (tiny) or patch/frame embeddings
    if cfg.vision_tokens:
        input_bits = batch * (cfg.vision_tokens * cfg.d_model * act_bits
                              + seq * 32.0)
    elif cfg.n_codebooks > 1:
        input_bits = batch * seq * cfg.n_codebooks * 32.0
    else:
        input_bits = batch * seq * 32.0
    result_bits = batch * cfg.n_codebooks * 32.0  # one sampled token (id)

    dev = resolve_device(device)
    return SplitProfile(
        name=cfg.name,
        layer_flops=torch.tensor(flops_l, dtype=torch.float32, device=dev),
        out_bits=torch.tensor(out_l, dtype=torch.float32, device=dev),
        input_bits=float(input_bits),
        result_bits=float(result_bits),
    )


def get_profile(name: str, device=None, **kw) -> SplitProfile:
    """A CNN profile, or a model configuration's transformer profile
    (``kw``: ``transformer_profile``'s seq / batch / act_bits), by name,
    on ``device`` (default: the card)."""
    if name in CNN_PROFILES:
        return CNN_PROFILES[name](resolve_device(device))
    return transformer_profile(get_config(name), device=device, **kw)
