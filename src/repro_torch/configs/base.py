"""Model configuration schema shared by every assigned architecture.

A model is a chain of residual blocks.  Each block position in the repeating
``pattern`` names a (mixer, ffn) pair:

  mixer: "attn"  — full (global) causal attention
         "local" — sliding-window causal attention
         "rec"   — RG-LRU recurrent block (Griffin / RecurrentGemma)
         "ssd"   — Mamba-2 state-space-duality block
  ffn:   "dense" | "moe" | "none"

The pattern repeats ``n_layers // len(pattern)`` times (scanned — compile time
is depth-independent); the remainder layers form an unstacked tail so uneven
depths (e.g. RecurrentGemma's 26 = 3·8 + 2) still work.

ERA (the paper's contribution) treats each block boundary as a candidate model
split point; per-block FLOP/byte profiles derive from these configs in
``repro_torch/core/profiles.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

LayerSpec = Tuple[str, str]  # (mixer, ffn)

VALID_MIXERS = ("attn", "local", "rec", "ssd")
VALID_FFNS = ("dense", "moe", "none")

VOCAB_PAD_MULTIPLE = 256  # keeps the vocab dim divisible by the model axis (16)


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    arch_type: str  # dense | moe | hybrid | ssm | vlm | audio
    source: str = ""  # citation, e.g. "[arXiv:2407.21783]"

    # trunk shape
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024

    # block pattern
    pattern: Tuple[LayerSpec, ...] = (("attn", "dense"),)
    window: int = 4096  # sliding window for "local" mixers

    # MoE
    n_experts: int = 0
    top_k: int = 0
    # None: dropless (every route computed; ``models/moe.py``)
    capacity_factor: Optional[float] = 1.25
    # runtime knob (not an architecture property): number of independent
    # dispatch groups; the distributed layer sets it to the data-axis size
    # so routing scatters stay shard-local (GShard per-device capacity)
    moe_dispatch_groups: int = 1

    # FFN / misc
    attn_qkv_bias: bool = False
    activation: str = "silu"  # "silu" (SwiGLU), "geglu", "gelu"
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    norm_eps: float = 1e-6
    gemma_style: bool = False  # sqrt(d_model) embed scale + (1 + w) RMSNorm
    tie_embeddings: bool = False

    # audio (musicgen): parallel codebooks; tokens are (B, K, S)
    n_codebooks: int = 1

    # vlm stub frontend: number of precomputed patch-embedding tokens the
    # serving path prepends; the ViT itself is out of scope (see DESIGN.md)
    vision_tokens: int = 0

    # SSD (mamba2)
    d_state: int = 0
    ssd_head_dim: int = 64
    ssd_expand: int = 2
    ssd_chunk: int = 256

    # RG-LRU (recurrentgemma): width of the recurrent branch
    d_rnn: int = 0
    rglru_c: float = 8.0
    conv_width: int = 4

    # numerics
    dtype: str = "bfloat16"

    # Terms the JAX package's configuration has no field for, read by the
    # models at their neutral values here (class attributes, not fields,
    # so that every registry entry's fields stay the JAX package's);
    # ``PortConfig`` makes them fields
    shared_d_ff = 0                 # an always-on shared expert's width
    position_embedding = "rope"     # "rope" | "nope" (no rotary embedding)
    attention_multiplier = 0.0      # the score scale; 0 -> 1/sqrt(head_dim)
    embedding_multiplier = 1.0      # times the token embedding
    residual_multiplier = 1.0       # times each mixer's and FFN's output
    logits_scaling = 1.0            # the logits are divided by it

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        for mixer, ffn in self.pattern:
            if mixer not in VALID_MIXERS:
                raise ValueError(f"{self.name}: bad mixer {mixer!r}")
            if ffn not in VALID_FFNS:
                raise ValueError(f"{self.name}: bad ffn {ffn!r}")
        if self.n_heads and self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")

    # derived ----------------------------------------------------------- #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, VOCAB_PAD_MULTIPLE
        return (v + m - 1) // m * m

    @property
    def pattern_len(self) -> int:
        return len(self.pattern)

    @property
    def n_units(self) -> int:
        """Number of full repeats of the pattern (scanned)."""
        return self.n_layers // self.pattern_len

    @property
    def tail_specs(self) -> Tuple[LayerSpec, ...]:
        """Remainder layers applied after the scanned units."""
        return self.pattern[: self.n_layers % self.pattern_len]

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssd_expand * self.d_model

    @property
    def n_ssd_heads(self) -> int:
        return self.d_inner // self.ssd_head_dim

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def has_attention(self) -> bool:
        return any(m in ("attn", "local") for m, _ in self.pattern)

    @property
    def is_subquadratic(self) -> bool:
        """True if no mixer needs an unbounded dense KV cache."""
        return all(m != "attn" for m, _ in self.pattern)

    @property
    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Expanded per-layer (mixer, ffn) list, length n_layers."""
        reps = self.pattern * (self.n_layers // self.pattern_len + 1)
        return reps[: self.n_layers]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A port-only configuration: ``ModelConfig`` with the terms its JAX
    counterpart lacks as fields (their meaning beside ``ModelConfig``'s
    neutral class attributes).  Registered with ``port_only=True``:
    ``get_config`` finds it, ``list_architectures`` (the JAX package's
    list) does not name it."""
    shared_d_ff: int = 0
    position_embedding: str = "rope"
    attention_multiplier: float = 0.0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    def __post_init__(self):
        super().__post_init__()
        if self.position_embedding not in ("rope", "nope"):
            raise ValueError(f"{self.name}: bad position_embedding "
                             f"{self.position_embedding!r}")


# --------------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------------- #
_REGISTRY: dict = {}
# configurations of the port alone (no JAX counterpart), by name
_PORT_ONLY: dict = {}
_TINY: dict = {}


def register(cfg: ModelConfig, tiny: ModelConfig, port_only=False):
    (_PORT_ONLY if port_only else _REGISTRY)[cfg.name] = cfg
    _TINY[cfg.name] = tiny
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name.endswith(":tiny"):
        return _TINY[name[: -len(":tiny")]]
    return _REGISTRY[name] if name in _REGISTRY else _PORT_ONLY[name]


def get_tiny_config(name: str) -> ModelConfig:
    _ensure_loaded()
    return _TINY[name]


def list_architectures():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import the per-arch modules for their registration side effects
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        dbrx_132b,
        llama3_8b,
        mixtral_8x22b,
        recurrentgemma_2b,
        qwen2_vl_72b,
        internlm2_1_8b,
        musicgen_medium,
        gemma3_12b,
        gemma_2b,
        mamba2_780m,
        granite_4_0_h_small,
    )
