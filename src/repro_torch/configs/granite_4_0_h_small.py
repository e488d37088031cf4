"""Granite 4.0-H Small (32B-A9B) — Mamba-2 layers and NoPE GQA layers,
each with a 72-expert top-10 MoE and a shared expert; µP multipliers.
[huggingface.co/ibm-granite/granite-4.0-h-small, model_type
granitemoehybrid]

Layer period of 10: Mamba-2 at 0-4 and 6-9, attention at 5.  Mamba-2:
128 heads of 64, state 128, one group, conv 4 with bias, chunk 256.
Attention: 32 query heads over 8 kv heads of 128, no rotary embedding,
scores scaled by 1/128.  Every layer's FFN: 72 SwiGLU experts of 768,
top-10, dropless, plus an always-on SwiGLU expert of 1536.  The
embedding is multiplied by 12, each mixer's and FFN's output by 0.22
before its residual add, and the logits divided by 16.  A port-only
configuration (``PortConfig``): the JAX package has no such model.
"""
from repro_torch.configs.base import PortConfig, register

PERIOD = (("ssd", "moe"),) * 5 + (("attn", "moe"),) + (("ssd", "moe"),) * 4

CONFIG = PortConfig(
    name="granite-4.0-h-small",
    arch_type="hybrid",
    source="[huggingface.co/ibm-granite/granite-4.0-h-small]",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    pattern=PERIOD,
    n_experts=72,
    top_k=10,
    capacity_factor=None,
    activation="silu",
    norm_eps=1e-5,
    tie_embeddings=True,
    d_state=128,
    ssd_head_dim=64,
    ssd_expand=2,
    ssd_chunk=256,
    conv_width=4,
    shared_d_ff=1536,
    position_embedding="nope",
    attention_multiplier=0.0078125,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
)

TINY = CONFIG.replace(
    name="granite-4.0-h-small:tiny", n_layers=3,
    pattern=(("ssd", "moe"), ("attn", "moe"), ("ssd", "moe")),
    d_model=256, n_heads=4, n_kv_heads=2, head_dim=64, d_ff=64,
    vocab_size=512, n_experts=8, top_k=3, shared_d_ff=128, d_state=32,
    ssd_head_dim=32, ssd_chunk=32, attention_multiplier=1.0 / 64,
)

register(CONFIG, TINY, port_only=True)
