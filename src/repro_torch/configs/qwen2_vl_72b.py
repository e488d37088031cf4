"""Qwen2-VL 72B — VLM decoder backbone with M-RoPE, GQA. [arXiv:2409.12191]

The ViT/vision frontend is a STUB per DESIGN.md: ``input_specs`` provides
precomputed patch embeddings (``vision_tokens`` of them) and 3-component
M-RoPE positions; this config is the language decoder that consumes them.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    source="[arXiv:2409.12191]",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    pattern=(("attn", "dense"),),
    attn_qkv_bias=True,
    activation="silu",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),  # t/h/w sections of the half head-dim (64)
    vision_tokens=1024,
)

TINY = CONFIG.replace(
    name="qwen2-vl-72b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, vision_tokens=16,
    mrope_sections=(8, 12, 12),  # half head-dim = 32
)

register(CONFIG, TINY)
