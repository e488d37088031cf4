"""Mixtral 8x22B — MoE 8 experts top-2, GQA, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    arch_type="moe",
    source="[arXiv:2401.04088]",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    # every layer uses sliding-window attention (SWA) per the Mixtral report
    pattern=(("local", "moe"),),
    window=4096,
    n_experts=8,
    top_k=2,
    activation="silu",
    rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="mixtral-8x22b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, n_experts=4, top_k=2, window=64,
)

register(CONFIG, TINY)
