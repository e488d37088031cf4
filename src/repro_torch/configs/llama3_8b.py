"""Llama-3 8B — dense GQA decoder, 128k vocab. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama3-8b",
    arch_type="dense",
    source="[arXiv:2407.21783]",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    pattern=(("attn", "dense"),),
    activation="silu",
    rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="llama3-8b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512,
)

register(CONFIG, TINY)
