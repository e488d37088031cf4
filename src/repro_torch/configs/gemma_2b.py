"""Gemma 2B — dense decoder, GeGLU, head_dim=256, MQA. [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    source="[arXiv:2403.08295]",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    pattern=(("attn", "dense"),),
    activation="geglu",
    gemma_style=True,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="gemma-2b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=1,
    head_dim=64, d_ff=512, vocab_size=512,
)

register(CONFIG, TINY)
