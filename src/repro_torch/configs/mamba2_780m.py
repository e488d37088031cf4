"""Mamba-2 780M — attention-free SSM with SSD (state-space duality).
[arXiv:2405.21060]

d_inner = 2 * d_model = 3072, head dim P = 64 (48 SSD heads), state N = 128.
Mamba blocks have no separate FFN (ffn="none").
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    source="[arXiv:2405.21060]",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pattern=(("ssd", "none"),),
    d_state=128,
    ssd_head_dim=64,
    ssd_expand=2,
    ssd_chunk=256,
    conv_width=4,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="mamba2-780m:tiny", n_layers=2, d_model=256, vocab_size=512,
    d_state=32, ssd_head_dim=32, ssd_chunk=32,
)

register(CONFIG, TINY)
