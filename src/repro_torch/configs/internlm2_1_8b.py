"""InternLM2 1.8B — dense GQA decoder. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    arch_type="dense",
    source="[arXiv:2403.17297]",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    pattern=(("attn", "dense"),),
    activation="silu",
    rope_theta=1_000_000.0,
)

TINY = CONFIG.replace(
    name="internlm2-1.8b:tiny", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=2, d_ff=512, vocab_size=512,
)

register(CONFIG, TINY)
