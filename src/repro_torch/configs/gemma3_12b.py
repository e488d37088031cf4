"""Gemma-3 12B — dense GQA, 5:1 local:global attention, 128k context, 256k
vocab. [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="gemma3-12b",
    arch_type="dense",
    source="[hf:google/gemma-3-1b-pt]",
    n_layers=48,  # 8 units of (5 local + 1 global)
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=(
        ("local", "dense"), ("local", "dense"), ("local", "dense"),
        ("local", "dense"), ("local", "dense"), ("attn", "dense"),
    ),
    window=1024,
    activation="geglu",
    gemma_style=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="gemma3-12b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    head_dim=64, d_ff=512, vocab_size=512, window=64,
    pattern=(("local", "dense"), ("attn", "dense")),  # compressed 1:1 local:global
)

register(CONFIG, TINY)
