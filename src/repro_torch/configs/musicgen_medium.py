"""MusicGen-medium — decoder-only over EnCodec tokens, 4 parallel codebooks
(delay pattern), MHA. [arXiv:2306.05284]

The EnCodec conv codec frontend is a STUB per DESIGN.md: tokens arrive as a
(B, K=4, S) grid of codebook ids; the model sums K embeddings per step and
emits K logit heads.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    source="[arXiv:2306.05284]",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,  # MHA
    d_ff=6144,
    vocab_size=2048,
    pattern=(("attn", "dense"),),
    activation="gelu",
    n_codebooks=4,
)

TINY = CONFIG.replace(
    name="musicgen-medium:tiny", n_layers=2, d_model=256, n_heads=4,
    n_kv_heads=4, d_ff=512, vocab_size=256, n_codebooks=2,
)

register(CONFIG, TINY)
