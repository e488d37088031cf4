"""RecurrentGemma 2B — Griffin hybrid: RG-LRU + local attention, 1:2 ratio
(pattern rec,rec,local), MQA. [arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    source="[arXiv:2402.19427]",
    n_layers=26,  # 8 full (rec,rec,local) units + (rec,rec) tail
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    pattern=(("rec", "dense"), ("rec", "dense"), ("local", "dense")),
    window=2048,
    activation="geglu",
    gemma_style=True,
    d_rnn=2560,
    conv_width=4,
    tie_embeddings=True,
)

TINY = CONFIG.replace(
    name="recurrentgemma-2b:tiny", n_layers=3, d_model=256, n_heads=2,
    n_kv_heads=1, head_dim=128, d_ff=512, vocab_size=512, d_rnn=256, window=64,
)

register(CONFIG, TINY)
