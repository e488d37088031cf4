"""DBRX 132B — fine-grained MoE, 16 experts top-4, GQA. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="dbrx-132b",
    arch_type="moe",
    source="[hf:databricks/dbrx-base]",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    pattern=(("attn", "moe"),),
    n_experts=16,
    top_k=4,
    activation="silu",
    rope_theta=500_000.0,
)

TINY = CONFIG.replace(
    name="dbrx-132b:tiny", n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512, n_experts=4, top_k=2,
)

register(CONFIG, TINY)
