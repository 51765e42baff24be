"""Zamba2-1.2B — hybrid Mamba2 backbone with a single shared attention block
applied every N layers (weights tied across occurrences).
[arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=10000.0,
    max_position=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_expand=2, attn_every=2,
        max_position=512,
    )
