"""Granite-MoE-3B-A800M — MoE decoder, 40 experts top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-3b-a800m-base family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    rope_theta=10000.0,
    max_position=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=256, num_experts=4, experts_per_token=2,
        max_position=512,
    )
