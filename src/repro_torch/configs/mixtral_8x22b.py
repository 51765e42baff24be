"""Mixtral-8x22B — MoE decoder, 8 experts top-2, GQA kv=8, sliding-window attn.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    max_position=65536,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=256, num_experts=4, experts_per_token=2,
        sliding_window=64, max_position=512,
    )
