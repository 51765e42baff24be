"""Granite-34B-Code — deep dense decoder with MQA (kv=1).
[arXiv:2405.04324]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",       # gpt-bigcode style 2-matrix MLP
    rope_theta=10000.0,
    max_position=8192,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=192, vocab_size=256, max_position=512,
    )
