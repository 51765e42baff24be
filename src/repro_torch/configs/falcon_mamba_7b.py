"""Falcon-Mamba-7B — attention-free Mamba-1 decoder.
[arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    max_position=1 << 20,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256, ssm_state=8, ssm_conv=4, ssm_expand=2,
        max_position=2048,
    )
