"""Mistral-Nemo-12B — dense decoder, GQA, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    max_position=131072,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, max_position=512,
    )
