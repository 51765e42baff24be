"""DeepSeek-67B — dense decoder, GQA kv=8, llama architecture.
[arXiv:2401.02954]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    max_position=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=256, max_position=512,
    )
