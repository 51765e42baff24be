"""StableLM-2-1.6B — dense decoder, MHA (kv=heads).
[hf:stabilityai/stablelm-2-1_6b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    rope_theta=10000.0,
    max_position=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=160, vocab_size=256, max_position=512,
    )
