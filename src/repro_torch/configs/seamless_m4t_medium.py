"""SeamlessM4T-medium — encoder-decoder transformer backbone; the audio
frontend is a stub (input_specs provides precomputed frame embeddings).
[arXiv:2308.11596]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend_dim=1024,        # speech frame embedding width (stub)
    rope_theta=10000.0,
    max_position=4096,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium-smoke", family="encdec",
        num_layers=2, encoder_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, frontend_dim=64, max_position=512,
    )
