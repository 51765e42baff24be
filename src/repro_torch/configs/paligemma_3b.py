"""PaliGemma-3B — Gemma-2B decoder backbone with SigLIP patch-embedding stub
frontend (input_specs provides precomputed patch embeddings). MQA kv=1.
[arXiv:2407.07726]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    frontend_tokens=256,        # 16x16 patches at 224px / patch 14 (SigLIP stub)
    frontend_dim=1152,          # SigLIP-So400m width
    rope_theta=10000.0,
    max_position=8192,
    logit_softcap=30.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b-smoke", family="vlm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, frontend_tokens=8, frontend_dim=48,
        max_position=512, logit_softcap=30.0,
    )
