"""stablelm-1.6b -- dense, RoPE, SwiGLU-style gated MLP.
[hf:stabilityai/stablelm-2-1_6b; unverified]  24L d=2048 32H d_ff=5632
vocab=100352."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100_352,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        compute_dtype="float32",
        remat="none",
    )
