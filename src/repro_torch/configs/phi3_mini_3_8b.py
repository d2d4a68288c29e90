"""phi3-mini-3.8b -- dense, RoPE, SwiGLU, GQA(kv=32 == MHA).
[arXiv:2404.14219; unverified]  32L d_model=3072 32H d_ff=8192 vocab=32064."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32_064,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-reduced",
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
