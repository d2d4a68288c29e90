"""phi-3-vision-4.2b -- phi3-mini backbone + CLIP patch embeddings (STUB:
input_specs provides precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]  32L d=3072 32H d_ff=8192."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="dense",
        n_layers=32,
        d_model=3072,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32_064,
        n_patches=576,  # 24x24 CLIP-ViT grid (stub frontend)
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-vision-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        n_patches=8,
        compute_dtype="float32",
        remat="none",
    )
