"""rwkv6-1.6b -- Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="rwkv",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads = d_model / rwkv_head_dim
        n_kv_heads=32,
        d_ff=7168,
        vocab=65_536,
        rwkv_head_dim=64,
        rwkv_lora=64,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-reduced",
        family="rwkv",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        rwkv_head_dim=16,
        rwkv_lora=8,
        ssm_chunk=16,
        compute_dtype="float32",
        remat="none",
    )
