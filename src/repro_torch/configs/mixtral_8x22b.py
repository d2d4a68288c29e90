"""mixtral-8x22b -- 8 experts top-2, GQA kv=8, sliding-window attention.
[arXiv:2401.04088; hf]  56L d_model=6144 48H d_ff=16384 vocab=32768."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16_384,
        vocab=32_768,
        window=4096,  # SWA per assignment
        n_experts=8,
        top_k=2,
        expert_sharding="tp",  # 8 experts < 16-way model axis -> shard d_ff
        capacity_factor=1.25,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        window=32,
        n_experts=4,
        top_k=2,
        moe_group=64,
        compute_dtype="float32",
        remat="none",
    )
