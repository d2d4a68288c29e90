"""deepseek-moe-16b -- fine-grained MoE: 2 shared + 64 routed, top-6.
[arXiv:2401.06066; hf]  28L d_model=2048 16H d_ff=1408 vocab=102400."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=102_400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        expert_sharding="ep",  # 64 experts / 16-way model axis = 4 each
        capacity_factor=1.25,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-reduced",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=512,
        n_experts=8,
        n_shared_experts=1,
        top_k=2,
        moe_group=64,
        compute_dtype="float32",
        remat="none",
    )
