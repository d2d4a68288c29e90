"""zamba2-2.7b -- hybrid: Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]  54L d=2560 32H d_ff=10240 vocab=32000 ssm_state=64."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=10_240,
        vocab=32_000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        conv_width=4,
        attn_every=6,  # shared attention applied after every 6 mamba layers
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-reduced",
        family="hybrid",
        n_layers=4,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        ssm_state=8,
        ssm_head_dim=16,
        ssm_expand=2,
        conv_width=4,
        attn_every=2,
        ssm_chunk=16,
        compute_dtype="float32",
        remat="none",
    )
