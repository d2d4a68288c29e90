"""starcoder2-15b -- code LM: GQA kv=4, RoPE, sliding window 4096, GELU MLP.
[arXiv:2402.19173; hf]  40L d=6144 48H d_ff=24576 vocab=49152."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=4,
        d_ff=24_576,
        vocab=49_152,
        act="gelu",
        gated_mlp=False,
        window=4096,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        act="gelu",
        gated_mlp=False,
        window=32,
        compute_dtype="float32",
        remat="none",
    )
