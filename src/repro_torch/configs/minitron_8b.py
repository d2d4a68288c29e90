"""minitron-8b -- pruned nemotron: squared-ReLU MLP (ungated), GQA kv=8,
huge 256k vocab.  [arXiv:2407.14679; hf]  32L d=4096 32H d_ff=16384."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16_384,
        vocab=256_000,
        act="relu2",
        gated_mlp=False,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-reduced",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        act="relu2",
        gated_mlp=False,
        compute_dtype="float32",
        remat="none",
    )
