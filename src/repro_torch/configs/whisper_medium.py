"""whisper-medium -- encoder-decoder audio backbone; conv frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]  24L d=1024 16H d_ff=4096 vocab=51865."""

from ..models.api import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium",
        family="encdec",
        n_layers=24,  # decoder layers
        n_enc_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab=51_865,
        act="gelu",
        gated_mlp=False,
        norm="ln",
        enc_seq=1500,
        tie_embeddings=True,
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-reduced",
        family="encdec",
        n_layers=2,
        n_enc_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        act="gelu",
        gated_mlp=False,
        norm="ln",
        enc_seq=32,
        tie_embeddings=True,
        compute_dtype="float32",
        remat="none",
    )
