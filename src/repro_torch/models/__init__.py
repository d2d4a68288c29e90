"""The port's LM zoo: RWKV6 and the Zamba2 hybrid (Mamba-2 + shared
attention), each running its sequence mixer on a hand-written CUDA
SaP-scan kernel (:mod:`repro_torch.kernels.wkv`, :mod:`repro_torch.kernels.ssd`),
and the dense, MoE and VLM-stub transformers and the whisper
encoder-decoder, whose prompt passes run their attention on the
hand-written flash kernel (:mod:`repro_torch.kernels.flash_attn`)."""

from .api import SHAPES, ModelConfig, ShapeSpec, dp_axes, get_family, supports_shape

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "dp_axes", "get_family", "supports_shape"]
