"""The port's LM zoo: RWKV6 and the Zamba2 hybrid (Mamba-2 + shared
attention), each running its sequence mixer on a hand-written CUDA
SaP-scan kernel (:mod:`repro_torch.kernels.wkv`, :mod:`repro_torch.kernels.ssd`)."""

from .api import ModelConfig, get_family

__all__ = ["ModelConfig", "get_family"]
