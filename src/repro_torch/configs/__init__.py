"""Architecture registry of the port: ``get_config(name, reduced)``.

Each module defines ``full()`` (the published configuration, as in the JAX
package's ``repro.configs``) and ``reduced()`` (a same-family miniature for
CPU tests).  Every architecture of the JAX package's registry is listed,
in its order.
"""

from __future__ import annotations

from ..models.api import ModelConfig
from . import (
    deepseek_moe_16b,
    minitron_8b,
    mixtral_8x22b,
    phi3_mini_3_8b,
    phi3_vision_4_2b,
    rwkv6_1_6b,
    sap_solver,
    stablelm_1_6b,
    starcoder2_15b,
    whisper_medium,
    zamba2_2_7b,
)

ARCHS = {
    "rwkv6-1.6b": rwkv6_1_6b,
    "mixtral-8x22b": mixtral_8x22b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "stablelm-1.6b": stablelm_1_6b,
    "minitron-8b": minitron_8b,
    "starcoder2-15b": starcoder2_15b,
    "zamba2-2.7b": zamba2_2_7b,
    "phi-3-vision-4.2b": phi3_vision_4_2b,
    "whisper-medium": whisper_medium,
}

SOLVER_ARCHS = {"sap-solver": sap_solver}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    """The full (or reduced) configuration of architecture ``name``."""
    mod = ARCHS[name]
    return mod.reduced() if reduced else mod.full()


def arch_names() -> list[str]:
    """Names of the architectures."""
    return list(ARCHS)
