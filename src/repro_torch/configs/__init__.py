"""Architecture registry of the port: ``get_config(name, reduced)``.

Each module defines ``full()`` (the published configuration, as in the JAX
package's ``repro.configs``) and ``reduced()`` (a same-family miniature for
CPU tests).  Only the architectures whose family is ported are listed.
"""

from __future__ import annotations

from ..models.api import ModelConfig
from . import (
    minitron_8b,
    phi3_mini_3_8b,
    rwkv6_1_6b,
    stablelm_1_6b,
    starcoder2_15b,
    zamba2_2_7b,
)

ARCHS = {
    "rwkv6-1.6b": rwkv6_1_6b,
    "phi3-mini-3.8b": phi3_mini_3_8b,
    "stablelm-1.6b": stablelm_1_6b,
    "minitron-8b": minitron_8b,
    "starcoder2-15b": starcoder2_15b,
    "zamba2-2.7b": zamba2_2_7b,
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    """The full (or reduced) configuration of architecture ``name``."""
    if name not in ARCHS:
        raise NotImplementedError(f"architecture {name!r} is not ported yet")
    mod = ARCHS[name]
    return mod.reduced() if reduced else mod.full()


def arch_names() -> list[str]:
    """Names of the ported architectures."""
    return list(ARCHS)
