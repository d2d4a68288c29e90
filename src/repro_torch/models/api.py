"""Model configuration and the family dispatch of the port's LM zoo.

A copy of :mod:`repro.models.api` for the families ported so far
(``"rwkv"``, ``"hybrid"`` and ``"dense"``).
``get_family(cfg)`` returns the module implementing the family protocol:

    init(cfg, generator, device)            -> parameters (an nn.Module)
    forward(cfg, params, tokens, ...)       -> (logits, state or aux)
    init_cache(cfg, batch, max_len, device) -> decode cache (dict of tensors)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)

Only the fields the ported families read are copied; the MoE routing,
encoder-decoder and VLM fields and the JAX execution knobs (``remat``,
``scan_layers``, ``kernel_impl``) come with the code that reads them.
``n_experts`` is copied so that a mixture-of-experts configuration is
refused rather than run as a dense one.  ``ShapeSpec`` and the sharding
helpers wait for the distributed path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, family knobs and execution knobs."""

    name: str
    family: str  # rwkv | hybrid | dense ported; moe | encdec not yet
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention
    tie_embeddings: bool = False
    # --- MoE (not ported: a configuration with experts is refused) -------------
    n_experts: int = 0
    # --- RWKV6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora: int = 32
    # --- Mamba2 / hybrid -----------------------------------------------------
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    attn_every: int = 0  # hybrid: shared attention block every N layers
    # --- execution knobs ---------------------------------------------------------
    compute_dtype: str = "bfloat16"
    ssm_chunk: int = 64
    scan_dtype: str = "float32"  # dtype of the SaP-scan tensors
    attn_block_k: int = 512

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 512, as the JAX package pads it
        (logits are sliced back to ``vocab`` where tokens are chosen)."""
        return -(-self.vocab // 512) * 512

    @property
    def head_dim(self) -> int:
        """Attention head width."""
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def cdtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]

    @property
    def sdtype(self) -> torch.dtype:
        """The dtype of the SaP-scan tensors (WKV / SSD inputs)."""
        return torch.bfloat16 if self.scan_dtype == "bfloat16" else torch.float32

    def params_count(self) -> int:
        """Approximate parameter count (embeddings included), the JAX
        package's formula."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.family == "dense" and not self.n_experts:
            blk = attn + d * f * (3 if self.gated_mlp else 2)
            return v * d * (1 if self.tie_embeddings else 2) + self.n_layers * blk
        if self.family == "rwkv":
            att = 4 * d * d + 2 * d * self.rwkv_lora * 6
            ffn = 2 * d * f + d * d
            return v * d * 2 + self.n_layers * (att + ffn)
        if self.family == "hybrid":
            din = self.ssm_expand * d
            h = din // self.ssm_head_dim
            mix = d * (2 * din + 2 * self.ssm_state + h) + din * d
            shared = attn + d * f * 3
            return v * d * 2 + self.n_layers * mix + shared
        raise NotImplementedError(f"family {self.family!r} is not ported yet")


def get_family(cfg: ModelConfig):
    """The module implementing ``cfg``'s family."""
    if cfg.family == "rwkv":
        from . import rwkv

        return rwkv
    if cfg.family == "hybrid":
        from . import mamba

        return mamba
    if cfg.family == "dense" and not cfg.n_experts:
        from . import transformer

        return transformer
    if cfg.family in ("dense", "moe", "encdec"):
        what = "mixture of experts" if cfg.n_experts else f"family {cfg.family!r}"
        raise NotImplementedError(f"{what} is not ported yet")
    raise ValueError(f"unknown family {cfg.family!r}")
