"""Model configuration, the workload shapes and the family dispatch of the
port's LM zoo.

A copy of :mod:`repro.models.api` for every family: ``"rwkv"``,
``"hybrid"``, ``"dense"`` and ``"moe"`` (both served by
:mod:`.transformer`) and ``"encdec"`` (:mod:`.whisper`).
``get_family(cfg)`` returns the module implementing the family protocol:

    init(cfg, generator, device)            -> parameters (an nn.Module)
    forward(cfg, params, tokens or batch)   -> (logits, state or aux)
    loss(cfg, params, batch)                -> (scalar loss, {"nll", "aux"})
    init_cache(cfg, batch, max_len, device) -> decode cache (dict of tensors)
    decode_step(cfg, params, cache, tokens) -> (logits, cache)

Every family's ``forward`` and ``loss`` also take a rank ``mesh``
(:mod:`.sharded`).  Every configuration field is copied but the JAX
execution knobs ``scan_layers`` and ``kernel_impl``, which have no
counterpart here.  ``remat`` rematerializes each layer of a training
forward (:func:`.layers.remat`, ``torch.utils.checkpoint``);
``expert_sharding`` picks the MoE layer's split over "model".
``ShapeSpec`` and ``SHAPES``
feed :func:`repro_torch.launch.roofline.model_flops`; ``dp_axes`` /
``dp_axes_for`` read a rank mesh (:mod:`repro_torch.launch.mesh`) and
``supports_shape`` says which shapes a family can run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture: widths, family knobs and execution knobs."""

    name: str
    family: str  # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default d_model // n_heads
    act: str = "silu"
    gated_mlp: bool = True
    norm: str = "rms"
    rope_theta: float = 10_000.0
    window: Optional[int] = None  # sliding-window attention
    tie_embeddings: bool = False
    # --- MoE ---------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"  # "ep" (experts split over "model") | "tp" (F split)
    router_aux_coef: float = 0.01
    moe_group: int = 512  # token group size of the GShard-style dispatch
    # --- RWKV6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    rwkv_lora: int = 32
    # --- Mamba2 / hybrid -----------------------------------------------------
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    attn_every: int = 0  # hybrid: shared attention block every N layers
    # --- encoder-decoder -------------------------------------------------------
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- VLM stub ---------------------------------------------------------------
    n_patches: int = 0  # precomputed patch embeddings prepended to text
    # --- execution knobs ---------------------------------------------------------
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
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
        if self.family in ("dense", "moe", "encdec"):
            mlp = d * f * (3 if self.gated_mlp else 2)
            if self.n_experts:
                routed = self.n_experts * mlp
                shared = self.n_shared_experts * mlp
                router = d * self.n_experts
                blk = attn + routed + shared + router
            else:
                blk = attn + mlp
            n_blocks = self.n_layers + self.n_enc_layers
            extra = self.n_enc_layers * attn  # cross-attention (rough)
            return v * d * (1 if self.tie_embeddings else 2) + n_blocks * blk + extra
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
        raise ValueError(self.family)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """A workload shape: sequence length, global batch and kind."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def dp_axes(mesh):
    """Data-parallel mesh axes present on this mesh (a
    :class:`repro_torch.launch.mesh.Mesh`, or anything with a ``shape``
    mapping of axis names): ("pod", "data") on the multi-pod production
    mesh, "data" on one pod, None on a mesh with neither."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def dp_axes_for(mesh, batch: int):
    """dp_axes, but only if ``batch`` divides across them (long_500k has
    global_batch=1: the batch dimension is replicated)."""
    dp = dp_axes(mesh)
    if dp is None:
        return None
    axes = dp if isinstance(dp, tuple) else (dp,)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return dp if batch % size == 0 else None


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    """long_500k decode needs a sub-quadratic sequence mixer: an SSM or
    linear-attention state, or a sliding window.  Pure full-attention
    architectures skip it."""
    if shape.name != "long_500k":
        return True
    return cfg.family in ("rwkv", "hybrid") or cfg.window is not None


def get_family(cfg: ModelConfig):
    """The module implementing ``cfg``'s family."""
    if cfg.family in ("dense", "moe"):
        from . import transformer

        return transformer
    if cfg.family == "rwkv":
        from . import rwkv

        return rwkv
    if cfg.family == "hybrid":
        from . import mamba

        return mamba
    if cfg.family == "encdec":
        from . import whisper

        return whisper
    raise ValueError(f"unknown family {cfg.family!r}")
