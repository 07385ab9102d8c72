"""Model configuration for the assigned architecture zoo.

One frozen dataclass covers every family (dense / MoE / MLA / SSM / hybrid /
VLM / enc-dec audio); family-specific knobs live in optional sub-configs.
``repro_torch.configs.<arch>`` modules instantiate these with the exact
assigned hyperparameters; ``reduced()`` shrinks any config for CPU smoke
tests.  The port's own copy of ``repro.models.config``: pure data, no
torch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_ff_expert: int = 0          # routed expert hidden dim
    capacity_factor: float = 1.25
    moe_every: int = 1            # 2 = interleaved (dense, MoE) layer pairs


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM (arXiv:2312.00752)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or -(-d_model // 16)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 12
    encoder_frames: int = 1500    # Whisper 30 s @ 50 Hz (stub frontend)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|hybrid|ssm|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    attention: str = "gqa"        # gqa|mla|none
    qkv_bias: bool = False
    activation: str = "swiglu"    # swiglu|geglu|gelu
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    hybrid_parallel_ssm: bool = False      # Hymba: attn ∥ mamba heads
    subquadratic: bool = False             # eligible for long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (per spec: small
        layers/width/experts/embeddings; same code paths)."""
        kw = dict(
            n_layers=2, d_model=64,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=max(1, min(2, self.n_kv_heads or 1)),
            d_ff=128, vocab_size=256, head_dim=16)
        if self.moe:
            kw["moe"] = dataclasses.replace(self.moe, n_experts=4,
                                            top_k=min(2, self.moe.top_k),
                                            d_ff_expert=64)
        if self.mla:
            kw["mla"] = MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                  qk_nope_dim=16, qk_rope_dim=8,
                                  v_head_dim=16)
        if self.ssm:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=8)
        if self.encdec:
            kw["encdec"] = dataclasses.replace(self.encdec,
                                               n_encoder_layers=2,
                                               encoder_frames=16)
        if self.sliding_window:
            kw["sliding_window"] = 8
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train|prefill|decode


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4096, 256, "train"),
    ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    ShapeSpec("decode_32k", 32768, 128, "decode"),
    ShapeSpec("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Dry-run applicability per the assignment rules."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is full-attention (skip per spec)")
    return True, ""
