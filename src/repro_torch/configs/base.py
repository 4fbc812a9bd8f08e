"""Model configs (counterpart of ``repro/configs/base.py``).

Every architecture is a ``ModelConfig`` in ``configs/<id>.py``, with the
same fields and values as the reference; ``dtype`` is a ``torch.dtype``
(bfloat16 by default, float32 in ``reduced``). The shape cells
(``SHAPES``, ``cells_for``) and ``input_specs`` say what a batch of each
cell holds: the names, shapes and dtypes the model's entry points take,
a frontend's ``features`` or ``patches`` among them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import torch


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int

    # attention flavor
    attn_type: str = "gqa"      # gqa | mla | none (attention-free)
    qk_norm: bool = False
    swa_window: int = 0         # 0 = full attention
    causal: bool = True         # False for encoder-only
    use_rope: bool = True       # Jamba uses no positional encoding
    rope_theta: float = 1_000_000.0
    mla: MLAConfig | None = None

    mlp_variant: str = "swiglu"   # swiglu (3 mats) | gelu (2 mats)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # expert hidden dim (may differ from d_ff)
    first_dense: int = 0        # first N layers use a dense FFN (Kimi K2)
    moe_period: int = 1         # MoE FFN every `moe_period` layers
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # hybrid (Jamba): layer i is attention iff i % attn_period == attn_offset
    attn_period: int = 1
    attn_offset: int = 0
    mamba: MambaConfig | None = None

    # rwkv
    rwkv_head_dim: int = 64

    # modality frontend (stubbed in the reference: embeddings fed directly)
    frontend: str = "none"      # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0  # e.g. 256 vision patch tokens

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16

    # training and sharding knobs, carried for the later slices
    remat: bool = True
    optimizer: str = "adamw"    # adamw | adafactor
    unroll: bool = False
    attn_chunk: int = 1024      # KV/Q chunk for online-softmax attention
    act_shard: str = "dmodel"
    fsdp: bool = True
    zero: int = 3
    moe_combine: str = "psum"
    microbatches: int = 1
    decode_sp: bool = False
    expert_parallel: bool = True

    @property
    def attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 512 (Megatron-style), as the
        reference pads its embedding and head."""
        return -(-self.vocab // 512) * 512

    @property
    def is_encoder(self) -> bool:
        return self.family == "encoder"

    def layer_kind(self, i: int) -> str:
        """'attn', 'mamba' or 'rwkv' mixer for layer i."""
        if self.attention_free:
            return "rwkv" if self.family == "ssm" else "mamba"
        if self.mamba is not None:  # hybrid
            return "attn" if i % self.attn_period == self.attn_offset \
                else "mamba"
        return "attn"

    def ffn_kind(self, i: int) -> str:
        """'mlp' or 'moe' FFN for layer i."""
        if self.n_experts and i >= self.first_dense and \
                i % self.moe_period == self.moe_offset:
            return "moe"
        return "mlp"

    def n_params(self) -> int:
        """Analytic parameter count (the reference's formula)."""
        d, L = self.d_model, self.n_layers
        total = self.vocab * d          # embedding
        if not self.tie_embeddings and not self.is_encoder:
            total += self.vocab * d     # lm head
        if self.is_encoder:
            total += self.vocab * d     # classifier head over small vocab
        for i in range(L):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.attn_type == "mla":
                    m = self.mla
                    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * m.q_lora_rank \
                        + m.q_lora_rank * self.n_heads * qk_head
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * self.d_head      # q
                    total += 2 * d * self.n_kv * self.d_head     # k, v
                    total += self.n_heads * self.d_head * d      # o
            elif kind == "mamba":
                mc = self.mamba
                d_in = mc.expand * d
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_in                 # in_proj
                total += d_in * mc.d_conv             # conv
                total += d_in * (dt_rank + 2 * mc.d_state)   # x_proj
                total += dt_rank * d_in + d_in        # dt_proj
                total += d_in * mc.d_state + d_in     # A, D
                total += d_in * d                     # out_proj
            elif kind == "rwkv":
                h = d // self.rwkv_head_dim
                total += 4 * d * d + d * d            # r,k,v,g,o (time mix)
                total += 5 * 32 * d * 2               # ddlerp loras (approx)
                total += 64 * d * 2                   # decay lora
                total += 2 * h * self.rwkv_head_dim   # u, ln params per head
            if kind != "rwkv":
                if self.ffn_kind(i) == "moe":
                    total += d * self.n_experts       # router
                    total += self.n_experts * 3 * d * self.d_expert
                else:
                    n_mats = 3 if self.mlp_variant == "swiglu" else 2
                    total += n_mats * d * self.d_ff
            else:
                total += d * int(3.5 * d) * 2         # rwkv channel mix
        return total


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class Cell:
    arch: str
    shape: ShapeConfig
    run: bool
    skip_reason: str = ""


def _subquadratic(cfg: ModelConfig) -> bool:
    """long_500k eligibility: SSM / hybrid / linear-attn / sliding-window."""
    return (cfg.family in ("ssm", "hybrid")) or (cfg.swa_window > 0)


def cells_for(cfg: ModelConfig) -> list[Cell]:
    out = []
    for shape in SHAPES.values():
        if shape.kind == "decode" and cfg.is_encoder:
            out.append(Cell(cfg.name, shape, False,
                            "encoder-only arch has no decode step"))
            continue
        if shape.name == "long_500k" and not _subquadratic(cfg):
            out.append(Cell(cfg.name, shape, False,
                            "pure full-attention arch; 500k decode needs "
                            "sub-quadratic attention (see DESIGN.md)"))
            continue
        out.append(Cell(cfg.name, shape, True))
    return out


# ---------------------------------------------------------------------------
# Input specs (tensors on the meta device, never allocated)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """Model inputs for one cell as ``meta`` tensors (the reference's
    ``jax.ShapeDtypeStruct``s): the names, shapes and dtypes a batch of
    the cell holds."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        # HuBERT-style: precomputed frame embeddings + mask + frame targets.
        return {
            "features": _spec((B, S, cfg.d_model), cfg.dtype),
            "mask": _spec((B, S), torch.bool),
            "targets": _spec((B, S), torch.int32),
        }
    if cfg.frontend == "vision_patches":
        P = cfg.n_frontend_tokens
        if shape.kind == "decode":
            return {
                "token": _spec((B, 1), torch.int32),
                "pos": _spec((B,), torch.int32),
            }
        return {
            "patches": _spec((B, P, cfg.d_model), cfg.dtype),
            "tokens": _spec((B, S - P), torch.int32),
            "targets": _spec((B, S - P), torch.int32),
        }
    if shape.kind == "decode":
        return {
            "token": _spec((B, 1), torch.int32),
            "pos": _spec((B,), torch.int32),
        }
    specs = {"tokens": _spec((B, S), torch.int32)}
    if shape.kind == "train":
        specs["targets"] = _spec((B, S), torch.int32)
    return specs


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family float32 config for CPU tests (the reference's
    ``reduced``, field for field)."""
    small: dict[str, Any] = dict(
        n_layers=max(2, cfg.attn_period) if cfg.mamba is not None else 2,
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 2) if cfg.n_kv > 1 else 1,
        d_head=16,
        d_ff=128,
        vocab=256,
        dtype=torch.float32,
        remat=False,
        fsdp=False,
    )
    if cfg.attn_type == "mla":
        small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                 qk_nope_head_dim=8, qk_rope_head_dim=8,
                                 v_head_dim=8)
    if cfg.n_experts:
        small["n_experts"] = 4
        small["top_k"] = 2
        small["d_expert"] = 64
    if cfg.mamba is not None:
        small["mamba"] = MambaConfig(d_state=4, d_conv=4, expand=2)
        small["n_layers"] = cfg.attn_period  # one full hybrid period
    if cfg.family == "ssm":
        small["rwkv_head_dim"] = 16
    if cfg.frontend == "vision_patches":
        small["n_frontend_tokens"] = 4
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
