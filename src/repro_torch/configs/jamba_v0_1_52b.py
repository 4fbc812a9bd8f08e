"""Jamba v0.1 52B — hybrid Mamba + attention (1:7) with MoE (16e top-2).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536. Attention at
layer i where i % 8 == 4 (attn_layer_period=8, offset=4); MoE FFN every
other layer (period 2, offset 1). Mamba: d_state 16, conv 4, expand 2.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_head=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    d_expert=14336,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    use_rope=False,       # Jamba has no positional encoding (Mamba provides it)
    rope_theta=10_000.0,
)
