"""Kimi K2 — trillion-param MoE (assigned spec: GQA kv=8, 384e top-8).

61L d_model=7168 64H (GQA kv=8) expert d_ff=2048 vocab=163840, MoE 384
experts top-8, first layer dense (dense d_ff uses the standard 4x-ish
intermediate so the dense layer is not degenerate). Adafactor optimizer:
Adam moments for ~1T params cannot fit 256 x 16 GB HBM (see DESIGN.md).
[arXiv:2501.kimi2; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=18432,            # dense FFN width for the first (dense) layer
    vocab=163840,
    n_experts=384,
    top_k=8,
    d_expert=2048,
    first_dense=1,
    rope_theta=1_000_000.0,
    optimizer="adafactor",
)
