"""Granite-34B-Code — llama-arch dense with MQA (kv=1).

88L d_model=6144 48H (kv=1) d_ff=24576 vocab=49152. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    mlp_variant="gelu",   # GPTBigCode-style 2-matrix MLP
    rope_theta=10_000.0,
)
