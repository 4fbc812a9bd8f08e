"""RWKV-6 "Finch" 7B — attention-free RNN with data-dependent decay.

32L d_model=4096, head_dim 64 (64 heads), channel-mix ratio 3.5,
vocab=65536. O(1) decode state -> runs long_500k. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # d_model / rwkv_head_dim
    n_kv=64,
    d_head=64,
    d_ff=14336,          # channel-mix hidden (~3.5x)
    vocab=65536,
    attn_type="none",
    rwkv_head_dim=64,
)
