"""InternVL2-Llama3-76B — VLM; this config is the LLM BACKBONE only.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. The InternViT
vision tower is a STUB: input_specs() provides precomputed patch
embeddings (B, 256, d_model) fused at the front of the sequence.
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    frontend="vision_patches",
    n_frontend_tokens=256,
    rope_theta=500_000.0,
)
