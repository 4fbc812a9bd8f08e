"""MiniCPM3-4B — dense with Multi-head Latent Attention (MLA).

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA: q_lora 768, kv_lora 256,
rope 32 + nope 64 per head, v_head 64. Decode uses the absorbed-weight
latent-cache formulation (cache = c_kv + k_rope only).
[hf:openbmb/MiniCPM3-4B; hf]"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv=40,
    d_head=64,
    d_ff=6400,
    vocab=73448,
    attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                  qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64),
    rope_theta=1_000_000.0,
)
