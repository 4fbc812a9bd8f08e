"""HuBERT X-Large — encoder-only audio transformer.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-frame cluster
targets). The CNN waveform frontend is a STUB, as in the reference:
``repro_torch.configs.base.input_specs`` feeds precomputed frame
embeddings (B, T, d_model), which ``models.model`` takes as they are.
Bidirectional attention, masked-prediction CE loss; no decode shapes.
[arXiv:2106.07447; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv=16,
    d_head=80,
    d_ff=5120,
    vocab=504,
    mlp_variant="gelu",   # classic transformer-encoder 2-matrix FFN
    causal=False,
    frontend="audio_frames",
    rope_theta=10_000.0,
)
