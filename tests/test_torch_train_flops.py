"""chip_smoke.py's ``model_flops`` (the model FLOPs of one training step
that its ``train-*`` phases print as a share of 989 TFLOP/s) against a
count by hand from the config, on parameters made on ``meta``.

An MoE layer's experts count at their active share: each token runs
through top_k of the n_experts experts' ``w_gate``/``w_up``/``w_down``;
the router counts whole. A Mamba layer counts its 2-D leaves: its four
projections, and ``A_log`` and ``conv_w`` for the scan's elementwise
work. Attention adds 3 B H T^2 (dq + dv) a causal layer. Reduced
configs and the full-width two-layer cuts the card trains (mixtral-8x7b,
jamba-v0.1-52b with ``tests/_train_ref.py``'s OVERRIDES) are both
counted; qwen3-8b pins the dense count.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs import get_config, reduced
from repro_torch.models import model as M
from tests._train_ref import OVERRIDES

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hand_count(cfg, B, T):
    d = cfg.d_model
    attn = d * cfg.n_heads * cfg.d_head + 2 * d * cfg.n_kv * cfg.d_head \
        + cfg.n_heads * cfg.d_head * d
    mats = 0
    for kind, ffn in M.layer_kinds(cfg):
        if kind == "attn":
            mats += attn
        else:
            mc = cfg.mamba
            d_in, n, k = mc.expand * d, mc.d_state, mc.d_conv
            dt_rank = mc.dt_rank or -(-d // 16)
            mats += (d * 2 * d_in + k * d_in + d_in * (dt_rank + 2 * n)
                     + dt_rank * d_in + d_in * n + d_in * d)
        if ffn == "moe":
            mats += d * cfg.n_experts + 3 * cfg.top_k * d * cfg.d_expert
        else:
            mats += 3 * d * cfg.d_ff
    head = cfg.padded_vocab * d
    n_attn = sum(kind == "attn" for kind, _ in M.layer_kinds(cfg))
    return 6 * B * T * (mats + head) \
        + n_attn * 3 * B * cfg.n_heads * T * T * 2 * cfg.d_head


def _cut(chip_smoke, arch, width):
    over = dict(n_layers=chip_smoke.TRAIN_LAYERS[arch],
                **chip_smoke.TRAIN_PERIOD.get(arch, {}))
    full = get_config(arch)
    if width == "reduced":
        return reduced(full, **over), (2, 16)
    return dataclasses.replace(full, **over), chip_smoke.TRAIN_SHAPE.get(
        arch, (chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ))


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "jamba-v0.1-52b",
                                  "qwen3-8b"])
def test_model_flops_counts_the_active_experts(chip_smoke, arch, width):
    cfg, (B, T) = _cut(chip_smoke, arch, width)
    params = M.init_params(cfg, 0, device="meta")
    got = chip_smoke.model_flops(cfg, params, B, T, M.layer_kinds(cfg))
    assert got == _hand_count(cfg, B, T)
    if cfg.n_experts and width == "full":
        # every expert counted would read top_k / n_experts of it
        dense = dataclasses.replace(cfg, top_k=cfg.n_experts)
        assert chip_smoke.model_flops(dense, params, B, T,
                                      M.layer_kinds(cfg)) > 3 * got


def test_the_card_trains_the_cut_the_cpu_holds(chip_smoke):
    """train-jamba-v0.1-52b's layers are the ones
    tests/test_torch_train_moe.py holds against the reference."""
    arch = "jamba-v0.1-52b"
    assert dict(n_layers=chip_smoke.TRAIN_LAYERS[arch],
                **chip_smoke.TRAIN_PERIOD[arch]) == OVERRIDES[arch]
    cfg, _ = _cut(chip_smoke, arch, "full")
    assert M.layer_kinds(cfg) == [("mamba", "mlp"), ("attn", "moe")]
