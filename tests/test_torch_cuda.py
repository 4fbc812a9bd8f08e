"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels
are built with nvcc at first use); without a card each skips. The file
imports neither JAX nor the JAX package, so it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances (abs and rel against the plain version): switch_step and
switch_tiers hold integers exactly and floats within 4 float32 ulp, but
for switch_tiers' cross-row sums: to_csw and fc_in sum n racks (CSWs) in
index order where the plain version's torch.sum takes another order, so
they are held to n + 3 ulp of their value ((n - 1) ulp bounds two orders
of n non-negative terms, 4 more the terms' own), the CSW tier is held
at 4 ulp on the kernel's own to_csw, and the accumulators (sums of up to
2 R P 2 + 2 non-negative terms, in a per-thread-then-tree order) to
that many ulp plus 4. flash_attention
2e-5 in float32 (summation order) and 2e-2 in bfloat16 (that order
flips roundings of the bf16 output), as tests/test_kernels.py holds the
TPU kernel; wkv y 2e-3 in float32 and 5e-2 in bfloat16, the state 2e-3
and, since the kernel updates it in the plain version's order of
roundings, exactly. The float64 switch kernels (the x64 mode) are held
as the float32 ones, in float64 ulp.

The sweep-engine tests hold the card's execution layer to itself, bit
for bit: a checkpoint taken while the tick replays from a CUDA graph
against the eager run's carry at the same boundary, a resume against the
uninterrupted run, pipelined buckets against serial ones; a retried
bucket (eager, host fold, on the card) within 1e-6 of the clean run. A
sweep laid over two views of the card (``_local_devices`` replaced)
equals the one-device run within 1e-6, with one capture and one block of
launches per view and one fold fetch; a checkpoint of it resumes on one
view bit for bit.

The analytic models on the card against the port's own CPU run: the
Fig 7 samplers (the mixture pick bit for bit, sizes and intervals within
4e-6 relative: the exponent's float32 ulp in ``exp``, as
tests/test_torch_traffic.py holds the CPU against the reference) and
``reactive_policy`` (its CUDA-graph run equal to its eager run; the
powered link-ticks exact against the CPU, the stall within 1e-6).

The dry run (``launch.dryrun``): rank 0 of a 2 x 2 mesh on the fake
process group, a reduced bf16 qwen3-8b train step run on the card
through the kernels, counts (FLOPs, bytes, collectives) equal to the
same step's on ``meta``, exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import checkpoint as CK
from repro_torch.core import ici_gating as I
from repro_torch.core import prng
from repro_torch.core import simulator as S
from repro_torch.core import traffic as T
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.kernels import (flash_attention, lcdc_switch, ops, ref,
                                 rwkv6_wkv)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import dist_for, fake_world, make_test_mesh

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WKV_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
#: the backward kernels against their plain versions, as a share of
#: each gradient's largest magnitude: float32 sums in another order
#: (1e-3, chip_smoke's bound; measured far below), and in bfloat16 the
#: gradients' own rounding (2^-9) grown by sums over the sequence
ATTN_BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
WKV_BWD_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
#: the rows' log-sum-exp, abs and rel: float32 sums of the scores in
#: another order
LSE_TOL = 1e-4
ULP = 2.0 ** -23
ULP64 = 2.0 ** -52
#: the golden capture's site (tests/data/preflow_golden.json)
GOLDEN_SITE = FBSite(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                     csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                     fc_ring_links=8)
#: sites of the switch_tiers cases: the paper's Fig 2 site, and a
#: padded hull of it with a site of 5 planes and 3 FCs
TIER_SITES = {
    "fbsite": (FBSite(),),
    "padded": (FBSite(), FBSite(n_clusters=2, racks_per_cluster=40,
                                csw_per_cluster=5, n_fc=3)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,d,causal,window,dtype", [
    (8, 256, 32, 128, True, 0, "bfloat16"),
    (1, 200, 32, 128, True, 0, "bfloat16"),
    (1, 384, 32, 128, True, 128, "bfloat16"),
    (2, 100, 3, 80, False, 0, "float32"),
    (2, 200, 16, 80, False, 0, "bfloat16"),   # hubert: the wgmma variant
    (1, 128, 2, 32, False, 32, "float32"),
    (1, 64, 2, 16, True, 0, "float32"),
])
def test_flash_kernel_vs_plain_version(cuda, B, T, H, d, causal, window,
                                       dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn((B, T, H, d), generator=g, device=cuda)
               .to(getattr(torch, dtype)) for _ in range(3))
    before = flash_attention.LAUNCHES
    got = ops.attention(q, k, v, causal=causal, swa_window=window)
    want = ref.attention_ref(q, k, v, causal=causal, swa_window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.dtype == q.dtype
    _close(got, want, ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,d,causal,window", [
    (8, 256, 32, 128, True, 0),       # the batched prefill
    (1, 200, 32, 128, True, 0),       # ragged, not a multiple of 64
    (1, 100, 32, 128, True, 0),
    (1, 384, 32, 128, True, 128),     # causal with a window
    (1, 128, 32, 128, False, 0),      # non-causal
    (2, 200, 8, 64, True, 0),         # d = 64
    (2, 100, 8, 64, False, 0),
    (2, 200, 16, 80, False, 0),       # hubert's d = 80, ragged
    (8, 512, 16, 80, False, 0),       # hubert's batched encode
    (1, 64, 16, 80, False, 0),
])
def test_flash_wgmma_variant_vs_plain_version(cuda, B, T, H, d, causal,
                                              window):
    """bf16 at d 64, 80 or 128 goes through the tensor-core variant (its
    counter moves, the CUDA-core one's does not) and agrees with the
    plain version; so does the CUDA-core variant on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((B, T, H, d), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    assert flash_attention.variant(q.dtype, d, d) == "wgmma"
    before = dict(flash_attention.VARIANT_LAUNCHES)
    got = ops.attention(q, k, v, causal=causal, swa_window=window)
    torch.cuda.synchronize()
    assert flash_attention.VARIANT_LAUNCHES == {
        "wgmma": before["wgmma"] + 1, "cuda_core": before["cuda_core"]}
    want = ref.attention_ref(q, k, v, causal=causal, swa_window=window)
    _close(got, want, ATTN_TOL["bfloat16"])
    first = flash_attention._flash_attention_variant(
        q, k, v, "cuda_core", causal=causal, swa_window=window)
    _close(first, want, ATTN_TOL["bfloat16"])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dq,dv,causal,dtype,picked", [
    (1, 64, 40, 96, 64, True, "bfloat16", "wgmma"),   # minicpm3-4b's MLA
    (1, 384, 40, 96, 64, True, "bfloat16", "wgmma"),
    (8, 256, 40, 96, 64, True, "bfloat16", "wgmma"),
    (1, 200, 40, 96, 64, True, "float32", "cuda_core"),
    (2, 100, 4, 96, 64, False, "bfloat16", "wgmma"),
    (1, 200, 40, 96, 64, True, "bfloat16", "wgmma"),  # T % 64 != 0
    (3, 130, 5, 96, 64, False, "bfloat16", "wgmma"),
    (1, 130, 2, 32, 48, True, "float32", "cuda_core"),  # dv > dq
])
def test_flash_kernel_dv_unlike_dq_vs_plain_version(cuda, B, T, H, dq, dv,
                                                    causal, dtype, picked):
    """v's head dim unlike q's: the variant ``variant`` picks launches
    (the wgmma one for MLA's bfloat16 (96, 64), the CUDA-core one
    otherwise), the output is (B, T, H, dv) and agrees with the plain
    version; where wgmma ran, the CUDA-core variant agrees too, and
    elsewhere the wgmma one refuses the inputs."""
    g = torch.Generator(device=cuda).manual_seed(4)
    dt = getattr(torch, dtype)
    q, k = (torch.randn((B, T, H, dq), generator=g, device=cuda).to(dt)
            for _ in range(2))
    v = torch.randn((B, T, H, dv), generator=g, device=cuda).to(dt)
    assert flash_attention.variant(dt, dq, dv) == picked
    before = dict(flash_attention.VARIANT_LAUNCHES)
    got = ops.attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.VARIANT_LAUNCHES == {
        n: c + (n == picked) for n, c in before.items()}
    assert got.dtype == dt and tuple(got.shape) == (B, T, H, dv)
    _close(got, want, ATTN_TOL[dtype])
    if picked == "wgmma":
        _close(flash_attention._flash_attention_variant(
            q, k, v, "cuda_core", causal=causal), want, ATTN_TOL[dtype])
    else:
        with pytest.raises(ValueError, match="wgmma variant"):
            flash_attention._flash_attention_variant(q, k, v, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,causal,window", [
    (1, 200, 200, 3, True, 0),      # causal, ragged T
    (2, 100, 160, 4, False, 0),     # T != S, both ragged
    (1, 200, 200, 3, True, 48),     # a window
])
@pytest.mark.parametrize("name", ["wgmma", "cuda_core"])
def test_flash_backward_variants_at_mla_head_dims(cuda, B, T, S, H, causal,
                                                  window, name):
    """MLA's bf16 (96, 64) (minicpm3-4b's training): the backward through
    each design (the wgmma one ``bwd_variant`` picks, and the CUDA-core
    first design on the same inputs) from the wgmma forward's output and
    log-sum-exp (within LSE_TOL of the plain one), against
    ``ref.attention_bwd_ref``, each gradient within ATTN_BWD_TOL of its
    largest magnitude; only the named variant's count moves, and a
    second call gives the same bits."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dt)
                   for shape in ((B, T, H, 96), (B, S, H, 96),
                                 (B, S, H, 64), (B, T, H, 64)))
    assert flash_attention.variant(dt, 96, 64) == "wgmma"
    assert flash_attention.bwd_variant(dt, 96, 64) == "wgmma"
    out, lse = flash_attention.flash_attention_lse(q, k, v, causal=causal,
                                                   swa_window=window)
    before = dict(flash_attention.BWD_VARIANT_LAUNCHES)
    runs = [flash_attention._flash_attention_bwd_variant(
        q, k, v, out, lse, do, name, causal=causal, swa_window=window)
        for _ in range(2)]
    torch.cuda.synchronize()
    assert flash_attention.BWD_VARIANT_LAUNCHES == {
        n: c + 2 * (n == name) for n, c in before.items()}
    plain_lse = ref.attention_lse_ref(q, k, causal=causal,
                                      swa_window=window)
    _close(lse, plain_lse, LSE_TOL)
    want = ref.attention_bwd_ref(q, k, v, out, plain_lse, do, causal=causal,
                                 swa_window=window)
    for label, got, w, g2 in zip("qkv", runs[0], want, runs[1]):
        assert got.dtype == dt and got.shape == w.shape
        assert torch.equal(got, g2), f"d{label} differs between two runs"
        assert _rel_err(got, w) <= ATTN_BWD_TOL["bfloat16"], label


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minicpm3-4b", "mixtral-8x7b",
                                  "jamba-v0.1-52b"])
def test_new_families_through_the_kernels(cuda, arch):
    """Reduced float32 MLA, MoE and Mamba models on the card: prefill
    through the kernels (flash once per attention layer) within 1e-4 of
    the plain path's logits scale, and decode steps from its cache equal
    to the plain path's."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = dataclasses.replace(reduced(get_config(arch)), n_layers=8)
    params = M.init_params(cfg, 0, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(0))
    n_attn = sum(kind == "attn" for kind, _ in M.layer_kinds(cfg))
    before = flash_attention.LAUNCHES
    kern, kc = M.prefill(cfg, params, {"tokens": toks},
                         kernel_fns=ops.model_kernel_fns())
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + n_attn > before
    plain, pc = M.prefill(cfg, params, {"tokens": toks})
    scale = float(plain.abs().max())
    assert float((kern - plain).abs().max()) <= 1e-4 * scale
    caches = []
    for pre in (kc, pc):
        c = M.init_cache(cfg, 2, 48, device=cuda)
        M.write_cache(c, pre)
        caches.append(c)
    tok = torch.argmax(plain, -1)[:, None]
    for t in range(40, 43):
        pos = torch.full((2,), t, dtype=torch.int32, device=cuda)
        a, caches[0] = M.decode_step(cfg, params, caches[0], tok, pos,
                                     kernel_fns=ops.model_kernel_fns())
        b, caches[1] = M.decode_step(cfg, params, caches[1], tok, pos)
        assert float((a - b).abs().max()) <= 1e-4 * scale
        tok = torch.argmax(b, -1)[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dh,dtype", [
    (1, 256, 64, 64, "bfloat16"),
    (4, 1, 64, 64, "bfloat16"),
    (2, 100, 64, 64, "bfloat16"),
    (2, 64, 3, 16, "float32"),
    (1, 33, 2, 8, "float32"),
])
def test_wkv_kernel_vs_plain_version(cuda, B, T, H, dh, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)

    def n(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    dt = getattr(torch, dtype)
    args = ((n(B, T, H, dh) * 0.5).to(dt), (n(B, T, H, dh) * 0.5).to(dt),
            n(B, T, H, dh).to(dt),
            torch.exp(-torch.exp(n(B, T, H, dh) * 0.5)).to(dt),
            (n(H, dh) * 0.3).to(dt), n(B, H, dh, dh) * 0.1)
    before = rwkv6_wkv.LAUNCHES
    y, s = ops.wkv(*args)
    y_ref, s_ref = ref.wkv_ref(*args)
    torch.cuda.synchronize()
    assert rwkv6_wkv.LAUNCHES == before + 1
    _close(y, y_ref, WKV_TOL[dtype])
    _close(s, s_ref, 2e-3)
    assert torch.equal(s, s_ref)


def _wkv_args(device, B, T, H, dh, dt, seed):
    g = torch.Generator(device=device).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=device)

    return ((n(B, T, H, dh) * 0.5).to(dt), (n(B, T, H, dh) * 0.5).to(dt),
            n(B, T, H, dh).to(dt),
            torch.exp(-torch.exp(n(B, T, H, dh) * 0.5)).to(dt),
            (n(H, dh) * 0.3).to(dt), n(B, H, dh, dh) * 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", rwkv6_wkv.GROUPS)
@pytest.mark.parametrize("splits", rwkv6_wkv.SPLITS)
@pytest.mark.parametrize("B,T", [(4, 1), (2, 100), (8, 256)])
def test_wkv_every_layout_keeps_the_state_exact(cuda, B, T, groups, splits):
    """Every (threads per column, blocks per head) layout the wrapper
    can pick: the final state equals the plain version's bit for bit,
    y is within the bf16 band."""
    args = _wkv_args(cuda, B, T, 64, 64, torch.bfloat16, 3)
    y, s = rwkv6_wkv._wkv_planned(*args, groups, splits)
    y_ref, s_ref = ref.wkv_ref(*args)
    torch.cuda.synchronize()
    assert float((s - s_ref).abs().max()) == 0.0
    _close(y, y_ref, WKV_TOL["bfloat16"])


def _rel_err(got, want):
    """max |got - want| over max |want|."""
    scale = float(want.abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,d,causal,window,dtype", [
    (2, 256, 4, 128, True, 0, "bfloat16"),        # the wgmma variant
    (1, 200, 3, 64, True, 64, "bfloat16"),
    (2, 100, 3, 80, False, 0, "float32"),         # the CUDA-core variant
    (1, 130, 2, 96, True, 48, "float32"),
    (2, 100, 3, 80, False, 0, "bfloat16"),        # hubert's, wgmma
])
def test_flash_lse_vs_plain_version(cuda, B, T, H, d, causal, window,
                                    dtype):
    """The forward's rows' log-sum-exp (training's) against the plain
    logsumexp of the scaled scores; the output is serving's, bit for
    bit."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((B, T, H, d), generator=g, device=cuda)
               .to(getattr(torch, dtype)) for _ in range(3))
    out, lse = flash_attention.flash_attention_lse(
        q, k, v, causal=causal, swa_window=window)
    want = ref.attention_lse_ref(q, k, causal=causal, swa_window=window)
    served = flash_attention.flash_attention(q, k, v, causal=causal,
                                             swa_window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, served)
    _close(lse, want, LSE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dq,dv,causal,window,dtype", [
    (2, 256, 4, 128, 128, True, 0, "bfloat16"),   # wgmma
    (1, 200, 3, 64, 64, True, 48, "bfloat16"),    # wgmma, window, ragged
    (1, 130, 2, 128, 128, False, 0, "bfloat16"),  # wgmma, non-causal
    (1, 200, 3, 96, 64, True, 0, "bfloat16"),     # MLA's, wgmma
    (2, 200, 4, 80, 80, False, 0, "bfloat16"),    # hubert's, wgmma
    (1, 130, 2, 64, 64, True, 48, "float32"),
    (2, 64, 2, 16, 16, False, 0, "float32"),
    (1, 100, 2, 128, 128, True, 0, "float32"),
])
def test_flash_backward_vs_plain_version(cuda, B, T, H, dq, dv, causal,
                                         window, dtype):
    """ops.attention's gradients on CUDA tensors (the forward kernel
    with its log-sum-exp, then the backward kernel through the variant
    ``bwd_variant`` picks: one launch of each) against
    ``ref.attention_bwd_ref`` on the same output, each gradient within
    ATTN_BWD_TOL of its largest magnitude; a second backward gives the
    same bits."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k = (torch.randn((B, T, H, dq), generator=g, device=cuda).to(dt)
            for _ in range(2))
    v = torch.randn((B, T, H, dv), generator=g, device=cuda).to(dt)
    do = torch.randn((B, T, H, dv), generator=g, device=cuda).to(dt)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES)
    by_variant = dict(flash_attention.BWD_VARIANT_LAUNCHES)
    picked = flash_attention.bwd_variant(dt, dq, dv)
    out = ops.attention(*leaves, causal=causal, swa_window=window)
    grads = torch.autograd.grad(out, leaves, do)
    again = torch.autograd.grad(
        ops.attention(*leaves, causal=causal, swa_window=window), leaves,
        do)
    torch.cuda.synchronize()
    assert (flash_attention.LAUNCHES, flash_attention.BWD_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    assert flash_attention.BWD_VARIANT_LAUNCHES == {
        n: c + 2 * (n == picked) for n, c in by_variant.items()}
    lse = ref.attention_lse_ref(q, k, causal=causal, swa_window=window)
    want = ref.attention_bwd_ref(q, k, v, out.detach(), lse, do,
                                 causal=causal, swa_window=window)
    for name, got, w, g2 in zip("qkv", grads, want, again):
        assert got.dtype == dt and got.shape == w.shape
        assert torch.equal(got, g2), f"d{name} differs between two runs"
        assert _rel_err(got, w) <= ATTN_BWD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H", [
    (2, 200, 200, 4),       # ragged T
    (2, 100, 160, 16),      # T != S, both ragged
])
@pytest.mark.parametrize("name", ["wgmma", "cuda_core"])
def test_flash_backward_variants_at_hubert_head_dim(cuda, B, T, S, H,
                                                    name):
    """hubert-xlarge's bf16 d = 80, non-causal: the backward through
    each design (the wgmma one ``bwd_variant`` picks, and the CUDA-core
    first design on the same inputs) from the wgmma forward's output and
    log-sum-exp, against ``ref.attention_bwd_ref``, each gradient within
    ATTN_BWD_TOL of its largest magnitude; only the named variant's
    count moves, and a second call gives the same bits."""
    dt = torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v, do = (torch.randn(shape, generator=g, device=cuda).to(dt)
                   for shape in ((B, T, H, 80), (B, S, H, 80),
                                 (B, S, H, 80), (B, T, H, 80)))
    assert flash_attention.bwd_variant(dt, 80, 80) == "wgmma"
    out, lse = flash_attention.flash_attention_lse(q, k, v, causal=False)
    before = dict(flash_attention.BWD_VARIANT_LAUNCHES)
    runs = [flash_attention._flash_attention_bwd_variant(
        q, k, v, out, lse, do, name, causal=False) for _ in range(2)]
    torch.cuda.synchronize()
    assert flash_attention.BWD_VARIANT_LAUNCHES == {
        n: c + 2 * (n == name) for n, c in before.items()}
    want = ref.attention_bwd_ref(q, k, v, out, ref.attention_lse_ref(
        q, k, causal=False), do, causal=False)
    for label, got, w, g2 in zip("qkv", runs[0], want, runs[1]):
        assert got.dtype == dt and got.shape == w.shape
        assert torch.equal(got, g2), f"d{label} differs between two runs"
        assert _rel_err(got, w) <= ATTN_BWD_TOL["bfloat16"], label


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,dtype,final,strong", [
    (1, 256, 64, "bfloat16", False, False),
    (2, 100, 8, "float32", True, False),
    (1, 33, 2, "float32", True, True),            # decays near 0
    (2, 16, 3, "float32", False, False),
    (2, 256, 64, "bfloat16", True, False),        # the training shape
    (2, 77, 64, "bfloat16", False, False),        # T % 16 != 0
    (3, 200, 5, "float32", True, True),
])
def test_wkv_backward_vs_plain_version(cuda, B, T, H, dtype, final,
                                       strong):
    """ops.wkv's gradients on CUDA tensors (the forward kernel writing
    the state every 16 tokens, then the backward kernel) against
    ``ref.wkv_bwd_ref``, each within WKV_BWD_TOL of its largest
    magnitude, with and without a gradient of the final state; a second
    backward gives the same bits."""
    dt = getattr(torch, dtype)
    args = list(_wkv_args(cuda, B, T, H, 64, dt, 7))
    if strong:                           # w = exp(-exp(x)) with x ~ 3..5
        args[3] = torch.exp(-torch.exp(3 + 2 * torch.rand_like(
            args[3].float()))).to(dt)
    g = torch.Generator(device=cuda).manual_seed(8)
    dy = torch.randn(args[0].shape, generator=g, device=cuda).to(dt)
    ds = torch.randn(args[5].shape, generator=g, device=cuda) if final \
        else None
    leaves = [a.clone().requires_grad_() for a in args]
    before = (rwkv6_wkv.LAUNCHES, rwkv6_wkv.BWD_LAUNCHES)
    runs = []
    for _ in range(2):
        y, s = ops.wkv(*leaves)
        outs, gos = ((y, s), (dy, ds)) if final else ((y,), (dy,))
        runs.append(torch.autograd.grad(outs, leaves, gos))
    torch.cuda.synchronize()
    assert (rwkv6_wkv.LAUNCHES, rwkv6_wkv.BWD_LAUNCHES) == (
        before[0] + 2, before[1] + 2)
    want = ref.wkv_bwd_ref(*args, dy, ds)
    for name, got, w, g2 in zip(("r", "k", "v", "w", "u", "s0"), runs[0],
                                want, runs[1]):
        assert got.shape == w.shape, name
        assert torch.equal(got, g2), f"d{name} differs between two runs"
        assert _rel_err(got, w) <= WKV_BWD_TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", {}),
    ("rwkv6-7b", {"rwkv_head_dim": 64, "remat": True}),  # the kernel's dh
])
def test_reduced_train_step_through_the_kernels(cuda, arch, over):
    """A reduced float32 training step on the card through the kernels'
    forwards and backwards against the plain versions (autograd): the
    loss and every gradient within 1e-4 of its scale, each backward
    kernel launched once a layer."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tree import leaves, unflatten
    from repro_torch.models import model as M
    cfg = reduced(get_config(arch), **over)
    params = M.init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab, (2, 40), generator=g,
                              device=cuda) for k in ("tokens", "targets")}
    out = []
    for fns in (ops.model_kernel_fns(), None):
        live = [p.detach().clone().requires_grad_() for p in leaves(params)]
        before = (flash_attention.BWD_LAUNCHES, rwkv6_wkv.BWD_LAUNCHES)
        loss, _ = M.train_loss(cfg, unflatten(params, live), batch,
                               kernel_fns=fns)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        moved = (flash_attention.BWD_LAUNCHES - before[0],
                 rwkv6_wkv.BWD_LAUNCHES - before[1])
        out.append((loss.detach(), grads, moved))
    torch.cuda.synchronize()
    n_attn = sum(k == "attn" for k, _ in M.layer_kinds(cfg))
    n_rwkv = cfg.n_layers - n_attn
    assert out[0][2] == (n_attn, n_rwkv) and out[1][2] == (0, 0)
    assert abs(float(out[0][0]) - float(out[1][0])) <= 1e-4 * float(
        out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        if b is None:
            assert a is None or float(a.abs().max()) == 0.0
            continue
        assert _rel_err(a, b) <= 1e-4


@pytest.mark.cuda
def test_serving_saves_nothing_for_a_backward(cuda):
    """Without an input that requires grad, ops.attention and ops.wkv
    launch serving's forward: no log-sum-exp, no saved states, no
    graph."""
    q = torch.randn((1, 64, 2, 64), device=cuda, dtype=torch.bfloat16)
    out = ops.attention(q, q, q)
    assert out.grad_fn is None
    args = _wkv_args(cuda, 1, 40, 2, 64, torch.bfloat16, 9)
    y, s = ops.wkv(*args)
    assert y.grad_fn is None and s.grad_fn is None
    leaf = q.clone().requires_grad_()
    with torch.no_grad():
        assert ops.attention(leaf, leaf, leaf).grad_fn is None


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 12), device=cuda)          # d % 8 != 0
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(TypeError, match="must be"):
        flash_attention.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="head dim of v"):   # dv % 8 != 0
        flash_attention.flash_attention(q, q, torch.zeros((1, 8, 2, 12),
                                                          device=cuda))
    r = torch.zeros((1, 4, 2, 48), device=cuda)          # dh not served
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_wkv.wkv(r, r, r, r, torch.zeros((2, 48), device=cuda),
                      torch.zeros((1, 2, 48, 48), device=cuda))
    r = torch.zeros((1, 4, 2, 32), device=cuda, requires_grad=True)
    with pytest.raises(ValueError, match="backward kernel takes"):
        ops.wkv(r, r, r, r, torch.zeros((2, 32), device=cuda),
                torch.zeros((1, 2, 32, 32), device=cuda))


def tiers_inputs(sites, seed, fault_share, device):
    """Random inputs of one tick's two switch tiers for the grid of
    ``sites`` (two scenarios a site) on their padded hull: queues,
    stages, drains, fault timers (``fault_share`` of the links struck),
    arrivals as the tick's strided ``by_dest[..., 1:]`` view, caps and
    accumulators; the hull's real valid masks."""
    runs = [(S.SimParams(spec=TRAFFIC_SPECS["fb_web"], site=st,
                         gating_enabled=g), i)
            for i, st in enumerate(sites) for g in (True, False)]
    batch = S.make_multi_site_batch(runs)
    hull = batch.hull
    rack_valid, csw_valid = S._site_masks(hull, batch.scen)[:2]
    B, R, P = len(runs), hull.n_racks, hull.csw_per_cluster
    NC, CUP = hull.n_csw, hull.csw_uplinks
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g)

    def timers(*shape):
        return torch.where(u(*shape) < fault_share,
                           torch.randint(1, 40, shape, generator=g),
                           0).to(torch.int32)

    t = dict(rsw_q=u(B, R, P, 2) * 15,
             rsw_stage=torch.randint(1, P + 1, (B, R), generator=g,
                                     dtype=torch.int32),
             rsw_draining=u(B, R) < 0.3, rsw_timer=timers(B, R, P),
             rack_valid=rack_valid, by_dest=u(B, R, 3) * 3,
             csw_q=u(B, NC, CUP) * 15,
             csw_stage=torch.randint(1, CUP + 1, (B, NC), generator=g,
                                     dtype=torch.int32),
             csw_draining=u(B, NC) < 0.3, csw_timer=timers(B, NC, CUP),
             csw_valid=csw_valid, cap=10 + u(B) * 15)
    t = {k: v.to(device) for k, v in t.items()}
    acc = {k: (u(B) * 50).to(device) for k in lcdc_switch.TIER_ACC}
    return (t["rsw_q"], t["rsw_stage"], t["rsw_draining"], t["rsw_timer"],
            t["rack_valid"], t["by_dest"][..., 1:], t["csw_q"],
            t["csw_stage"], t["csw_draining"], t["csw_timer"],
            t["csw_valid"], t["cap"], acc)


def _within(got, want, rtol):
    d = (got.double() - want.double()).abs()
    assert bool((d <= rtol * torch.maximum(got.double().abs(),
                                           want.double().abs())).all()), \
        float(d.max())


@pytest.mark.cuda
@pytest.mark.parametrize("sites", sorted(TIER_SITES))
@pytest.mark.parametrize("fault_share", [0.0, 0.15])
def test_switch_tiers_kernel_vs_plain_version(cuda, sites, fault_share):
    args = tiers_inputs(TIER_SITES[sites], 7, fault_share, cuda)
    before = lcdc_switch.LAUNCHES
    got = ops.switch_tiers(*args)
    want = ref.switch_tiers_ref(*args)
    torch.cuda.synchronize()
    assert lcdc_switch.LAUNCHES == before + 1
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    for name in ("rsw_q", "rsw_wait"):
        _within(getattr(got, name), getattr(want, name), 4 * ULP)
    _within(got.to_csw, want.to_csw, (R // (NC // P) + 3) * ULP)
    _within(got.fc_in, want.fc_in, (NC + 3) * ULP)
    # the CSW tier on the kernel's own arrivals
    csw = ref.switch_step_ref(
        args[6].reshape(B * NC, CUP), args[7].reshape(-1),
        got.to_csw[..., 1].reshape(-1), args[8].reshape(-1),
        valid=(args[10][..., None] & (args[9] == 0)).reshape(B * NC, CUP),
        cap=args[11].repeat_interleave(NC),
        serve_rate=lcdc_switch.CSW_SERVE_RATE)
    _within(got.csw_q, csw[0].reshape(B, NC, CUP), 4 * ULP)
    _within(got.csw_wait, csw[5].reshape(B, NC), 4 * ULP)
    for k in lcdc_switch.TIER_ACC:
        _within(got.acc[k], want.acc[k], (2 * R * P * 2 + 5) * ULP)


@pytest.mark.cuda
@pytest.mark.parametrize("L,K", [(1, 1), (3, 2), (4, 1), (4, 2), (7, 1),
                                 (16, 2)])
def test_switch_step_kernel_vs_plain_version(cuda, L, K):
    """The public switch_step at widths its templates cover (the
    simulator's are 4)."""
    g = torch.Generator().manual_seed(L * 10 + K)
    S_ = 333
    q = torch.rand((S_, L, K), generator=g) * 15
    args = [q, torch.randint(1, L + 1, (S_,), generator=g,
                             dtype=torch.int32),
            torch.rand((S_, K), generator=g) * 3,
            torch.rand((S_,), generator=g) < 0.4]
    kw = dict(valid=torch.rand((S_, L), generator=g) < 0.8,
              cap=10 + torch.rand((S_,), generator=g) * 15,
              hi=torch.full((S_,), 0.75), lo=torch.full((S_,), 0.22))
    args = [a.to(cuda) for a in args]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    got = lcdc_switch.switch_step(*args, serve_rate=2.0, **kw)
    want = ref.switch_step_ref(*args, serve_rate=2.0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if a.dtype.is_floating_point:
            _within(a, b, 4 * ULP)
        else:
            assert torch.equal(a, b)


def _to_x64(args):
    """switch_tiers' arguments in the x64 mode's types: float64 queues
    and accumulators; the arrivals and caps stay float32."""
    args = list(args)
    args[0], args[6] = args[0].double(), args[6].double()
    args[12] = {k: v.double() for k, v in args[12].items()}
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("sites", sorted(TIER_SITES))
@pytest.mark.parametrize("fault_share", [0.0, 0.15])
def test_switch_tiers_f64_kernel_vs_plain_version(cuda, sites, fault_share):
    """The float64 instantiation (the x64 tick's) on the same cases as
    the float32 one, in float64 ulp; its launch counts."""
    args = _to_x64(tiers_inputs(TIER_SITES[sites], 9, fault_share, cuda))
    before = lcdc_switch.LAUNCHES
    got = ops.switch_tiers(*args)
    want = ref.switch_tiers_ref(*args)
    torch.cuda.synchronize()
    assert lcdc_switch.LAUNCHES == before + 1
    assert got.rsw_q.dtype == got.acc["drops"].dtype == torch.float64
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    for name in ("rsw_q", "rsw_wait"):
        _within(getattr(got, name), getattr(want, name), 4 * ULP64)
    _within(got.to_csw, want.to_csw, (R // (NC // P) + 3) * ULP64)
    _within(got.fc_in, want.fc_in, (NC + 3) * ULP64)
    csw = ref.switch_step_ref(
        args[6].reshape(B * NC, CUP), args[7].reshape(-1),
        got.to_csw[..., 1].reshape(-1), args[8].reshape(-1),
        valid=(args[10][..., None] & (args[9] == 0)).reshape(B * NC, CUP),
        cap=args[11].repeat_interleave(NC),
        serve_rate=lcdc_switch.CSW_SERVE_RATE)
    _within(got.csw_q, csw[0].reshape(B, NC, CUP), 4 * ULP64)
    _within(got.csw_wait, csw[5].reshape(B, NC), 4 * ULP64)
    for k in lcdc_switch.TIER_ACC:
        _within(got.acc[k], want.acc[k], (2 * R * P * 2 + 5) * ULP64)


@pytest.mark.cuda
@pytest.mark.parametrize("L,K", [(1, 1), (4, 1), (4, 2), (16, 2)])
def test_switch_step_f64_kernel_vs_plain_version(cuda, L, K):
    g = torch.Generator().manual_seed(L * 10 + K)
    S_ = 333
    args = [torch.rand((S_, L, K), generator=g, dtype=torch.float64) * 15,
            torch.randint(1, L + 1, (S_,), generator=g, dtype=torch.int32),
            torch.rand((S_, K), generator=g, dtype=torch.float64) * 3,
            torch.rand((S_,), generator=g) < 0.4]
    kw = dict(valid=torch.rand((S_, L), generator=g) < 0.8,
              cap=10 + torch.rand((S_,), generator=g) * 15,
              hi=torch.full((S_,), 0.75), lo=torch.full((S_,), 0.22))
    args = [a.to(cuda) for a in args]
    kw = {k: v.to(cuda) for k, v in kw.items()}
    got = lcdc_switch.switch_step(*args, serve_rate=4.0, **kw)
    want = ref.switch_step_ref(*args, serve_rate=4.0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if a.dtype.is_floating_point:
            _within(a, b, 4 * ULP64)
        else:
            assert torch.equal(a, b)


def _golden_batch():
    def p(spec, **kw):
        return S.SimParams(spec=TRAFFIC_SPECS[spec], site=GOLDEN_SITE, **kw)
    return S.make_batch([
        (p("fb_hadoop", gating_enabled=True, rate_scale=1.6), 8),
        (p("fb_hadoop", gating_enabled=False, rate_scale=1.6), 9),
        (p("fb_web", gating_enabled=True,
           link_mtbf_ticks=400.0, repair_ticks=30), 3)])


@pytest.mark.cuda
def test_graph_and_eager_sweeps_agree(cuda):
    """The tick replayed from a CUDA graph against the same ticks run
    eagerly: equal results and equal final state (every scatter_add
    weight here is an integer, so its sums are exact in any order),
    one capture and one switch_tiers launch a tick, a remainder chunk
    included."""
    batch = _golden_batch()
    runs = {}
    for graph in (True, False):
        lcdc_switch.LAUNCHES = 0
        S.CAPTURE_COUNT = 0
        S.HOST_TRANSFER_COUNT = 0
        res, state = S.run_sweep(batch, 250, chunk_ticks=100,
                                 return_state=True, device=cuda,
                                 graph=graph)
        assert lcdc_switch.LAUNCHES == 250
        assert S.CAPTURE_COUNT == (1 if graph else 0)
        assert S.HOST_TRANSFER_COUNT == 1
        runs[graph] = (res, state)
    assert runs[True][0] == runs[False][0]
    a = list(S._leaf_pairs(runs[True][1], runs[False][1]))
    assert all(torch.equal(x, y) for x, y in a)


@pytest.mark.cuda
def test_x64_sweep_launches_the_f64_kernel(cuda):
    """An x64 sweep on the card replays a tick whose switch_tiers launch
    is the float64 kernel (one a tick, counted), gives the CUDA-graph
    and eager runs equal results, and keeps float64 state."""
    batch = _golden_batch()
    runs = {}
    for graph in (True, False):
        lcdc_switch.LAUNCHES = lcdc_switch.LAUNCHES_F64 = 0
        S.CAPTURE_COUNT = 0
        res, state = S.run_sweep(batch, 250, chunk_ticks=100,
                                 return_state=True, device=cuda,
                                 graph=graph, x64=True)
        assert lcdc_switch.LAUNCHES == lcdc_switch.LAUNCHES_F64 == 250
        assert S.CAPTURE_COUNT == (1 if graph else 0)
        assert state.rsw_q.dtype == torch.float64
        runs[graph] = res
    assert runs[True] == runs[False]
    assert runs[True] != S.run_sweep(batch, 250, chunk_ticks=100,
                                     device=cuda)


#: two small sites of tests/test_durability.py: a two-bucket plan
BUCKET_SITE = dict(n_clusters=2, racks_per_cluster=3, servers_per_rack=4,
                   csw_per_cluster=2, n_fc=2, csw_ring_links=2,
                   fc_ring_links=4)


def _two_bucket_runs():
    a = FBSite(**BUCKET_SITE)
    b = FBSite(**dict(BUCKET_SITE, racks_per_cluster=5))
    spec = TRAFFIC_SPECS["fb_hadoop"]
    return [(S.SimParams(spec=spec, site=a), 0),
            (S.SimParams(spec=spec, site=b), 1),
            (S.SimParams(spec=spec, site=a, gating_enabled=False), 2)]


def _zero_counts():
    lcdc_switch.LAUNCHES = 0
    S.CAPTURE_COUNT = 0
    S.HOST_TRANSFER_COUNT = 0


@pytest.mark.cuda
def test_snapshot_under_graph_replay_equals_eager_carry(cuda, tmp_path):
    """The replays overwrite the carry in place, so a snapshot must be a
    clone taken at its boundary: every file of the replayed run equals,
    array for array, the eager run's file at the same boundary."""
    files = {}
    for graph in (True, False):
        d = tmp_path / ("graph" if graph else "eager")
        _zero_counts()
        S.run_sweep(_golden_batch(), 250, chunk_ticks=50, validate=True,
                    device=cuda, graph=graph,
                    checkpoint=CK.CheckpointSpec(directory=d, tag="g",
                                                 every_chunks=1, keep=8))
        assert S.HOST_TRANSFER_COUNT == 1 + 4
        files[graph] = CK.list_checkpoints(d, "g")
    assert [c for c, _ in files[True]] == [c for c, _ in files[False]] \
        == [1, 2, 3, 4]
    for (_, a), (_, b) in zip(files[True], files[False]):
        xa, xb = CK.read_checkpoint(a)[1], CK.read_checkpoint(b)[1]
        assert sorted(xa) == sorted(xb)
        for name in xa:
            np.testing.assert_array_equal(xa[name], xb[name], err_msg=name)


@pytest.mark.cuda
def test_resume_on_the_card_equals_the_uninterrupted_run(cuda, tmp_path,
                                                         monkeypatch):
    batch = _golden_batch()
    full = S.run_sweep(batch, 250, chunk_ticks=50, validate=True,
                       device=cuda)

    def kill(ci):
        if ci == 3:
            raise RuntimeError("preempted")

    monkeypatch.setattr(S, "CHUNK_HOOK", kill)
    with pytest.raises(RuntimeError, match="preempted"):
        S.run_sweep(batch, 250, chunk_ticks=50, validate=True, device=cuda,
                    checkpoint=CK.CheckpointSpec(directory=tmp_path,
                                                 tag="k", every_chunks=1,
                                                 keep=8))
    monkeypatch.setattr(S, "CHUNK_HOOK", None)
    found = CK.list_checkpoints(tmp_path, "k")
    assert [c for c, _ in found] == [1, 2]
    _zero_counts()
    res = S.resume_sweep(found[-1][1], device=cuda)
    assert (lcdc_switch.LAUNCHES, S.CAPTURE_COUNT,
            S.HOST_TRANSFER_COUNT) == (150, 1, 1)
    assert res == full


@pytest.mark.cuda
def test_pipelined_equals_serial_on_the_card(cuda):
    out = {}
    for pipeline in (True, False):
        _zero_counts()
        out[pipeline] = S.run_sweep_planned(
            _two_bucket_runs(), 200, max_compiles=2, chunk_ticks=80,
            device=cuda, pipeline=pipeline)
        assert (lcdc_switch.LAUNCHES, S.CAPTURE_COUNT,
                S.HOST_TRANSFER_COUNT) == (400, 2, 2)
    assert out[True] == out[False]


@pytest.mark.cuda
def test_retry_runs_eagerly_on_the_card(cuda, monkeypatch):
    """A bucket failing its dispatch once is retried on the card (eager
    ticks, host fold: the switch kernel still launches every tick, no
    capture) within 1e-6 of the clean run."""
    clean = S.run_sweep_planned(_two_bucket_runs(), 200, max_compiles=2,
                                chunk_ticks=80, device=cuda)

    def hook(k, phase):
        if (k, phase) == (0, "dispatch"):
            raise RuntimeError("transient")

    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", hook)
    _zero_counts()
    res = S.run_sweep_planned(_two_bucket_runs(), 200, max_compiles=2,
                              chunk_ticks=80, device=cuda)
    # bucket 1 replayed from its graph; bucket 0 eagerly, fetched a chunk
    # at a time (3 chunks)
    assert (lcdc_switch.LAUNCHES, S.CAPTURE_COUNT,
            S.HOST_TRANSFER_COUNT) == (400, 1, 1 + 3)
    assert all("error" not in r for r in res)
    diff, where = S.worst_parity(clean, res)
    assert diff <= 1e-6, (diff, where)


@pytest.mark.cuda
def test_guards_and_host_fold_on_the_card(cuda):
    """The guards ride the fold fetch (one transfer, one capture, results
    unchanged) and trip at chunk 0 under an impossible tolerance; the
    host fold is within 1e-6 of the device fold."""
    batch = _golden_batch()
    plain = S.run_sweep(batch, 250, chunk_ticks=100, device=cuda)
    _zero_counts()
    checked = S.run_sweep(batch, 250, chunk_ticks=100, validate=True,
                          device=cuda)
    assert (S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT) == (1, 1)
    assert checked == plain
    with pytest.raises(S.SweepValidationError) as ei:
        S.run_sweep(batch, 250, chunk_ticks=100, validate=True,
                    validate_tol=-1.0, device=cuda)
    assert ei.value.first_bad_chunk == 0
    assert set(ei.value.labels) == set(batch.labels)
    _zero_counts()
    host = S.run_sweep(batch, 250, chunk_ticks=100, fold="host",
                       device=cuda)
    assert S.HOST_TRANSFER_COUNT == 3
    diff, where = S.worst_parity(plain, host)
    assert diff <= 1e-6, (diff, where)


@pytest.mark.cuda
@pytest.mark.parametrize("partitionable", [True, False])
def test_samplers_on_the_card_equal_the_cpu(cuda, partitionable):
    for trace, spec in T.TRAFFIC_SPECS.items():
        for seed in (0, 1, 7):
            out = {}
            for dev in (cuda, torch.device("cpu")):
                key = prng.key(seed, device=dev)
                k1 = prng.split(key, 3, partitionable)[0]
                out[dev.type] = [t.cpu() for t in (
                    prng.uniform(k1, 20_000, partitionable)
                    < torch.tensor(spec.size_w, device=dev),
                    T.sample_flow_sizes(key, spec, 20_000,
                                        partitionable=partitionable),
                    T.sample_intervals(key, spec, 20_000,
                                       partitionable=partitionable))]
            (pc, sc, ic), (pp, sp, ip) = out["cuda"], out["cpu"]
            assert torch.equal(pc, pp), (trace, seed)
            np.testing.assert_allclose(sc.numpy(), sp.numpy(), rtol=4e-6,
                                       atol=0)
            np.testing.assert_allclose(ic.numpy(), ip.numpy(), rtol=4e-6,
                                       atol=0)


@pytest.mark.cuda
def test_reactive_policy_on_the_card_equals_the_cpu(cuda):
    for ph, idle in ((I.StepPhases("x", "train_4k", 8, 100.0, 25.0, 50.0,
                                   10.0), 0.0),
                     (I.StepPhases("y", "serve", 32, 313.7, 41.3, 77.0,
                                   0.0), 0.4)):
        got = I.reactive_policy(ph, idle_frac=idle, device=cuda)
        eager = I.reactive_policy(ph, idle_frac=idle, device=cuda,
                                  graph=False)
        want = I.reactive_policy(ph, idle_frac=idle, device="cpu")
        assert got == eager
        assert got["link_on_frac"] == want["link_on_frac"]
        assert got["latency_penalty"] == pytest.approx(
            want["latency_penalty"], rel=1e-6, abs=0)


@pytest.mark.cuda
def test_sweep_over_two_views_of_the_card(cuda, tmp_path, monkeypatch):
    batch = _golden_batch()            # 3 rows: one pad row on two views
    _zero_counts()
    one, st1 = S.run_sweep(batch, 250, chunk_ticks=100, return_state=True,
                           device=cuda)
    monkeypatch.setattr(S, "_local_devices", lambda dev: [dev, dev])
    _zero_counts()
    two, st2 = S.run_sweep(batch, 250, chunk_ticks=100, return_state=True,
                           device=cuda)
    assert (lcdc_switch.LAUNCHES, S.CAPTURE_COUNT,
            S.HOST_TRANSFER_COUNT) == (2 * 250, 2, 1)
    assert S.worst_parity(one, two)[0] <= 1e-6
    assert [r["label"] for r in two] == list(batch.labels)
    assert st2.rsw_q.shape[0] == 3
    spec = CK.CheckpointSpec(directory=tmp_path, every_chunks=1, tag="v",
                             keep=8)
    def kill(ci):
        if ci == 2:
            raise RuntimeError("preempted")

    monkeypatch.setattr(S, "CHUNK_HOOK", kill)
    with pytest.raises(RuntimeError, match="preempted"):
        S.run_sweep(batch, 250, chunk_ticks=100, device=cuda,
                    checkpoint=spec)
    monkeypatch.setattr(S, "CHUNK_HOOK", None)
    again = S.resume_sweep(CK.latest_checkpoint(tmp_path, "v"),
                           device=cuda, shard=False)
    assert again == two


def _card_and_meta(cuda, cfg, shape):
    got = {}
    for dev in (cuda, "meta"):
        with fake_world(4):
            dist = dist_for(make_test_mesh(2, 2))
            got[str(dev)] = dryrun.lower_cell(cfg, shape, dist, dev)
            implied = dryrun.implied_bytes(cfg, dist, shape)
    card, meta = got[str(cuda)], got["meta"]
    assert card["counts"] == meta["counts"]
    assert card["unknown"] == meta["unknown"] == {}
    assert card["log"] == meta["log"]
    assert {k: v[1] for k, v in card["collective_bytes"].items()} == \
        {"/".join(k): v for k, v in implied.items()}
    assert card["memory"]["temp_size_in_bytes"] > 0
    return card


@pytest.mark.cuda
def test_dryrun_card_counts_equal_meta(cuda):
    """A reduced train cell (remat, FSDP, the flash kernels) and a
    reduced decode cell on the sequence-sharded cache (granite-34b, one
    kv head: the partial softmax combined over 'model'): the card's
    counts equal meta's, the collective bytes the specs'."""
    cfg = reduced(get_config("qwen3-8b"), remat=True, fsdp=True,
                  dtype=torch.bfloat16)
    card = _card_and_meta(cuda, cfg, ShapeConfig("t", 64, 8, "train"))
    fwd = card["launches"]["flash_attention"]
    assert sum(fwd.values()) == 2 * 2          # 2 layers, remat
    assert sum(card["launches"]["flash_attention_bwd"].values()) == 2
    cfg = reduced(get_config("granite-34b"), dtype=torch.bfloat16)
    card = _card_and_meta(cuda, cfg, ShapeConfig("d", 64, 8, "decode"))
    assert card["collective_bytes"]["pmax/model"][0] == cfg.n_layers


@pytest.mark.cuda
def test_sync_sanitizer_trips_on_an_injected_item(cuda, monkeypatch):
    """Under the sync sanitizer a sweep on the card runs its blessed
    fetches (the fold fetch, a checkpoint's snapshot) with zero implicit
    syncs, graph or eager; an ``.item()`` injected at a chunk boundary
    raises."""
    from repro_torch.analysis.sanitizer import sync_sanitizer
    batch = _golden_batch()
    with sync_sanitizer():
        ref = S.run_sweep(batch, 64, chunk_ticks=16, device=cuda,
                          validate=True)
        assert S.run_sweep(batch, 64, chunk_ticks=16, device=cuda,
                           graph=False) == ref
        spec = CK.CheckpointSpec(directory=str(CK.DEFAULT_DIR / "san"),
                                 tag="san")
        assert S.run_sweep(batch, 64, chunk_ticks=16, device=cuda,
                           checkpoint=spec) == ref
    probe = torch.ones(1, device=cuda)
    monkeypatch.setattr(S, "CHUNK_HOOK",
                        lambda ci: ci == 2 and probe.sum().item())
    with sync_sanitizer(), pytest.raises(RuntimeError, match="synchroniz"):
        S.run_sweep(batch, 64, chunk_ticks=16, device=cuda)


@pytest.mark.cuda
def test_audit_card_counts_equal_the_cpus(cuda):
    """The artifact audit of the 2x2c2f2 tick on the card: clean, the
    counts equal the CPU's in both modes, the captured graph without a
    host node, its pool measured, the carry written in place."""
    from pathlib import Path

    from repro_torch.analysis import artifact as A
    from repro_torch.analysis.registry import load_config
    root = Path(__file__).resolve().parents[1]
    got = {}
    for dev in ("cuda", "cpu"):
        findings, payload = A.run_audit(root, load_config(root),
                                        units=["sweep_tick"], device=dev)
        assert findings == [], [f.format() for f in findings]
        got[dev] = {(c["tag"], c["mode"]): c
                    for c in payload["units"]["sweep_tick"]["cases"]}
    for key, card in got["cuda"].items():
        assert card["measured"] == got["cpu"][key]["measured"], key
        assert card["graph"]["kinds"].get("host", 0) == 0
        assert 0 < card["memory"]["peak"] <= card["memory"]["reserved"]
        assert card["launches_per_replay"] == 1
        assert card["leaves_in_place"]


@pytest.mark.cuda
def test_audit_peak_budget_trips_on_a_grown_tick(cuda, monkeypatch):
    """A tick that holds 256 KiB more across its ops than the shipped
    one breaks every sweep_tick case's peak budget on the card (RL007),
    in both modes; nothing else fires."""
    from pathlib import Path

    from repro_torch.analysis import artifact as A
    from repro_torch.analysis.registry import load_config
    root = Path(__file__).resolve().parents[1]
    make = S.make_sim_step

    def grown(*args, **kwargs):
        step = make(*args, **kwargs)

        def tick(state):
            pad = torch.ones(64 * 1024, device=state.key.device)
            out = step(state)
            pad.add_(1.0)
            return out
        return tick
    monkeypatch.setattr(S, "make_sim_step", grown)
    findings, _ = A.run_audit(root, load_config(root),
                              units=["sweep_tick"], device="cuda")
    assert {f.rule for f in findings} == {"RL007"}
    assert len(findings) == 8, [f.format() for f in findings]
    assert all("live at its peak" in f.message for f in findings)
