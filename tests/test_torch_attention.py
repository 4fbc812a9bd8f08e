"""The port's attention against the reference.

``repro_torch.kernels.ref.attention_ref`` (the model's
``chunked_attention``, the plain version the CUDA flash kernel is held
against on the card) is compared with the reference's
``chunked_attention``, its naive softmax ``attention_naive`` and its
Pallas ``flash_attention`` in interpret mode, on the ATTN_CASES shapes
of tests/test_kernels.py, on ragged lengths and with a value head dim
unlike the query's (MLA: q/k 96, v 64); then the GQA layer
(``gqa_forward``, ``gqa_decode``) on a reduced qwen3-8b.

Tolerances: 2e-5 (abs and rel) in float32, where the two sides differ
only in summation order; 2e-2 in bfloat16, where that order flips the
rounding of the bf16 output (the same bands tests/test_kernels.py holds
the Pallas kernel to). The layer tests are float32 at rtol 1e-4 (atol
1e-5), as the model tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jattn
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import flash_attention, ops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

# (B, T, S, H, dh, causal, swa, dtype, blocks): tests/test_kernels.py
ATTN_CASES = [
    (1, 64, 64, 1, 32, True, 0, "float32", 32),
    (2, 128, 128, 2, 64, True, 0, "float32", 64),
    (2, 128, 128, 2, 64, False, 0, "float32", 64),
    (1, 128, 128, 2, 32, True, 32, "float32", 32),
    (1, 128, 128, 1, 128, True, 0, "bfloat16", 64),
    (1, 64, 64, 2, 80, False, 0, "float32", 32),   # hubert head dim
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LAYER_RTOL, LAYER_ATOL = 1e-4, 1e-5


def _qkv(seed, B, T, S, H, dh, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, n, H, dh)).astype(np.float32)
            for n in (T, S, S)]
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_attention_vs_reference(case):
    """The port's plain version against the reference's chunked
    attention, its naive softmax and its Pallas kernel (interpret
    mode), each on the same inputs."""
    B, T, S, H, dh, causal, swa, dtype, blk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, B, T, S, H, dh, dtype)
    got = tref.attention_ref(tq, tk, tv, causal=causal, swa_window=swa)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = TOL[dtype]
    _close(got, jattn.chunked_attention(jq, jk, jv, causal=causal,
                                        swa_window=swa), tol)
    _close(got, jref.attention_naive(jq, jk, jv, causal=causal,
                                     swa_window=swa), tol)
    _close(got, pallas_flash(jq, jk, jv, causal=causal, swa_window=swa,
                             block_q=blk, block_k=blk, interpret=True), tol)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_attention_chunks_agree(case):
    """Chunked at the kernel's block size, the plain version gives the
    one-chunk result, as the reference's does."""
    B, T, S, H, dh, causal, swa, dtype, blk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, B, T, S, H, dh, dtype)
    one = tref.attention_ref(tq, tk, tv, causal=causal, swa_window=swa)
    many = tattn.chunked_attention(tq, tk, tv, causal=causal,
                                   swa_window=swa, chunk_q=blk, chunk_k=blk)
    _close(many, one.float().numpy(), TOL[dtype])
    _close(many, jattn.chunked_attention(
        jq, jk, jv, causal=causal, swa_window=swa, chunk_q=blk,
        chunk_k=blk), TOL[dtype])


@pytest.mark.parametrize("T,swa", [(100, 0), (200, 0), (200, 48), (7, 0)])
def test_plain_attention_ragged_length(T, swa):
    """Serving prompts have any length: one chunk covers T <= 1024."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, 2, T, T, 2, 32, "float32")
    got = tref.attention_ref(tq, tk, tv, causal=True, swa_window=swa)
    _close(got, jattn.chunked_attention(jq, jk, jv, causal=True,
                                        swa_window=swa), 2e-5)
    _close(got, jref.attention_naive(jq, jk, jv, causal=True,
                                     swa_window=swa), 2e-5)
    _close(tref.attention_naive(tq, tk, tv, causal=True, swa_window=swa),
           jref.attention_naive(jq, jk, jv, causal=True, swa_window=swa),
           2e-5)


def test_plain_attention_noncausal_window_is_the_softmax():
    """causal=False with a window masks only keys a window or more
    behind: the plain version gives the reference's naive softmax. (The
    reference's Pallas kernel also skips the key blocks ahead of the
    diagonal in this case, so it is not compared here.)"""
    (jq, jk, jv), (tq, tk, tv) = _qkv(8, 1, 128, 128, 2, 32, "float32")
    got = tref.attention_ref(tq, tk, tv, causal=False, swa_window=32)
    _close(got, jref.attention_naive(jq, jk, jv, causal=False,
                                     swa_window=32), 2e-5)


# (B, T, H, dq, dv, causal, swa, dtype, chunk): v's head dim unlike q's
DV_CASES = [
    (1, 64, 2, 96, 64, True, 0, "float32", 64),      # minicpm3's MLA dims
    (2, 128, 3, 96, 64, True, 0, "float32", 32),     # chunked
    (1, 100, 2, 96, 64, True, 0, "float32", 100),    # ragged
    (2, 64, 2, 96, 64, False, 0, "float32", 64),
    (1, 128, 2, 32, 16, True, 32, "float32", 64),    # dv < dq, windowed
    (1, 64, 2, 16, 48, True, 0, "float32", 64),      # dv > dq
    (1, 128, 4, 96, 64, True, 0, "bfloat16", 128),
]


@pytest.mark.parametrize("case", DV_CASES)
def test_plain_attention_dv_unlike_dq_vs_reference(case):
    """q/k of dq, v of dv -> (B, T, H, dv) in v's dtype, as the
    reference's chunked attention and naive softmax give it."""
    B, T, H, dq, dv, causal, swa, dtype, ck = case
    rng = np.random.default_rng(9)
    arrs = [rng.standard_normal((B, T, H, d)).astype(np.float32)
            for d in (dq, dq, dv)]
    jq, jk, jv = (jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs)
    tq, tk, tv = (torch.as_tensor(a).to(getattr(torch, dtype))
                  for a in arrs)
    got = tref.attention_ref(tq, tk, tv, causal=causal, swa_window=swa)
    assert got.dtype == tv.dtype and tuple(got.shape) == (B, T, H, dv)
    tol = TOL[dtype]
    _close(got, jattn.chunked_attention(jq, jk, jv, causal=causal,
                                        swa_window=swa), tol)
    _close(got, jref.attention_naive(jq, jk, jv, causal=causal,
                                     swa_window=swa), tol)
    many = tattn.chunked_attention(tq, tk, tv, causal=causal,
                                   swa_window=swa, chunk_q=ck, chunk_k=ck)
    _close(many, jattn.chunked_attention(jq, jk, jv, causal=causal,
                                         swa_window=swa, chunk_q=ck,
                                         chunk_k=ck), tol)
    assert torch.equal(ops.attention(tq, tk, tv, causal=causal,
                                     swa_window=swa), got)


def test_chunked_attention_rejects_partial_chunks():
    (_, _, _), (tq, tk, tv) = _qkv(3, 1, 96, 96, 1, 16, "float32")
    with pytest.raises(ValueError, match="multiples"):
        tattn.chunked_attention(tq, tk, tv, chunk_q=64, chunk_k=64)


def test_ops_attention_takes_cpu_tensors_to_the_plain_version():
    (_, _, _), (tq, tk, tv) = _qkv(4, 1, 32, 32, 2, 16, "float32")
    before = flash_attention.LAUNCHES
    got = ops.attention(tq, tk, tv, causal=True, swa_window=8)
    assert torch.equal(got, tref.attention_ref(tq, tk, tv, causal=True,
                                               swa_window=8))
    assert flash_attention.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention.flash_attention(tq, tk, tv)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "wgmma"),                  # hubert-xlarge
    (torch.bfloat16, 32, "cuda_core"),
    (torch.bfloat16, 96, "cuda_core"),
    (torch.float32, 128, "cuda_core"),
    (torch.float32, 64, "cuda_core"),
    (torch.float32, 80, "cuda_core"),
])
def test_flash_variant_from_dtype_and_head_dim(dtype, d, want):
    """The tensor-core variant takes bfloat16 at dq = dv in {64, 80,
    128}; float32 (full float32 products) and every other head dim take
    the CUDA-core variant."""
    assert flash_attention.variant(dtype, d, d) == want


@pytest.mark.parametrize("dtype,dq,dv,want", [
    (torch.bfloat16, 96, 64, "wgmma"),              # MLA (minicpm3-4b)
    (torch.bfloat16, 128, 64, "cuda_core"),
    (torch.bfloat16, 64, 128, "cuda_core"),
    (torch.float32, 96, 64, "cuda_core"),
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 80, 64, "cuda_core"),
    (torch.bfloat16, 64, 80, "cuda_core"),
])
def test_flash_variant_with_dv_unlike_dq(dtype, dq, dv, want):
    """A value head dim unlike the query's takes the tensor cores only
    at MLA's (96, 64) in bfloat16 (q/k in two swizzle atoms, the second
    zero-filled past 96; v in one); every other pair the CUDA cores."""
    assert flash_attention.variant(dtype, dq, dv) == want


@pytest.mark.parametrize("arch,want", [
    ("qwen3-8b", "wgmma"), ("granite-34b", "wgmma"),
    ("mixtral-8x7b", "wgmma"), ("jamba-v0.1-52b", "wgmma"),
    ("minicpm3-4b", "wgmma"), ("hubert-xlarge", "wgmma"),
])
def test_flash_variant_of_each_served_config(arch, want):
    """At its own dtype and the head dims its prefill hands the kernel,
    each attention config reaches the variant the kernel note promises:
    d = 128 and 64, MLA's q/k of 96 with v of 64 (minicpm3-4b) and
    hubert's d = 80 the tensor cores."""
    cfg = t_get_config(arch)
    dq = dv = cfg.d_head
    if cfg.attn_type == "mla":
        m = cfg.mla
        dq, dv = m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    assert flash_attention.variant(cfg.dtype, dq, dv) == want


@pytest.mark.parametrize("dtype,dq,dv,want,want_fwd", [
    (torch.bfloat16, 64, 64, "wgmma", "wgmma"),
    (torch.bfloat16, 128, 128, "wgmma", "wgmma"),
    (torch.float32, 128, 128, "cuda_core", "cuda_core"),
    (torch.float32, 64, 64, "cuda_core", "cuda_core"),
    (torch.bfloat16, 96, 64, "wgmma", "wgmma"),     # MLA (minicpm3-4b)
    (torch.bfloat16, 16, 16, "cuda_core", "cuda_core"),
    (torch.bfloat16, 128, 64, "cuda_core", "cuda_core"),
    (torch.bfloat16, 80, 80, "wgmma", "wgmma"),     # hubert-xlarge
    (torch.bfloat16, 80, 64, "cuda_core", "cuda_core"),
    (torch.bfloat16, 64, 80, "cuda_core", "cuda_core"),
])
def test_flash_bwd_variant_follows_the_forward(dtype, dq, dv, want,
                                               want_fwd):
    """The backward takes the tensor cores wherever the forward does:
    bfloat16 at (64, 64), (80, 80), (128, 128) and MLA's (96, 64);
    float32 (the gradient check's full float32 products) and every other
    head dim the CUDA cores, forward and backward alike."""
    assert flash_attention.bwd_variant(dtype, dq, dv) == want
    assert flash_attention.variant(dtype, dq, dv) == want_fwd


def test_flash_wgmma_backward_refuses_mla():
    """The private variant entries check the pair they are asked for:
    MLA's bfloat16 (96, 64) goes through wgmma and through the CUDA
    cores (the first design, kept for timing), forward and backward; the
    wgmma entries refuse MLA in float32, and bfloat16 at (64, 96) (q/k
    and v swapped)."""
    for bwd in (False, True):
        for name in ("wgmma", "cuda_core"):
            flash_attention._check_variant(name, torch.bfloat16, 96, 64,
                                           bwd=bwd)
        for dtype, dq, dv in ((torch.float32, 96, 64),
                              (torch.bfloat16, 64, 96)):
            with pytest.raises(ValueError, match="wgmma"):
                flash_attention._check_variant("wgmma", dtype, dq, dv,
                                               bwd=bwd)


def test_flash_wgmma_backward_covers_the_forward():
    """Every (dq, dv) the wgmma forward takes in bfloat16 has a wgmma
    backward too, so no bfloat16 training path leaves the tensor cores
    for its backward."""
    assert set(flash_attention.WGMMA_BWD_SHAPES) == set(
        flash_attention.WGMMA_SHAPES)
    for dq, dv in flash_attention.WGMMA_SHAPES:
        assert flash_attention.bwd_variant(torch.bfloat16, dq, dv) == \
            flash_attention.variant(torch.bfloat16, dq, dv) == "wgmma"


def test_flash_wgmma_takes_hubert_both_ways():
    """The private variant entries take hubert-xlarge's bfloat16 (80,
    80) through wgmma forward and backward (and through the CUDA cores,
    the first design kept for timing), and refuse wgmma for float32 at
    (80, 80) and for bfloat16 at (80, 64) or (64, 80)."""
    for bwd in (False, True):
        for name in ("wgmma", "cuda_core"):
            flash_attention._check_variant(name, torch.bfloat16, 80, 80,
                                           bwd=bwd)
        for dtype, dq, dv in ((torch.float32, 80, 80),
                              (torch.bfloat16, 80, 64),
                              (torch.bfloat16, 64, 80)):
            with pytest.raises(ValueError, match="wgmma"):
                flash_attention._check_variant("wgmma", dtype, dq, dv,
                                               bwd=bwd)


@pytest.mark.parametrize("dq,dv", [(96, 64), (64, 64), (128, 128),
                                   (80, 80), (80, 64), (64, 80)])
def test_flash_float32_takes_the_cuda_cores(dq, dv):
    """float32 (the float32 logit and gradient checks need full float32
    products) stays on the CUDA cores forward and backward at every pair
    the wgmma kernels take in bfloat16, MLA's and hubert's among them,
    and beside hubert's d 80 paired with 64."""
    assert flash_attention.variant(torch.float32, dq, dv) == "cuda_core"
    assert flash_attention.bwd_variant(torch.float32, dq, dv) == "cuda_core"


def test_flash_backward_refuses_cpu_tensors():
    """The backward launches a kernel or raises: CPU tensors go to the
    plain version through ops.attention, never through the kernels'
    wrapper, which counts nothing."""
    (_, _, _), (tq, tk, tv) = _qkv(6, 1, 16, 16, 2, 64, "bfloat16")
    out = tref.attention_ref(tq, tk, tv)
    lse = tref.attention_lse_ref(tq, tk)
    before = (flash_attention.BWD_LAUNCHES,
              dict(flash_attention.BWD_VARIANT_LAUNCHES))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention.flash_attention_bwd(tq, tk, tv, out, lse, out)
    for name in ("wgmma", "cuda_core"):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            flash_attention._flash_attention_bwd_variant(
                tq, tk, tv, out, lse, out, name)
    assert (flash_attention.BWD_LAUNCHES,
            flash_attention.BWD_VARIANT_LAUNCHES) == before


def test_flash_variant_entry_refuses_cpu_and_unknown_variants():
    (_, _, _), (tq, tk, tv) = _qkv(5, 1, 16, 16, 2, 16, "float32")
    before = dict(flash_attention.VARIANT_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention._flash_attention_variant(tq, tk, tv, "wgmma")
    assert flash_attention.VARIANT_LAUNCHES == before


def _layer(arch, seed, **over):
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **over)
    p = jax.device_get(jattn.gqa_init(jax.random.PRNGKey(seed), cfg,
                                      cfg.dtype))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def _assert_layer_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_RTOL, atol=LAYER_ATOL)


@pytest.mark.parametrize("arch,over", [("qwen3-8b", {}),
                                       ("qwen3-8b", {"swa_window": 5}),
                                       ("granite-34b", {})])
def test_gqa_forward_vs_reference(arch, over):
    cfg, tcfg, p, tp = _layer(arch, 0, **over)
    x = np.random.default_rng(5).standard_normal(
        (2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None, :]
    out, (k, v) = jattn.gqa_forward(p, cfg, jnp.asarray(x),
                                    positions=jnp.asarray(pos))
    for fn in (None, ops.attention):
        tout, (tk, tv) = tattn.gqa_forward(tp, tcfg, torch.as_tensor(x),
                                           positions=torch.as_tensor(pos),
                                           kernel_fn=fn)
        _assert_layer_close(tout, out)
        _assert_layer_close(tk, k)
        _assert_layer_close(tv, v)


@pytest.mark.parametrize("over,pos", [
    ({}, [5, 9]),                          # inside the cache
    ({}, [3, 16]),                         # row 1 past it: not written
    ({"swa_window": 8}, [3, 13]),          # rolling window, wrapped
])
def test_gqa_decode_vs_reference(over, pos):
    cfg, tcfg, p, tp = _layer("qwen3-8b", 1, **over)
    rng = np.random.default_rng(6)
    B, S = 2, 8 if over else 16
    kc, vc = (rng.standard_normal((B, S, cfg.n_kv, cfg.d_head))
              .astype(np.float32) for _ in range(2))
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    out, cache = jattn.gqa_decode(p, cfg, jnp.asarray(x),
                                  {"k": jnp.asarray(kc),
                                   "v": jnp.asarray(vc)},
                                  jnp.asarray(pos, jnp.int32))
    tcache = {"k": torch.as_tensor(kc.copy()), "v": torch.as_tensor(vc.copy())}
    tout, tcache = tattn.gqa_decode(tp, tcfg, torch.as_tensor(x), tcache,
                                    torch.as_tensor(pos, dtype=torch.int32))
    _assert_layer_close(tout, out)
    _assert_layer_close(tcache["k"], cache["k"])
    _assert_layer_close(tcache["v"], cache["v"])
