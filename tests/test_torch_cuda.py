"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels
are built with nvcc at first use); without a card each skips. The file
imports neither JAX nor the JAX package, so it runs where only the
port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances (abs and rel against the plain version): flash_attention
2e-5 in float32 (summation order) and 2e-2 in bfloat16 (that order
flips roundings of the bf16 output), as tests/test_kernels.py holds the
TPU kernel; wkv y 2e-3 in float32 and 5e-2 in bfloat16, the state 2e-3
and, since the kernel updates it in the plain version's order of
roundings, exactly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention, ops, ref, rwkv6_wkv

ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
WKV_TOL = {"float32": 2e-3, "bfloat16": 5e-2}


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
])
def test_flash_wgmma_variant_vs_plain_version(cuda, B, T, H, d, causal,
                                              window):
    """bf16 at d 64 or 128 goes through the tensor-core variant (its
    counter moves, the CUDA-core one's does not) and agrees with the
    plain version; so does the CUDA-core variant on the same inputs."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn((B, T, H, d), generator=g, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    assert flash_attention.variant(q.dtype, d) == "wgmma"
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


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 12), device=cuda)          # d % 8 != 0
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(TypeError, match="must be"):
        flash_attention.flash_attention(q, q.bfloat16(), q)
    r = torch.zeros((1, 4, 2, 48), device=cuda)          # dh not served
    with pytest.raises(ValueError, match="head dim"):
        rwkv6_wkv.wkv(r, r, r, r, torch.zeros((2, 48), device=cuda),
                      torch.zeros((1, 2, 48, 48), device=cuda))
