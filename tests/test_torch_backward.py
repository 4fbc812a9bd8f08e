"""The training side of the port's kernels on the CPU: the gradients of
``ops.attention`` and ``ops.wkv`` (on CPU tensors the plain backward
versions, which the backward kernels are also held against on the card:
``ref.attention_bwd_ref``, ``ref.wkv_bwd_ref``, with
``ref.attention_lse_ref``), and those versions called directly, against
``jax.vjp`` of the reference's ``chunked_attention`` and ``wkv_scan`` on
the same numpy inputs.

Tolerances, each gradient against its largest magnitude: 1e-5 (float32
sums in another order; they read 4.1e-7 for attention and 2.5e-7 for
wkv). The log-sum-exp within 1e-5 (abs and rel).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import rwkv6 as JR
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA

ATTN_TOL = 1e-5
WKV_TOL = 1e-5


def _close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _attn_inputs(B, T, H, dq, dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, H, dq)).astype(np.float32)
            for _ in range(2))
    v, do = (rng.standard_normal((B, T, H, dv)).astype(np.float32)
             for _ in range(2))
    return q, k, v, do


CASES = [  # (B, T, H, dq, dv, causal, window)
    (2, 16, 3, 16, 16, True, 0),
    (1, 24, 2, 16, 16, True, 5),          # sliding window
    (2, 16, 2, 24, 8, True, 0),           # dv != dq (MLA)
    (1, 12, 2, 8, 16, False, 0),          # bidirectional
    (1, 80, 2, 96, 64, True, 0),          # MLA's dims, ragged over 2 tiles
    (1, 90, 2, 96, 64, True, 48),         # MLA's dims, a window
]


@pytest.mark.parametrize("B,T,H,dq,dv,causal,window", CASES)
def test_attention_grads_vs_reference(B, T, H, dq, dv, causal, window):
    q, k, v, do = _attn_inputs(B, T, H, dq, dv, seed=T + dq)

    def fwd(q, k, v):
        return JA.chunked_attention(q, k, v, causal=causal,
                                    swa_window=window)
    out, vjp = jax.vjp(fwd, *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(do))

    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got_out = ops.attention(*leaves, causal=causal, swa_window=window)
    got = torch.autograd.grad(got_out, leaves, torch.tensor(do))
    _close(got_out, out, ATTN_TOL, "out")
    for name, g, w in zip("qkv", got, want):
        _close(g, w, ATTN_TOL, "d" + name)

    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    lse = ref.attention_lse_ref(tq, tk, causal=causal, swa_window=window)
    s = np.einsum("bthd,bshd->bhts", q, k) * dq ** -0.5
    qp, kp = np.arange(T)[:, None], np.arange(T)[None, :]
    vis = np.ones((T, T), bool)
    if causal:
        vis &= qp >= kp
    if window:
        vis &= qp - kp < window
    s = np.where(vis, s, -np.inf)
    m = s.max(-1, keepdims=True)
    lse_np = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse_np, rtol=1e-5, atol=1e-5)
    plain = ref.attention_bwd_ref(tq, tk, tv, got_out.detach(), lse,
                                  torch.tensor(do), causal=causal,
                                  swa_window=window)
    for name, g, w in zip("qkv", plain, want):
        assert g.dtype == torch.float32
        _close(g, w, ATTN_TOL, "plain d" + name)


def test_gqa_forward_grads_vs_reference():
    """GQA through ``gqa_forward``: K/V repeated before the attention,
    so autograd sums the repeated heads' gradients back onto the n_kv
    projections."""
    from repro import configs as jconfigs
    cfg = jconfigs.reduced(jconfigs.get_config("qwen3-8b"))
    tcfg = reduced(get_config("qwen3-8b"))
    assert tcfg.n_heads // tcfg.n_kv == 2 and tcfg.qk_norm
    rng = np.random.default_rng(4)
    d, H, Hkv, dh = tcfg.d_model, tcfg.n_heads, tcfg.n_kv, tcfg.d_head
    shapes = {"wq": (d, H * dh), "wk": (d, Hkv * dh), "wv": (d, Hkv * dh),
              "wo": (H * dh, d), "q_norm": (dh,), "k_norm": (dh,)}
    jp = {k: (rng.standard_normal(s) * (0.3 if len(s) == 2 else 1.0) + (
        0.0 if len(s) == 2 else 1.0)).astype(np.float32)
        for k, s in shapes.items()}
    tp = {k: torch.tensor(a) for k, a in jp.items()}
    jp = {k: jnp.asarray(a) for k, a in jp.items()}
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None, :]

    def fwd(p, x):
        return JA.gqa_forward(p, cfg, x, positions=jnp.asarray(pos))[0]
    _, vjp = jax.vjp(fwd, jp, jnp.asarray(x))
    jg, jx = vjp(jnp.asarray(dy))

    live = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.tensor(x, requires_grad=True)
    out, _ = TA.gqa_forward(live, tcfg, tx, positions=torch.tensor(pos),
                            kernel_fn=ops.attention)
    grads = torch.autograd.grad(out, [tx, *live.values()],
                                torch.tensor(dy))
    _close(grads[0], jx, ATTN_TOL, "dx")
    for (name, _), g in zip(live.items(), grads[1:]):
        _close(g, jg[name], ATTN_TOL, name)


def _wkv_inputs(B, T, H, dh, seed, strong=False):
    rng = np.random.default_rng(seed)

    def n(*s):
        return rng.standard_normal(s).astype(np.float32)
    x = 3 + 2 * rng.random((B, T, H, dh)) if strong else n(B, T, H, dh) * 0.5
    w = np.exp(-np.exp(x)).astype(np.float32)
    return (n(B, T, H, dh) * 0.5, n(B, T, H, dh) * 0.5, n(B, T, H, dh), w,
            n(H, dh) * 0.3, n(B, H, dh, dh) * 0.1, n(B, T, H, dh),
            n(B, H, dh, dh))


@pytest.mark.parametrize("B,T,H,dh,strong", [
    (2, 20, 3, 8, False),
    (1, 33, 2, 16, False),
    (1, 20, 2, 8, True),            # w = exp(-exp(3..5)): near 0
])
def test_wkv_grads_vs_reference(B, T, H, dh, strong):
    *args, dy, ds = _wkv_inputs(B, T, H, dh, seed=T + dh, strong=strong)
    if strong:
        assert float(np.min(args[3])) < 1e-8
    (y, sT), vjp = jax.vjp(JR.wkv_scan, *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    names = ("dr", "dk", "dv", "dw", "du", "ds0")

    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    ty, ts = ops.wkv(*leaves)
    got = torch.autograd.grad((ty, ts), leaves,
                              (torch.tensor(dy), torch.tensor(ds)))
    _close(ty, y, 1e-5, "y")
    for name, g, w in zip(names, got, want):
        _close(g, w, WKV_TOL, name)

    plain = ref.wkv_bwd_ref(*(torch.tensor(a) for a in args),
                            torch.tensor(dy), torch.tensor(ds))
    for name, g, w in zip(names, plain, want):
        assert g.dtype == torch.float32
        _close(g, w, WKV_TOL, "plain " + name)


def test_wkv_plain_backward_without_a_final_gradient():
    """``dsT=None`` (the final state unused, as in a training step) is
    a zero gradient of the final state."""
    *args, dy, ds = _wkv_inputs(1, 18, 2, 8, seed=3)
    ts = [torch.tensor(a) for a in args]
    a = ref.wkv_bwd_ref(*ts, torch.tensor(dy))
    b = ref.wkv_bwd_ref(*ts, torch.tensor(dy), torch.zeros_like(ts[5]))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
