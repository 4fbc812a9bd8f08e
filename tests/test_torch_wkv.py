"""The port's RWKV-6 time mix and wkv recurrence against the reference.

``repro_torch.models.rwkv6.wkv_scan`` (``kernels.ref.wkv_ref``, the
plain version the CUDA wkv kernel is held against on the card) is
compared with the reference's ``wkv_scan`` and with its chunked Pallas
kernel ``wkv_chunked`` in interpret mode, on the WKV_CASES shapes of
tests/test_kernels.py and at T = 1 (a decode step); then ``time_mix``,
``channel_mix`` and ``_group_norm`` on a reduced rwkv6-7b.

Tolerances: against ``wkv_scan`` 1e-5 (abs and rel) in float32 (the
same products and sums, the sum over i in another order) and 5e-2 in
bfloat16 (that order flips the rounding of the bf16 output; the state
is float32 and keeps 1e-5); against the chunked kernel 2e-3 in float32
and 5e-2 in bfloat16, the bands tests/test_kernels.py holds it to (its
chunked form rescales by exp(+-cumulative log-decay)). The layer tests
are float32 at rtol 1e-4 (atol 1e-5), as the model tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, reduced
from repro.kernels.rwkv6_wkv import wkv_chunked
from repro.models import rwkv6 as jrw
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops, rwkv6_wkv
from repro_torch.kernels import ref as tref
from repro_torch.models import rwkv6 as trw

# (B, T, H, dh, chunk, dtype): tests/test_kernels.py, plus decode steps
WKV_CASES = [
    (1, 32, 1, 8, 16, "float32"),
    (2, 64, 3, 16, 16, "float32"),
    (2, 48, 2, 32, 16, "float32"),
    (1, 64, 2, 16, 8, "float32"),
    (1, 32, 2, 16, 16, "bfloat16"),
    (4, 1, 3, 16, 1, "float32"),
    (4, 1, 3, 16, 1, "bfloat16"),
]
SCAN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
CHUNK_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
STATE_TOL = 1e-5
LAYER_RTOL, LAYER_ATOL = 1e-4, 1e-5


def _inputs(seed, B, T, H, dh, dtype):
    """r, k, v, w (RWKV-6's decay range w = exp(-exp(x))), u and a
    float32 state, as numpy, then as jax and torch arrays."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    arrs = [n((B, T, H, dh)) * 0.5, n((B, T, H, dh)) * 0.5,
            n((B, T, H, dh)), np.exp(-np.exp(n((B, T, H, dh)) * 0.5)),
            n((H, dh)) * 0.3]
    arrs = [a.astype(np.float32) for a in arrs]
    s0 = (n((B, H, dh, dh)) * 0.1).astype(np.float32)
    jx = [jnp.asarray(a, dtype=getattr(jnp, dtype)) for a in arrs] \
        + [jnp.asarray(s0)]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrs] \
        + [torch.as_tensor(s0)]
    return jx, tx


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv_scan_vs_reference(case):
    B, T, H, dh, chunk, dtype = case
    jx, tx = _inputs(2, B, T, H, dh, dtype)
    y, s = tref.wkv_ref(*tx)
    assert y.dtype == tx[0].dtype and s.dtype == torch.float32
    jy, js = jrw.wkv_scan(*jx)
    _close(y, jy, SCAN_TOL[dtype])
    _close(s, js, STATE_TOL)
    cy, cs = wkv_chunked(*jx, chunk=chunk, interpret=True)
    _close(y, cy, CHUNK_TOL[dtype])
    _close(s, cs, CHUNK_TOL[dtype])


def test_wkv_scan_splits_at_any_token():
    """Running T tokens at once equals running them in two segments,
    the second from the first's final state (prefill then decode)."""
    _, (r, k, v, w, u, s0) = _inputs(3, 2, 24, 2, 16, "float32")
    y, s = tref.wkv_ref(r, k, v, w, u, s0)
    y1, s1 = tref.wkv_ref(r[:, :17], k[:, :17], v[:, :17], w[:, :17], u,
                          s0)
    y2, s2 = tref.wkv_ref(r[:, 17:], k[:, 17:], v[:, 17:], w[:, 17:], u,
                          s1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(s2, s)


def test_ops_wkv_takes_cpu_tensors_to_the_plain_version():
    _, tx = _inputs(4, 1, 8, 2, 16, "float32")
    before = rwkv6_wkv.LAUNCHES
    y, s = ops.wkv(*tx)
    y_ref, s_ref = tref.wkv_ref(*tx)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert rwkv6_wkv.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6_wkv.wkv(*tx)


@pytest.mark.parametrize("B,T,H,want", [
    (1, 256, 64, (8, 2)),    # one request's prefill: 64 pairs
    (1, 64, 64, (8, 2)),
    (2, 100, 64, (8, 2)),
    (4, 256, 64, (8, 1)),
    (8, 256, 64, (4, 1)),    # launch.serve's batched prefill
    (16, 256, 64, (2, 1)),
    (64, 256, 64, (1, 1)),
    (4, 1, 64, (4, 1)),      # decode steps
    (8, 1, 64, (4, 1)),
    (1, 1, 64, (4, 2)),
])
def test_wkv_plan_from_batch_tokens_heads(B, T, H, want):
    """The wrapper's (threads per state column, blocks per head) at the
    serve shapes of rwkv6-7b and around them."""
    assert rwkv6_wkv.plan(B, T, H) == want


def test_wkv_plan_is_always_a_built_layout():
    """Whatever the shape, the plan names a layout the kernel is built
    for, gives at least half the SMs a block where the pairs allow it,
    and in prefill keeps B H G at most 2,048."""
    for B in (1, 2, 3, 4, 8, 16, 64):
        for T in (0, 1, 2, 64, 100, 384):
            for H in (1, 3, 32, 64, 128):
                groups, splits = rwkv6_wkv.plan(B, T, H)
                assert groups in rwkv6_wkv.GROUPS
                assert splits in rwkv6_wkv.SPLITS
                if T > 1:
                    assert B * H * groups <= 2048 or groups == 1
                assert B * H * splits >= min(rwkv6_wkv.SMS // 2, B * H)


@pytest.mark.parametrize("T,final", [(77, True), (33, False), (16, True)])
def test_wkv_bwd_padding_tokens_are_inert(T, final):
    """The backward kernel runs every chunk's 16 tokens, staging those
    past the sequence's end as zeros with w = 1. Such tokens leave the
    state and its gradient as they are: the plain backward over the
    padded sequence (their dy zero) gives the unpadded one's gradients
    for the real tokens and the initial state, bit for bit, and zeros
    for the padding's r, k, v."""
    _, (r, k, v, w, u, s0) = _inputs(11, 2, T, 3, 64, "float32")
    rng = np.random.default_rng(12)
    dy = torch.as_tensor(rng.standard_normal(r.shape).astype(np.float32))
    ds = torch.as_tensor(rng.standard_normal(s0.shape).astype(np.float32)) \
        if final else None
    pad = -T % 16 or 16
    z = torch.zeros((2, pad, 3, 64))
    padded = [torch.cat([x, fill], dim=1) for x, fill in (
        (r, z), (k, z), (v, z), (w, torch.ones_like(z)), (dy, z))]
    want = tref.wkv_bwd_ref(r, k, v, w, u, s0, dy, ds)
    got = tref.wkv_bwd_ref(*padded[:4], u, s0, padded[4], ds)
    for name, g, x in zip(("r", "k", "v", "w"), got[:4], want[:4]):
        assert torch.equal(g[:, :T], x), name
    for name, g in zip(("r", "k", "v"), got[:3]):
        assert not g[:, T:].any(), name
    assert torch.equal(got[4], want[4]) and torch.equal(got[5], want[5])


def test_wkv_bwd_refuses_cpu_tensors_and_counts_nothing():
    """The backward kernel's wrapper takes CUDA tensors only (ops and
    the autograd function take CPU tensors to the plain version), with
    or without a final-state gradient, and counts nothing it does not
    launch."""
    _, (r, k, v, w, u, s0) = _inputs(13, 1, 20, 2, 64, "float32")
    ckpt = torch.zeros((1, 2, 2, 64, 64))
    before = rwkv6_wkv.BWD_LAUNCHES
    for ds in (None, s0):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            rwkv6_wkv.wkv_bwd(r, k, v, w, u, ckpt, r, ds)
    assert rwkv6_wkv.BWD_LAUNCHES == before


@pytest.mark.parametrize("groups", rwkv6_wkv.GROUPS)
def test_split_column_arithmetic_vs_reference(groups):
    """The kernel's arithmetic written out in float32 on the CPU: y_j as
    the G row groups' partials of sum_i r_i S_ij, summed pairwise as the
    shuffles do, plus v_j sum_i r_i u_i k_i; each state row updated as
    kv = k_i v_j, S = w_i S, S = S + kv. The state equals the plain
    version's bit for bit, y is within SCAN_TOL of the reference."""
    B, T, H, dh = 2, 12, 2, 16
    jx, tx = _inputs(6, B, T, H, dh, "float32")
    r, k, v, w, u, s = tx
    rows = dh // groups
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (x[:, t] for x in (r, k, v, w))     # (B, H, dh)
        own = [slice(g * rows, (g + 1) * rows) for g in range(groups)]
        parts = [torch.einsum("bhi,bhij->bhj", rt[..., o], s[..., o, :])
                 for o in own]
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
        a = (rt * u * kt).sum(-1, keepdim=True)
        ys.append(parts[0] + a * vt)
        kv = kt[..., :, None] * vt[..., None, :]
        s = wt[..., :, None] * s + kv
    y_ref, s_ref = tref.wkv_ref(*tx)
    assert torch.equal(s, s_ref)
    jy, _ = jrw.wkv_scan(*jx)
    _close(torch.stack(ys, dim=1), jy, SCAN_TOL["float32"])


def _rwkv_layer(seed):
    cfg = reduced(get_config("rwkv6-7b"))
    tcfg = t_reduced(t_get_config("rwkv6-7b"))
    p = jax.device_get(jrw.rwkv_init(jax.random.PRNGKey(seed), cfg,
                                     cfg.dtype))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


def _layer_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LAYER_RTOL, atol=LAYER_ATOL)


@pytest.mark.parametrize("T", [12, 1])
def test_time_mix_vs_reference(T):
    cfg, tcfg, p, tp = _rwkv_layer(0)
    rng = np.random.default_rng(5)
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // dh
    x = rng.standard_normal((2, T, d)).astype(np.float32)
    shift = rng.standard_normal((2, d)).astype(np.float32)
    state = (rng.standard_normal((2, H, dh, dh)) * 0.1).astype(np.float32)
    out, sh, st = jrw.time_mix(p, cfg, jnp.asarray(x), jnp.asarray(shift),
                               jnp.asarray(state))
    for fn in (None, ops.wkv):
        tout, tsh, tst = trw.time_mix(tp, tcfg, torch.as_tensor(x),
                                      torch.as_tensor(shift),
                                      torch.as_tensor(state), kernel_fn=fn)
        _layer_close(tout, out)
        _layer_close(tsh, sh)
        _layer_close(tst, st)


@pytest.mark.parametrize("T", [12, 1])
def test_channel_mix_vs_reference(T):
    cfg, _, p, tp = _rwkv_layer(1)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    shift = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    out, sh = jrw.channel_mix(p, jnp.asarray(x), jnp.asarray(shift))
    tout, tsh = trw.channel_mix(tp, torch.as_tensor(x),
                                torch.as_tensor(shift))
    _layer_close(tout, out)
    _layer_close(tsh, sh)


def test_group_norm_and_state_init_vs_reference():
    cfg = reduced(get_config("rwkv6-7b"))
    tcfg = t_reduced(t_get_config("rwkv6-7b"))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32) * 3
    wt = rng.standard_normal(cfg.d_model).astype(np.float32)
    H = cfg.d_model // cfg.rwkv_head_dim
    _layer_close(trw._group_norm(torch.as_tensor(x), torch.as_tensor(wt), H),
                 jrw._group_norm(jnp.asarray(x), jnp.asarray(wt), H))
    ref = jrw.rwkv_state_init(cfg, 3)
    got = trw.rwkv_state_init(tcfg, 3, device="cpu")
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(ref[k].dtype)
