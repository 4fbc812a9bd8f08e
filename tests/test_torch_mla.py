"""The port's MLA (multi-head latent attention) against the reference.

``mla_forward`` (the naive, un-absorbed prefill that feeds attention q/k
of nope + rope dims and v of ``v_head_dim``) and ``mla_decode`` (the
absorbed-weight decode over the latent ``c_kv``/``k_rope`` cache) of
``repro_torch.models.attention`` are compared with the reference's on a
reduced minicpm3-4b, with the reference's random parameters carried
across and the same numpy inputs; also at MLA's own head dims (nope 64
+ rope 32 = 96 for q/k, 64 for v: the shapes the flash kernel takes
with dv != dq on the card).

Float32 at rtol 1e-4 and atol 1e-5 of the leaf's largest magnitude, as
tests/test_torch_model.py: both sides run the same float32 operations
in other summation orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig, get_config, reduced
from repro.models import attention as jattn
from repro_torch.configs import MLAConfig as TMLAConfig
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn

RTOL, ATOL = 1e-4, 1e-5
#: minicpm3-4b's head dims at a reduced width
MLA_DIMS = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=64,
                qk_rope_head_dim=32, v_head_dim=64)


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


def _layer(seed, head_dims=False, **over):
    cfg = reduced(get_config("minicpm3-4b"), **over)
    tcfg = t_reduced(t_get_config("minicpm3-4b"), **over)
    if head_dims:
        cfg = dataclasses.replace(cfg, mla=MLAConfig(**MLA_DIMS))
        tcfg = dataclasses.replace(tcfg, mla=TMLAConfig(**MLA_DIMS))
    p = jax.device_get(jattn.attn_init(jax.random.PRNGKey(seed), cfg,
                                       cfg.dtype))
    tp = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
    return cfg, tcfg, p, tp


@pytest.mark.parametrize("head_dims", [False, True])
@pytest.mark.parametrize("T", [12, 7])
def test_mla_forward_vs_reference(head_dims, T):
    cfg, tcfg, p, tp = _layer(0, head_dims)
    x = np.random.default_rng(5).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    pos = np.arange(T)[None, :]
    out, (c_kv, k_rope) = jattn.mla_forward(p, cfg, jnp.asarray(x),
                                            positions=jnp.asarray(pos))
    for fn in (None, ops.attention):
        tout, (tc, tk) = tattn.mla_forward(tp, tcfg, torch.as_tensor(x),
                                           positions=torch.as_tensor(pos),
                                           kernel_fn=fn)
        assert tuple(tc.shape) == (2, T, cfg.mla.kv_lora_rank)
        assert tuple(tk.shape) == (2, T, cfg.mla.qk_rope_head_dim)
        _close(tout, out)
        _close(tc, c_kv)
        _close(tk, k_rope)


def test_mla_forward_hands_the_kernel_dq_96_and_dv_64():
    """At minicpm3's head dims the attention call gets q/k of 96 and v
    of 64, with no window and the config's causal flag; nothing pads v."""
    _, tcfg, _, tp = _layer(1, head_dims=True)
    seen = []

    def spy(q, k, v, **kw):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1], kw))
        return ops.attention(q, k, v, **kw)

    x = torch.randn((1, 8, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    tattn.mla_forward(tp, tcfg, x, positions=torch.arange(8)[None],
                      kernel_fn=spy)
    assert seen == [(96, 96, 64, {"causal": True})]


@pytest.mark.parametrize("head_dims", [False, True])
@pytest.mark.parametrize("pos", [[5, 9], [3, 16], [0, 15]])
def test_mla_decode_vs_reference(head_dims, pos):
    """One absorbed-weight decode step from a random latent cache: the
    output and the cache with its new row (a row past the cache, pos
    16 of 16, is not written, as the reference's scatter drops it)."""
    cfg, tcfg, p, tp = _layer(2, head_dims)
    m = cfg.mla
    rng = np.random.default_rng(6)
    B, S = 2, 16
    c_kv = rng.standard_normal((B, S, m.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((B, S, m.qk_rope_head_dim)) \
        .astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    out, cache = jattn.mla_decode(
        p, cfg, jnp.asarray(x),
        {"c_kv": jnp.asarray(c_kv), "k_rope": jnp.asarray(k_rope)},
        jnp.asarray(pos, jnp.int32))
    tcache = {"c_kv": torch.as_tensor(c_kv.copy()),
              "k_rope": torch.as_tensor(k_rope.copy())}
    ref_c = tcache["c_kv"]
    tout, tcache = tattn.mla_decode(tp, tcfg, torch.as_tensor(x), tcache,
                                    torch.as_tensor(pos, dtype=torch.int32))
    assert tcache["c_kv"] is ref_c                      # written in place
    _close(tout, out)
    _close(tcache["c_kv"], cache["c_kv"])
    _close(tcache["k_rope"], cache["k_rope"])
    for b, i in enumerate(pos):
        if i >= S:
            np.testing.assert_array_equal(tcache["c_kv"][b].numpy(),
                                          c_kv[b])


def test_mla_decode_matches_forward():
    """Decode at position T - 1 from the forward's latent rows of the
    first T - 1 tokens gives the forward's last output: the absorbed
    form is the naive one, held inside the port."""
    _, tcfg, _, tp = _layer(3, head_dims=True)
    T = 10
    x = torch.randn((2, T, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    full, (c_kv, k_rope) = tattn.mla_forward(
        tp, tcfg, x, positions=torch.arange(T)[None])
    cache = {"c_kv": torch.zeros_like(c_kv), "k_rope": torch.zeros_like(
        k_rope)}
    cache["c_kv"][:, :T - 1] = c_kv[:, :T - 1]
    cache["k_rope"][:, :T - 1] = k_rope[:, :T - 1]
    dec, cache = tattn.mla_decode(tp, tcfg, x[:, -1:], cache,
                                  torch.full((2,), T - 1, dtype=torch.int32))
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(cache["c_kv"].numpy(), c_kv.numpy(),
                               rtol=RTOL, atol=1e-6)
