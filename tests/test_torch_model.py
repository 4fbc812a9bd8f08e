"""The port's model stack and configs against the reference.

For reduced qwen3-0.6b, qwen3-8b, rwkv6-7b, minicpm3-4b (MLA),
mixtral-8x7b (MoE, sliding window), jamba-v0.1-52b (Mamba + attention +
MoE, one 8-sublayer period) and kimi-k2-1t-a32b (a dense prefix layer,
then MoE), the reference's random
parameters are carried across with ``core.convert.params_from_numpy``;
the port's prefill logits and every cache leaf (``cache_from_numpy``
maps the reference's stacked caches) are compared with
``repro.models.model.prefill``, then three greedy ``decode_step``s from
the merged cache. Float32 throughout, rtol 1e-4 and atol 1e-5 of the
leaf's largest magnitude: both sides run the same float32 operations,
in other summation orders and with XLA's fusions on the reference side,
and a sum that cancels to a small value (a wkv state entry) keeps the
rounding error of its larger terms.

The configs must name the same models with the same fields, layer kinds
and parameter counts. ``convert`` must lay the reference's stacks
(jamba's period of 8, kimi-k2's ``prefix0``) out in model order, float32
leaves kept float32; ``init_params`` gives its layout for every family,
the frontends' (hubert's GELU MLP and untied head, internvl's
backbone) too. The frontends themselves are held in
tests/test_torch_frontends.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.kernels import ops
from repro_torch.models import model as TM

ARCHS = ["qwen3-0.6b", "qwen3-8b", "rwkv6-7b", "minicpm3-4b",
         "mixtral-8x7b", "jamba-v0.1-52b", "kimi-k2-1t-a32b"]
#: the families this slice adds, for the port-side decode-consistency
#: checks (the reference's tests/test_decode_consistency.py)
NEW_ARCHS = ARCHS[3:]
#: the audio and vision frontends (tests/test_torch_frontends.py)
FRONTEND_ARCHS = ["hubert-xlarge", "internvl2-76b"]
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


def _models(arch, seed=0, **over):
    cfg = jconfigs.reduced(jconfigs.get_config(arch), **over)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), **over)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp))


def _merge(dst, src):
    """The reference tests' prefix merge of a prefill cache into a
    longer one."""
    if dst.shape == src.shape:
        return src
    for ax in range(dst.ndim):
        if dst.shape[ax] != src.shape[ax]:
            sl = [slice(None)] * dst.ndim
            sl[ax] = slice(0, src.shape[ax])
            return dst.at[tuple(sl)].set(src)
    return src


def _assert_caches_close(tcache, jcache):
    want = convert.cache_from_numpy(jax.device_get(jcache))
    assert len(tcache["layers"]) == len(want["layers"])
    assert torch.equal(tcache["pos_offset"].int(), want["pos_offset"].int())
    for got, ref in zip(tcache["layers"], want["layers"]):
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].shape == ref[k].shape, k
            _close(got[k], ref[k].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_vs_reference(arch):
    cfg, tcfg, jp, tp = _models(arch)
    B, T, max_len = 2, 12, 16
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, T))
    jl, jc = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    tl, tc = TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)},
                        kernel_fns=ops.model_kernel_fns())
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    _assert_caches_close(tc, jc)

    jc = jax.tree.map(_merge, JM.init_cache(cfg, B, max_len,
                                            dtype=cfg.dtype), jc)
    full = TM.init_cache(tcfg, B, max_len, device="cpu")
    TM.write_cache(full, tc)
    _assert_caches_close(full, jc)
    tok = np.argmax(np.asarray(jl), -1)[:, None]
    tc = full
    for t in range(T, T + 3):
        jl, jc = JM.decode_step(cfg, jp, jc, jnp.asarray(tok, jnp.int32),
                                jnp.full((B,), t, jnp.int32))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.as_tensor(tok),
                                torch.full((B,), t, dtype=torch.int32),
                                kernel_fns=ops.model_kernel_fns())
        _close(tl, jl)
        _assert_caches_close(tc, jc)
        tok = np.argmax(np.asarray(jl), -1)[:, None]


def test_decode_matches_full_forward():
    """Decode from a prefill cache equals the prefill of the longer
    sequence (the reference's decode-consistency property, held inside
    the port)."""
    _, tcfg, _, tp = _models("qwen3-8b", seed=3)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, tcfg.vocab, (2, 10)))
    full, _ = TM.prefill(tcfg, tp, {"tokens": toks})
    _, pre = TM.prefill(tcfg, tp, {"tokens": toks[:, :-1]})
    cache = TM.init_cache(tcfg, 2, 10, device="cpu")
    TM.write_cache(cache, pre)
    dec, _ = TM.decode_step(tcfg, tp, cache, toks[:, -1:],
                            torch.full((2,), 9, dtype=torch.int32))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=3e-5,
                               rtol=RTOL)


@pytest.mark.parametrize("arch", ARCHS + FRONTEND_ARCHS)
def test_init_matches_reference_layout(arch):
    """init_params / init_cache give the reference's leaves, shapes and
    dtypes (values differ: another generator)."""
    cfg, tcfg, _, want = _models(arch)
    got = TM.init_params(tcfg, 0, device="cpu")
    assert set(got) == set(want)
    assert len(got["layers"]) == len(want["layers"]) == cfg.n_layers

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, f"{prefix}{k}.")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from flat(v, f"{prefix}{i}.")
        else:
            yield prefix, tree

    g, w = dict(flat(got)), dict(flat(want))
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    cache = TM.init_cache(tcfg, 3, 20, device="cpu")
    ref = convert.cache_from_numpy(jax.device_get(
        JM.init_cache(cfg, 3, 20, dtype=cfg.dtype)))
    g, w = dict(flat(cache)), dict(flat(ref))
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k


def test_init_params_is_seeded():
    tcfg = tconfigs.reduced(tconfigs.get_config("rwkv6-7b"))
    a = TM.init_params(tcfg, 7, device="cpu")
    b = TM.init_params(tcfg, 7, device="cpu")
    c = TM.init_params(tcfg, 8, device="cpu")
    assert torch.equal(a["layers"][1]["rwkv"]["wk"],
                       b["layers"][1]["rwkv"]["wk"])
    assert not torch.equal(a["layers"][1]["rwkv"]["wk"],
                           c["layers"][1]["rwkv"]["wk"])


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen3-8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(tcfg, 1, 8)


def test_params_from_numpy_keeps_bf16_bits():
    cfg = jconfigs.reduced(jconfigs.get_config("qwen3-8b"),
                           dtype=jnp.bfloat16)
    jp = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(jp)
    want = np.asarray(jp["stack"]["sub0"]["attn"]["wq"][1], np.float32)
    got = tp["layers"][1]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_configs_name_the_same_models():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS:
        for red in (False, True):
            j = jconfigs.get_config(arch)
            t = tconfigs.get_config(arch)
            if red:
                j, t = jconfigs.reduced(j), tconfigs.reduced(t)
            jf, tf = dataclasses.asdict(j), dataclasses.asdict(t)
            assert jnp.dtype(jf.pop("dtype")).name == \
                str(tf.pop("dtype")).removeprefix("torch.")
            assert jf == tf, arch
            assert t.n_params() == j.n_params()
            assert t.padded_vocab == j.padded_vocab
            assert [t.layer_kind(i) for i in range(t.n_layers)] == \
                [j.layer_kind(i) for i in range(j.n_layers)]
            assert [t.ffn_kind(i) for i in range(t.n_layers)] == \
                [j.ffn_kind(i) for i in range(j.n_layers)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_matches_full_forward_new_families(arch):
    """The reference's decode-consistency property on the port (MoE
    capacity raised, as there, so that drops do not differ between the
    two token counts)."""
    _, tcfg, _, tp = _models(arch, seed=1, capacity_factor=8.0)
    B, T = 2, 12
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tcfg.vocab, (B, T)))
    full, _ = TM.prefill(tcfg, tp, {"tokens": toks})
    _, pre = TM.prefill(tcfg, tp, {"tokens": toks[:, :-1]})
    cache = TM.init_cache(tcfg, B, T, device="cpu")
    TM.write_cache(cache, pre)
    dec, new = TM.decode_step(tcfg, tp, cache, toks[:, -1:],
                              torch.full((B,), T - 1, dtype=torch.int32))
    assert float((dec - full).abs().max()) < 3e-3
    for a, b in zip(cache["layers"], new["layers"]):
        assert {k: (v.shape, v.dtype) for k, v in a.items()} == \
            {k: (v.shape, v.dtype) for k, v in b.items()}


def test_swa_rolling_cache_mixtral():
    """The reference's test of that name on the port: with the prompt
    longer than the window the prefill cache is rolled, and the decode
    step from it gives the full forward's logits; both equal the
    reference's."""
    cfg, tcfg, jp, tp = _models("mixtral-8x7b", seed=4, swa_window=8,
                                capacity_factor=8.0)
    B, T = 2, 16
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (B, T))
    full, _ = TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks)})
    _, cache = TM.prefill(tcfg, tp, {"tokens": torch.as_tensor(toks[:, :-1])})
    assert cache["layers"][0]["k"].shape[1] == 8
    pos = torch.full((B,), T - 1, dtype=torch.int32)
    dec, _ = TM.decode_step(tcfg, tp, cache, torch.as_tensor(toks[:, -1:]),
                            pos)
    assert float((dec - full).abs().max()) < 3e-3
    _, jc = JM.prefill(cfg, jp, {"tokens": jnp.asarray(toks[:, :-1],
                                                       jnp.int32)})
    jdec, _ = JM.decode_step(cfg, jp, jc, jnp.asarray(toks[:, -1:],
                                                      jnp.int32),
                             jnp.full((B,), T - 1, jnp.int32))
    _close(dec, jdec)


@pytest.mark.parametrize("arch,n_layers", [("jamba-v0.1-52b", 16),
                                           ("kimi-k2-1t-a32b", 3)])
def test_convert_lays_out_the_stack_in_model_order(arch, n_layers):
    """jamba: two periods of 8 sublayers (``stack["sub<j>"]`` with a
    leading axis of 2); kimi-k2: ``prefix0`` (dense) then the stacked
    MoE layers. Layer i of the port is the reference's layer i, its
    mixer and FFN those of ``layer_kind(i)``/``ffn_kind(i)``; the
    router, A_log and D stay float32 beside bf16 weights, and so do
    Mamba's conv and h states in the cache."""
    cfg = jconfigs.reduced(jconfigs.get_config(arch), n_layers=n_layers,
                           dtype=jnp.bfloat16)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch), n_layers=n_layers,
                            dtype=torch.bfloat16)
    jp = jax.device_get(JM.init_params(cfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_numpy(jp)
    assert len(tp["layers"]) == n_layers
    n_prefix = cfg.first_dense
    period = len(jp["stack"])
    for i, layer in enumerate(tp["layers"]):
        kind, ffn = TM.layer_kinds(tcfg)[i]
        assert kind in layer and ffn in layer, (i, sorted(layer))
        if i < n_prefix:
            src = jp[f"prefix{i}"]
        else:
            j = i - n_prefix
            src = jax.tree.map(lambda a: a[j // period],
                               jp["stack"][f"sub{j % period}"])
        for path, want in jax.tree_util.tree_leaves_with_path(src):
            got = layer
            for k in path:
                got = got[k.key]
            np.testing.assert_array_equal(got.float().numpy(),
                                          np.asarray(want, np.float32))
        if ffn == "moe":
            assert layer["moe"]["router"].dtype == torch.float32
            assert layer["moe"]["w_up"].dtype == torch.bfloat16
        if kind == "mamba":
            assert layer["mamba"]["A_log"].dtype == torch.float32
            assert layer["mamba"]["D"].dtype == torch.float32
            assert layer["mamba"]["in_proj"].dtype == torch.bfloat16
    cache = convert.cache_from_numpy(jax.device_get(
        JM.init_cache(cfg, 2, 8, dtype=cfg.dtype)))
    ours = TM.init_cache(tcfg, 2, 8, device="cpu")
    for (kind, _), got, want in zip(TM.layer_kinds(tcfg), ours["layers"],
                                    cache["layers"]):
        assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
            {k: (v.shape, v.dtype) for k, v in want.items()}
        if kind == "mamba":
            assert want["conv"].dtype == want["h"].dtype == torch.float32

