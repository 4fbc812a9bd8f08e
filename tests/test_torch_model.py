"""The port's model stack and configs against the reference.

For reduced qwen3-0.6b, qwen3-8b and rwkv6-7b, the reference's random
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
and parameter counts; kinds the port does not run yet must raise.
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

ARCHS = ["qwen3-0.6b", "qwen3-8b", "rwkv6-7b"]
RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=RTOL,
                               atol=ATOL * scale)


def _models(arch, seed=0):
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
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


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch,item", [("minicpm3-4b", "13b"),
                                       ("mixtral-8x7b", "13c"),
                                       ("kimi-k2-1t-a32b", "13c"),
                                       ("jamba-v0.1-52b", "13d")])
def test_unported_kinds_raise(arch, item):
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        TM.init_params(tcfg, 0, device="cpu")


def test_frontends_raise():
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen3-8b"))
    tp = TM.init_params(tcfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13i"):
        TM.prefill(tcfg, tp, {"patches": torch.zeros(1, 4, 64),
                              "tokens": torch.zeros(1, 4, dtype=torch.long)})
