"""The port's serving path against the reference's.

The port's ``ContinuousBatcher`` and the reference's serve the same
requests (the prompts of tests/test_batcher.py) with the same random
parameters (carried across with ``core.convert.params_from_numpy``), on
reduced qwen3-0.6b and rwkv6-7b in float32. Greedy tokens must be equal
and so must the tick and idle-tick counts (``idle_fraction``): an
argmax over float32 logits that agree to ~1e-6 (test_torch_model.py)
picks the same token unless two logits tie to that precision, which
these seeds do not produce. The ``launch.serve`` path (one batched
prefill, lock-step decode) must give the reference's direct greedy
decode, token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serving.batcher import ContinuousBatcher as JBatcher
from repro.serving.batcher import Request as JRequest
from repro_torch import configs as tconfigs
from repro_torch.core import convert
from repro_torch.launch import serve
from repro_torch.serving import ContinuousBatcher, Request

PROMPTS = [[5, 9, 2, 7], [11, 3, 1, 8, 6, 2], [4, 4, 4]]
ARCHS = ["qwen3-0.6b", "rwkv6-7b"]


def _models(arch, seed=0):
    cfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, tcfg, jp, convert.params_from_numpy(jax.device_get(jp))


def _serve_both(arch, prompts, n_new, seed=0, extra_steps=0, **kw):
    cfg, tcfg, jp, tp = _models(arch, seed)
    jb = JBatcher(cfg, jp, **kw)
    tb = ContinuousBatcher(tcfg, tp, **kw)
    jr = [JRequest(rid=i, tokens=p, max_new=n_new)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, tokens=p, max_new=n_new)
          for i, p in enumerate(prompts)]
    for b, reqs in ((jb, jr), (tb, tr)):
        for r in reqs:
            b.submit(r)
        b.run(max_ticks=200)
        for _ in range(extra_steps):      # steps with every slot free
            b.step()
    return jb, jr, tb, tr


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_matches_reference(arch):
    jb, jr, tb, tr = _serve_both(arch, PROMPTS, 6, n_slots=2, max_len=64,
                                 extra_steps=2)
    for a, b in zip(jr, tr):
        assert b.done and a.done
        assert b.out == a.out, (b.rid, b.out, a.out)
    assert (tb.ticks, tb.idle_ticks) == (jb.ticks, jb.idle_ticks)
    assert tb.idle_fraction() == jb.idle_fraction() > 0
    assert tb.prefills == len(PROMPTS)


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_slot_reuse_matches_reference(arch):
    """Four requests through one slot: sequential slot reuse."""
    prompts = [[i + 1, i + 2] for i in range(4)]
    jb, jr, tb, tr = _serve_both(arch, prompts, 3, seed=1, n_slots=1,
                                 max_len=32)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert all(r.done and len(r.out) == 3 for r in tr)
    assert tb.ticks == jb.ticks and tb.decode_steps == tb.ticks


def test_batcher_eos_and_length_budget_match_reference():
    """A request ends at EOS, another at the cache's end, as in the
    reference; both free their slot for the queue."""
    _, jr, _, _ = _serve_both("qwen3-0.6b", PROMPTS, 8, n_slots=2,
                              max_len=64)
    eos = jr[1].out[3]
    jb, jr, tb, tr = _serve_both("qwen3-0.6b", PROMPTS + [[1] * 9], 8,
                                 n_slots=2, max_len=14, eos_id=eos)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert tr[1].out[-1] == eos and len(tr[1].out) < 8
    assert len(tr[3].out) < 8                  # ran into max_len
    assert tb.ticks == jb.ticks


def _direct_greedy(cfg, params, prompts, n_new):
    """The reference's serve loop: batched prefill, prefix merge into a
    cache of P + n_new positions, lock-step greedy decode."""
    toks = jnp.asarray(prompts, jnp.int32)
    B, P = toks.shape
    logits, cache = JM.prefill(cfg, params, {"tokens": toks})
    full = JM.init_cache(cfg, B, P + n_new, dtype=cfg.dtype)

    def merge(dst, src):
        if dst.shape == src.shape:
            return src
        for ax in range(dst.ndim):
            if dst.shape[ax] != src.shape[ax]:
                sl = [slice(None)] * dst.ndim
                sl[ax] = slice(0, src.shape[ax])
                return dst.at[tuple(sl)].set(src)
        return src

    cache = jax.tree.map(merge, full, cache)
    tok = jnp.argmax(logits, -1)[:, None]
    out = [tok]
    for t in range(P, P + n_new - 1):
        logits, cache = JM.decode_step(cfg, params, cache, tok,
                                       jnp.full((B,), t, jnp.int32))
        tok = jnp.argmax(logits, -1)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_matches_reference(arch):
    cfg, tcfg, jp, tp = _models(arch, seed=2)
    for prompts in ([PROMPTS[0]], [PROMPTS[1]], [PROMPTS[0], [3, 1, 4, 1]]):
        want = _direct_greedy(cfg, jp, prompts, 6)
        got = serve.generate(tcfg, tp, torch.as_tensor(prompts), 6)
        np.testing.assert_array_equal(got["tokens"].numpy(), want)
        assert got["prefill_tok_s"] > 0 and got["decode_tok_s"] > 0


def test_serve_main_on_cpu(capsys):
    res = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert tuple(res["tokens"].shape) == (2, 4)
    assert "prefill" in capsys.readouterr().out


def test_serve_main_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-8b", "--reduced"])
