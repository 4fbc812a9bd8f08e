"""The switch_step datapath of the port against the reference.

``repro_torch.kernels.ref.switch_step_ref`` (the plain PyTorch version,
which the CUDA kernel is held against on the card) is compared with
``repro.kernels.ref.switch_step_ref`` compiled with ``jax.jit``, as the
reference simulator runs it, on every case family of
tests/test_kernels.py and at the simulator's two tier shapes. Integer
outputs (hi/lo triggers) must be equal; float outputs must agree to
FLOAT_RTOL relative to the larger of the two values and OPERAND_SCALE
(the magnitude of the queues, arrivals and caps the cases feed in). The
tolerance is ulp-scale: both sides do the same float32 operations, but
XLA sums 8 or more ports in another order than a sequential loop, and
computes the 3-D single-component post-serve queue q - q*frac without
the fused multiply-add it uses everywhere else (the simulator never
takes that form), which cancels to an ulp of q rather than of the result.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import _build, lcdc_switch, ops
from repro_torch.kernels import ref as tref

FLOAT_RTOL = 8 * 2.0 ** -23     # 8 float32 ulp, relative
OPERAND_SCALE = 32.0            # queues <= 15, arrivals <= 3, caps <= 25

_jref = jax.jit(jref.switch_step_ref, static_argnames=("serve_rate",))


def _inputs(seed, S, L, K, *, drain=False, valid=None, cap=False,
            squeeze=False):
    rng = np.random.default_rng(seed)
    q = (rng.random((S, L, K)) * 15).astype(np.float32)
    stage = rng.integers(1, L + 1, S).astype(np.int32)
    arr = (rng.random((S, K)) * 2).astype(np.float32)
    kw = {}
    args = [q[..., 0], stage, arr[..., 0]] if squeeze else [q, stage, arr]
    args.append(rng.random(S) < 0.4 if drain else np.zeros(S, bool))
    if valid == "switch":
        v = rng.random(S) < 0.6
        args[2] = args[2] * (v[:, None] if not squeeze else v)
        kw["valid"] = v
    elif valid == "link":
        v = rng.random((S, L)) < 0.55
        v[:4] = False                    # whole-switch outages
        kw["valid"] = v
    if cap:
        kw["cap"] = np.linspace(10.0, 25.0, S).astype(np.float32)
    return args, kw


def _both(args, kw, **static):
    want = _jref(*[jnp.asarray(a) for a in args],
                 **{k: jnp.asarray(v) for k, v in kw.items()}, **static)
    got = tref.switch_step_ref(*[torch.as_tensor(a) for a in args],
                               **{k: torch.as_tensor(v)
                                  for k, v in kw.items()}, **static)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _assert_close(want, got):
    assert len(want) == len(got) == 8
    for i, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape, (i, w.shape, g.shape)
        if w.dtype.kind == "f":
            d = np.abs(w.astype(np.float64) - g)
            scale = np.maximum(np.maximum(np.abs(w), np.abs(g)),
                               OPERAND_SCALE)
            assert np.all(d <= FLOAT_RTOL * scale), (i, d.max())
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype),
                                          err_msg=str(i))


@pytest.mark.parametrize("S,L", [(128, 4), (256, 4), (128, 8), (16, 4),
                                 (100, 4)])
def test_switch_step_vs_ref(S, L):
    args, kw = _inputs(3, S, L, 1, squeeze=True)
    args[2] = args[2] * 1.5
    _assert_close(*_both(args, kw))


@pytest.mark.parametrize("S,L,K,serve_rate",
                         [(128, 4, 2, 1.0), (16, 4, 2, 1.0),
                          (64, 4, 1, 4.0), (96, 8, 3, 2.0)])
def test_switch_step_components_vs_ref(S, L, K, serve_rate):
    args, kw = _inputs(7, S, L, K, drain=True)
    _assert_close(*_both(args, kw, cap=17.0, hi=0.6, lo=0.3,
                         serve_rate=serve_rate))


@pytest.mark.parametrize("S,L,K", [(64, 4, 2), (100, 3, 1)])
def test_switch_step_valid_mask_vs_ref(S, L, K):
    args, kw = _inputs(13, S, L, K, valid="switch")
    want, got = _both(args, kw)
    _assert_close(want, got)
    nq, served, hi_t, lo_t, drop, wait, m1, m2 = got
    inv = ~kw["valid"]
    np.testing.assert_array_equal(nq[inv], args[0][inv])
    for x in (served, hi_t, lo_t, drop, wait, m1, m2):
        assert np.all(x[inv] == 0)


@pytest.mark.parametrize("S,L,K", [(64, 4, 2), (100, 4, 1), (100, 16, 2)])
def test_switch_step_per_link_valid_vs_ref(S, L, K):
    args, kw = _inputs(17, S, L, K, valid="link")
    want, got = _both(args, kw)
    _assert_close(want, got)
    nq, served, _, _, drop, _, _, _ = got
    dead = ~kw["valid"]
    np.testing.assert_array_equal(nq.sum(2)[dead], args[0].sum(2)[dead])
    assert np.all(served.sum(2)[dead] == 0)
    alldead = dead.all(axis=1)
    assert alldead[:4].all()
    np.testing.assert_allclose(drop[alldead], args[2].sum(1)[alldead],
                               rtol=1e-6)


def test_switch_step_per_switch_cap_vs_ref():
    args, kw = _inputs(11, 100, 4, 1, squeeze=True, cap=True)
    args[2] = args[2] * 1.5
    _assert_close(*_both(args, kw))


@pytest.mark.parametrize("S,L,K,serve_rate", [(1280, 4, 2, 1.0),
                                              (160, 4, 1, 4.0)])
def test_switch_step_sim_tier_shapes(S, L, K, serve_rate):
    """The simulator's RSW tier (B*R, P, 2) and CSW-uplink tier
    (B*NC, CUP) on the default site's 10-scenario grid, with drains,
    per-link faults and per-row watermark columns."""
    args, kw = _inputs(29, S, L, K, drain=True, valid="link", cap=True,
                       squeeze=K == 1)
    kw["hi"] = np.full(S, 0.75, np.float32)
    kw["lo"] = np.full(S, 0.22, np.float32)
    _assert_close(*_both(args, kw, serve_rate=serve_rate))


def test_drain_blocks_enqueue_but_serves():
    q = torch.tensor([[5.0, 9.0]])[..., None]
    nq, served, _, _, drop, wait, _, _ = tref.switch_step_ref(
        q, torch.tensor([2], dtype=torch.int32), torch.tensor([[3.0]]),
        torch.tensor([True]), cap=20.0)
    np.testing.assert_array_equal(nq[0, :, 0].numpy(), [7.0, 8.0])
    np.testing.assert_array_equal(served[0, :, 0].numpy(), [1.0, 1.0])
    assert float(drop[0]) == 0.0 and float(wait[0]) == 5.0


def test_ops_dispatch_cpu_goes_to_plain_version():
    args, kw = _inputs(5, 32, 4, 2, drain=True)
    t = [torch.as_tensor(a) for a in args]
    a = ops.switch_step(*t, serve_rate=1.0)
    b = tref.switch_step_ref(*t, serve_rate=1.0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_wrapper_refuses_cpu_tensors():
    args, _ = _inputs(5, 8, 4, 2)
    before = lcdc_switch.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        lcdc_switch.switch_step(*[torch.as_tensor(a) for a in args])
    assert lcdc_switch.LAUNCHES == before


def test_build_target_is_keyed_by_source_and_ignored_dir():
    """The kernel library lands in build/repro_torch/ (git-ignored),
    named by a hash of its source and flags; nothing builds at import."""
    target = _build._target("lcdc_switch")
    assert target.parent == _build.BUILD_DIR
    assert target.parent.parts[-2:] == ("build", "repro_torch")
    assert target.name.startswith("lcdc_switch-")
    assert "lcdc_switch" not in _build._LOADED


def test_build_target_covers_every_flag(monkeypatch):
    """A source's own flags join the common ones, and the library's name
    covers all of them: another flag for one source rebuilds only that
    source's library."""
    names = ("flash_attention", "lcdc_switch", "rwkv6_wkv")
    before = {n: _build._target(n) for n in names}
    for n in names:
        assert _build.flags(n)[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert "-Xptxas" in _build.flags(n)   # the ptxas report
    monkeypatch.setitem(_build.SOURCE_FLAGS, "rwkv6_wkv",
                        _build.SOURCE_FLAGS["rwkv6_wkv"] + ("-lineinfo",))
    assert _build._target("rwkv6_wkv") != before["rwkv6_wkv"]
    assert _build._target("flash_attention") == before["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("S,L,K,serve_rate", [(1280, 4, 2, 1.0),
                                              (160, 4, 1, 4.0),
                                              (100, 16, 2, 2.0)])
def test_cuda_kernel_vs_plain_version(S, L, K, serve_rate):
    """On the card: the CUDA kernel against the plain version, same
    inputs; integers exact, floats within 4 ulp."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    args, kw = _inputs(31, S, L, K, drain=True, valid="link", cap=True,
                       squeeze=K == 1)
    dev = torch.device("cuda")
    t = [torch.as_tensor(a).to(dev) for a in args]
    tk = {k: torch.as_tensor(v).to(dev) for k, v in kw.items()}
    before = lcdc_switch.LAUNCHES
    got = lcdc_switch.switch_step(*t, serve_rate=serve_rate, **tk)
    want = tref.switch_step_ref(*t, serve_rate=serve_rate, **tk)
    torch.cuda.synchronize()
    assert lcdc_switch.LAUNCHES == before + 1
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            d = (g.double() - w.double()).abs()
            assert bool((d <= 4 * 2.0 ** -23 * torch.maximum(
                g.double().abs(), w.double().abs())).all())
        else:
            assert torch.equal(g, w)
