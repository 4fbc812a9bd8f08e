"""The port's stage controller (repro_torch/core/gating.py) against the
reference (repro/core/gating.py), fed identical inputs and uniforms.

Everything here is integer or boolean state plus float comparisons, so
every output must be equal (no tolerance): the watermark products
hi*cap and lo*cap are the same float32 products on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gating as jg
from repro_torch.core import gating as tg


def _state(rng, S, L, *, busy=True):
    stage = rng.integers(1, L + 1, S).astype(np.int32)
    up = (rng.integers(0, 4, S) * (rng.random(S) < 0.3)).astype(np.int32) \
        if busy else np.zeros(S, np.int32)
    draining = (rng.random(S) < 0.3) & (stage > 1)
    off = (rng.integers(0, 11, S) * (rng.random(S) < 0.2)).astype(np.int32)
    hold = (rng.integers(0, 50, S) * (rng.random(S) < 0.3)).astype(np.int32)
    powered = np.arange(L)[None, :] < stage[:, None]
    return (stage, up, draining, off, hold, powered)


def _queues(rng, S, L):
    q = (rng.random((S, L)) * 25).astype(np.float32)
    q[rng.random((S, L)) < 0.2] = 0.0            # drained top queues
    return q


def _eq(a, b, what=""):
    a = [np.asarray(x) for x in a]
    b = [x.numpy() for x in b]
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(y, x.astype(y.dtype),
                                      err_msg=f"{what}[{i}]")


def _j(st):
    return jg.GateState(*[jnp.asarray(x) for x in st])


def _t(st):
    return tg.GateState(*[torch.as_tensor(x) for x in st])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gate_step_fault_free(seed):
    rng = np.random.default_rng(seed)
    S, L = 200, 4
    st, q = _state(rng, S, L), _queues(rng, S, L)
    max_stage = rng.integers(1, L + 1, S).astype(np.int32)
    kw = dict(cap=20.0, hi=0.75, lo=0.22, dwell=16)
    want = jax.jit(lambda s, q, m: jg.gate_step(s, q, max_stage=m, **kw))(
        _j(st), jnp.asarray(q), jnp.asarray(max_stage))
    got = tg.gate_step(_t(st), torch.as_tensor(q),
                       max_stage=torch.as_tensor(max_stage), **kw)
    _eq(want, got, "gate")


@pytest.mark.parametrize("seed,fail_p,jitter", [(0, 0.0, 0.0),
                                                (1, 0.3, 0.5),
                                                (2, 0.9, 1.0)])
def test_gate_step_fault_mode(seed, fail_p, jitter):
    """Jittered and failing wakes plus the min-connectivity fallback,
    with per-switch knob columns as the sweep engine passes them."""
    rng = np.random.default_rng(seed)
    S, L = 300, 4
    st, q = _state(rng, S, L), _queues(rng, S, L)
    link_ok = rng.random((S, L)) < 0.6
    link_ok[:10] = False
    link_real = np.arange(L)[None, :] < rng.integers(1, L + 1, S)[:, None]
    u_j = rng.random(S).astype(np.float32)
    u_f = rng.random(S).astype(np.float32)
    fwake = rng.integers(0, 3, S).astype(np.int32)
    fallback = rng.random(S) < 0.8
    knobs = dict(dwell=np.full(S, 16, np.int32),
                 wake_fail_prob=np.full(S, fail_p, np.float32),
                 wake_jitter_frac=np.full(S, jitter, np.float32))
    j_out, j_fw, j_diag = jax.jit(
        lambda s, q, ok, real, uj, uf, fw, fb, kn: jg.gate_step(
            s, q, cap=20.0, hi=0.75, lo=0.22, link_ok=ok, link_real=real,
            u_jitter=uj, u_fail=uf, fault_wake=fw, fallback=fb, **kn))(
        _j(st), q, link_ok, link_real, u_j, u_f, fwake, fallback, knobs)
    t_out, t_fw, t_diag = tg.gate_step(
        _t(st), torch.as_tensor(q), cap=20.0, hi=0.75, lo=0.22,
        link_ok=torch.as_tensor(link_ok),
        link_real=torch.as_tensor(link_real),
        u_jitter=torch.as_tensor(u_j), u_fail=torch.as_tensor(u_f),
        fault_wake=torch.as_tensor(fwake),
        fallback=torch.as_tensor(fallback),
        **{k: torch.as_tensor(v) for k, v in knobs.items()})
    _eq(j_out, t_out, "gate")
    _eq([j_fw, j_diag["retries"], j_diag["forced"]],
        [t_fw, t_diag["retries"], t_diag["forced"]], "fault")
    if fail_p == 0.0:
        # zero knobs and all-healthy links: identical to the plain path
        ok_all = torch.ones((S, L), dtype=torch.bool)
        z = torch.zeros(S)
        a, _, _ = tg.gate_step(_t(st), torch.as_tensor(q), dwell=16,
                               link_ok=ok_all, u_jitter=z, u_fail=z,
                               fault_wake=torch.as_tensor(fwake))
        b = tg.gate_step(_t(st), torch.as_tensor(q), dwell=16)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("plane_p", [0.0, 0.05])
def test_fault_arrivals_with_plane_hazards(plane_p):
    rng = np.random.default_rng(3)
    S, L = 256, 4
    timer = (rng.integers(0, 5, (S, L))
             * (rng.random((S, L)) < 0.3)).astype(np.int32)
    u = rng.random((S, L)).astype(np.float32)
    plane_u = np.broadcast_to(rng.random((1, L)).astype(np.float32),
                              (S, L)).copy()
    powered = rng.random((S, L)) < 0.7
    real = rng.random((S, L)) < 0.9
    want = jax.jit(lambda *a: jg.fault_arrivals(
        *a[:4], 0.05, 40, plane_u=a[4], plane_fail_prob=plane_p))(
        timer, u, powered, real, plane_u)
    got = tg.fault_arrivals(*[torch.as_tensor(x) for x in
                              (timer, u, powered, real)], 0.05, 40,
                            plane_u=torch.as_tensor(plane_u),
                            plane_fail_prob=plane_p)
    _eq(want, got, "fault_arrivals")
    # zero hazards leave an all-zero carry all-zero
    t0, f0 = tg.fault_arrivals(torch.zeros((S, L), dtype=torch.int32),
                               torch.as_tensor(u), torch.as_tensor(powered),
                               torch.as_tensor(real), 0.0, 40,
                               plane_u=torch.as_tensor(plane_u),
                               plane_fail_prob=0.0)
    assert not bool(t0.any()) and not bool(f0.any())


def test_watermark_triggers_and_usable_links():
    rng = np.random.default_rng(4)
    S, L = 300, 4
    q = _queues(rng, S, L)
    stage = rng.integers(1, L + 1, S).astype(np.int32)
    drain = rng.random(S) < 0.5
    valid = rng.random((S, L)) < 0.8
    cap = rng.uniform(10, 25, S).astype(np.float32)
    for lv in (None, valid):
        want = jg.watermark_triggers(jnp.asarray(q), jnp.asarray(stage),
                                     cap=jnp.asarray(cap), hi=0.75, lo=0.22,
                                     link_valid=None if lv is None
                                     else jnp.asarray(lv))
        got = tg.watermark_triggers(torch.as_tensor(q),
                                    torch.as_tensor(stage),
                                    cap=torch.as_tensor(cap), hi=0.75,
                                    lo=0.22, link_valid=None if lv is None
                                    else torch.as_tensor(lv))
        _eq(want, got, "triggers")
    _eq([jg.usable_links(jnp.asarray(stage), jnp.asarray(drain), L)],
        [tg.usable_links(torch.as_tensor(stage), torch.as_tensor(drain),
                         L)], "usable")


def test_stall_attribution_and_init():
    rng = np.random.default_rng(5)
    S, L = 64, 4
    st = _state(rng, S, L)
    wake = rng.integers(0, 4, S).astype(np.int32)
    timer = np.zeros((S, L), np.int32)
    on = rng.random(S) < 0.5
    want = jg.stall_attribution(_j(st), jg.FaultState(jnp.asarray(timer),
                                                      jnp.asarray(wake)),
                                jnp.asarray(on))
    got = tg.stall_attribution(_t(st), tg.FaultState(
        torch.as_tensor(timer), torch.as_tensor(wake)), torch.as_tensor(on))
    _eq(want, got, "stall")
    _eq(jg.gate_init(S, L), tg.gate_init(S, L), "gate_init")
    _eq(jg.fault_init(S, L), tg.fault_init(S, L), "fault_init")
