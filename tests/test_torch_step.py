"""Tick-level parity: one simulator step of the port against the JAX
reference, from ONE state.

The reference runs k ticks, its ``SimState`` is carried across with
``repro_torch.core.convert``, both engines step once, and every leaf is
compared: integer and boolean leaves (keys, flow tables, stages, timers)
must be equal; float leaves (queues, cwnds, accumulators) must agree to
ATOL + RTOL*|x|. Both sides do the same float32 operations; the band
covers the few sums XLA orders differently and the products it fuses
into adds where the port rounds twice (ulp-level, measured <= 1e-7
relative).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import simulator as JS
from repro.core import workloads as JW
from repro.core.topology import FBSite as JSite
from repro.core.traffic import TRAFFIC_SPECS as JSPECS
from repro_torch.core import convert, prng, workloads
from repro_torch.core import simulator as TS
from repro_torch.core.topology import FBSite as TSite
from repro_torch.core.traffic import TRAFFIC_SPECS as TSPECS

RTOL = ATOL = 1e-6
K_TICKS = 40

SITE = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
            csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)
SMALL = dict(n_clusters=1, racks_per_cluster=5, servers_per_rack=6,
             csw_per_cluster=3, n_fc=1, csw_ring_links=2, fc_ring_links=4)
HARSH = dict(wake_fail_prob=0.30, wake_jitter_frac=0.50,
             link_mtbf_ticks=500.0, repair_ticks=40, plane_fail_prob=0.01)
FLOWS = dict(flow_mode=1, flow_arrival_rate=0.3, flow_size_dist="datamining",
             incast_degree=4, flow_table_cap=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend (with each other and with the other test
    workers), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CASES = {
    "rate": ([SITE], {}),
    "flows": ([SITE], FLOWS),
    "harsh_faults": ([SITE], HARSH),
    "multi_site": ([SITE, SMALL], dict(HARSH, plane_fail_prob=0.0)),
}


def _runs(S, Site, specs, sites, knobs):
    runs = []
    for i, s in enumerate(sites):
        site = Site(**s)
        runs += [(S.SimParams(spec=specs["fb_hadoop"], site=site,
                              gating_enabled=True, rate_scale=1.6,
                              **knobs), 8 + i),
                 (S.SimParams(spec=specs["fb_web"], site=site,
                              gating_enabled=False, **knobs), 3 + i)]
    return runs


def _batches(case):
    sites, knobs = CASES[case]
    build = (lambda S: S.make_batch) if len(sites) == 1 else \
        (lambda S: S.make_multi_site_batch)
    jb = build(JS)(_runs(JS, JSite, JSPECS, sites, knobs))
    tb = build(TS)(_runs(TS, TSite, TSPECS, sites, knobs))
    return jb, tb


@functools.lru_cache(maxsize=None)
def _jstep(hull):
    return jax.jit(jax.vmap(JS.make_sim_step(hull)))


def _leaves(state):
    """Flat {path: numpy} of a reference SimState."""
    out = {}
    for f in JS.SimState._fields:
        v = getattr(state, f)
        if isinstance(v, dict):
            out.update({f"{f}.{k}": np.asarray(a) for k, a in v.items()})
        elif isinstance(v, tuple):
            out.update({f"{f}.{g}": np.asarray(getattr(v, g))
                        for g in v._fields})
        else:
            out[f] = np.asarray(v)
    return out


def _assert_state_close(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k, a in want.items():
        b = got[k]
        assert a.shape == b.shape, (k, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_and_init_state_match(case):
    jb, tb = _batches(case)
    assert jb.labels == tb.labels and jb.seeds == tb.seeds
    jscen = jax.device_get(jb.scen)
    for f in TS.Scenario._fields:
        np.testing.assert_array_equal(getattr(tb.scen, f).numpy(),
                                      np.asarray(getattr(jscen, f)),
                                      err_msg=f)
    _, state, _, _, _ = JS._prepare_sweep_args(jb, fold="device")
    init = TS._init_state(tb.hull, tb.scen, prng.key(tb.seeds))
    _assert_state_close(_leaves(jax.device_get(state)),
                        convert.state_to_numpy(init))


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_tick_from_shared_state(case):
    jb, tb = _batches(case)
    scen, state, _, _, _ = JS._prepare_sweep_args(jb, fold="device")
    jstep = _jstep(jb.hull)
    for _ in range(K_TICKS):
        state = jstep(scen, state)
    shared = jax.device_get(state)
    if case == "flows":
        assert np.asarray(shared.ft_rem).any(), "flow table never filled"
    if case == "harsh_faults":
        assert np.asarray(shared.rsw_fault.timer).any(), "no fault struck"
    want = _leaves(jax.device_get(jstep(scen, state)))
    tscen = convert.scenario_from_numpy(jax.device_get(scen))
    step = TS.make_sim_step(tb.hull, tscen, flows=tb.flows)
    got = convert.state_to_numpy(step(convert.state_from_numpy(shared)))
    _assert_state_close(want, got)


def test_convert_round_trip():
    jb, _ = _batches("harsh_faults")
    _, state, _, _, _ = JS._prepare_sweep_args(jb, fold="device")
    shared = jax.device_get(state)
    back = convert.state_to_numpy(convert.state_from_numpy(shared))
    for k, a in _leaves(shared).items():
        assert back[k].dtype == a.dtype or k == "key", k
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_step_runs_on_explicit_device_only():
    """The step keeps every tensor on the scenarios' device (CPU here):
    nothing is created on another device behind the caller's back."""
    _, tb = _batches("rate")
    state = TS._init_state(tb.hull, tb.scen, prng.key(tb.seeds))
    out = TS.make_sim_step(tb.hull, tb.scen, flows=tb.flows)(state)
    leaves = convert.state_to_numpy(out)
    assert all(isinstance(v, np.ndarray) for v in leaves.values())
    assert out.rsw_q.device == torch.device("cpu")


@pytest.mark.parametrize("dist", [0, 1])
def test_flow_size_sampler_and_classes_match(dist):
    """The flow engine's inverse-CDF sampler, size classes and ideal
    FCT on a grid of uniforms: sizes and classes equal, ideal FCT
    within an ulp."""
    u = np.concatenate([np.linspace(0.0, 1.0, 4001, endpoint=False),
                        np.asarray(JW.CDF_PROB[dist][:-1])]) \
        .astype(np.float32)
    want = np.asarray(jax.jit(JW.sample_flow_size_pkts)(u, dist))
    got = workloads.sample_flow_size_pkts(torch.as_tensor(u), dist).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        workloads.flow_size_class(torch.as_tensor(got)).numpy(),
        np.asarray(JW.flow_size_class(want)))
    np.testing.assert_allclose(
        workloads.ideal_fct_us(torch.as_tensor(got), 6.75).numpy(),
        np.asarray(JW.ideal_fct_us(want, 6.75)), rtol=2 ** -23)
