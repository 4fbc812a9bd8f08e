"""Both switch tiers of a tick (``switch_tiers``) and the in-place tick
a CUDA graph replays (``step_into``), on the CPU.

* ``repro_torch.kernels.ref.switch_tiers_ref`` (the plain version the
  CUDA kernel is held against on the card, and the tick's CPU path)
  against the reference's own composition, run under ``jax.jit``: its
  two ``switch_step_ref`` calls and the glue around them
  (src/repro/core/simulator.py:1068-1125), vmapped over scenarios, on
  the same numpy-seeded inputs, at a small hull and at ``FBSite()``
  widths, with and without faulted links and on a padded hull. The
  outputs are all float: queues and waits agree to FLOAT_RTOL (8
  float32 ulp) relative to the larger of the two values and
  OPERAND_SCALE, as tests/test_torch_switch.py holds one tier; to_csw,
  fc_in and the accumulators are sums over racks, CSWs or a whole tier
  that XLA and PyTorch take in other orders, so they are held to
  SUM_RTOL relative (up to 2,050 non-negative terms a scenario;
  measured at most 2.4e-7, in to_csw). The CSW queues inherit to_csw's
  difference through their arrivals (at most 8.5e-7 of their own value,
  well inside 8 ulp of OPERAND_SCALE).
* ``step_into`` on static buffers against the functional step, bit for
  bit over 50 ticks, in both threefry schemes.
* ``run_sweep`` on the CPU runs eagerly: it captures nothing and refuses
  ``graph=True``. (Its results against the golden file are pinned by
  tests/test_torch_sweep.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import prng
from repro_torch.core import simulator as TS
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS
from repro_torch.kernels import lcdc_switch, ops
from repro_torch.kernels import ref as tref

FLOAT_RTOL = 8 * 2.0 ** -23     # 8 float32 ulp, relative
OPERAND_SCALE = 32.0            # queues <= 15, arrivals <= 3, caps <= 25
SUM_RTOL = 1e-6

SMALL = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
             csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)
ODD = dict(n_clusters=3, racks_per_cluster=5, servers_per_rack=6,
           csw_per_cluster=3, n_fc=1, csw_ring_links=2, fc_ring_links=4)
#: (sites, share of links faulted, seed)
CASES = {
    "small": ((SMALL,), 0.0, 1),
    "small_faults": ((SMALL,), 0.2, 2),
    "fbsite": (({},), 0.0, 3),
    "fbsite_faults": (({},), 0.15, 4),
    "padded": (({}, ODD), 0.1, 5),
}
HARSH = dict(wake_fail_prob=0.30, wake_jitter_frac=0.50,
             link_mtbf_ticks=300.0, repair_ticks=20, plane_fail_prob=0.01)
FLOWS = dict(flow_mode=1, flow_arrival_rate=0.3, flow_size_dist="datamining",
             incast_degree=4, flow_table_cap=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors on the CPU: intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(sites):
    runs = [(TS.SimParams(spec=TRAFFIC_SPECS["fb_web"], site=FBSite(**s),
                          gating_enabled=g), i)
            for i, s in enumerate(sites) for g in (True, False)]
    return TS.make_multi_site_batch(runs)


def _inputs(case):
    """switch_tiers' arguments as numpy arrays (arrivals as the tick's
    (B, R, 3) ``by_dest``, its last two columns taken later)."""
    sites, share, seed = CASES[case]
    batch = _batch(sites)
    hull = batch.hull
    rack_valid, csw_valid = (m.numpy() for m in
                             TS._site_masks(hull, batch.scen)[:2])
    B, R, P = len(batch), hull.n_racks, hull.csw_per_cluster
    NC, CUP = hull.n_csw, hull.csw_uplinks
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.random(shape) * scale).astype(np.float32)

    def timers(*shape):
        return np.where(rng.random(shape) < share,
                        rng.integers(1, 40, shape), 0).astype(np.int32)

    args = [f32(B, R, P, 2, scale=15),
            rng.integers(1, P + 1, (B, R)).astype(np.int32),
            rng.random((B, R)) < 0.3, timers(B, R, P), rack_valid,
            f32(B, R, 3, scale=3), f32(B, NC, CUP, scale=15),
            rng.integers(1, CUP + 1, (B, NC)).astype(np.int32),
            rng.random((B, NC)) < 0.3, timers(B, NC, CUP), csw_valid,
            (10 + rng.random(B) * 15).astype(np.float32)]
    acc = {k: f32(B, scale=50) for k in lcdc_switch.TIER_ACC}
    return args, acc


def _reference_tiers(rsw_q, rsw_stage, rsw_drain, rsw_timer, rack_valid,
                     by_dest, csw_q, csw_stage, csw_drain, csw_timer,
                     csw_valid, cap, acc):
    """One scenario's switch tiers as the reference tick runs them
    (src/repro/core/simulator.py:1068-1125)."""
    R, P = rsw_q.shape[:2]
    NC = csw_q.shape[0]
    NCL = NC // P
    acc = dict(acc)
    (rsw_q, served_split, _, _, rsw_drop, rsw_wait, rsw_m1,
     rsw_m2) = jref.switch_step_ref(
        rsw_q, rsw_stage, by_dest[:, 1:], rsw_drain,
        valid=rack_valid[:, None] & (rsw_timer == 0), cap=cap,
        serve_rate=1.0)
    acc["drops"] += jnp.sum(rsw_drop)
    acc["rsw_backlog"] += jnp.sum(rsw_q) + jnp.sum(served_split)
    acc["rsw_served"] += jnp.sum(served_split)
    acc["rsw_occ_m1"] += jnp.sum(rsw_m1)
    acc["rsw_occ_m2"] += jnp.sum(rsw_m2)
    to_csw = jnp.sum(served_split.reshape(NCL, R // NCL, P, 2), axis=1)
    inter_in = to_csw[..., 1].reshape(NC)
    (new_csw_q, cserve, _, _, csw_drop, csw_wait, csw_m1,
     csw_m2) = jref.switch_step_ref(
        csw_q, csw_stage, inter_in, csw_drain,
        valid=csw_valid[:, None] & (csw_timer == 0), cap=cap,
        serve_rate=4.0)
    acc["drops"] += jnp.sum(csw_drop)
    acc["csw_up_backlog"] += jnp.sum(csw_q)
    acc["csw_up_served"] += jnp.sum(cserve)
    acc["csw_occ_m1"] += jnp.sum(csw_m1)
    acc["csw_occ_m2"] += jnp.sum(csw_m2)
    fc_in = jnp.sum(cserve, axis=0)
    return rsw_q, rsw_wait, to_csw, new_csw_q, csw_wait, fc_in, acc


_jtiers = jax.jit(jax.vmap(_reference_tiers))


def _torch_args(args, acc):
    t = [torch.as_tensor(a) for a in args]
    t[5] = t[5][..., 1:]              # the tick's strided by_dest view
    return (*t, {k: torch.as_tensor(v) for k, v in acc.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_switch_tiers_ref_vs_reference(case):
    args, acc = _inputs(case)
    want = _jtiers(*[jnp.asarray(a) for a in args],
                   {k: jnp.asarray(v) for k, v in acc.items()})
    got = tref.switch_tiers_ref(*_torch_args(args, acc))
    assert isinstance(got, lcdc_switch.Tiers)
    pairs = [(n, g, w) for n, g, w in zip(got._fields[:6], got[:6],
                                          want[:6])]
    pairs += [(f"acc.{k}", got.acc[k], want[6][k])
              for k in lcdc_switch.TIER_ACC]
    assert sorted(got.acc) == sorted(lcdc_switch.TIER_ACC)
    for name, g, w in pairs:
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, name
        d = np.abs(g.astype(np.float64) - w)
        big = np.maximum(np.abs(g), np.abs(w))
        if name in ("to_csw", "fc_in") or name.startswith("acc."):
            assert np.all(d <= SUM_RTOL * big), (name, d.max())
        else:
            assert np.all(d <= FLOAT_RTOL * np.maximum(big, OPERAND_SCALE)), \
                (name, d.max())


def test_ops_switch_tiers_dispatch_cpu_goes_to_plain_version():
    args, acc = _inputs("small_faults")
    before = lcdc_switch.LAUNCHES
    got = ops.switch_tiers(*_torch_args(args, acc))
    want = tref.switch_tiers_ref(*_torch_args(args, acc))
    assert lcdc_switch.LAUNCHES == before
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)
    assert all(torch.equal(got.acc[k], want.acc[k]) for k in want.acc)


def test_switch_tiers_kernel_wrapper_refuses_cpu_tensors():
    args, acc = _inputs("small")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lcdc_switch.switch_tiers(*_torch_args(args, acc))


def _leaves_equal(a, b):
    pairs = list(TS._leaf_pairs(a, b))
    assert len(pairs) == 32 + len(TS.ACC_SHAPES)    # every leaf
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)


@pytest.mark.parametrize("partitionable", [True, False])
def test_step_into_matches_the_functional_step(partitionable):
    """The in-place tick a CUDA graph replays, on the CPU: 50 ticks of
    ``step_into`` on static buffers leave exactly the state of 50
    functional steps, under faults and the flow engine."""
    site = FBSite(**SMALL)
    runs = [(TS.SimParams(spec=TRAFFIC_SPECS["fb_hadoop"], site=site,
                          gating_enabled=True, rate_scale=1.6, **HARSH,
                          **FLOWS), 8),
            (TS.SimParams(spec=TRAFFIC_SPECS["fb_web"], site=site,
                          gating_enabled=False, **HARSH), 3)]
    batch = TS.make_batch(runs)
    scen = batch.scen
    step = TS.make_sim_step(batch.hull, scen, flows=batch.flows,
                            threefry_partitionable=partitionable)
    state = TS._init_state(batch.hull, scen, prng.key(batch.seeds))
    static = TS._init_state(batch.hull, scen, prng.key(batch.seeds))
    buffers = [t.data_ptr() for t, _ in TS._leaf_pairs(static, static)]
    for _ in range(50):
        state = step(state)
        TS.step_into(step, static)
    assert [t.data_ptr() for t, _ in TS._leaf_pairs(static, static)] \
        == buffers                    # written in place
    assert _leaves_equal(static, state)
    assert float(state.acc["fault_link_ticks"].sum()) > 0
    assert float(state.acc["flows_started"].sum()) > 0


def test_cpu_sweep_runs_eagerly_without_a_capture():
    batch = _batch((SMALL,))
    before = TS.CAPTURE_COUNT
    res = TS.run_sweep(batch, 60, chunk_ticks=25, device="cpu")
    assert TS.CAPTURE_COUNT == before
    assert res[0]["ticks"] == 60 and res[0]["injected_pkts"] > 0
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        TS.run_sweep(batch, 5, device="cpu", graph=True)
