"""The port's analytic models against the reference: the Fig 1 / Fig 11
power models (core/energy.py), the Fig 1 network designs
(core/topology.py) and the node-level hiding condition
(core/node_model.py).

All of it is plain float64 Python in both packages, so the port must
equal the reference exactly (``==``, no tolerance) on every design, at
util 0.3 / 0.5 / 0.7 and several transceiver on-fractions; and
tests/test_energy_node.py's own checks hold on the port.
"""
import dataclasses

import pytest
from hypothesis import given, strategies as st

from repro.core import energy as JE
from repro.core import node_model as JN
from repro.core import topology as JT
from repro_torch.core import constants as C
from repro_torch.core import energy as E
from repro_torch.core import node_model as N
from repro_torch.core import topology as T

UTILS = (0.30, 0.50, 0.70)
ON_FRACS = (0.0, 0.25, 0.4, 0.613, 1.0)


def test_every_reference_name_exists_in_the_port():
    for ref, port in ((JE, E), (JN, N)):
        names = {n for n in vars(ref) if not n.startswith("__")
                 and n not in ("annotations", "dataclass", "C")}
        assert names <= set(vars(port)), names - set(vars(port))
    for n in ("NetworkDesign", "fb_site_design",
              "flattened_butterfly_design", "fat_tree_designs",
              "all_designs"):
        assert hasattr(T, n), n
    for n in ("TPU_PEAK_BF16_FLOPS", "TPU_HBM_BW", "TPU_ICI_LINK_BW",
              "TPU_ICI_LINKS_PER_CHIP", "ICI_XCVR_W"):
        assert getattr(C, n) == getattr(__import__(
            "repro.core.constants", fromlist=[n]), n), n


def test_designs_equal_the_reference():
    port = [dataclasses.asdict(d) for d in T.all_designs()]
    ref = [dataclasses.asdict(d) for d in JT.all_designs()]
    assert port == ref
    for p, r in zip(T.all_designs(), JT.all_designs()):
        assert p.network_power_w() == r.network_power_w()
    assert [dataclasses.asdict(d) for d in T.fat_tree_designs(4096)] \
        == [dataclasses.asdict(d) for d in JT.fat_tree_designs(4096)]
    assert dataclasses.asdict(T.flattened_butterfly_design(1000)) \
        == dataclasses.asdict(JT.flattened_butterfly_design(1000))


def test_model_tables_equal_the_reference():
    assert E.SERVER_PEAK_W == JE.SERVER_PEAK_W
    assert E.SERVER_SPLIT == JE.SERVER_SPLIT
    assert E.OPT_STEPS == JE.OPT_STEPS
    assert sorted(E.UTIL_CURVES) == sorted(JE.UTIL_CURVES)
    for k in JE.UTIL_CURVES:
        for u in (0.0, 0.1, 0.3, 0.77, 1.0):
            assert E.UTIL_CURVES[k](u) == JE.UTIL_CURVES[k](u)


@pytest.mark.parametrize("util", UTILS)
@pytest.mark.parametrize("design", range(5))
def test_power_breakdown_series_equal(design, util):
    got = E.power_breakdown_series(T.all_designs()[design], util)
    want = JE.power_breakdown_series(JT.all_designs()[design], util)
    assert got == want


@pytest.mark.parametrize("util", UTILS)
def test_final_network_fractions_equal(util):
    assert E.final_network_fractions(util) == JE.final_network_fractions(util)


@pytest.mark.parametrize("on_frac", ON_FRACS)
@pytest.mark.parametrize("util", UTILS)
def test_dc_savings_equal(util, on_frac):
    got = E.dc_savings(on_frac, util)
    want = JE.dc_savings(on_frac, util)
    assert list(got) == list(want)
    for k in want:
        assert dataclasses.asdict(got[k]) == dataclasses.asdict(want[k]), k


# ---- tests/test_energy_node.py's checks, on the port ----------------------

def test_stack_budget_and_constants_in_sync():
    assert N.STACK_STAGES == JN.STACK_STAGES
    assert tuple(ns for _, ns in N.STACK_STAGES) == C.TCP_STACK_NS
    assert sum(C.TCP_STACK_NS) == 3750
    assert C.SENDMSG_TO_TX_US * 1000 <= sum(C.TCP_STACK_NS)


def test_laser_turn_on_hidden():
    t = N.default_timing()
    assert dataclasses.asdict(t) == dataclasses.asdict(JN.default_timing())
    assert t.hidden and t.added_latency_ns == 0.0 and t.slack_ns == 2749.375
    assert N.hiding_condition(C.LASER_ON_US)
    assert N.max_hideable_laser_on_us() == JN.max_hideable_laser_on_us()
    assert N.max_hideable_laser_on_us() >= 3.0


@given(st.floats(0.01, 10.0))
def test_property_hiding_condition(laser_us):
    assert N.hiding_condition(laser_us) == JN.hiding_condition(laser_us) \
        == (laser_us + C.CDR_LOCK_US <= C.SENDMSG_TO_TX_US)


@given(st.floats(0.01, 20.0))
def test_property_timing_agrees_with_hiding_condition(laser_us):
    t = N.NodeTiming(stack_ns=int(C.SENDMSG_TO_TX_US * 1000),
                     laser_on_ns=int(laser_us * 1000),
                     cdr_ns=C.CDR_LOCK_US * 1000)
    r = JN.NodeTiming(**dataclasses.asdict(t))
    assert (t.slack_ns, t.hidden, t.added_latency_ns) \
        == (r.slack_ns, r.hidden, r.added_latency_ns)
    assert t.hidden == (t.added_latency_ns == 0.0)
    assert t.hidden == N.hiding_condition(t.laser_on_ns / 1000.0)
    excess = (t.laser_on_ns + t.cdr_ns) - t.stack_ns
    assert t.added_latency_ns == pytest.approx(max(0.0, excess))


def test_fig1_network_fraction_grows():
    fracs = []
    for d in T.all_designs():
        series = E.power_breakdown_series(d, util=0.30)
        net = [sum(v for k, v in frac.items() if k != "servers")
               for _, _, frac in series]
        assert net[0] < 0.25 and net[-1] > net[1]
        fracs.append(net[-1])
    assert sum(fracs) / len(fracs) > 0.25
    series = E.power_breakdown_series(T.fb_site_design(), util=0.30)
    assert sum(v for k, v in series[-1][2].items() if k != "servers") > 0.15


def test_fig1_final_transceiver_fraction():
    fr = E.final_network_fractions(0.30)
    tx = [v["transceivers"] for v in fr.values()]
    full = [v["phy_nic_transceivers"] for v in fr.values()]
    assert 0.10 <= sum(tx) / len(tx) <= 0.30
    assert max(full) >= 0.35


def test_fig11_dc_savings():
    res = E.dc_savings(transceiver_on_frac=0.4, util=0.30)
    avg = res["average"]
    assert 0.06 <= avg.savings_links_only <= 0.20
    assert avg.savings_with_phy_nic > avg.savings_links_only
    assert 0.15 <= avg.savings_with_phy_nic <= 0.35
    designs = [r for k, r in res.items() if k != "average"]
    expect = sum(r.transceiver_frac for r in designs) / len(designs)
    assert res["average"].transceiver_frac == pytest.approx(expect)
    assert res["average"].transceiver_frac > 0.05


def test_fb_site_counts_and_positive_power():
    s = T.FBSite()
    assert s.n_servers == 6144 and s.n_racks == 128
    assert s.n_rsw_csw_links == 512 and s.n_csw_fc_links == 64
    assert s.transceiver_power_w() == JT.FBSite().transceiver_power_w()
    for d in T.all_designs():
        assert all(v > 0 for v in d.network_power_w().values())
