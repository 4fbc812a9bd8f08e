"""The port's artifact auditor (RL007/RL008/RL009) and the planner's
``cost_model="hlo"``, beside the reference's (tests/test_artifact.py,
tests/test_planner.py).

Three layers, mirroring the auditor's own split:

* the pure checkers driven with injected violations (a collective, a
  host read, a copy between devices, a host node or a device-to-host
  copy in a captured graph, a carry leaf in new storage, the wrong fold
  dtype, a graph pool over budget, cost drift, an unblessed mode, a
  coverage miss, a calibration spread), each pinning its EXACT rule ID;
  and the op inventory read off real ops;
* the audit of the real engine: the shipped tree and committed
  contracts audit clean in x32 and x64 in one process on the CPU;
  violations injected into the real tick (a host read, an op without a
  cost rule, a carry rebound to new storage) raise their rules and the
  unpatched tick is clean; a mutated contracts file raises RL007 and
  flips the CLI ``--check`` exit code to 1;
* the planner: ``hlo_cost_table`` reads the committed contracts (the
  port's, and the reference's file as the reference reads it), and
  ``plan_sites(cost_model="hlo", cost_table=T)`` gives the reference's
  plan for the same T (buckets, padded costs, fingerprint, report).

The card's half (pool bytes, the captured graph's nodes, counts equal
to the CPU's) is in tests/test_torch_cuda.py and chip_smoke.py's phase
``analysis``.
"""
import dataclasses
import textwrap
import types
from pathlib import Path

import pytest
import torch
import torch.distributed as tdist

from repro.analysis import artifact as ref_artifact
from repro.core import planner as JP
from repro.core.topology import FBSite as JFBSite
from repro_torch.analysis import artifact as A
from repro_torch.analysis.hlo import TickCounter
from repro_torch.analysis.registry import load_config
from repro_torch.core import planner
from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite, full_site_tag
from repro_torch.launch.mesh import fake_world

REPO = Path(__file__).resolve().parents[1]
REF_CONTRACTS = REPO / "src/repro/analysis/artifact_contracts.toml"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rules(findings):
    return [f.rule for f in findings]


# ---- the pure checkers: injected violations -> exact rule IDs -----------

def test_fixture_clean_inventory_passes():
    assert A.check_op_inventory({}, {}, {}, "p", "w") == []
    assert A.check_graph_nodes({"kinds": {"kernel": 40, "memcpy": 2},
                                "copies": {"device->device": 2}},
                               "p", "w") == []
    assert A.check_in_place([], "p", "w") == []
    assert A.check_unknown_ops({}, "p", "w") == []


@pytest.mark.parametrize("kind", ["collective", "host_read", "crossing"])
def test_fixture_op_inventory_is_rl008(kind):
    found = {"collective": ({"c10d.allreduce_": 1}, {}, {}),
             "host_read": ({}, {"aten._local_scalar_dense": 2}, {}),
             "crossing": ({}, {}, {"aten._to_copy: ['cuda:0'] -> ['cpu']":
                                   1})}[kind]
    got = A.check_op_inventory(*found, "p", "w")
    assert rules(got) == ["RL008"]
    assert next(iter(next(d for d in found if d))) in got[0].message


def test_fixture_host_node_and_d2h_copy_are_rl008():
    got = A.check_graph_nodes({"kinds": {"kernel": 3, "host": 1},
                               "copies": {}}, "p", "w")
    assert rules(got) == ["RL008"]
    assert "host node" in got[0].message
    got = A.check_graph_nodes({"kinds": {"memcpy": 1},
                               "copies": {"device->host": 1}}, "p", "w")
    assert rules(got) == ["RL008"]
    assert "device->host" in got[0].message


def test_fixture_carry_in_new_storage_is_rl009():
    got = A.check_in_place(["state.rsw_q", "state.acc['drops']"], "p", "w")
    assert rules(got) == ["RL009"]
    assert "state.rsw_q" in got[0].message


def test_fixture_fold_dtype_drift_is_rl007():
    assert A.check_fold_dtype("float32", "float32", "p", "w") == []
    got = A.check_fold_dtype("float64", "float32", "p", "w")
    assert rules(got) == ["RL007"]
    assert "Kahan" in got[0].message


def test_fixture_unknown_op_is_rl007():
    got = A.check_unknown_ops({"aten.cummax.default": 1}, "p", "w")
    assert rules(got) == ["RL007"]
    assert "aten.cummax.default" in got[0].message


def test_fixture_memory_over_budget_is_rl007():
    assert A.check_memory_budget(110_000, 120_000, "p", "w") == []
    got = A.check_memory_budget(110_000, 100_000, "p", "w")
    assert rules(got) == ["RL007"]
    assert "110000 B" in got[0].message
    # budget 0 = unset: a measured peak without a budget fires too
    got = A.check_memory_budget(110_000, 0, "p", "w")
    assert rules(got) == ["RL007"]
    assert "no budget" in got[0].message
    # None = not measured (the CPU): never fires
    assert A.check_memory_budget(None, 1, "p", "w") == []
    assert A.check_memory_budget(None, 0, "p", "w") == []


def test_every_captured_case_has_a_budget_per_mode():
    """Each case of a unit the card captures (the sweep tick, run_sim's)
    carries its own peak budget in both modes, the x64 one above the
    x32 one, and the larger hull's above the smaller's."""
    units = {u["name"]: u for u in A.load_contracts(REPO)["artifact"]["unit"]}
    for name in ("sweep_tick", "run_sim"):
        for c in units[name]["case"]:
            x32, x64 = (c[f"peak_bytes_budget_{m}"] for m in A.MODES)
            assert 0 < x32 < x64, (name, c["tag"])
    tick = {c["tag"]: c["peak_bytes_budget_x32"]
            for c in units["sweep_tick"]["case"]}
    assert tick["2x2c2f2"] < tick["2x4c2f2"] < tick["4x8c4f4"]


def test_fixture_cost_drift_is_rl007():
    blessed = {"flops_per_tick_scen": 1000.0, "bytes_per_tick_scen": 2000.0}
    ok = {"flops_per_tick_scen": 1400.0, "bytes_per_tick_scen": 2100.0}
    assert A.check_cost_drift(ok, blessed, 0.5, "x32", "p", "w") == []
    bad = {"flops_per_tick_scen": 1501.0, "bytes_per_tick_scen": 2100.0}
    got = A.check_cost_drift(bad, blessed, 0.5, "x32", "p", "w")
    assert rules(got) == ["RL007"]
    assert "tick FLOPs" in got[0].message
    bad = {"flops_per_tick_scen": 1501.0, "bytes_per_tick_scen": 4000.0}
    assert rules(A.check_cost_drift(bad, blessed, 0.5, "x32", "p",
                                    "w")) == ["RL007", "RL007"]


def test_fixture_unblessed_mode_is_rl007():
    got = A.check_cost_drift({"flops_per_tick_scen": 1.0}, None, 0.5,
                             "x64", "p", "w")
    assert rules(got) == ["RL007"]
    assert "--bless-artifacts" in got[0].message


def test_fixture_coverage_miss_is_rl007():
    cfg = types.SimpleNamespace(raw={"compile_site": [
        {"file": "src/a.py", "qualname": "f"},
        {"file": "src/b.py", "qualname": "g.inner"},
        {"file": "src/c.py", "qualname": "h"},
    ]})
    art = {"unit": [{"covers": ["src/a.py::f", "src/b.py::g"]}],
           "skip": [{"file": "src/c.py", "qualname": "h",
                     "reason": "why not"}]}
    assert A.check_coverage(cfg, art) == []   # exact, prefix, skip
    art["skip"] = []
    got = A.check_coverage(cfg, art)
    assert rules(got) == ["RL007"]
    assert "src/c.py::h" in got[0].message
    art["skip"] = [{"file": "src/c.py", "qualname": "h", "reason": " "}]
    assert rules(A.check_coverage(cfg, art)) == ["RL007"]


def test_fixture_calibration_spread_is_rl007():
    cal = {"ratio_spread": 1.2, "hulls": [{"tag": "a", "ratio": 3.0}]}
    assert A.check_calibration(cal, 2.0) == []
    cal = {"ratio_spread": 2.5,
           "hulls": [{"tag": "2x2c2f2", "ratio": 2.0},
                     {"tag": "4x8c4f4", "ratio": 5.0}]}
    got = A.check_calibration(cal, 2.0)
    assert rules(got) == ["RL007"]
    assert got[0].path == "src/repro_torch/core/planner.py"
    assert "cost_model='hlo'" in got[0].message


def test_tick_counter_inventory_of_real_ops():
    """A collective (fake process group), a host read and a copy to
    another device, each seen by the counter and each RL008."""
    assert not tdist.is_initialized()
    with fake_world(2):
        x = torch.ones(4)
        with TickCounter() as tc:
            tdist.all_reduce(x)
            x.sum().item()
            torch.ones(3).to("meta")
            torch.where(x > 0, x, torch.tensor(0.0))    # a 0-d scalar
    assert tc.collectives() == {"c10d.allreduce_": 1}
    assert tc.host_reads() == {"aten._local_scalar_dense": 1}
    assert list(tc.crossings) == ["aten._to_copy: ['cpu'] -> ['meta']"]
    assert rules(A.check_op_inventory(
        tc.collectives(), tc.host_reads(), dict(tc.crossings), "p",
        "w")) == ["RL008"] * 3
    assert tc.unknown == {}


# ---- the audit of the real engine ---------------------------------------

def test_shipped_tree_audits_clean_x32_and_x64():
    """The committed engine and contracts: zero findings in both modes,
    in one process, on the CPU (the graph is the card's)."""
    findings, payload = A.run_audit(REPO, load_config(REPO), device="cpu")
    assert findings == [], "\n".join(f.format() for f in findings)
    assert set(payload["units"]) == {"sweep_tick", "run_sim",
                                     "ici_reactive"}
    assert payload["modes"] == ["x32", "x64"]
    cases = payload["units"]["sweep_tick"]["cases"]
    assert [(c["tag"], c["mode"]) for c in cases] == [
        (t, m) for m in ("x32", "x64")
        for t in ("2x2c2f2", "2x4c2f2", "4x8c4f4", "2x2c2f2+validate")]
    for c in cases:
        assert c["fold_dtype"] == {"x32": "float32",
                                   "x64": "float64"}[c["mode"]]
        assert c["leaves_in_place"]
        assert c["graph"] == c["memory"] == "not measured"
        # the switch datapath is one operator on every device
        assert c["tick"]["counts"]["flops"] > 0
    for u in payload["units"].values():
        for c in u["cases"]:
            t = c["tick"]
            assert t["collectives"] == t["host_reads"] == {}
            assert t["crossings"] == t["unknown"] == {}
    for mode in ("x32", "x64"):
        cal = payload["calibration"][mode]
        assert len(cal["hulls"]) == 3
        assert cal["ratio_spread"] <= 2.0
    # the x64 tick costs more (float64 draws through fma64)
    by = {(c["tag"], c["mode"]): c["measured"] for c in cases}
    assert by[("2x2c2f2", "x64")]["flops_per_tick_scen"] > \
        by[("2x2c2f2", "x32")]["flops_per_tick_scen"]


ONE_CASE = """\
[artifact]
schema_version = 1
cost_rtol = 0.5
max_ratio_spread = 2.0

[[artifact.unit]]
name = "sweep_tick"
builder = "sweep_tick"
file = "src/repro_torch/core/simulator.py"
fold_dtype_x32 = "{fold}"

[[artifact.unit.case]]
tag = "2x2c2f2"
ncl = 2
rpc = 2
spr = 4
cpc = 2
nfc = 2
n_scenarios = 2
"""


@pytest.fixture(scope="module")
def one_case(tmp_path_factory):
    """The shipped 2x2c2f2 case alone, its x32 band blessed."""
    p = tmp_path_factory.mktemp("contracts") / "one.toml"
    p.write_text(ONE_CASE.format(fold="float32"))
    A.run_audit(REPO, load_config(REPO), p, bless=True,
                units=["sweep_tick"], device="cpu")
    return p


def _audit(path):
    findings, _ = A.run_audit(REPO, load_config(REPO), path,
                              units=["sweep_tick"], device="cpu")
    return findings


def _with_step(monkeypatch, extra):
    """Every step make_sim_step builds runs ``extra(state)`` first."""
    make = S.make_sim_step

    def make_sim_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def bad(state):
            extra(state)
            return step(state)
        return bad
    monkeypatch.setattr(S, "make_sim_step", make_sim_step)


def test_clean_case_audits_clean(one_case):
    assert _audit(one_case) == []


def test_host_read_in_the_tick_is_rl008(one_case, monkeypatch):
    _with_step(monkeypatch, lambda st: st.rsw_q.sum().item())
    got = _audit(one_case)
    assert rules(got) == ["RL008"] * 2          # x32 and x64
    assert "_local_scalar_dense" in got[0].message


def test_op_without_cost_rule_in_the_tick_is_rl007(one_case, monkeypatch):
    _with_step(monkeypatch, lambda st: torch.cummax(st.rsw_q.flatten(), 0))
    got = _audit(one_case)
    assert "RL007" in rules(got)
    assert any("cummax" in f.message for f in got)


def test_carry_rebound_to_new_storage_is_rl009(one_case, monkeypatch):
    def rebinding(step, static):
        for d, s in S._leaf_pairs(static, step(static)):
            if d is not s:
                d.set_(s.clone())
    monkeypatch.setattr(S, "step_into", rebinding)
    got = _audit(one_case)
    assert rules(got) == ["RL009"] * 2
    assert "state.key" in got[0].message


def test_fold_dtype_contract_is_rl007(tmp_path):
    p = tmp_path / "c.toml"
    p.write_text(ONE_CASE.format(fold="float64"))
    got = _audit(p)
    assert "RL007" in rules(got)
    assert any("fold buffer dtype is float32" in f.message for f in got)


MUTATED_CONTRACTS = """\
[artifact]
schema_version = 1
cost_rtol = 0.5
max_ratio_spread = 2.0

[[artifact.unit]]
name = "ici_reactive"
builder = "ici_reactive"
file = "src/repro_torch/core/ici_gating.py"
covers = ["src/repro_torch/core/ici_gating.py::_reactive_program"]

[[artifact.unit.case]]
tag = "t256"
n_ticks = 256
tick_us = 1.0

[artifact.unit.case.measured.x32]
flops_per_tick_scen = 511000.0

[[artifact.unit.case]]
tag = "t128"
n_ticks = 128
tick_us = 1.0
"""


@pytest.fixture(scope="module")
def mutated_contracts(tmp_path_factory):
    p = tmp_path_factory.mktemp("contracts") / "mutated.toml"
    p.write_text(MUTATED_CONTRACTS)
    return p


def test_mutated_contracts_raise_rl007(mutated_contracts):
    """One audit run, injected violations: a 1000x-drifted blessed x32
    FLOPs band, and three unblessed case-modes (t256 in x64, t128 in
    both)."""
    findings, _ = A.run_audit(REPO, load_config(REPO), mutated_contracts,
                              units=["ici_reactive"], device="cpu")
    msgs = [f.message for f in findings]
    assert rules(findings) == ["RL007"] * 4, msgs
    assert sum("--bless-artifacts" in m for m in msgs) == 3
    assert any("drifted beyond" in m for m in msgs)
    assert any("--bless-artifacts" in m for m in msgs)


def test_cli_check_exits_nonzero_on_artifact_violation(mutated_contracts):
    from repro_torch.analysis.cli import main
    rc = main(["--check", "--root", str(REPO), "--device", "cpu",
               "--artifact-contracts", str(mutated_contracts),
               "--artifact-units", "ici_reactive", "-q"])
    assert rc == 1


def test_schema_version_mismatch_is_rl007(tmp_path):
    p = tmp_path / "contracts.toml"
    p.write_text("[artifact]\nschema_version = 99\n")
    findings, _ = A.run_audit(REPO, load_config(REPO), p, units=[],
                              device="cpu")
    assert rules(findings) == ["RL007"]
    assert "schema_version" in findings[0].message


# ---- the planner's cost_model="hlo" --------------------------------------

def test_hlo_cost_table_reads_committed_contracts():
    table = A.hlo_cost_table(REPO)
    # the three non-validate tick hulls, keyed by full site tag
    assert len(table) == 3
    for tag, entry in table.items():
        assert entry["flops_per_tick_scen"] > 0
        assert tag == full_site_tag(entry["site"])
    t64 = A.hlo_cost_table(REPO, mode="x64")
    assert set(t64) == set(table)
    assert all(t64[k]["flops_per_tick_scen"]
               > table[k]["flops_per_tick_scen"] for k in table)


def test_hlo_cost_table_of_the_references_file_is_the_references():
    for mode in ("x32", "x64"):
        ours = A.hlo_cost_table(contracts_path=REF_CONTRACTS, mode=mode)
        ref = ref_artifact.hlo_cost_table(mode=mode)
        assert set(ours) == set(ref)
        for tag, e in ref.items():
            assert ours[tag]["flops_per_tick_scen"] == \
                e["flops_per_tick_scen"]
            assert dataclasses.asdict(ours[tag]["site"]) == \
                dataclasses.asdict(e["site"])


def _mixed_sites(F):
    return ([F(2, 2, 4, 2, 2)] * 3 + [F(4, 8, 16, 4, 4)] * 2
            + [F(2, 4, 8, 2, 2)])


def _bench_sites(F):
    # benchmarks/bench_multi_site.py's three fabric shapes
    return [F(), F(n_clusters=2, racks_per_cluster=64, csw_per_cluster=4,
                   n_fc=4),
            F(n_clusters=8, racks_per_cluster=16, csw_per_cluster=2,
              n_fc=2, csw_ring_links=4, fc_ring_links=8)]


def _tables(source):
    """The same cost table T for the port and the reference (each with
    its own FBSite): the reference's blessed XLA table, or the port's
    blessed counted one."""
    t = ref_artifact.hlo_cost_table() if source == "reference" \
        else A.hlo_cost_table(REPO)
    mine = {k: dict(v, site=FBSite(**dataclasses.asdict(v["site"])))
            for k, v in t.items()}
    ref = {k: dict(v, site=JFBSite(**dataclasses.asdict(v["site"])))
           for k, v in t.items()}
    return mine, ref


@pytest.mark.parametrize("source", ["reference", "port"])
@pytest.mark.parametrize("sites", ["mixed", "bench_multi_site"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plan_sites_hlo_equals_the_references(source, sites, k):
    make = {"mixed": _mixed_sites, "bench_multi_site": _bench_sites}[sites]
    mine_t, ref_t = _tables(source)
    a = planner.plan_sites(make(FBSite), k, cost_model="hlo",
                           cost_table=mine_t)
    b = JP.plan_sites(make(JFBSite), k, cost_model="hlo", cost_table=ref_t)
    assert [x.indices for x in a.buckets] == [x.indices for x in b.buckets]
    assert [dataclasses.asdict(x.hull) for x in a.buckets] == \
        [dataclasses.asdict(x.hull) for x in b.buckets]
    assert [x.padded_cost for x in a.buckets] == \
        [x.padded_cost for x in b.buckets]
    assert a.fingerprint == b.fingerprint
    assert a.report() == b.report()


def test_hlo_cost_fn_exact_hit_and_scaled_fallback():
    """Synthetic table: measured hulls cost exactly their table entry;
    unmeasured hulls get site_cost rescaled by the geometric-mean
    measured/model ratio (2x and 8x -> k = 4)."""
    small, large = FBSite(2, 2, 4, 2, 2), FBSite(4, 8, 16, 4, 4)
    table = {
        full_site_tag(small): {
            "flops_per_tick_scen": 2.0 * planner.site_cost(small),
            "site": small},
        full_site_tag(large): {
            "flops_per_tick_scen": 8.0 * planner.site_cost(large),
            "site": large},
    }
    cost = planner.hlo_cost_fn(table)
    assert cost(small) == 2.0 * planner.site_cost(small)
    assert cost(large) == 8.0 * planner.site_cost(large)
    other = FBSite(3, 3, 6, 3, 3)
    assert cost(other) == pytest.approx(4.0 * planner.site_cost(other))
    bare = planner.hlo_cost_fn({})
    assert bare(other) == planner.site_cost(other)


def test_plan_sites_hlo_mode_uses_the_table():
    """A table that inverts the small/large cost ordering shows in the
    bucket costs: the cost model is consulted, not just loaded."""
    small, large = FBSite(2, 2, 4, 2, 2), FBSite(4, 8, 16, 4, 4)
    sites = [small] * 2 + [large] * 2
    table = {
        full_site_tag(small): {
            "flops_per_tick_scen": 100.0 * planner.site_cost(large),
            "site": small},
        full_site_tag(large): {
            "flops_per_tick_scen": planner.site_cost(large),
            "site": large},
    }
    plan = planner.plan_sites(sites, max_compiles=2, cost_model="hlo",
                              cost_table=table)
    by_first = {b.indices[0]: b for b in plan.buckets}
    assert by_first[0].padded_cost == pytest.approx(
        2 * 100.0 * planner.site_cost(large))
    assert by_first[2].padded_cost == pytest.approx(
        2 * planner.site_cost(large))


def test_plan_sites_hlo_mode_loads_committed_contracts():
    """Without an explicit table the mode reads the port's committed
    contracts; the bucketing matches the hand model on the blessed
    hulls (the calibration contract keeps the two proportional)."""
    sites = _mixed_sites(FBSite)
    a = planner.plan_sites(sites, max_compiles=2)
    b = planner.plan_sites(sites, max_compiles=2, cost_model="hlo")
    assert [x.indices for x in a.buckets] == \
        [x.indices for x in b.buckets]
    assert a.fingerprint == b.fingerprint   # fingerprint is cost-free


def test_counted_flops_beside_the_references_xla_count():
    """Reported, not held: the port's counted FLOPs of one tick per
    scenario over the reference's blessed XLA count for the same tag
    (an eager, unfused count against a fused program's)."""
    ours, ref = A.hlo_cost_table(REPO), ref_artifact.hlo_cost_table()
    assert set(ours) == set(ref)
    ratios = {k: ours[k]["flops_per_tick_scen"]
              / ref[k]["flops_per_tick_scen"] for k in ours}
    assert all(r > 0 for r in ratios.values()), ratios
    print(textwrap.indent("\n".join(f"{k}: {r:.2f}x"
                                    for k, r in sorted(ratios.items())),
                          "  "))
