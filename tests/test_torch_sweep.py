"""Run-level parity of the port's sweep engine, its exact contracts, and
its isolation from JAX.

* The port's ``run_sweep(device="cpu")`` against the reference
  ``run_sweep`` on the golden site: ``worst_parity`` <= 1e-3 (the
  reference's own parity band), including a remainder chunk.
* The port against ``tests/data/preflow_golden.json["results"]`` (x32):
  <= 1e-3. Those results were captured under JAX's original threefry
  counter scheme, so this run draws with ``threefry_partitionable=False``.
* With faults and flows on (test_torch_step.py's ``HARSH`` and
  ``FLOWS`` knobs), the port against the reference over a whole run,
  under the original scheme: <= 1e-3 (see the test for the number
  reached).
* Zero fault knobs and ``flow_mode=0`` leave every fault and flow
  accumulator at exactly 0; exactly one fold fetch per run.
* ``run_sim`` (one scenario, one chunk) and ``compare_traces`` against
  the reference's within 1e-3; the schema version and the fault/flow
  fingerprints are the reference's.
* Importing the port (planner and checkpoint included) and running a
  sweep, a planned sweep and a resume loads neither ``jax`` nor
  ``repro``; with no CUDA device, ``run_sweep()`` raises.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import simulator as JS
from repro.core.topology import FBSite as JSite
from repro.core.traffic import TRAFFIC_SPECS as JSPECS
from repro_torch.core import simulator as TS
from repro_torch.core.topology import FBSite as TSite
from repro_torch.core.traffic import TRAFFIC_SPECS as TSPECS

GOLDEN = Path(__file__).with_name("data") / "preflow_golden.json"
SRC = Path(__file__).resolve().parents[1] / "src"
PARITY_TOL = 1e-3
SITE = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
            csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend (with each other and with the other test
    workers), so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_runs(S, Site, specs):
    """The golden capture's rows (tests/test_flows.py:_golden_runs)."""
    site = Site(**SITE)

    def p(spec, **kw):
        return S.SimParams(spec=specs[spec], site=site, **kw)
    return [(p("fb_hadoop", gating_enabled=True, rate_scale=1.6), 8),
            (p("fb_hadoop", gating_enabled=False, rate_scale=1.6), 9),
            (p("fb_web", gating_enabled=True), 3)]


@pytest.fixture(scope="module")
def golden_run():
    """The port on the golden config, with the fold fetches it made."""
    g = json.loads(GOLDEN.read_text())
    cfg = g["config"]
    batch = TS.make_batch(_golden_runs(TS, TSite, TSPECS))
    before = TS.HOST_TRANSFER_COUNT
    res = TS.run_sweep(batch, cfg["ticks"], chunk_ticks=cfg["chunk_ticks"],
                       device="cpu", threefry_partitionable=False)
    return g, batch, res, TS.HOST_TRANSFER_COUNT - before


def test_golden_results_x32(golden_run):
    g, batch, res, _ = golden_run
    rows = g["results"]
    assert [r["label"] for r in rows] == list(batch.labels)
    keys = [k for k in TS.PARITY_KEYS if k in rows[0]]
    diff, where = TS.worst_parity(rows, res, keys)
    assert diff <= PARITY_TOL, (diff, where)


def test_zero_knobs_leave_fault_and_flow_accumulators_zero(golden_run):
    _, _, res, _ = golden_run
    zero = ("fault_dropped_pkts", "fault_drop_frac", "wake_retries",
            "forced_wakes", "conn_loss_ticks", "link_fault_frac",
            "delay_fault_stall_us", "fault_stall_frac", "flows_started",
            "flows_completed", "flows_evicted", "fct_p99_us",
            "fct_slowdown_p99")
    for r in res:
        for k in zero:
            assert r[k] == 0.0, (r["label"], k, r[k])
        assert not any(r["fct_slow_hist"][c][b] for c in range(3)
                       for b in range(len(r["fct_slow_hist"][c])))
        assert r["injected_pkts"] > 0


def test_one_fold_fetch_per_run(golden_run):
    assert golden_run[3] == 1


def test_run_parity_vs_reference_with_remainder_chunk():
    """300 ticks in chunks of 128: two full chunks and a remainder of
    44, on both engines; the default (partitionable) threefry scheme."""
    jres = JS.run_sweep(JS.make_batch(_golden_runs(JS, JSite, JSPECS)), 300,
                        chunk_ticks=128)
    before = TS.HOST_TRANSFER_COUNT
    tres = TS.run_sweep(TS.make_batch(_golden_runs(TS, TSite, TSPECS)), 300,
                        chunk_ticks=128, device="cpu")
    assert TS.HOST_TRANSFER_COUNT - before == 1
    diff, where = TS.worst_parity(jres, tres)
    assert diff <= PARITY_TOL, (diff, where)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose(b["delay_hist"], a["delay_hist"],
                                   rtol=PARITY_TOL, atol=1e-9)


HARSH = dict(wake_fail_prob=0.30, wake_jitter_frac=0.50,
             link_mtbf_ticks=500.0, repair_ticks=40, plane_fail_prob=0.01)
FLOWS = dict(flow_mode=1, flow_arrival_rate=0.3, flow_size_dist="datamining",
             incast_degree=4, flow_table_cap=12)


def _faults_flows_runs(S, Site, specs):
    site = Site(**SITE)
    kw = dict(HARSH, **FLOWS)
    return [(S.SimParams(spec=specs["fb_hadoop"], site=site,
                         gating_enabled=True, rate_scale=1.6, **kw), 8),
            (S.SimParams(spec=specs["fb_web"], site=site,
                         gating_enabled=False, **kw), 3),
            (S.SimParams(spec=specs["university"], site=site,
                         gating_enabled=True, rate_scale=1.5, **kw), 0)]


def test_run_parity_with_faults_and_flows():
    """Faults and the flow engine on (test_torch_step.py's HARSH and
    FLOWS knobs) on the golden site: fb_hadoop lcdc x1.6 s8, fb_web base
    s3 and university lcdc x1.5 s0, 2,000 ticks in chunks of 500, under
    the original threefry scheme, the port against the reference.
    Reached: worst_parity 1.5e-7. (Before the flow engine's emissions
    were summed in the reference's order, 3.9e-2: see ROADMAP Queue 3.)"""
    with jax.threefry_partitionable(False):
        ref = JS.run_sweep(JS.make_batch(_faults_flows_runs(JS, JSite,
                                                            JSPECS)),
                           2000, chunk_ticks=500)
    res = TS.run_sweep(TS.make_batch(_faults_flows_runs(TS, TSite, TSPECS)),
                       2000, chunk_ticks=500, device="cpu",
                       threefry_partitionable=False)
    assert [r["label"] for r in res] == [r["label"] for r in ref]
    assert all(r["flows_started"] > 0 for r in res)
    assert any(r["fault_dropped_pkts"] > 0 for r in res)
    diff, where = TS.worst_parity(ref, res)
    assert diff <= PARITY_TOL, (diff, where)


def test_run_sweep_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = TS.make_batch(_golden_runs(TS, TSite, TSPECS)[:1])
    with pytest.raises(RuntimeError, match="CUDA"):
        TS.run_sweep(batch, 5)


def test_run_sim_matches_the_reference():
    """One scenario in one chunk: the reference's single scan without a
    fold."""
    jp = _golden_runs(JS, JSite, JSPECS)[0][0]
    tp = _golden_runs(TS, TSite, TSPECS)[0][0]
    ref = JS.run_sim(jp, 200, seed=8)
    res = TS.run_sim(tp, 200, seed=8, device="cpu")
    assert res["label"] == ref["label"] and res["ticks"] == 200
    diff, where = TS.worst_parity([ref], [res])
    assert diff <= PARITY_TOL, (diff, where)


def test_compare_traces_matches_the_reference():
    ref = JS.compare_traces(n_ticks=40, traces=("fb_web",))
    res = TS.compare_traces(n_ticks=40, traces=("fb_web",), device="cpu")
    assert list(res) == list(ref) == ["fb_web"]
    diff, where = TS.worst_parity(
        [ref["fb_web"]["lcdc"], ref["fb_web"]["baseline"]],
        [res["fb_web"]["lcdc"], res["fb_web"]["baseline"]])
    assert diff <= PARITY_TOL, (diff, where)
    for k in ("switch_energy_savings", "latency_penalty"):
        assert abs(res["fb_web"][k] - ref["fb_web"][k]) <= PARITY_TOL * max(
            abs(ref["fb_web"][k]), 1.0), k


def test_schema_and_fingerprints_are_the_reference():
    assert TS.SIM_SCHEMA_VERSION == JS.SIM_SCHEMA_VERSION
    assert TS.fault_fingerprint() == JS.fault_fingerprint()
    assert TS.flow_fingerprint() == JS.flow_fingerprint()
    jp, tp = (S.SimParams(spec=specs["fb_web"], link_mtbf_ticks=50.0,
                          repair_ticks=3, flow_mode=1, incast_degree=2)
              for S, specs in ((JS, JSPECS), (TS, TSPECS)))
    assert TS.fault_fingerprint(tp) == JS.fault_fingerprint(jp)
    assert TS.flow_fingerprint(tp) == JS.flow_fingerprint(jp)


def test_port_imports_neither_jax_nor_reference(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.core import checkpoint as CK, planner\n"
        "from repro_torch.core import simulator as S\n"
        "from repro_torch.core.topology import FBSite\n"
        "from repro_torch.core.traffic import TRAFFIC_SPECS\n"
        "import repro_torch.core.convert, repro_torch.kernels.ops\n"
        "site = FBSite(n_clusters=1, racks_per_cluster=3, "
        "servers_per_rack=4, csw_per_cluster=2, n_fc=2)\n"
        "other = FBSite(n_clusters=1, racks_per_cluster=2, "
        "servers_per_rack=4, csw_per_cluster=2, n_fc=2)\n"
        "runs = [(S.SimParams(spec=TRAFFIC_SPECS['fb_web'], site=s), 0) "
        "for s in (site, other)]\n"
        "b = S.make_batch(runs[:1])\n"
        "r = S.run_sweep(b, 20, chunk_ticks=8, device='cpu')\n"
        "assert r[0]['ticks'] == 20\n"
        f"spec = CK.CheckpointSpec(directory={str(tmp_path)!r}, tag='g')\n"
        "S.run_sweep(b, 20, chunk_ticks=8, device='cpu', validate=True, "
        "checkpoint=spec)\n"
        "r2 = S.resume_sweep(CK.latest_checkpoint(spec.directory, 'g'), "
        "device='cpu')\n"
        "assert r2[0]['injected_pkts'] == r[0]['injected_pkts']\n"
        "r64 = S.run_sweep(b, 20, chunk_ticks=8, device='cpu', x64=True)\n"
        "assert r64[0]['ticks'] == 20\n"
        "p = S.run_sweep_planned(runs, 20, max_compiles=2, chunk_ticks=8, "
        "device='cpu')\n"
        "assert [x['plan_bucket'] for x in p] == [0, 1]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(repr(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
