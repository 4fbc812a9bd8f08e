"""The port's ICI-gating analysis (core/ici_gating.py) against the
reference's.

* tests/test_hlo_ici.py's policy cases, on the port.
* ``scheduled_policy`` equal to the reference's (plain float64 Python).
* ``reactive_policy``: the port runs the controller as a loop of ticks
  of its ``gating.gate_step`` on the device, the reference as one jitted
  ``lax.scan``. ``link_on_frac`` (powered link-ticks, an integer count)
  must be exact and ``latency_penalty`` (the stall, float32 ticks summed
  in order) within ``PENALTY_RTOL`` relative (measured: equal on every
  case below). The cases cover idle gaps, a step with no collective
  tail, several layer counts, a tick longer than 1 us and a small
  ``max_ticks``.
* ``phases_from_dryrun`` and ``analyze_cell`` on a synthetic dry-run
  record in ``tmp_path``, both modules' ``RESULTS`` pointed there;
  ``analyze_all`` finds nothing in an empty directory, as the reference.
"""
import dataclasses
import json
import runpy
from pathlib import Path

import pytest
import torch

from repro.core import ici_gating as JI
from repro_torch.core import ici_gating as I

PENALTY_RTOL = 1e-6
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" \
    / "torch_energy_proportional_fabric.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phases(mod=I):
    # tests/test_hlo_ici.py's: 100 us compute + 25 us collective per layer
    return mod.StepPhases("x", "train_4k", n_layers=8, t_compute_us=100.0,
                          t_collective_us=25.0, t_tail_us=50.0,
                          coll_tail_us=10.0)


def _pair(**kw):
    return I.StepPhases(**kw), JI.StepPhases(**kw)


CASES = {
    "hlo_ici": dict(arch="x", shape="train_4k", n_layers=8,
                    t_compute_us=100.0, t_collective_us=25.0,
                    t_tail_us=50.0, coll_tail_us=10.0),
    "collective_bound": dict(arch="x", shape="train_4k", n_layers=8,
                             t_compute_us=10.0, t_collective_us=50.0,
                             t_tail_us=0.0, coll_tail_us=0.0),
    "deep_no_tail": dict(arch="y", shape="serve", n_layers=32,
                         t_compute_us=313.7, t_collective_us=41.3,
                         t_tail_us=77.0, coll_tail_us=0.0),
    "long_ticks": dict(arch="z", shape="train", n_layers=61,
                       t_compute_us=1234.5, t_collective_us=321.1,
                       t_tail_us=999.0, coll_tail_us=456.7),
}
RUNS = [(c, idle, mt) for c in CASES for idle, mt in
        ((0.0, 4096), (0.4, 4096), (0.0, 300))]


# ---- tests/test_hlo_ici.py's policy cases ---------------------------------

def test_scheduled_policy_saves_energy_at_zero_latency():
    r = I.scheduled_policy(_phases())
    assert r["latency_penalty"] == 0.0
    assert 0.0 < r["ici_energy_savings"] < 0.75
    assert r["link_on_frac"] >= 0.25


def test_scheduled_policy_idle_scales_savings():
    busy = I.scheduled_policy(_phases(), idle_frac=0.0)
    idle = I.scheduled_policy(_phases(), idle_frac=0.8)
    assert idle["ici_energy_savings"] > busy["ici_energy_savings"]


def test_reactive_policy_pays_latency():
    r = I.reactive_policy(_phases(), device="cpu")
    s = I.scheduled_policy(_phases())
    assert r["ici_energy_savings"] <= s["ici_energy_savings"] + 0.15
    assert r["latency_penalty"] >= 0.0


def test_collective_bound_step_saves_little():
    ph = I.StepPhases("x", "train_4k", n_layers=8, t_compute_us=10.0,
                      t_collective_us=50.0, t_tail_us=0.0, coll_tail_us=0.0)
    assert I.scheduled_policy(ph)["ici_energy_savings"] < 0.2


# ---- against the reference ------------------------------------------------

@pytest.mark.parametrize("idle", [0.0, 0.4, 0.8])
@pytest.mark.parametrize("case", list(CASES))
def test_scheduled_policy_equal(case, idle):
    ph, jph = _pair(**CASES[case])
    assert (ph.step_us, ph.collective_duty) \
        == (jph.step_us, jph.collective_duty)
    assert I.scheduled_policy(ph, idle_frac=idle) \
        == JI.scheduled_policy(jph, idle_frac=idle)


@pytest.mark.parametrize("case,idle,max_ticks", RUNS)
def test_reactive_policy_matches_the_reference(case, idle, max_ticks):
    ph, jph = _pair(**CASES[case])
    got = I.reactive_policy(ph, idle_frac=idle, max_ticks=max_ticks,
                            device="cpu")
    want = JI.reactive_policy(jph, idle_frac=idle, max_ticks=max_ticks)
    assert sorted(got) == sorted(want)
    assert got["link_on_frac"] == want["link_on_frac"]
    assert got["ici_energy_savings"] == want["ici_energy_savings"]
    assert (got["step_us"], got["tick_us"]) \
        == (want["step_us"], want["tick_us"])
    assert got["latency_penalty"] == pytest.approx(
        want["latency_penalty"], rel=PENALTY_RTOL, abs=0)


def test_entry_points_need_a_device():
    """No CUDA device and no ``device="cpu"``: the reactive policy, the
    dry-run analysis and the port's example raise, never falling back
    to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        I.reactive_policy(_phases())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        I.analyze_all()
    example = runpy.run_path(str(EXAMPLE))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example["main"]()


def test_graph_replay_needs_a_cuda_device():
    with pytest.raises(ValueError, match="graph=True"):
        I.reactive_policy(_phases(), device="cpu", graph=True)


# ---- dry-run records --------------------------------------------------------

def _record(arch="toy", shape="train_4k", ok=True):
    # 12 scanned layers: total = L1 + 11 more layers + a tail
    per_flops, l1 = 3.2e15, 3.5e15
    return {"arch": arch, "shape": shape, "ok": ok, "acct": {
        "per_layer_flops": per_flops, "per_layer_bytes": 4.1e12,
        "per_layer_coll_link_bytes": 9.0e11,
        "total_flops": l1 + 11 * per_flops,
        "total_coll_link_bytes": 12 * 9.0e11 + 2.5e11,
        "L1": {"cost": {"flops": l1}}}}


def test_phases_from_dryrun_equal():
    rec = _record()
    for n_chips in (256, 64):
        ph = I.phases_from_dryrun(rec, n_chips)
        want = JI.phases_from_dryrun(rec, n_chips)
        assert dataclasses.asdict(ph) == dataclasses.asdict(want)
    assert ph.n_layers == I._n_scan(rec) == JI._n_scan(rec) == 12
    assert I.phases_from_dryrun({"arch": "a"}) is None
    assert I._n_scan({"acct": {"per_layer_flops": 0.0}}) == 1


def test_analyze_cell_and_all_on_a_synthetic_record(tmp_path, monkeypatch):
    monkeypatch.setattr(I, "RESULTS", tmp_path)
    monkeypatch.setattr(JI, "RESULTS", tmp_path)
    assert I.analyze_all(device="cpu") == JI.analyze_all() == []
    (tmp_path / "toy__train_4k__single.json").write_text(
        json.dumps(_record()))
    (tmp_path / "bad__train_4k__single.json").write_text(
        json.dumps(_record("bad", ok=False)))
    got = I.analyze_cell("toy", "train_4k", idle_frac=0.2, device="cpu")
    want = JI.analyze_cell("toy", "train_4k", idle_frac=0.2)
    assert got["scheduled"] == want["scheduled"]
    for k in ("arch", "shape", "collective_duty", "t_compute_us",
              "t_collective_us"):
        assert got[k] == want[k], k
    assert got["reactive"]["link_on_frac"] \
        == want["reactive"]["link_on_frac"]
    assert got["reactive"]["latency_penalty"] == pytest.approx(
        want["reactive"]["latency_penalty"], rel=PENALTY_RTOL, abs=0)
    assert I.analyze_cell("bad", "train_4k", device="cpu") is None
    assert I.analyze_cell("none", "train_4k", device="cpu") is None
    rows = I.analyze_all(device="cpu")
    assert [(r["arch"], r["shape"]) for r in rows] == [("toy", "train_4k")]
    assert [(r["arch"], r["shape"]) for r in JI.analyze_all()] \
        == [("toy", "train_4k")]
