"""The port's runtime contract sanitizers (repro_torch.analysis
.sanitizer), beside the reference's (tests/test_sanitizer.py): the sync
sanitizer around the blessed fetch points, the capture watcher that
counts tick programs by their builder, and the CAPTURE_HOOK ledger that
turns the planner pipeline's one-program-per-bucket contract into an
assertion naming the offending bucket's hull tag.

On the CPU the sync sanitizer arms nothing (torch's sync debug mode is
a CUDA feature); its teeth are tested on the card in
tests/test_torch_cuda.py and chip_smoke.py's phase ``analysis``. The
ledger and the watcher mean the same on both devices: here the tick
program is the eagerly stepped tick. A sanitized two-site sweep holds
the reference's hull tag and stays within the reference's 1e-3 parity
band (``worst_parity``) of its run.
"""
import pytest
import torch

from repro.core import simulator as JS
from repro.core.topology import FBSite as JFBSite
from repro.core.topology import full_site_tag as ref_full_site_tag
from repro.core.traffic import TRAFFIC_SPECS as J_SPECS
from repro_torch.analysis import sanitizer as SAN
from repro_torch.analysis.sanitizer import (CaptureLedger, CaptureWatcher,
                                            SanitizerSession)
from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite, full_site_tag
from repro_torch.core.traffic import TRAFFIC_SPECS
from repro_torch.device import fetch_point

TICKS, CHUNK = 200, 100
PARITY_TOL = 1e-3

SITE_KW = [dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                csw_per_cluster=3, n_fc=2, csw_ring_links=4,
                fc_ring_links=8),
           dict(n_clusters=3, racks_per_cluster=4, servers_per_rack=6,
                csw_per_cluster=2, n_fc=3, csw_ring_links=4,
                fc_ring_links=8)]
SITE_A, SITE_B = (FBSite(**kw) for kw in SITE_KW)


def _mixed(sim, site_cls, specs):
    a, b = (site_cls(**kw) for kw in SITE_KW)
    h, u = specs["fb_hadoop"], specs["university"]
    return [(sim.SimParams(spec=h, site=a), 0),
            (sim.SimParams(spec=u, site=b, rate_scale=1.5), 1),
            (sim.SimParams(spec=h, site=a, gating_enabled=False), 2),
            (sim.SimParams(spec=u, site=b), 3)]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def sweep_sanitizer():
    """Arm the runtime contract sanitizers around a sweep test: the sync
    sanitizer (torch.cuda.set_sync_debug_mode("error") on a CUDA
    device), the capture watcher and the CAPTURE_HOOK per-bucket
    ledger. Yields a repro_torch.analysis.sanitizer.SanitizerSession."""
    with SAN.sweep_sanitizer() as session:
        yield session


@pytest.fixture(scope="module")
def mixed_runs():
    return _mixed(S, FBSite, TRAFFIC_SPECS)


@pytest.fixture(scope="module")
def reference():
    """The reference's run of the same two-site sweep, and its hull."""
    batch = JS.make_multi_site_batch(_mixed(JS, JFBSite, J_SPECS))
    return (JS.run_sweep(batch, TICKS, chunk_ticks=CHUNK),
            ref_full_site_tag(batch.hull))


# ---- the capture watcher ------------------------------------------------

def test_capture_watcher_counts_programs(mixed_runs):
    """Every run builds its tick program (there is no compile cache to
    hit): two runs, two builds by make_sim_step; no capture on the
    CPU."""
    batch = S.make_batch(mixed_runs[:1])
    with CaptureWatcher() as cw:
        S.run_sweep(batch, 4, device="cpu")
        S.run_sweep(batch, 4, device="cpu", graph=False)
    assert cw.programs_of("make_sim_step") == 2
    assert cw.events == ["make_sim_step"] * 2
    assert S.make_sim_step.__name__ == "make_sim_step"   # restored


# ---- sync sanitizer + ledger around a real sweep ------------------------

def test_sweep_runs_clean_under_sanitizer(sweep_sanitizer, mixed_runs,
                                          reference):
    """The full sweep engine under the sanitizers: one tick program,
    attributed to the reference's padded hull, the ledger agreeing with
    the CAPTURE_COUNT pin, and the results within the reference's 1e-3
    band of its run."""
    n0, h0 = S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT
    res = S.run_sweep(S.make_multi_site_batch(mixed_runs), TICKS,
                      chunk_ticks=CHUNK, device="cpu")
    ref_res, ref_tag = reference
    assert len(res) == len(mixed_runs)
    assert sweep_sanitizer.ledger.tags == [ref_tag]
    assert sweep_sanitizer.ledger.new_captures() == S.CAPTURE_COUNT - n0
    assert S.HOST_TRANSFER_COUNT - h0 == 1
    assert sweep_sanitizer.watcher.programs_of("make_sim_step") == 1
    diff, where = S.worst_parity(ref_res, res)
    assert diff <= PARITY_TOL, (diff, where)
    assert [r["label"] for r in res] == [r["label"] for r in ref_res]


def test_eager_sweep_reports_its_program(sweep_sanitizer, mixed_runs):
    """graph=False on the CPU (the card's eager path too): the eagerly
    stepped tick is the program the ledger sees."""
    batch = S.make_batch(mixed_runs[:1])
    S.run_sweep(batch, 8, chunk_ticks=4, device="cpu", graph=False)
    assert sweep_sanitizer.ledger.tags == [full_site_tag(batch.hull)]


# ---- one program per bucket under pipeline=True -------------------------

def test_pipeline_one_capture_per_bucket(sweep_sanitizer, mixed_runs):
    """Under pipeline=True every plan bucket builds exactly one tick
    program, attributed per hull by the CAPTURE_HOOK ledger (not just a
    drifted global total)."""
    res, plan = S.run_sweep_planned(mixed_runs, TICKS, chunk_ticks=CHUNK,
                                    max_compiles=2, pipeline=True,
                                    return_plan=True, device="cpu")
    assert plan["n_buckets"] == 2
    sweep_sanitizer.assert_one_capture_per_bucket(plan)
    assert sorted(sweep_sanitizer.ledger.tags) == \
        sorted(b["hull"] for b in plan["buckets"])
    # the watcher agrees: one tick program built per bucket
    assert sweep_sanitizer.watcher.programs_of("make_sim_step") == \
        plan["n_buckets"]
    assert not any("error" in r for r in res)
    assert [r["label"] for r in res] == \
        list(S.make_multi_site_batch(mixed_runs).labels)


def _session_with(sites):
    cl = CaptureLedger()
    cl.sites = list(sites)
    return SanitizerSession(watcher=CaptureWatcher(), ledger=cl)


def test_retraced_bucket_fails_with_hull_tag():
    tag_a = full_site_tag(SITE_A)
    plan = {"buckets": [{"hull": tag_a}]}
    with pytest.raises(AssertionError, match="traced 2x") as ei:
        _session_with([SITE_A, SITE_A]).assert_one_capture_per_bucket(
            plan)
    assert tag_a in str(ei.value)         # names the guilty bucket


def test_untraced_bucket_fails_with_hull_tag():
    tag_a = full_site_tag(SITE_A)
    plan = {"buckets": [{"hull": tag_a}]}
    with pytest.raises(AssertionError, match="never traced") as ei:
        _session_with([]).assert_one_capture_per_bucket(plan)
    assert tag_a in str(ei.value)


def test_stray_hull_fails_with_hull_tag():
    plan = {"buckets": [{"hull": full_site_tag(SITE_A)}]}
    with pytest.raises(AssertionError, match="undeclared") as ei:
        _session_with([SITE_A, SITE_B]).assert_one_capture_per_bucket(
            plan)
    assert full_site_tag(SITE_B) in str(ei.value)


def test_plan_object_names_the_same_buckets():
    """A planner.SweepPlan works as the plan too."""
    from repro_torch.core import planner
    plan = planner.plan_sites([SITE_A, SITE_B], max_compiles=2)
    _session_with([SITE_A, SITE_B]).assert_one_capture_per_bucket(plan)


def test_ledger_restores_previous_hook():
    S.CAPTURE_HOOK = None
    with CaptureLedger():
        assert S.CAPTURE_HOOK is not None
        with CaptureLedger() as inner:
            S.CAPTURE_HOOK("fake-site")     # chains to the outer ledger
            assert inner.sites == ["fake-site"]
    assert S.CAPTURE_HOOK is None


# ---- the sync sanitizer's CPU behaviour ---------------------------------

def test_sync_sanitizer_arms_nothing_on_the_cpu():
    """Without a card the sanitizer and the fetch points touch no CUDA
    state (the mode is a CUDA feature); a CPU sweep inside both runs."""
    if torch.cuda.is_available():
        pytest.skip("the CPU-only behaviour")
    with SAN.sync_sanitizer(), fetch_point():
        x = torch.ones(3).sum().item()
    assert x == 3.0
    assert not torch.cuda.is_initialized()
