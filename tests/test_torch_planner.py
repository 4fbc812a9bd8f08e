"""The port's hull-bucketing planner and planned sweeps.

* ``plan_sites`` gives the reference's plan for the same sites: the same
  buckets, hulls, costs, ``fingerprint``, ``dispatch_order`` and
  ``report()`` (the site lists of tests/test_planner.py, and random
  lists drawn from its pool); ``FLOW_SLOTS`` tracks ``F_SLOTS``
  (``cost_model="hlo"`` against the reference's is held in
  tests/test_torch_artifact.py).
* ``run_sweep_planned`` on tests/test_planner.py's ``mixed_runs`` is
  within 1e-3 (``worst_parity``) of the reference's, with equal labels,
  ``plan_bucket`` and ``plan_hull``; pipelined equals serial bit for
  bit; ``max_compiles=1`` is ``run_sweep(make_multi_site_batch(runs))``
  bit for bit; one fold fetch per bucket.
* The isolation, retry, backoff, deadline and salvage cases of
  tests/test_faults.py and tests/test_durability.py, held inside the
  port (the retry runs eagerly on the host fold, within 1e-6 of the
  clean run).
"""
import dataclasses
from pathlib import Path

import pytest
import torch
from hypothesis import given, strategies as st

from repro.core import planner as JP
from repro.core import simulator as JS
from repro.core.topology import FBSite as JSite
from repro.core.traffic import TRAFFIC_SPECS as JSPECS
from repro_torch.core import checkpoint as CK
from repro_torch.core import planner
from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS

PARITY_TOL = 1e-3
HOST_FOLD_TOL = 1e-6
TICKS, CHUNK = 200, 80          # two full chunks and a remainder of 40

# tests/test_planner.py's sites, as field dicts for both engines
SITE_A = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
              csw_per_cluster=3, n_fc=2, csw_ring_links=4, fc_ring_links=8)
SITE_B = dict(n_clusters=3, racks_per_cluster=4, servers_per_rack=6,
              csw_per_cluster=2, n_fc=3, csw_ring_links=4, fc_ring_links=8)
_SM = dict(n_clusters=2, servers_per_rack=8, csw_per_cluster=2, n_fc=2,
           csw_ring_links=4, fc_ring_links=8)
BIMODAL = (dict(racks_per_cluster=4, **_SM), dict(racks_per_cluster=5, **_SM),
           dict(racks_per_cluster=6, **_SM), {},
           dict(racks_per_cluster=28), dict(racks_per_cluster=24))
POOL = (dict(n_clusters=1, racks_per_cluster=1, servers_per_rack=1,
             csw_per_cluster=1, n_fc=1, csw_ring_links=1, fc_ring_links=1),
        BIMODAL[0], SITE_A, SITE_B, {})
MIXED = ([dict(zip(("n_clusters", "racks_per_cluster", "servers_per_rack",
                    "csw_per_cluster", "n_fc"), v))
          for v in [(2, 2, 4, 2, 2)] * 3 + [(4, 8, 16, 4, 4)] * 2
          + [(2, 4, 8, 2, 2)]])
SITE_LISTS = {
    "bimodal": list(BIMODAL),
    "exact_groups": [SITE_A, SITE_B, SITE_A, SITE_B, SITE_A],
    "pool": list(POOL),
    "mixed": MIXED,
    "mixed_runs": [SITE_A, SITE_A, SITE_B, SITE_B],
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_plan(sites, k):
    mine = planner.plan_sites([FBSite(**s) for s in sites], max_compiles=k)
    ref = JP.plan_sites([JSite(**s) for s in sites], max_compiles=k)
    assert [b.indices for b in mine.buckets] == \
        [b.indices for b in ref.buckets]
    assert [dataclasses.astuple(b.hull) for b in mine.buckets] == \
        [dataclasses.astuple(b.hull) for b in ref.buckets]
    assert mine.fingerprint == ref.fingerprint
    assert mine.dispatch_order == ref.dispatch_order
    assert mine.report() == ref.report()
    assert [mine.bucket_tag(i) for i in range(len(mine.buckets))] == \
        [ref.bucket_tag(i) for i in range(len(ref.buckets))]
    return mine


# ---- the planner against the reference's -------------------------------

@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("name", sorted(SITE_LISTS))
def test_plan_equals_the_reference(name, k):
    _same_plan(SITE_LISTS[name], k)


@given(st.lists(st.integers(0, 4), min_size=1, max_size=12),
       st.integers(1, 5))
def test_random_plans_equal_the_reference(idxs, k):
    plan = _same_plan([POOL[i] for i in idxs], k)
    seen = sorted(i for b in plan.buckets for i in b.indices)
    assert seen == list(range(len(idxs)))


def test_flow_slots_in_sync():
    """The planner's torch-free copy of the flow-slot width tracks the
    simulator's constant (the dominant cost-model term)."""
    assert planner.FLOW_SLOTS == S.F_SLOTS == JP.FLOW_SLOTS
    assert planner.PLAN_SCHEMA_VERSION == JP.PLAN_SCHEMA_VERSION


def test_plan_rejects_bad_inputs():
    with pytest.raises(ValueError, match="empty"):
        planner.plan_sites([])
    with pytest.raises(ValueError, match="max_compiles"):
        planner.plan_sites([FBSite()], max_compiles=0)
    with pytest.raises(ValueError, match="cost_model"):
        planner.plan_sites([FBSite()], cost_model="bogus")


# ---- planned execution --------------------------------------------------

def _mixed_runs(Sim, Site, specs):
    """tests/test_planner.py's mixed_runs: two sites, two traces."""
    h, u = specs["fb_hadoop"], specs["university"]
    a, b = Site(**SITE_A), Site(**SITE_B)
    return [(Sim.SimParams(spec=h, site=a), 0),
            (Sim.SimParams(spec=h, site=a, gating_enabled=False), 0),
            (Sim.SimParams(spec=u, site=b, rate_scale=1.5), 1),
            (Sim.SimParams(spec=u, site=b, gating_enabled=False), 1)]


def _planned(runs, **kw):
    kw.setdefault("chunk_ticks", CHUNK)
    return S.run_sweep_planned(runs, TICKS, device="cpu", **kw)


@pytest.fixture(scope="module")
def piped():
    """The port's pipelined 2-bucket run of mixed_runs, with the fold
    fetches it made."""
    h0 = S.HOST_TRANSFER_COUNT
    res, plan = _planned(_mixed_runs(S, FBSite, TRAFFIC_SPECS),
                         max_compiles=2, return_plan=True)
    return res, plan, S.HOST_TRANSFER_COUNT - h0


def test_planned_matches_the_reference(piped):
    res, plan, fetches = piped
    ref, ref_plan = JS.run_sweep_planned(
        _mixed_runs(JS, JSite, JSPECS), TICKS, chunk_ticks=CHUNK,
        max_compiles=2, return_plan=True)
    assert plan == ref_plan
    assert fetches == plan["n_buckets"] == 2
    for a, b in zip(ref, res):
        assert (a["label"], a["plan_bucket"], a["plan_hull"]) == \
            (b["label"], b["plan_bucket"], b["plan_hull"])
    diff, key = S.worst_parity(ref, res)
    assert diff <= PARITY_TOL, (diff, key)


def test_serial_matches_pipelined_in_caller_order(piped):
    """pipeline=False on a shuffled copy of the runs: results come back
    in the caller's order (labels line up with make_multi_site_batch's),
    same-site scenarios share a bucket, and every result equals the
    pipelined run's for its label, bit for bit (bucket indices follow
    the caller's order, so they are the one key that moves)."""
    runs = _mixed_runs(S, FBSite, TRAFFIC_SPECS)
    shuffled = [runs[i] for i in (2, 0, 3, 1)]
    res = _planned(shuffled, max_compiles=2, pipeline=False)
    assert [r["label"] for r in res] == \
        list(S.make_multi_site_batch(shuffled).labels)
    assert res[0]["plan_bucket"] == res[2]["plan_bucket"]
    assert res[1]["plan_bucket"] == res[3]["plan_bucket"]
    assert res[0]["plan_bucket"] != res[1]["plan_bucket"]
    assert res[1]["plan_hull"] == "2x8c3f2s8r4-8"    # SITE_A's own tag
    by_label = {r["label"]: r for r in piped[0]}
    for r in res:
        want = dict(by_label[r["label"]])
        assert r.pop("plan_bucket") == 1 - want.pop("plan_bucket")
        assert r == want


def test_k1_degenerate_matches_make_multi_site_batch():
    """max_compiles=1 is the single-hull path, bit for bit."""
    runs = _mixed_runs(S, FBSite, TRAFFIC_SPECS)
    single = S.run_sweep(S.make_multi_site_batch(runs), 120,
                         chunk_ticks=50, device="cpu")
    planned = S.run_sweep_planned(runs, 120, chunk_ticks=50,
                                  max_compiles=1, device="cpu")
    for a, b in zip(single, planned):
        assert b.pop("plan_bucket") == 0
        assert b.pop("plan_hull") == "3x8c3f3s8r4-8"
        assert a == b


def test_planned_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.run_sweep_planned(_mixed_runs(S, FBSite, TRAFFIC_SPECS), 5)


# ---- bucket isolation, retries, salvage --------------------------------

#: the small two-bucket runs of tests/test_durability.py (its SITE and
#: a second site of 5 racks a cluster), at its planned-run length
DUR_SITE = dict(n_clusters=2, racks_per_cluster=3, servers_per_rack=4,
                csw_per_cluster=2, n_fc=2, csw_ring_links=2, fc_ring_links=4)
F_TICKS, F_CHUNK = 160, 80


def _fault_runs():
    a = FBSite(**DUR_SITE)
    b = FBSite(**dict(DUR_SITE, racks_per_cluster=5))
    spec = TRAFFIC_SPECS["fb_hadoop"]
    return [(S.SimParams(spec=spec, site=a), 0),
            (S.SimParams(spec=spec, site=b), 1),
            (S.SimParams(spec=spec, site=a, gating_enabled=False), 2)]


def _fail(bucket, phases=("dispatch", "fetch", "retry"), calls=None,
          message="boom"):
    def hook(k, phase):
        if calls is not None:
            calls.append((k, phase))
        if k == bucket and phase in phases:
            raise RuntimeError(message)
    return hook


def _sweep_faults(**kw):
    return S.run_sweep_planned(_fault_runs(), F_TICKS, max_compiles=2,
                               chunk_ticks=F_CHUNK, device="cpu", **kw)


@pytest.fixture(scope="module")
def clean_faults():
    return _sweep_faults()


def test_isolates_a_permanent_bucket_failure(monkeypatch, clean_faults):
    """A bucket failing dispatch AND its retry comes back as structured
    error entries in caller order; the other bucket is untouched."""
    calls = []
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK",
                        _fail(0, calls=calls, message="boom retry"))
    res = _sweep_faults()
    good = [r for r in res if "error" not in r]
    bad = [r for r in res if "error" in r]
    assert good and bad
    for r in bad:
        assert r["error"] == {"type": "RuntimeError",
                              "message": "boom retry",
                              "stage": "dispatch", "retried": True}
        assert r["plan_bucket"] == 0 and r["label"] and r["plan_hull"]
    for (p, seed), r in zip(_fault_runs(), res):
        assert f"s{seed}" in r["label"]
    by_label = {r["label"]: r for r in clean_faults}
    for r in good:
        assert r == by_label[r["label"]]
    assert (0, "retry") in calls


@pytest.mark.parametrize("stage,pipeline", [("dispatch", False),
                                            ("fetch", True)])
def test_transient_failure_is_retried_on_the_host_fold(
        monkeypatch, clean_faults, stage, pipeline):
    """A bucket failing once is retried (eager ticks, host fold, the same
    device) and succeeds within 1e-6 of the clean run."""
    calls = []
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK",
                        _fail(0, (stage,), calls, "transient"))
    res = _sweep_faults(pipeline=pipeline)
    assert all("error" not in r for r in res)
    diff, key = S.worst_parity(clean_faults, res)
    assert diff <= HOST_FOLD_TOL, (diff, key)
    assert calls.count((0, "retry")) == 1
    if stage == "dispatch" and not pipeline:
        assert calls == [(0, "dispatch"), (0, "retry"),
                         (1, "dispatch"), (1, "fetch")]


def test_backoff_schedule_and_policy_validation():
    p = S.BucketRetryPolicy(max_retries=4, backoff_base_s=0.25,
                            backoff_mult=2.0, backoff_max_s=0.6)
    assert [p.backoff_s(a) for a in (1, 2, 3, 4)] == [0.25, 0.5, 0.6, 0.6]
    d = S.BucketRetryPolicy()
    assert (d.max_retries, d.backoff_s(1), d.deadline_s) == (1, 0.0, None)
    for kw in (dict(max_retries=-1), dict(backoff_base_s=-0.1),
               dict(backoff_mult=0.5), dict(backoff_max_s=-1.0),
               dict(deadline_s=-2.0)):
        with pytest.raises(ValueError, match="BucketRetryPolicy"):
            S.BucketRetryPolicy(**kw)


def test_retry_backoff_sequence_and_structured_error(monkeypatch):
    sleeps, calls = [], []
    monkeypatch.setattr(S, "RETRY_SLEEP", sleeps.append)
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", _fail(0, calls=calls,
                                                     message="perma"))
    policy = S.BucketRetryPolicy(max_retries=3, backoff_base_s=0.25,
                                 backoff_mult=2.0, backoff_max_s=0.6)
    res = _sweep_faults(retry=policy)
    assert sleeps == [0.25, 0.5, 0.6]
    bad = [r for r in res if "error" in r]
    good = [r for r in res if "error" not in r]
    assert bad and good
    for r in bad:
        assert r["error"] == {"type": "RuntimeError", "message": "perma",
                              "stage": "dispatch", "retried": True}
    assert [c for c in calls if c[1] == "retry"] == [(0, "retry")] * 3
    assert all(r["injected_pkts"] > 0 for r in good)


def test_deadline_cuts_retries_not_results(monkeypatch):
    calls = []
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", _fail(0, calls=calls,
                                                     message="slow"))
    policy = S.BucketRetryPolicy(max_retries=5, deadline_s=0.0)
    res = _sweep_faults(retry=policy)
    bad = [r for r in res if "error" in r]
    assert bad
    for r in bad:
        assert r["error"]["retried"] is False
        assert sorted(r["error"]) == ["message", "retried", "stage", "type"]
    assert not [c for c in calls if c[1] == "retry"]
    assert [r for r in res if "error" not in r]


def test_tripped_guard_is_a_fetch_failure_the_retry_clears(
        monkeypatch, clean_faults):
    """A bucket whose conservation guard trips fails at fetch, as the
    reference's does; its retry runs on the host fold, whose guard checks
    finiteness only, so every bucket comes back within 1e-6 of the
    clean run after one retry each."""
    calls = []
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", _fail(-1, calls=calls))
    res = _sweep_faults(validate=True, validate_tol=-1.0)
    assert all("error" not in r for r in res)
    diff, key = S.worst_parity(clean_faults, res)
    assert diff <= HOST_FOLD_TOL, (diff, key)
    assert sorted(c for c in calls if c[1] == "retry") == \
        [(0, "retry"), (1, "retry")]


def test_degraded_bucket_leaves_resumable_salvage(tmp_path, monkeypatch,
                                                  clean_faults):
    """With checkpointing on, an exhausted bucket that never reached a
    chunk boundary leaves a chunk-0 salvage snapshot whose resume
    reproduces the bucket's clean results bit-identically."""
    runs = _fault_runs()
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", _fail(0, message="perma"))
    res = S.run_sweep_planned(
        runs, F_TICKS, max_compiles=2, chunk_ticks=F_CHUNK, device="cpu",
        checkpoint=CK.CheckpointSpec(directory=tmp_path, tag="plan",
                                     every_chunks=1, keep=8))
    bad = [r for r in res if "error" in r]
    good = [r for r in res if "error" not in r]
    assert bad and good
    ck = bad[0]["error"]["checkpoint"]
    assert ck is not None and Path(ck).name.endswith("-00000000.ckpt.npz")
    meta = CK.read_checkpoint(ck)[0]
    assert meta["plan"]["bucket"] == 0 and meta["plan"]["fingerprint"]
    monkeypatch.setattr(S, "BUCKET_FAIL_HOOK", None)
    resumed = S.resume_sweep(ck, device="cpu")
    by_label = {r["label"]: r for r in clean_faults}
    ref = [by_label[r["label"]] for r in resumed]
    diff, key = S.worst_parity(ref, resumed)
    assert diff == 0.0, key
