"""Durable sweeps in the port: checkpoint/resume, and the file format
shared with the reference.

* Inside the port (tests/test_durability.py's SITE, KNOBS, TICKS and
  CHUNK: every stateful mechanism rides the snapshot): a checkpointed
  run is bit-identical to the plain one with exactly 1 + n_checkpoints
  host transfers; a run killed at a chunk boundary resumes
  bit-identically in one further transfer; resume keeps the cadence;
  prune bounds the files; the host fold refuses checkpoints.
* Every ``CheckpointError`` reason: the engine mismatches (schema,
  knob fingerprints, scenario fields, a float64 fold, the threefry
  scheme, the carry inventory), a truncated or bit-flipped file, a stale
  checksum, an old layout; and the atomic write.
* Across engines, on the golden site with runs tests/test_torch_sweep.py
  already holds within 1e-3, ``validate=True``: a reference-written
  checkpoint resumes in the port, and a port-written one passes the
  reference's ``read_checkpoint`` and finishes in its ``resume_sweep``,
  each within 1e-3 of the reference's uninterrupted run. This holds the
  format and the carry mapping; the tick's fault and flow dynamics are
  pinned by tests/test_torch_step.py.
"""
import io
import json

import numpy as np
import pytest
import torch

from repro.core import checkpoint as JCK
from repro.core import simulator as JS
from repro.core.topology import FBSite as JSite
from repro.core.traffic import TRAFFIC_SPECS as JSPECS
from repro_torch.core import checkpoint as CK
from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS

TICKS, CHUNK = 240, 40          # 6 chunks; cadence-2 boundaries {2, 4}
SITE = FBSite(n_clusters=2, racks_per_cluster=3, servers_per_rack=4,
              csw_per_cluster=2, n_fc=2, csw_ring_links=2, fc_ring_links=4)
# every stateful mechanism rides the snapshot: fault timers, plane
# hazards, the flow table, plus a gating-off row and a knob-free row
KNOBS = dict(link_mtbf_ticks=400.0, repair_ticks=30, wake_fail_prob=0.05,
             plane_fail_prob=1e-3, flow_mode=1, rate_scale=1.5)
PARITY_TOL = 1e-3
#: the golden capture's site (tests/data/preflow_golden.json)
GOLDEN_SITE = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                   csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                   fc_ring_links=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs():
    spec = TRAFFIC_SPECS["fb_hadoop"]
    return [(S.SimParams(spec=spec, site=SITE, **KNOBS), 3),
            (S.SimParams(spec=spec, site=SITE, gating_enabled=False,
                         **KNOBS), 4),
            (S.SimParams(spec=spec, site=SITE), 5)]


def _batch():
    return S.make_batch(_runs())


def _spec(directory, **kw):
    kw.setdefault("every_chunks", 2)
    kw.setdefault("tag", "t")
    kw.setdefault("keep", 8)
    return CK.CheckpointSpec(directory=directory, **kw)


def _run(**kw):
    return S.run_sweep(_batch(), TICKS, chunk_ticks=CHUNK, validate=True,
                       device="cpu", **kw)


def _kill_at(ci):
    def hook(c):
        if c == ci:
            raise RuntimeError("preempted")
    return hook


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted run every in-port test compares against
    (validate=True so the guard rides the snapshots too)."""
    return _run()


@pytest.fixture(scope="module")
def ckpt_file(tmp_path_factory):
    """A real mid-run checkpoint (boundary 4 of 6) for the tamper and
    rejection tests to copy and mutate."""
    d = tmp_path_factory.mktemp("seed-ckpts")
    _run(checkpoint=_spec(d, tag="seed"))
    path = CK.latest_checkpoint(d, "seed")
    assert path is not None
    return path


# ---- checkpointed runs are observation-only -----------------------------

def test_checkpointed_run_bit_identical_with_pins(tmp_path, reference):
    """Cadenced snapshots change nothing: bit-identical metrics, no
    capture, and exactly 1 + n_checkpoints transfers (cadence 2 over 6
    chunks -> boundaries {2, 4}; the final boundary is never
    snapshotted)."""
    c0, h0 = S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT
    res = _run(checkpoint=_spec(tmp_path))
    assert S.CAPTURE_COUNT == c0
    assert S.HOST_TRANSFER_COUNT - h0 == 1 + 2
    assert [c for c, _ in CK.list_checkpoints(tmp_path, "t")] == [2, 4]
    diff, key = S.worst_parity(reference, res)
    assert diff == 0.0, key


def test_kill_at_chunk_k_then_resume_bit_identical(tmp_path, reference,
                                                   monkeypatch):
    """Preemption at the top of chunk 4: the boundary-4 snapshot was
    stashed but not yet written (deferred by one chunk), so only
    boundary 2 survives, and resuming it runs chunks 2..5
    bit-identically in ONE further transfer."""
    monkeypatch.setattr(S, "CHUNK_HOOK", _kill_at(4))
    with pytest.raises(RuntimeError, match="preempted"):
        _run(checkpoint=_spec(tmp_path))
    monkeypatch.setattr(S, "CHUNK_HOOK", None)
    found = CK.list_checkpoints(tmp_path, "t")
    assert [c for c, _ in found] == [2]
    h0 = S.HOST_TRANSFER_COUNT
    res = S.resume_sweep(found[0][1], device="cpu")
    assert S.HOST_TRANSFER_COUNT - h0 == 1
    diff, key = S.worst_parity(reference, res)
    assert diff == 0.0, key


def test_resume_keeps_checkpointing_at_cadence(tmp_path, reference,
                                               monkeypatch):
    """A CheckpointSpec passed to resume_sweep continues snapshotting at
    the same ABSOLUTE chunk cadence (boundary 4 here), still
    bit-identically."""
    monkeypatch.setattr(S, "CHUNK_HOOK", _kill_at(4))
    with pytest.raises(RuntimeError, match="preempted"):
        _run(checkpoint=_spec(tmp_path))
    monkeypatch.setattr(S, "CHUNK_HOOK", None)
    h0 = S.HOST_TRANSFER_COUNT
    res = S.resume_sweep(CK.latest_checkpoint(tmp_path, "t"),
                         checkpoint=_spec(tmp_path), device="cpu")
    assert S.HOST_TRANSFER_COUNT - h0 == 1 + 1
    assert [c for c, _ in CK.list_checkpoints(tmp_path, "t")] == [2, 4]
    diff, key = S.worst_parity(reference, res)
    assert diff == 0.0, key


def test_prune_bounds_retained_files(tmp_path, reference):
    """keep=1 with a cadence of 1 leaves exactly the newest resumable
    boundary (5 of 6) on disk, and it still resumes bit-identically."""
    _run(checkpoint=_spec(tmp_path, every_chunks=1, keep=1))
    found = CK.list_checkpoints(tmp_path, "t")
    assert [c for c, _ in found] == [5]
    diff, key = S.worst_parity(reference,
                               S.resume_sweep(found[0][1], device="cpu"))
    assert diff == 0.0, key


def test_host_fold_checkpoint_rejected(tmp_path):
    """The host fold synchronizes per chunk already; checkpointing it is
    an upfront error on both entry points."""
    with pytest.raises(ValueError, match="fold='device'"):
        S.run_sweep(_batch(), TICKS, chunk_ticks=CHUNK, fold="host",
                    checkpoint=_spec(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="fold='device'"):
        S.run_sweep_planned(_runs(), TICKS, chunk_ticks=CHUNK,
                            fold="host", checkpoint=_spec(tmp_path),
                            device="cpu")


def test_checkpoint_spec_validation():
    for kw in (dict(every_chunks=0), dict(every_chunks=1.5),
               dict(keep=0), dict(tag="bad/tag"), dict(tag="")):
        with pytest.raises(ValueError, match="CheckpointSpec"):
            CK.CheckpointSpec(**kw)
    assert CK.CheckpointSpec(tag="a", every_chunks=3).path_for(7).name \
        == "a-00000007.ckpt.npz"


def test_default_directory_is_the_ignored_results_tree():
    assert CK.DEFAULT_DIR.parts[-2:] == ("results", "checkpoints")
    assert (CK.DEFAULT_DIR.parents[1] / "src" / "repro_torch").is_dir()


# ---- corrupt / mismatched checkpoints fail fast -------------------------

def _rewritten(src, dst, mutate):
    """Copy a checkpoint applying ``mutate(meta, arrays)``; the rewrite
    restamps the content checksum, so what is probed is the ENGINE-level
    rejection in resume_sweep, not the file integrity layer."""
    meta, arrays = CK.read_checkpoint(src)
    mutate(meta, arrays)
    return CK.write_checkpoint(dst, meta, arrays)


def _drop_state_leaf(meta, arrays):
    name = next(n for n in sorted(arrays) if n.startswith("state"))
    del arrays[name]


def _reshape_state_leaf(meta, arrays):
    name = next(n for n in sorted(arrays) if n.startswith("state"))
    arrays[name] = np.repeat(arrays[name], 2, axis=0)


def _retype_key(meta, arrays):
    arrays["state.key"] = arrays["state.key"].astype(np.int64)


def _drop_fold_leaf(meta, arrays):
    del arrays["fold_comp/injected"]


def _drop_guard(meta, arrays):
    del arrays["guard"]


@pytest.mark.parametrize("reason,mutate", [
    ("sim_schema", lambda m, a: m.update(sim_schema=999)),
    ("fingerprint", lambda m, a: m.update(fault_knobs=m["fault_knobs"][:-1])),
    ("fingerprint",
     lambda m, a: m.update(flow_knobs=m["flow_knobs"] + ["ghost"])),
    ("scenario_fields",
     lambda m, a: m.update(scenario_fields=m["scenario_fields"] + ["ghost"])),
    ("x64_mode", lambda m, a: m.update(fold_dtype="float64")),
    ("state_schema", _drop_state_leaf),
    ("state_schema", _reshape_state_leaf),
    ("state_schema", _retype_key),
    ("state_schema", _drop_fold_leaf),
    ("state_schema", _drop_guard),
], ids=["sim_schema", "fault_knobs", "flow_knobs", "scenario_fields",
        "x64_mode", "missing_leaf", "reshaped_leaf", "retyped_key",
        "missing_fold", "missing_guard"])
def test_mismatched_checkpoint_rejected(tmp_path, ckpt_file, reason, mutate):
    bad = _rewritten(ckpt_file, tmp_path / "bad.ckpt.npz", mutate)
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(bad, device="cpu")
    assert ei.value.reason == reason
    assert "checkpoint rejected" in str(ei.value)


def test_threefry_scheme_is_the_recorded_one(tmp_path, ckpt_file):
    """The file records the scheme it was drawn with; resume uses it and
    refuses a caller who asks for the other one. A file without the key
    (as the reference writes it) reads as the partitionable scheme."""
    meta = CK.read_checkpoint(ckpt_file)[0]
    assert meta["threefry_partitionable"] is True
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(ckpt_file, device="cpu",
                       threefry_partitionable=False)
    assert ei.value.reason == "threefry_scheme"
    bare = _rewritten(ckpt_file, tmp_path / "bare.ckpt.npz",
                      lambda m, a: m.pop("threefry_partitionable"))
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(bare, device="cpu", threefry_partitionable=False)
    assert ei.value.reason == "threefry_scheme"


def test_truncated_checkpoint_rejected(tmp_path, ckpt_file):
    data = ckpt_file.read_bytes()
    bad = tmp_path / "trunc.ckpt.npz"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(bad, device="cpu")
    assert ei.value.reason == "format"


def test_bitflipped_checkpoint_rejected(tmp_path, ckpt_file):
    """A single flipped byte surfaces at whichever integrity layer sees
    it first (the zip container or the content checksum), never as a
    silent resume."""
    data = bytearray(ckpt_file.read_bytes())
    data[len(data) // 2] ^= 0xFF
    bad = tmp_path / "flip.ckpt.npz"
    bad.write_bytes(bytes(data))
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(bad, device="cpu")
    assert ei.value.reason in ("checksum", "format")


def _resaved(meta, arrays, path):
    """Write meta + arrays WITHOUT restamping the checksum."""
    blob = io.BytesIO()
    np.savez(blob, **{CK._META_MEMBER: np.frombuffer(
        json.dumps(meta, sort_keys=True).encode("utf-8"),
        dtype=np.uint8)}, **arrays)
    return CK.atomic_write_bytes(path, blob.getvalue())


def test_stale_checksum_rejected(tmp_path, ckpt_file):
    """Tampered array contents under a stale stored checksum is exactly
    the class the content hash exists for."""
    meta, arrays = CK.read_checkpoint(ckpt_file)
    name = next(n for n in sorted(arrays) if n.startswith("fold_sum"))
    arrays[name] = arrays[name] + 1
    bad = _resaved(meta, arrays, tmp_path / "stale.ckpt.npz")
    with pytest.raises(CK.CheckpointError) as ei:
        CK.read_checkpoint(bad)
    assert ei.value.reason == "checksum"


def test_wrong_ckpt_schema_rejected(tmp_path, ckpt_file):
    meta, arrays = CK.read_checkpoint(ckpt_file)
    meta["ckpt_schema"] = 999
    bad = _resaved(meta, arrays, tmp_path / "old.ckpt.npz")
    with pytest.raises(CK.CheckpointError) as ei:
        S.resume_sweep(bad, device="cpu")
    assert ei.value.reason == "ckpt_schema"


def test_atomic_write_leaves_no_temp_files(tmp_path):
    p = CK.atomic_write_text(tmp_path / "x.json", "{}")
    assert p.read_text() == "{}"
    assert [f.name for f in tmp_path.iterdir()] == ["x.json"]


def test_checksum_and_layout_match_the_reference(tmp_path, ckpt_file):
    """The two engines stamp and verify files alike: the same checksum
    of the same content, and each reads what the other wrote."""
    meta, arrays = CK.read_checkpoint(ckpt_file)
    body = {k: v for k, v in meta.items() if k != "checksum"}
    assert CK._checksum(body, arrays) == JCK._checksum(body, arrays)
    assert CK.CKPT_SCHEMA_VERSION == JCK.CKPT_SCHEMA_VERSION
    JCK.read_checkpoint(ckpt_file)
    mine = JCK.write_checkpoint(tmp_path / "ref.ckpt.npz", body, arrays)
    assert CK.read_checkpoint(mine)[0]["checksum"] == meta["checksum"]


# ---- across engines -----------------------------------------------------

def _golden_runs(Sim, Site, specs):
    site = Site(**GOLDEN_SITE)

    def p(spec, **kw):
        return Sim.SimParams(spec=specs[spec], site=site, **kw)
    return [(p("fb_hadoop", gating_enabled=True, rate_scale=1.6), 8),
            (p("fb_hadoop", gating_enabled=False, rate_scale=1.6), 9),
            (p("fb_web", gating_enabled=True), 3)]


X_TICKS, X_CHUNK = 300, 100


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The reference's uninterrupted checked run of the golden rows, and
    a checkpoint it wrote at boundary 2 of 3."""
    d = tmp_path_factory.mktemp("jax-ckpts")
    batch = JS.make_batch(_golden_runs(JS, JSite, JSPECS))
    res = JS.run_sweep(batch, X_TICKS, chunk_ticks=X_CHUNK, validate=True,
                       checkpoint=JCK.CheckpointSpec(directory=d,
                                                     every_chunks=2,
                                                     tag="j", keep=8))
    found = JCK.list_checkpoints(d, "j")
    assert [c for c, _ in found] == [2]
    return res, found[0][1]


def test_reference_checkpoint_resumes_in_the_port(jax_run):
    ref, path = jax_run
    h0 = S.HOST_TRANSFER_COUNT
    res = S.resume_sweep(path, device="cpu")
    assert S.HOST_TRANSFER_COUNT - h0 == 1
    assert [r["label"] for r in res] == [r["label"] for r in ref]
    diff, key = S.worst_parity(ref, res)
    assert diff <= PARITY_TOL, (diff, key)


def test_port_checkpoint_resumes_in_the_reference(tmp_path, jax_run):
    ref, _ = jax_run
    S.run_sweep(S.make_batch(_golden_runs(S, FBSite, TRAFFIC_SPECS)),
                X_TICKS, chunk_ticks=X_CHUNK, validate=True, device="cpu",
                checkpoint=CK.CheckpointSpec(directory=tmp_path,
                                             every_chunks=2, tag="p",
                                             keep=8))
    path = CK.latest_checkpoint(tmp_path, "p")
    meta, arrays = JCK.read_checkpoint(path)
    assert meta["chunk_index"] == 2 and meta["fold_dtype"] == "float32"
    assert arrays["state.key"].dtype == np.uint32
    res = JS.resume_sweep(path)
    diff, key = S.worst_parity(ref, res)
    assert diff <= PARITY_TOL, (diff, key)
