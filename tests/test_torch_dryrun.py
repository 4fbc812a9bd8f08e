"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.hlo_analysis``)
against the reference's (``repro.launch.dryrun``).

* (a) ``parse_collectives`` on the reference's HLO sample gives the
  reference's ``by_op()``; ``collective_stats`` names the port's records
  as HLO ops with the reference's ring factors.
* (b) Reduced qwen3-8b on a 2 x 2 mesh, train (T 64, B 8) and prefill:
  the port's per-layer dot FLOPs equal the reference's per-layer HLO dot
  FLOPs (summed over every ``dot`` of its compiled text, each operand's
  shape resolved from the line that defines it) exactly, and its
  per-layer FLOPs are within ``FLOPS_RTOL`` of XLA's ``cost_analysis``;
  (c) reduced mixtral-8x7b the same. The bytes' ratio to XLA's
  ``bytes accessed`` and both sides' collectives by op are printed.
* (d) ``acct``'s ``L1 + (n_scan - 1)(L2 - L1)`` equals the full-depth
  count (FLOPs and collective bytes exactly, bytes to 1e-12) for reduced
  qwen3-8b, mixtral-8x7b, jamba-v0.1-52b and kimi-k2-1t-a32b at three
  periods.
* (e) ``meta`` counts equal ``cpu`` counts exactly, cell by cell.
* (f) Each reduced cell's collective bytes by (op, axis) equal
  ``implied_bytes`` (remat, FSDP, ZeRO-2, microbatches, the
  psum_scatter MoE combine, decode_sp, adafactor and the pod axis among
  them; the vocab-parallel head and a tied table's lookup, RWKV's and
  Mamba's tensor-parallel sums, and a decode's combine over a
  sequence-sharded GQA or MLA cache), under each ``act_shard`` (the
  residual between layers cut over d, the default, over the sequence,
  or whole).
* (g) ``ici_gating.analyze_all(device="cpu")`` over the port's records
  equals the reference's ``analyze_all`` over the same files.
* (h) The dry run refuses to run beside a real (gloo) default group;
  its CLI writes records with the reference's keys on ``meta`` and
  raises without a card by default.
* (i) On the card: ``tests/test_torch_cuda.py::test_dryrun_card_counts_
  equal_meta`` (that file imports no JAX, so it runs on the card) holds
  one reduced cell's counts to its ``meta`` counts.

The reference runs in one subprocess with 4 host devices
(``tests/_subproc.py``); every port run is rank 0 of a fake process
group in this process.
"""
from __future__ import annotations

import json

import pytest
import torch
import torch.distributed as tdist

from _subproc import run_with_devices
from repro.launch.hlo_analysis import parse_collectives as ref_parse
from repro_torch.configs import ShapeConfig, get_config, reduced
from repro_torch.core import ici_gating as I
from repro_torch.launch import dryrun as D
from repro_torch.launch import hlo_analysis as hla
from repro_torch.launch.mesh import dist_for, fake_world, make_test_mesh
from test_hlo_ici import SAMPLE_HLO

#: the port's per-layer FLOPs against XLA's (its dots alone are 93% of
#: them; the rest is elementwise, counted as HloCostAnalysis counts it)
FLOPS_RTOL = 0.10
PENALTY_RTOL = 1e-6          # tests/test_torch_ici.py's
MESH = (2, 2)

#: (arch, kind, T, B) of the cells held against the reference's records
REF_CELLS = [("qwen3-8b", "train", 64, 8), ("qwen3-8b", "prefill", 64, 8),
             ("mixtral-8x7b", "train", 64, 8)]

_REF_CODE = r'''
import json, re, sys
from pathlib import Path
from repro.configs import ShapeConfig, get_config, reduced
from repro.core import ici_gating as JI
from repro.launch import hlo_analysis as hla
from repro.launch.dryrun import _acct_cfg, lower_cell
from repro.launch.mesh import make_test_mesh

_DEF = re.compile(r"^\s*(?:ROOT\s+)?(%?[\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
_DOT = re.compile(r"=\s*\w+\[([\d,]*)\][^=]*?\sdot\((%?[\w.\-]+),")


def dot_flops(text):
    """2 x output elements x contracted size over every dot, each lhs
    shape read from the line that defines it."""
    shapes = {}
    for line in text.splitlines():
        m = _DEF.match(line)
        if m:
            shapes[m.group(1)] = [int(s) for s in m.group(2).split(",") if s]
    total = 0
    for line in text.splitlines():
        if " dot(" not in line:
            continue
        m = _DOT.search(line)
        out = 1
        for s in m.group(1).split(","):
            if s:
                out *= int(s)
        lhs = shapes[m.group(2)]
        cd = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
        k = 1
        for d in cd.group(1).split(",") if cd and cd.group(1) else []:
            k *= lhs[int(d)]
        total += 2 * out * k
    return total


cells, rec_dir = json.loads(sys.argv[1]), sys.argv[2]
mesh = make_test_mesh(2, 2)
out = {}
for arch, kind, T, B in cells:
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("t", T, B, kind)
    acct = {}
    for n in (1, 2):
        c, _ = lower_cell(_acct_cfg(cfg, shape, n), shape, mesh,
                          donate=False)
        text = c.as_text()
        acct[n] = {"cost": hla.cost_stats(c), "dots": dot_flops(text),
                   "coll": hla.parse_collectives(text).by_op()}
    out[f"{arch}/{kind}"] = {
        "per_layer_flops": acct[2]["cost"]["flops"]
        - acct[1]["cost"]["flops"],
        "per_layer_bytes": acct[2]["cost"]["bytes_accessed"]
        - acct[1]["cost"]["bytes_accessed"],
        "per_layer_dot_flops": acct[2]["dots"] - acct[1]["dots"],
        "L2_collectives": acct[2]["coll"]}
JI.RESULTS = Path(rec_dir)
out["analyze_all"] = JI.analyze_all(idle_frac=0.1)
print("JSON" + json.dumps(out))
'''


def _cfg(arch, **over):
    return reduced(get_config(arch), **over)


def _run(arch, kind, T, B, device="cpu", results=None, over=None):
    return D.run_cell(arch, f"{kind}_t{T}", "single", device=device,
                      cfg=_cfg(arch, **(over or {})),
                      shape=ShapeConfig(f"{kind}_t{T}", T, B, kind),
                      mesh_shape=MESH, results=results, verbose=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    """The port's records of REF_CELLS in one directory, named as the
    production cells that ``ici_gating.analyze_all`` reads."""
    d = tmp_path_factory.mktemp("dryrun_torch")
    recs = {}
    for arch, kind, T, B in REF_CELLS:
        rec = _run(arch, kind, T, B, results=d)
        assert rec["ok"], rec.get("error")
        recs[f"{arch}/{kind}"] = rec
    return d, recs


@pytest.fixture(scope="module")
def reference(port_records):
    d, _ = port_records
    out = run_with_devices(
        f"import sys; sys.argv = ['ref', {json.dumps(json.dumps(REF_CELLS))},"
        f" {str(d)!r}]\n" + _REF_CODE, n_devices=4, timeout=300)
    line = [s for s in out.splitlines() if s.startswith("JSON")][-1]
    return json.loads(line[4:])


# (a) ------------------------------------------------------------------------

def test_parse_collectives_equals_reference():
    got = hla.parse_collectives(SAMPLE_HLO)
    want = ref_parse(SAMPLE_HLO)
    assert got.by_op() == want.by_op()
    assert got.total_link_bytes == want.total_link_bytes
    assert got.total_result_bytes == want.total_result_bytes


def test_collective_stats_names_and_ring_factors():
    log = [("psum", "model", 1024, 2), ("all_gather", "data", 4096, 4),
           ("psum_scatter", "data+model", 256, 8), ("pmax", "model", 64, 2),
           ("ppermute", "stage", 128, 4)]
    st = hla.collective_stats(log, {"data": 4, "model": 2, "stage": 4})
    by = st.by_op()
    assert by["all-reduce"] == {"count": 2, "result_bytes": 1088.0,
                                "link_bytes": 2 * 1088 * 1 / 2}
    assert by["all-gather"]["link_bytes"] == 4096 * 3 / 4
    assert by["reduce-scatter"]["link_bytes"] == 256 * 7
    assert by["collective-permute"]["link_bytes"] == 128
    with pytest.raises(ValueError, match="group of 2"):
        hla.collective_stats([("psum", "data", 4, 2)], {"data": 4})


# (b), (c) -------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,T,B", REF_CELLS,
                         ids=[f"{a}-{k}" for a, k, _, _ in REF_CELLS])
def test_per_layer_flops_against_reference(port_records, reference, arch,
                                           kind, T, B):
    rec = port_records[1][f"{arch}/{kind}"]
    ref = reference[f"{arch}/{kind}"]
    acct = rec["acct"]
    # every product the reference's compiled step runs, the port runs
    assert acct["per_layer_dot_flops"] == ref["per_layer_dot_flops"]
    ratio = acct["per_layer_flops"] / ref["per_layer_flops"]
    print(f"\n{arch} {kind}: per-layer FLOPs {acct['per_layer_flops']:.0f} "
          f"(XLA {ref['per_layer_flops']:.0f}, ratio {ratio:.4f}; dots "
          f"{acct['per_layer_dot_flops']} both); bytes "
          f"{acct['per_layer_bytes']:.0f} / XLA's bytes accessed "
          f"{ref['per_layer_bytes']:.0f} = "
          f"{acct['per_layer_bytes'] / ref['per_layer_bytes']:.3f}; "
          f"collectives at 2 layers: port {acct['L2']['collectives']}, "
          f"XLA {ref['L2_collectives']}")
    assert abs(ratio - 1) <= FLOPS_RTOL


# (d) ------------------------------------------------------------------------

DEEP = [("qwen3-8b", {"n_layers": 3}), ("mixtral-8x7b", {"n_layers": 3}),
        ("jamba-v0.1-52b", {"n_layers": 24}),
        ("kimi-k2-1t-a32b", {"n_layers": 4})]


@pytest.mark.parametrize("arch,over", DEEP, ids=[a for a, _ in DEEP])
def test_acct_reconstructs_full_depth(tmp_path, arch, over):
    rec = _run(arch, "train", 16, 8, results=tmp_path, over=over)
    acct = rec["acct"]
    assert acct["total_flops"] == rec["cost"]["flops"]
    assert acct["total_coll_link_bytes"] == rec["collective_link_bytes"]
    assert acct["total_bytes"] == pytest.approx(
        rec["cost"]["bytes_accessed"], rel=1e-12, abs=0)
    _, n_scan, _ = D.model_lib.stack_plan(_cfg(arch, **over))
    assert n_scan == 3


# (e), (f) -------------------------------------------------------------------

#: (arch, kind, T, B, config overrides, mesh)
CELLS = [
    ("qwen3-8b", "train", 16, 8, {}, (2, 2)),
    ("qwen3-8b", "prefill", 16, 8, {}, (2, 2)),
    ("qwen3-8b", "decode", 16, 8, {}, (2, 2)),
    ("qwen3-8b", "decode", 16, 1, {}, (2, 2)),
    ("qwen3-8b", "train", 16, 2, {}, (2, 2)),
    ("qwen3-8b", "train", 16, 8, {"remat": True, "fsdp": True}, (2, 2)),
    ("qwen3-8b", "train", 16, 8, {"fsdp": True, "zero": 2}, (2, 2)),
    ("qwen3-8b", "train", 16, 8, {"fsdp": True, "microbatches": 2},
     (2, 2)),
    ("qwen3-8b", "decode", 16, 8, {"decode_sp": True}, (2, 2)),
    ("qwen3-8b", "train", 16, 8, {"remat": True, "fsdp": True},
     (2, 2, 2)),
    ("mixtral-8x7b", "train", 16, 8, {"remat": True, "fsdp": True}, (2, 2)),
    ("mixtral-8x7b", "train", 16, 2, {"remat": True, "fsdp": True,
                                      "moe_combine": "psum_scatter"},
     (2, 2)),
    ("mixtral-8x7b", "decode", 16, 8, {}, (2, 2)),
    ("jamba-v0.1-52b", "train", 16, 8, {"remat": True, "fsdp": True},
     (2, 2)),
    ("jamba-v0.1-52b", "decode", 16, 8, {}, (2, 2, 2)),
    ("kimi-k2-1t-a32b", "train", 16, 8, {"remat": True, "fsdp": True},
     (2, 2, 2)),
    ("kimi-k2-1t-a32b", "prefill", 16, 8, {}, (2, 2)),
    ("rwkv6-7b", "train", 16, 8, {"remat": True, "fsdp": True}, (2, 2)),
    ("rwkv6-7b", "decode", 16, 8, {}, (2, 2)),
    ("minicpm3-4b", "train", 16, 8, {"remat": True, "fsdp": True}, (2, 2)),
    ("hubert-xlarge", "train", 16, 8, {"remat": True, "fsdp": True},
     (2, 2)),
    ("internvl2-76b", "prefill", 16, 8, {}, (2, 2)),
    ("qwen3-0.6b", "train", 16, 8, {"remat": True, "fsdp": True}, (2, 2)),
    ("granite-34b", "decode", 16, 8, {}, (2, 2)),
    ("minicpm3-4b", "decode", 16, 8, {}, (2, 2)),
]


def _cell_id(c):
    arch, kind, T, B, over, mesh = c
    return "-".join([arch, kind, f"B{B}"] + [f"{k}={v}" for k, v in
                                              over.items()]
                    + ["x".join(map(str, mesh))])


def _lower(cell, device, **act):
    arch, kind, T, B, over, dims = cell
    cfg = _cfg(arch, **over, **act)
    shape = ShapeConfig("t", T, B, kind)
    pod = dims[0] if len(dims) == 3 else 0
    with fake_world(int(torch.tensor(dims).prod())):
        dist = dist_for(make_test_mesh(dims[-2], dims[-1], pod))
        res = D.lower_cell(cfg, shape, dist, device)
        res["implied"] = {"/".join(k): v for k, v in
                          D.implied_bytes(cfg, dist, shape).items()}
    return res


@pytest.mark.parametrize("cell", CELLS, ids=[_cell_id(c) for c in CELLS])
def test_meta_counts_equal_cpu_and_collectives_equal_implied(cell):
    cpu, meta = _lower(cell, "cpu"), _lower(cell, "meta")
    assert cpu["unknown"] == {} and meta["unknown"] == {}
    assert cpu["counts"] == meta["counts"]
    assert cpu["log"] == meta["log"]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes"):
        assert cpu["memory"][k] == meta["memory"][k], k
    got = {k: v[1] for k, v in cpu["collective_bytes"].items()}
    assert got == cpu["implied"]


@pytest.mark.parametrize("cell", CELLS, ids=[_cell_id(c) for c in CELLS])
@pytest.mark.parametrize("act_shard", ["none", "seq"])
def test_collectives_equal_implied_under_each_act_shard(cell, act_shard):
    """The residual stream whole over 'model' (``"none"``) or cut over
    the sequence (``"seq"``; a decode's T of 1 falls back to whole): the
    counted collective bytes still equal ``implied_bytes``; the
    default, ``"dmodel"``, is the test above."""
    res = _lower(cell, "cpu", act_shard=act_shard)
    assert res["unknown"] == {}
    assert {k: v[1] for k, v in res["collective_bytes"].items()} == \
        res["implied"]


# (g) ------------------------------------------------------------------------

def test_analyze_all_equals_reference(port_records, reference, monkeypatch):
    d, _ = port_records
    monkeypatch.setattr(I, "RESULTS", d)
    got = I.analyze_all(idle_frac=0.1, device="cpu")
    want = reference["analyze_all"]
    assert [(r["arch"], r["shape"]) for r in got] == \
        [(r["arch"], r["shape"]) for r in want]
    assert len(got) == len(REF_CELLS)
    for g, w in zip(got, want):
        assert g["scheduled"] == w["scheduled"]
        for k in ("collective_duty", "t_compute_us", "t_collective_us"):
            assert g[k] == w[k], k
        assert g["reactive"]["link_on_frac"] == w["reactive"]["link_on_frac"]
        assert g["reactive"]["latency_penalty"] == pytest.approx(
            w["reactive"]["latency_penalty"], rel=PENALTY_RTOL, abs=0)


# (h) ------------------------------------------------------------------------

def test_refuses_beside_a_real_group(tmp_path):
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                             rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="never a real job"):
            _run("qwen3-8b", "train", 16, 8, results=tmp_path)
        assert not list(tmp_path.glob("*.json"))
    finally:
        tdist.destroy_process_group()


def test_cli_writes_reference_keys_on_meta(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    monkeypatch.setattr(D, "get_config", lambda a: _cfg(a))
    monkeypatch.setattr(D, "MESHES", {"single": MESH,
                                      "multi": (2,) + MESH})
    D.main(["--arch", "qwen3-8b", "--shape", "train_4k", "--device",
            "meta"])
    for mesh in ("single", "multi"):
        rec = json.loads((tmp_path / f"qwen3-8b__train_4k__{mesh}.json")
                         .read_text())
        assert rec["ok"] and rec["n_devices"] == 4 * (mesh == "single") \
            + 8 * (mesh == "multi")
        assert set(rec["memory"]) == set(hla.MEMORY_KEYS)
        assert rec["memory"]["temp_size_in_bytes"] is None
        assert set(rec["cost"]) == {"flops", "bytes_accessed"}
        assert {"collectives", "collective_link_bytes", "compile_s",
                "arch", "shape", "mesh"} <= set(rec)
    acct = json.loads((tmp_path / "qwen3-8b__train_4k__single.json")
                      .read_text())["acct"]
    assert {"L1", "L2", "per_layer_flops", "per_layer_bytes",
            "per_layer_coll_link_bytes", "total_flops", "total_bytes",
            "total_coll_link_bytes"} <= set(acct)
    assert I.phases_from_dryrun(dict(acct=acct, arch="a", shape="s"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(D, "RESULTS", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        D.main(["--arch", "qwen3-8b", "--shape", "train_4k"])
    assert not list(tmp_path.glob("*.json"))


def test_failure_recorded_verbatim(tmp_path, monkeypatch):
    """A cell whose step fails is recorded as it failed (the error, its
    traceback, the argument bytes known from the shapes), never replaced
    by another device's count, and no accounting pass follows."""
    def step(*_a, **_k):
        def fail(*_):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 37.12 GiB")
        return fail
    monkeypatch.setattr(D, "make_train_step", step)
    rec = _run("qwen3-8b", "train", 16, 8, results=tmp_path)
    assert not rec["ok"]
    assert rec["error"] == ("OutOfMemoryError: CUDA out of memory. Tried "
                            "to allocate 37.12 GiB")
    assert "OutOfMemoryError" in rec["traceback"]
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] is None
    assert not {"cost", "collectives", "acct"} & set(rec)
    on_disk = json.loads((tmp_path / "qwen3-8b__train_t16__single.json")
                         .read_text())
    assert on_disk["error"] == rec["error"]
