"""The port's contract linter (``repro_torch.analysis``) on its own test
corpus, beside the reference's (tests/test_analysis.py).

One known-bad fixture per rule pinning the exact rule ID **and line**
(each fixture marks its expected lines with a ``# <- RLxxx`` comment),
clean once fixed; a suppressed case, registry drift, the suppression
baseline, and a self-run asserting the shipped port tree is clean. The
fixtures build a mini repo under tmp_path with their own registry, so
they cannot interfere with the real compile_sites.toml. Against the
reference: the port's toml reader parses every committed contract file
of both packages as the reference's does, and the port's scenario
contract is the reference's field for field.
"""
import json
import shutil
import textwrap
from pathlib import Path

import pytest

from repro.analysis import toml_lite as ref_toml
from repro_torch.analysis import toml_lite
from repro_torch.analysis.engine import run_lint
from repro_torch.analysis.findings import RULES, scan_suppressions
from repro_torch.analysis.reachability import dead_code_report
from repro_torch.analysis.registry import REGISTRY_RELPATH, Config, load_config

REPO = Path(__file__).resolve().parents[1]

MINI_CFG = """
[analysis]
lint_scope = ["src/demo"]
max_suppressions = {max_sup}
hot_modules = ["src/demo/hot.py"]
bitexact_modules = ["src/demo/exact.py"]
require_scenario_contract = false
{extra}
"""


def mini(tmp_path, files, *, max_sup=0, extra=""):
    """Build a throwaway lint root: files maps relpath -> source."""
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    cfg = Config(raw=toml_lite.loads(
        MINI_CFG.format(max_sup=max_sup, extra=textwrap.dedent(extra))),
        root=tmp_path)
    return run_lint(tmp_path, cfg)


def hits(rep, rule, suppressed=False):
    return [(f.path, f.line) for f in rep.findings
            if f.rule == rule and f.suppressed == suppressed]


def marked(path, src, rule):
    """(path, line) of every line of ``src`` marked ``# <- rule``."""
    return [(path, i) for i, ln in
            enumerate(textwrap.dedent(src).splitlines(), 1)
            if f"# <- {rule}" in ln]


# ---- RL001 traced-control-flow -----------------------------------------

RL001_CAPTURE = """\
    import torch

    def f(x):
        if x > 0:               # <- RL001
            return x
        return -x

    def run(g, x):
        with torch.cuda.graph(g):
            f(x)
    """


def test_rl001_if_on_captured_value(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": RL001_CAPTURE})
    assert hits(rep, "RL001") == marked("src/demo/mod.py", RL001_CAPTURE,
                                        "RL001")


def test_rl001_fixed_is_clean(tmp_path):
    fixed = RL001_CAPTURE.replace("if x > 0:               # <- RL001",
                                  "if x.dim() > 0:")
    assert hits(mini(tmp_path, {"src/demo/mod.py": fixed}), "RL001") == []


def test_rl001_decorator_root_and_coercions(tmp_path):
    src = """\
        import torch

        @torch.compile
        def f(x):
            n = x.numel()               # metadata: static
            if n > 2:
                x = x * 2
            y = x.sum().item()          # <- RL001
            return bool(x.any()) + y    # <- RL001
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL001") == marked("src/demo/mod.py", src, "RL001")


def test_rl001_interprocedural_and_statics(tmp_path):
    """Taint flows through a project call; partial-bound params, is-None
    and shape checks stay untainted, and so does a helper whose every
    return is metadata."""
    src = """\
        import functools

        import torch

        def kind(t):
            return t.dtype

        def helper(v, mode):
            if mode == "fast":          # untainted: mode is bound
                v = v * 2
            assert v.dim() == 2         # untainted: metadata
            if kind(v) == torch.float64:
                v = v.float()
            return float(v)             # <- RL001

        def g(x, y=None, mode="slow"):
            if y is None:               # untainted: is-None is static
                y = x
            return helper(x + y, mode)

        run = torch.compile(functools.partial(g, mode="slow"))
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL001") == marked("src/demo/mod.py", src, "RL001")


def test_rl001_factory_closure_is_rooted(tmp_path):
    """A step built by a closure factory and captured through a local
    alias is still traced-reachable (the simulator's own shape)."""
    src = """\
        import torch

        def make_step(n):
            def step(state):
                assert n > 0                # untainted closure const
                while state.sum() > 1:      # <- RL001
                    state = state - 1
                return state
            return step

        def drive(g, state):
            step = make_step(4)
            with torch.cuda.graph(g):
                step(state)
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL001") == marked("src/demo/mod.py", src, "RL001")


def test_rl001_declared_root_with_static_params(tmp_path):
    """A function reached through a parameter is a [[traced_root]] of
    the registry; its ``static`` params stay clean."""
    src = """\
        class Plan:
            def draw(self, key):
                if self.wide:               # static: self
                    key = key * 2
                if key[0] > 3:              # <- RL001
                    key = key + 1
                return key
        """
    extra = """
        [[traced_root]]
        file = "src/demo/mod.py"
        qualname = "Plan.draw"
        static = ["self"]
        reason = "called from the captured tick"
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src}, extra=extra)
    assert hits(rep, "RL001") == marked("src/demo/mod.py", src, "RL001")


def test_rl001_fires_in_the_real_tick(tmp_path):
    """A host sync injected into the shipped sweep tick is found on the
    CPU, with the shipped registry: the roots reach the real step."""
    for sub in ("core", "kernels"):
        shutil.copytree(REPO / "src/repro_torch" / sub,
                        tmp_path / "src/repro_torch" / sub,
                        ignore=shutil.ignore_patterns("__pycache__",
                                                      "csrc"))
    sim = tmp_path / "src/repro_torch/core/simulator.py"
    lines = sim.read_text().splitlines()
    at = next(i for i, ln in enumerate(lines)
              if ln.startswith("    def step(state: SimState)"))
    lines.insert(at + 1, "        if state.rsw_q.sum() > 0:")
    lines.insert(at + 2, "            pass")
    sim.write_text("\n".join(lines) + "\n")
    cfg = load_config(REPO)
    rep = run_lint(tmp_path, Config(raw=cfg.raw, root=tmp_path))
    assert hits(rep, "RL001") == [("src/repro_torch/core/simulator.py",
                                   at + 2)]


# ---- RL002 compile-site registry ---------------------------------------

def test_rl002_unregistered_sites_and_drift(tmp_path):
    src = """\
        import torch

        from repro_torch.kernels import _build

        _LIB = torch.library.Library("demo", "DEF")

        def capture(g, f):
            with torch.cuda.graph(g):               # <- RL002
                f()

        def bind():
            return _build.function("lib", "sym", [])  # <- RL002

        def define(schema):
            _LIB.define(schema)                     # <- RL002
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src}, extra="""
        [[compile_site]]
        file = "src/demo/mod.py"
        qualname = "gone_function"
        kind = "cuda_graph"
        multiplicity = "one"
        """)
    got = hits(rep, "RL002")
    for want in marked("src/demo/mod.py", src, "RL002"):
        assert want in got
    assert any("registry drift" in f.message for f in rep.findings
               if f.rule == "RL002")


def test_rl002_registered_sites_are_clean(tmp_path):
    src = """\
        import torch

        def capture(g, f):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                f()
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src}, extra="""
        [[compile_site]]
        file = "src/demo/mod.py"
        qualname = "capture"
        kind = "cuda_graph"
        multiplicity = "one capture per call"
        """)
    assert hits(rep, "RL002") == []


def test_rl002_capture_count_pin_drift(tmp_path):
    """A CAPTURE_COUNT probe outside [capture_count].counted_fns is
    drift, and so is a declared function without one."""
    rep = mini(tmp_path, {"src/demo/mod.py": """\
        CAPTURE_COUNT = 0

        def rogue(x):
            global CAPTURE_COUNT
            CAPTURE_COUNT += 1
            return x
        """}, extra="""
        [capture_count]
        file = "src/demo/mod.py"
        counted_fns = ["blessed_fn"]
        """)
    msgs = [f.message for f in rep.findings if f.rule == "RL002"]
    assert any("rogue" in m for m in msgs)
    assert any("blessed_fn" in m for m in msgs)


def test_rl002_registry_entries_need_reasons(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": "X = 1\n"}, extra="""
        [[blessed_transfer]]
        file = "src/demo/hot.py"
        qualname = "f"
        reason = " "
        """)
    assert [f.rule for f in rep.findings] == ["RL002"]
    assert "no reason" in rep.findings[0].message


# ---- RL003 host-transfer smell -----------------------------------------

RL003_HOT = """\
    import torch

    def blessed_fetch(x):
        return x.cpu().numpy()

    def leaky(x, s):
        y = x.sum().item()              # <- RL003
        z = x.to("cpu")                 # <- RL003
        torch.cuda.synchronize()        # <- RL003
        s.synchronize()                 # <- RL003
        return y, z, x.tolist()         # <- RL003
    """
RL003_BLESS = """
    [[blessed_transfer]]
    file = "src/demo/hot.py"
    qualname = "blessed_fetch"
    reason = "the one declared fetch"
    """


def test_rl003_host_syncs_outside_blessed(tmp_path):
    rep = mini(tmp_path, {"src/demo/hot.py": RL003_HOT}, extra=RL003_BLESS)
    assert hits(rep, "RL003") == marked("src/demo/hot.py", RL003_HOT,
                                        "RL003")


def test_rl003_blessed_is_clean(tmp_path):
    bless = RL003_BLESS + RL003_BLESS.replace("blessed_fetch", "leaky")
    rep = mini(tmp_path, {"src/demo/hot.py": RL003_HOT}, extra=bless)
    assert hits(rep, "RL003") == []


def test_rl003_np_asarray_on_traced_value(tmp_path):
    src = """\
        import numpy as np
        import torch

        @torch.compile
        def f(x):
            return np.asarray(x).sum()      # <- RL003
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL003") == marked("src/demo/mod.py", src, "RL003")


# ---- RL004 scenario-leaf sync ------------------------------------------

RL004_CODE = """\
    SIM_SCHEMA_VERSION = 3
    FAULT_KNOBS = ("mtbf",)

    class Scenario:
        rate: object
        mtbf: object

    class Params:
        rate: float = 1.0
        mtbf: float = 0.0

        def __post_init__(self):
            assert self.rate >= 0

    def use(s):
        return s.rate + s.mtbf
"""

RL004_CONTRACT = """
    [scenario_contract]
    file = "src/demo/mod.py"
    scenario_class = "Scenario"
    params_class = "Params"
    schema_version = {ver}
    scenario_fields = [{fields}]
    validated_params = ["rate"]
    fingerprint_params = ["mtbf"]

    [[validation_exempt]]
    field = "mtbf"
    reason = "zero disables"
"""


def test_rl004_clean_contract(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": RL004_CODE},
               extra=RL004_CONTRACT.format(ver=3,
                                           fields='"rate", "mtbf"'))
    assert hits(rep, "RL004") == []


def test_rl004_unregistered_leaf_and_version_drift(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": RL004_CODE},
               extra=RL004_CONTRACT.format(ver=4, fields='"rate"'))
    got = hits(rep, "RL004")
    assert ("src/demo/mod.py", 6) in got     # mtbf leaf unregistered
    assert ("src/demo/mod.py", 1) in got     # schema version mismatch


def test_rl004_unvalidated_param(tmp_path):
    code = RL004_CODE.replace('        assert self.rate >= 0\n',
                              '        pass\n')
    rep = mini(tmp_path, {"src/demo/mod.py": code},
               extra=RL004_CONTRACT.format(ver=3,
                                           fields='"rate", "mtbf"'))
    assert ("src/demo/mod.py", 9) in hits(rep, "RL004")  # rate unchecked


def test_rl004_inventory_is_the_references():
    """The port's scenario contract is the reference's, field for
    field (the port reproduces its dynamics and reads its
    checkpoints), and the shipped simulator satisfies it."""
    ours = load_config(REPO).raw
    ref = ref_toml.load(REPO / "src/repro/analysis/compile_sites.toml")
    a, b = dict(ours["scenario_contract"]), dict(ref["scenario_contract"])
    assert a.pop("file") == "src/repro_torch/core/simulator.py"
    assert b.pop("file") == "src/repro/core/simulator.py"
    assert a == b
    assert ours["validation_exempt"] == ref["validation_exempt"]
    assert a["schema_version"] == 8


# ---- RL005 PRNG discipline ---------------------------------------------

def test_rl005_key_reuse(tmp_path):
    src = """\
        from repro_torch.core import prng

        def sample(key):
            a = prng.uniform(key, 3)
            b = prng.normal(key, 3)         # <- RL005
            return a + b
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL005") == marked("src/demo/mod.py", src, "RL005")


def test_rl005_fold_in_between_is_clean(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": """\
        from repro_torch.core import prng

        def sample(key):
            a = prng.uniform(key, 3)
            key = prng.fold_in(key, 1)
            b = prng.normal(key, 3)
            k1, k2 = prng.split(key)
            c = prng.uniform(k1, 1) + prng.uniform(k2, 1)
            return a + b + c
        """})
    assert hits(rep, "RL005") == []


def test_rl005_reuse_across_loop_iterations(tmp_path):
    src = """\
        from repro_torch.core import prng

        def sample(key, n):
            out = 0.0
            for i in range(n):
                out += prng.hash_counters(key, i, i)    # <- RL005
            return out
        """
    rep = mini(tmp_path, {"src/demo/mod.py": src})
    assert hits(rep, "RL005") == marked("src/demo/mod.py", src, "RL005")


# ---- RL006 dtype discipline --------------------------------------------

RL006_CODE = """\
    import torch

    def f(x):
        y = torch.as_tensor(x, dtype=torch.float64)     # <- RL006
        z = x.astype("float64")                         # <- RL006
        w = torch.zeros(3, dtype=float)                 # <- RL006
        return y + z + w + x.double()                   # <- RL006

    def g(x):
        return x.double()                               # <- RL006
    """


def test_rl006_float64_in_bitexact_module(tmp_path):
    rep = mini(tmp_path, {"src/demo/exact.py": RL006_CODE})
    assert hits(rep, "RL006") == marked("src/demo/exact.py", RL006_CODE,
                                        "RL006")


def test_rl006_exemption_is_per_function(tmp_path):
    """A [[dtype_exempt]] clears its function only, never the module."""
    rep = mini(tmp_path, {"src/demo/exact.py": RL006_CODE}, extra="""
        [[dtype_exempt]]
        file = "src/demo/exact.py"
        qualname = "f"
        reason = "the x64 mode's float64 path"
        """)
    assert hits(rep, "RL006") == marked("src/demo/exact.py", RL006_CODE,
                                        "RL006")[-1:]


def test_rl006_not_applied_outside_bitexact(tmp_path):
    rep = mini(tmp_path, {"src/demo/mod.py": """\
        import torch
        ACC = torch.zeros(4, dtype=torch.float64)
        """})
    assert hits(rep, "RL006") == []


# ---- suppressions -------------------------------------------------------

def test_suppression_with_reason_suppresses(tmp_path):
    rep = mini(tmp_path, {"src/demo/exact.py": """\
        import torch

        def f(x):
            # repro-torch-lint: disable=RL006(host-side fold wants f64)
            return torch.as_tensor(x, dtype=torch.float64)
        """}, max_sup=1)
    assert hits(rep, "RL006") == []
    assert hits(rep, "RL006", suppressed=True) == \
        [("src/demo/exact.py", 5)]
    assert rep.unsuppressed == []
    assert rep.suppression_count == 1


def test_suppression_without_reason_is_rl000(tmp_path):
    rep = mini(tmp_path, {"src/demo/exact.py": """\
        import torch

        def f(x):
            return x.to(torch.float64)  # repro-torch-lint: disable=RL006
        """}, max_sup=1)
    assert hits(rep, "RL000") == [("src/demo/exact.py", 4)]
    assert hits(rep, "RL006") == [("src/demo/exact.py", 4)]  # NOT hidden


def test_suppression_baseline_only_goes_down(tmp_path):
    rep = mini(tmp_path, {"src/demo/exact.py": """\
        import torch
        # repro-torch-lint: disable=RL006(one)
        A = torch.zeros(1, dtype=torch.float64)
        # repro-torch-lint: disable=RL006(two)
        B = torch.zeros(1, dtype=torch.float64)
        """}, max_sup=1)
    assert any(f.rule == "RL000" and "baseline" in f.message
               for f in rep.findings)


def test_suppression_scanner_own_line_targets_next():
    sup = scan_suppressions("x.py",
                            "# repro-torch-lint: disable=RL001(why)\n"
                            "code_line()\n")
    assert sup.reason_for("RL001", 2) == "why"
    assert sup.reason_for("RL001", 1) is None
    assert sup.count == 1


# ---- the shipped tree ---------------------------------------------------

def test_shipped_tree_is_clean():
    """`python -m repro_torch.analysis --check` contract: zero
    unsuppressed findings on the lint scope with the committed
    registry."""
    cfg = load_config(REPO)
    rep = run_lint(REPO, cfg)
    assert rep.unsuppressed == [], "\n".join(
        f.format() for f in rep.unsuppressed)
    assert rep.suppression_count <= cfg.max_suppressions
    assert "src/repro_torch/core/simulator.py" in rep.files
    assert any(f.startswith("examples/torch_") for f in rep.files)


def test_shipped_registry_round_trips():
    cfg = load_config(REPO)
    assert cfg.lint_scope == ["src/repro_torch/core",
                              "src/repro_torch/kernels",
                              "examples/torch_*.py"]
    assert {e["kind"] for e in cfg.raw["compile_site"]} == \
        {"cuda_graph", "kernel_load", "operator"}
    assert cfg.raw["capture_count"]["counted_fns"] == ["_TickGraph.run"]
    assert {"_dispatch_chunks", "_finish_sweep", "_snapshot_sweep"} <= \
        cfg.blessed("src/repro_torch/core/simulator.py")
    # float64 exemptions are functions, never a whole module
    for e in cfg.raw["dtype_exempt"]:
        assert e["qualname"] and e["reason"].strip()
    roots = {(e["file"], e["qualname"]) for e in cfg.traced_roots()}
    assert ("src/repro_torch/core/simulator.py", "make_sim_step.step") \
        in roots
    assert ("src/repro_torch/kernels/ops.py", "switch_tiers") in roots


def test_rules_table_is_complete():
    assert sorted(RULES) == [f"RL00{i}" for i in range(10)]
    for rule, (name, invariant) in RULES.items():
        assert name and invariant, rule


def test_dead_code_report_reachability():
    cfg = load_config(REPO)
    rep = dead_code_report(REPO, cfg.lint_exempt)
    reach = set(rep["reachable"])
    for mod in ("repro_torch.core.simulator", "repro_torch.core.planner",
                "repro_torch.core.gating", "repro_torch.kernels.ref",
                "repro_torch.kernels.ops", "repro_torch.models.model",
                "repro_torch.launch.serve", "repro_torch.analysis.cli"):
        assert mod in reach, mod
    assert "chip_smoke.py" in rep["entry_scripts"]
    for u in rep["unreachable"]:
        assert u["exempt"], f"non-exempt dead module: {u['module']}"


def test_cli_check_and_json(tmp_path):
    """End-to-end CLI: --check exits 0 on the shipped tree and the
    --json report is well-formed (--no-artifacts: lint only, no tick;
    the audit has its own CLI test in tests/test_torch_artifact.py)."""
    from repro_torch.analysis.cli import main
    out = tmp_path / "report.json"
    rc = main(["--check", "--no-artifacts", "--json", str(out),
               "--root", str(REPO), "-q"])
    assert rc == 0
    rep = json.loads(out.read_text())
    assert rep["n_unsuppressed"] == 0
    assert rep["suppressions"]["count"] <= \
        rep["suppressions"]["baseline"]
    assert set(rep["rules"]) == set(RULES)
    assert "artifact" not in rep           # audit skipped, not empty


def test_cli_check_fails_on_bad_tree(tmp_path):
    from repro_torch.analysis.cli import main
    (tmp_path / "src/demo").mkdir(parents=True)
    (tmp_path / REGISTRY_RELPATH).parent.mkdir(parents=True)
    (tmp_path / "src/demo/mod.py").write_text(textwrap.dedent(
        RL001_CAPTURE))
    (tmp_path / REGISTRY_RELPATH).write_text(
        '[analysis]\nlint_scope = ["src/demo"]\n'
        "require_scenario_contract = false\n")
    assert main(["--check", "--root", str(tmp_path), "-q"]) == 1


# ---- toml_lite ------------------------------------------------------------

def test_toml_lite_nested_table_headers():
    doc = toml_lite.loads(textwrap.dedent("""\
        [a]
        x = 1
        [a.b]
        y = 2
        [a.b.c]
        z = "deep"
        """))
    assert doc == {"a": {"x": 1, "b": {"y": 2, "c": {"z": "deep"}}}}


def test_toml_lite_arrays_of_tables_nest():
    doc = toml_lite.loads(textwrap.dedent("""\
        [[unit]]
        name = "u1"
        [[unit.case]]
        tag = "a"
        [unit.case.measured.x32]
        flops = 1.5
        [[unit.case]]
        tag = "b"
        [unit.case.measured.x64]
        flops = 2.5
        [[unit]]
        name = "u2"
        """))
    units = doc["unit"]
    assert [u["name"] for u in units] == ["u1", "u2"]
    cases = units[0]["case"]
    assert [c["tag"] for c in cases] == ["a", "b"]
    assert cases[0]["measured"] == {"x32": {"flops": 1.5}}
    assert cases[1]["measured"] == {"x64": {"flops": 2.5}}
    assert "case" not in units[1]


def test_toml_lite_dotted_header_through_scalar_is_an_error():
    with pytest.raises(toml_lite.TomlError, match="not a table"):
        toml_lite.loads("[a]\nb = 1\n[a.b.c]\nd = 2\n")
    with pytest.raises(toml_lite.TomlError, match="empty table array"):
        toml_lite.loads("[a]\nb = []\n[a.b.c]\nd = 2\n")


@pytest.mark.parametrize("rel", [
    "src/repro/analysis/compile_sites.toml",
    "src/repro/analysis/artifact_contracts.toml",
    "src/repro_torch/analysis/compile_sites.toml",
    "src/repro_torch/analysis/artifact_contracts.toml",
])
def test_toml_lite_equals_the_references(rel):
    """The port's own reader parses every committed contract file of
    both packages as the reference's reader does."""
    text = (REPO / rel).read_text()
    assert toml_lite.loads(text) == ref_toml.loads(text)


def test_toml_lite_loads_the_committed_artifact_contracts():
    art = toml_lite.load(
        REPO / "src/repro_torch/analysis/artifact_contracts.toml"
    )["artifact"]
    assert art["schema_version"] == 1
    assert {u["name"] for u in art["unit"]} == \
        {"sweep_tick", "run_sim", "ici_reactive"}
    tick = next(u for u in art["unit"] if u["name"] == "sweep_tick")
    assert [c["tag"] for c in tick["case"]] == [
        "2x2c2f2", "2x4c2f2", "4x8c4f4", "2x2c2f2+validate"]
    case0 = tick["case"][0]
    assert set(case0["measured"]) == {"x32", "x64"}
    assert case0["measured"]["x32"]["flops_per_tick_scen"] > 0
    assert all(s["reason"].strip() for s in art["skip"])
