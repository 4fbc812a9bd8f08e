"""The checked-in contract registry (compile_sites.toml) and the two
checkers that diff it against the tree: RL002 (compile sites) and
RL004 (scenario-leaf sync).

compile_sites.toml is the single declarative home for:

* ``[analysis]``   - lint scope, hot/bit-exact module lists, exempt
  trees, and the suppression-count baseline;
* ``[[compile_site]]`` - every site that builds a device program, with
  its multiplicity (free prose, but it must be non-empty: a registered
  site with no stated multiplicity is itself RL002). The port's kinds:
  ``cuda_graph`` (a ``torch.cuda.graph(...)`` capture or a
  ``torch.cuda.CUDAGraph``), ``kernel_load`` (a binding of a
  ``kernels/csrc/*.cu`` library through ``kernels._build``) and
  ``operator`` (a ``torch.library`` operator definition);
* ``[capture_count]`` - which functions carry the ``CAPTURE_COUNT += 1``
  probe, cross-checked against the code so the registry can never
  drift from the pin;
* ``[[blessed_transfer]]`` - the fetch points RL003 exempts (the same
  fetches HOST_TRANSFER_COUNT counts, and the waits beside them);
* ``[[traced_root]]`` - the functions RL001's taint starts from beyond
  the ones it discovers (a function handed to a CUDA-graph capture
  through a parameter cannot be resolved statically);
* ``[[dtype_exempt]]`` - the functions of a bit-exact module that need
  float64 (the x64 mode's own paths), each with its reason;
* ``[scenario_contract]`` + ``[[validation_exempt]]`` - the Scenario /
  SimParams field inventory RL004 enforces.

Adding a capture, a kernel binding, an operator, a host fetch, or a
scenario knob without the matching registry edit is a finding: the
registry diff IS the review artifact.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from . import toml_lite
from .astutil import ModuleIndex, Project, resolves_to
from .findings import Finding

REGISTRY_RELPATH = "src/repro_torch/analysis/compile_sites.toml"


@dataclass
class Config:
    raw: dict
    root: Path

    @property
    def analysis(self) -> dict:
        return self.raw.get("analysis", {})

    @property
    def lint_scope(self) -> list:
        return self.analysis.get("lint_scope", [])

    @property
    def hot_modules(self) -> list:
        return self.analysis.get("hot_modules", [])

    @property
    def bitexact_modules(self) -> list:
        return self.analysis.get("bitexact_modules", [])

    @property
    def lint_exempt(self) -> list:
        return self.analysis.get("lint_exempt", [])

    @property
    def max_suppressions(self) -> int:
        return int(self.analysis.get("max_suppressions", 0))

    def _qualnames(self, table: str, relpath: str) -> set:
        return {b["qualname"] for b in self.raw.get(table, [])
                if b.get("file") == relpath}

    def blessed(self, relpath: str) -> set:
        return self._qualnames("blessed_transfer", relpath)

    def dtype_exempt(self, relpath: str) -> set:
        return self._qualnames("dtype_exempt", relpath)

    def traced_roots(self) -> list:
        return list(self.raw.get("traced_root", []))

    def is_exempt(self, relpath: str) -> bool:
        return any(relpath == e or relpath.startswith(e.rstrip("/") +
                                                      "/")
                   for e in self.lint_exempt)


def load_config(root: Path, path: Path | None = None) -> Config:
    p = path or (root / REGISTRY_RELPATH)
    return Config(raw=toml_lite.load(p), root=root)


def check_reasons(cfg: Config) -> list:
    """Every blessed transfer, dtype exemption and traced root states
    why (a reviewed registry edit carries its justification)."""
    out = []
    for table in ("blessed_transfer", "dtype_exempt", "traced_root"):
        for e in cfg.raw.get(table, []):
            if not (e.get("file") and e.get("qualname")):
                out.append(Finding(
                    "RL002", REGISTRY_RELPATH, 1,
                    f"{table} entry {e!r} is missing file/qualname"))
            elif not str(e.get("reason", "")).strip():
                out.append(Finding(
                    "RL002", REGISTRY_RELPATH, 1,
                    f"{table} entry {e['file']}::{e['qualname']} "
                    "carries no reason"))
    return out


# ---------------------------------------------------------------------------
# RL002 - compile-site registry
# ---------------------------------------------------------------------------

#: site kind -> the fully dotted callables whose call is such a site
_KIND_NAMES = {
    "cuda_graph": ("torch.cuda.graph", "torch.cuda.CUDAGraph",
                   "torch.cuda.make_graphed_callables"),
    "kernel_load": ("repro_torch.kernels._build.function",
                    "repro_torch.kernels._build.load"),
    "operator": ("torch.library.define", "torch.library.custom_op",
                 "torch.library.impl"),
}
_LIBRARY = "torch.library.Library"


def enclosing_qualname(mi: ModuleIndex, node) -> str:
    # innermost enclosing *def*: a lambda is not a registry address,
    # its defining function is
    best = None
    for fi in mi.funcs.values():
        fn = fi.node
        if isinstance(fn, ast.Lambda):
            continue
        if fn.lineno <= node.lineno <= getattr(fn, "end_lineno",
                                               fn.lineno):
            if best is None or fn.lineno >= best.node.lineno:
                best = fi
    return best.qualname if best else "<module>"


def _library_names(mi: ModuleIndex) -> set:
    """Module-level names bound to a ``torch.library.Library(...)``."""
    out = set()
    for node in mi.tree.body:
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and resolves_to(mi, node.value.func, _LIBRARY)):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def discover_compile_sites(mi: ModuleIndex):
    """Yield (qualname, kind, line) for each capture, kernel binding
    and operator definition (``lib.define(...)`` on a module-level
    ``torch.library.Library``, or the ``torch.library`` functions)."""
    libs = _library_names(mi)
    for node in ast.walk(mi.tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if (libs and isinstance(f, ast.Attribute) and f.attr == "define"
                and isinstance(f.value, ast.Name) and f.value.id in libs):
            yield enclosing_qualname(mi, node), "operator", node.lineno
            continue
        for kind, names in _KIND_NAMES.items():
            if resolves_to(mi, f, *names):
                yield enclosing_qualname(mi, node), kind, node.lineno
                break
    for fi in mi.funcs.values():
        node = fi.node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if resolves_to(mi, d, "torch.library.custom_op"):
                    yield fi.qualname, "operator", dec.lineno


def _capture_probe_qualnames(mi: ModuleIndex) -> set:
    """Functions containing a ``CAPTURE_COUNT += 1`` probe."""
    out = set()
    for node in ast.walk(mi.tree):
        if (isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Name)
                and node.target.id == "CAPTURE_COUNT"):
            out.add(enclosing_qualname(mi, node))
    return out


def check_registry(proj: Project, cfg: Config) -> list:
    out = []
    entries = cfg.raw.get("compile_site", [])
    declared = {}
    for i, e in enumerate(entries):
        key = (e.get("file", ""), e.get("qualname", ""),
               e.get("kind", ""))
        if not all(key):
            out.append(Finding(
                "RL002", REGISTRY_RELPATH, 1,
                f"compile_site entry #{i + 1} is missing "
                "file/qualname/kind"))
            continue
        if key in declared:
            out.append(Finding(
                "RL002", REGISTRY_RELPATH, 1,
                f"duplicate compile_site entry {key}"))
        declared[key] = e
        if not str(e.get("multiplicity", "")).strip():
            out.append(Finding(
                "RL002", REGISTRY_RELPATH, 1,
                f"compile_site {key} declares no multiplicity"))

    matched = set()
    for mi in proj.modules.values():
        for qualname, kind, line in discover_compile_sites(mi):
            key = (mi.path, qualname, kind)
            if key in declared:
                matched.add(key)
            else:
                out.append(Finding(
                    "RL002", mi.path, line,
                    f"unregistered {kind} site in {qualname} (declare "
                    "it in analysis/compile_sites.toml with its "
                    "multiplicity)"))
    for key in declared:
        if key not in matched and proj.by_path(key[0]) is not None:
            out.append(Finding(
                "RL002", REGISTRY_RELPATH, 1,
                f"registry drift: declared compile site {key} no "
                "longer exists in the code"))

    cc = cfg.raw.get("capture_count", {})
    cc_file = cc.get("file")
    if cc_file:
        mi = proj.by_path(cc_file)
        if mi is not None:
            actual = _capture_probe_qualnames(mi)
            want = set(cc.get("counted_fns", []))
            for q in sorted(actual - want):
                out.append(Finding(
                    "RL002", cc_file, 1,
                    f"CAPTURE_COUNT probe in {q} is not declared in "
                    "[capture_count] counted_fns (registry drift vs the "
                    "capture pin)"))
            for q in sorted(want - actual):
                out.append(Finding(
                    "RL002", REGISTRY_RELPATH, 1,
                    f"[capture_count] declares {q} but no CAPTURE_COUNT "
                    "probe exists there"))
    return out + check_reasons(cfg)


# ---------------------------------------------------------------------------
# RL004 - scenario-leaf sync
# ---------------------------------------------------------------------------

def _class_fields(cls: ast.ClassDef) -> dict:
    """AnnAssign field name -> line for a NamedTuple/dataclass body."""
    return {s.target.id: s.lineno for s in cls.body
            if isinstance(s, ast.AnnAssign)
            and isinstance(s.target, ast.Name)}


def _module_assign(mi: ModuleIndex, name: str):
    for node in mi.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return node
    return None


def check_scenario_contract(proj: Project, cfg: Config) -> list:
    out = []
    sc = cfg.raw.get("scenario_contract")
    if not sc:
        # mini-configs (the analyzer's own test fixtures) may opt out;
        # the real registry must carry the table
        if cfg.analysis.get("require_scenario_contract", True):
            return [Finding("RL004", REGISTRY_RELPATH, 1,
                            "missing [scenario_contract] table")]
        return []
    mi = proj.by_path(sc.get("file", ""))
    if mi is None:
        return [Finding("RL004", REGISTRY_RELPATH, 1,
                        f"scenario_contract.file {sc.get('file')!r} is "
                        "not in the lint scope")]

    classes = {n.name: n for n in mi.tree.body
               if isinstance(n, ast.ClassDef)}
    scen_cls = classes.get(sc.get("scenario_class", "Scenario"))
    par_cls = classes.get(sc.get("params_class", "SimParams"))

    # 1. Scenario leaves <-> contract inventory
    if scen_cls is None:
        out.append(Finding("RL004", mi.path, 1,
                           "scenario class not found"))
    else:
        actual = _class_fields(scen_cls)
        want = set(sc.get("scenario_fields", []))
        for f in sorted(set(actual) - want):
            out.append(Finding(
                "RL004", mi.path, actual[f],
                f"Scenario leaf {f!r} is not in the contract's "
                "scenario_fields (new knob: register it AND bump "
                "schema_version)"))
        for f in sorted(want - set(actual)):
            out.append(Finding(
                "RL004", REGISTRY_RELPATH, 1,
                f"contract lists scenario field {f!r} that Scenario no "
                "longer has"))
        # every leaf must be consumed somewhere outside the class body
        reads = {n.attr for n in ast.walk(mi.tree)
                 if isinstance(n, ast.Attribute)
                 and not (scen_cls.lineno <= n.lineno
                          <= scen_cls.end_lineno)}
        for f, line in actual.items():
            if f in want and f not in reads:
                out.append(Finding(
                    "RL004", mi.path, line,
                    f"Scenario leaf {f!r} is never read in the "
                    "simulator (dead knob)"))

    # 2. schema version pin
    ver_node = _module_assign(mi, sc.get("schema_version_name",
                                         "SIM_SCHEMA_VERSION"))
    if ver_node is None:
        out.append(Finding("RL004", mi.path, 1,
                           "SIM_SCHEMA_VERSION assignment not found"))
    elif isinstance(ver_node.value, ast.Constant):
        if ver_node.value.value != sc.get("schema_version"):
            out.append(Finding(
                "RL004", mi.path, ver_node.lineno,
                f"SIM_SCHEMA_VERSION is {ver_node.value.value} but the "
                f"contract pins {sc.get('schema_version')} (bump both "
                "together)"))

    # 3. fingerprint knobs == the module's KNOBS literals: the fault pin
    # always, the flow engine's when the contract declares it
    fp_pins = [(sc.get("fingerprint_name", "FAULT_KNOBS"),
                "fingerprint_params")]
    if "flow_fingerprint_params" in sc:
        fp_pins.append((sc.get("flow_fingerprint_name", "FLOW_KNOBS"),
                        "flow_fingerprint_params"))
    for fp_name, fp_key in fp_pins:
        fk_node = _module_assign(mi, fp_name)
        if fk_node is None:
            out.append(Finding("RL004", mi.path, 1,
                               f"{fp_name} assignment not found"))
            continue
        lits = [e.value for e in ast.walk(fk_node.value)
                if isinstance(e, ast.Constant)
                and isinstance(e.value, str)]
        if lits != list(sc.get(fp_key, [])):
            out.append(Finding(
                "RL004", mi.path, fk_node.lineno,
                f"{fp_name} {tuple(lits)} != contract {fp_key} "
                f"{tuple(sc.get(fp_key, []))}: the cache fingerprint "
                "and the registry must move together"))

    # 4. SimParams validation table
    if par_cls is None:
        out.append(Finding("RL004", mi.path, 1,
                           "params class not found"))
        return out
    actual_p = _class_fields(par_cls)
    validated = set(sc.get("validated_params", []))
    exempt = {e["field"]: e for e in cfg.raw.get("validation_exempt",
                                                 [])}
    for f, e in exempt.items():
        if not str(e.get("reason", "")).strip():
            out.append(Finding(
                "RL004", REGISTRY_RELPATH, 1,
                f"validation_exempt entry {f!r} carries no reason"))
    post = None
    for n in par_cls.body:
        if isinstance(n, ast.FunctionDef) and n.name == "__post_init__":
            post = n
    post_reads = set()
    if post is not None:
        post_reads = {a.attr for a in ast.walk(post)
                      if isinstance(a, ast.Attribute)
                      and isinstance(a.value, ast.Name)
                      and a.value.id == "self"}
    for f, line in actual_p.items():
        if f in validated:
            if f not in post_reads:
                out.append(Finding(
                    "RL004", mi.path, line,
                    f"SimParams.{f} is declared validated but "
                    "__post_init__ never checks it"))
        elif f not in exempt:
            out.append(Finding(
                "RL004", mi.path, line,
                f"SimParams.{f} is in neither validated_params nor "
                "[[validation_exempt]]: every knob needs a range "
                "check or a stated exemption"))
    for f in sorted((validated | set(exempt)) - set(actual_p)):
        out.append(Finding(
            "RL004", REGISTRY_RELPATH, 1,
            f"contract mentions SimParams field {f!r} that no longer "
            "exists"))
    # every fingerprint knob (any family) must be a real SimParams field
    for fp_key in ("fingerprint_params", "flow_fingerprint_params"):
        for f in sc.get(fp_key, []):
            if f not in actual_p:
                out.append(Finding(
                    "RL004", REGISTRY_RELPATH, 1,
                    f"{fp_key} lists {f!r} which is not a "
                    "SimParams field"))
    return out
