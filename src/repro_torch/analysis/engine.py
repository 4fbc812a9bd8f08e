"""Lint orchestration: scope -> project -> checkers -> suppressions.

`run_lint` is the single entry the CLI and the tests share. It returns
a :class:`LintReport` whose ``findings`` carry their suppression state
(a suppressed finding stays in the report, the JSON artifact is the
audit trail, but does not fail ``--check``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from . import checkers, registry, taint
from .astutil import load_project
from .findings import Finding, apply_suppressions, scan_suppressions
from .registry import REGISTRY_RELPATH, Config


@dataclass
class LintReport:
    findings: list = field(default_factory=list)
    suppression_count: int = 0
    baseline: int = 0
    files: list = field(default_factory=list)

    @property
    def unsuppressed(self) -> list:
        return [f for f in self.findings if not f.suppressed]

    def by_rule(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out.setdefault(f.rule, []).append(f)
        return out

    def to_json(self) -> dict:
        return {
            "files": self.files,
            "n_findings": len(self.findings),
            "n_unsuppressed": len(self.unsuppressed),
            "suppressions": {"count": self.suppression_count,
                             "baseline": self.baseline},
            "findings": [f.to_json() for f in self.findings],
        }


def lint_paths(root: Path, cfg: Config, paths=None) -> list:
    """Resolve the lint scope to concrete .py files (a scope entry may
    be a directory, a file or a glob such as ``examples/torch_*.py``)."""
    scopes = paths if paths else cfg.lint_scope
    files = []
    for s in scopes:
        p = root / s
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.is_file():
            files.append(p)
        elif any(c in s for c in "*?["):
            files.extend(sorted(q for q in root.glob(s) if q.is_file()))
    return [f for f in files
            if not cfg.is_exempt(f.relative_to(root).as_posix())]


def run_lint(root: Path, cfg: Config, paths=None) -> LintReport:
    files = lint_paths(root, cfg, paths)
    proj = load_project(root, files)
    rep = LintReport(baseline=cfg.max_suppressions,
                     files=[m.path for m in proj.modules.values()])

    findings = []
    findings += taint.analyze(proj, cfg.traced_roots()).findings
    for mi in proj.modules.values():
        if mi.path in cfg.hot_modules:
            findings += checkers.check_host_transfers(
                mi, cfg.blessed(mi.path))
        if mi.path in cfg.bitexact_modules:
            findings += checkers.check_dtypes(mi, cfg.dtype_exempt(mi.path))
        findings += checkers.check_prng(mi)
    findings += registry.check_registry(proj, cfg)
    findings += registry.check_scenario_contract(proj, cfg)

    # suppressions: per-file inline annotations, then the global
    # count-only-goes-down baseline
    total = 0
    by_path = {}
    for mi in proj.modules.values():
        sup = scan_suppressions(mi.path, mi.source)
        by_path[mi.path] = sup
        total += sup.count
        findings += sup.bad
    out = []
    for f in findings:
        sup = by_path.get(f.path)
        out += apply_suppressions([f], sup) if sup else [f]
    if total > cfg.max_suppressions:
        out.append(Finding(
            "RL000", REGISTRY_RELPATH, 1,
            f"suppression count {total} exceeds the committed baseline "
            f"{cfg.max_suppressions}: the baseline only goes down "
            "silently; raising it is a reviewed registry edit"))
    rep.findings = sorted(out, key=lambda f: (f.path, f.line, f.rule))
    rep.suppression_count = total
    return rep
