"""``python -m repro_torch.analysis``: the port's contract linter and
artifact-audit CLI.

Exit status: 0 unless ``--check`` is given and unsuppressed findings
remain (or the registry itself is unreadable, or the audit fails to
run: 2). ``--json``/``--dead-code`` write machine-readable reports under
``results/analysis_torch/``; the artifact audit (RL007-RL009) runs
whenever the contracts file is present, on ``--device`` (``cuda`` by
default, which needs a card; ``cpu`` anywhere), in both modes (skip it
with ``--no-artifacts``; refresh the measured bands with
``--bless-artifacts``). The lint needs no device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from . import artifact
from .engine import run_lint
from .findings import RULES
from .reachability import dead_code_report
from .registry import REGISTRY_RELPATH, load_config

REPORT_DIR = "results/analysis_torch"


def find_root(start: Path | None = None) -> Path:
    """Repo root = nearest ancestor holding the registry; falls back to
    the source checkout this module sits in."""
    cur = (start or Path.cwd()).resolve()
    for p in [cur, *cur.parents]:
        if (p / REGISTRY_RELPATH).is_file():
            return p
    return Path(__file__).resolve().parents[3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract-aware static analysis + artifact audit for "
                    "the port's sweep engine (rules RL001-RL009; see "
                    "ROADMAP 'Static contracts of the port')")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the registry's "
                         "lint_scope)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 if any unsuppressed finding remains")
    ap.add_argument("--json", nargs="?", metavar="PATH",
                    const=f"{REPORT_DIR}/analysis_report.json",
                    default=None,
                    help="write the machine-readable report "
                         "(default %(const)s)")
    ap.add_argument("--dead-code", action="store_true",
                    help=f"also emit {REPORT_DIR}/dead_code_report.json "
                         "(module reachability from the port's entry "
                         "points)")
    ap.add_argument("--no-artifacts", action="store_true",
                    help="skip the artifact audit (RL007-RL009): lint "
                         "only, no tick runs")
    ap.add_argument("--bless-artifacts", action="store_true",
                    help="count the audited ticks and rewrite the "
                         "contract file's per-mode measured bands "
                         "(collective/host-round-trip/in-place violations "
                         "still fail: they are never blessable)")
    ap.add_argument("--artifact-contracts", default=None, metavar="PATH",
                    help="contracts file to audit against (default "
                         f"{artifact.ARTIFACT_RELPATH})")
    ap.add_argument("--artifact-units", default=None, metavar="NAMES",
                    help="comma-separated subset of audit units to run "
                         "(skips the registry-coverage check)")
    ap.add_argument("--device", default="cuda",
                    help="device the audit runs its ticks on (default "
                         "%(default)s; cpu on a machine without a card)")
    ap.add_argument("--root", default=None,
                    help="repo root (default: auto-detected)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-finding output")
    args = ap.parse_args(argv)

    root = Path(args.root).resolve() if args.root else find_root()
    try:
        cfg = load_config(root)
    except Exception as e:  # unreadable registry is itself a failure
        print(f"error: cannot load {REGISTRY_RELPATH}: {e}",
              file=sys.stderr)
        return 2

    rep = run_lint(root, cfg, args.paths or None)

    # artifact audit: on whenever the contracts file exists
    contracts_path = Path(args.artifact_contracts).resolve() \
        if args.artifact_contracts else root / artifact.ARTIFACT_RELPATH
    artifact_payload = None
    if not args.no_artifacts and contracts_path.is_file():
        units = [u.strip() for u in args.artifact_units.split(",")
                 if u.strip()] if args.artifact_units else None
        try:
            afindings, artifact_payload = artifact.run_audit(
                root, cfg, contracts_path, bless=args.bless_artifacts,
                units=units, device=args.device)
        except Exception as e:
            print(f"error: artifact audit failed: {e}", file=sys.stderr)
            return 2
        rep.findings = sorted(
            rep.findings + afindings,
            key=lambda f: (f.path, f.line, f.rule))
    elif args.bless_artifacts:
        print(f"error: no contracts file at {contracts_path}",
              file=sys.stderr)
        return 2

    if not args.quiet:
        for f in rep.findings:
            print(f.format())
    by_rule = rep.by_rule()
    parts = []
    for rule in sorted(by_rule):
        n = len(by_rule[rule])
        ns = sum(1 for f in by_rule[rule] if not f.suppressed)
        parts.append(f"{rule}:{ns}/{n}")
    print(f"repro_torch.analysis: {len(rep.files)} files, "
          f"{len(rep.unsuppressed)} unsuppressed finding(s) "
          f"({', '.join(parts) if parts else 'clean'}), "
          f"{rep.suppression_count}/{rep.baseline} suppressions used")
    if artifact_payload is not None:
        cal = artifact_payload["calibration"]
        n_cases = sum(len(u.get("cases", []))
                      for u in artifact_payload["units"].values())
        spreads = ", ".join(f"{m} {c['ratio_spread']:.2f}"
                            for m, c in cal.items())
        print(f"artifact audit: {len(artifact_payload['units'])} "
              f"unit(s), {n_cases} case(s) "
              f"[{'+'.join(artifact_payload['modes'])}, "
              f"{artifact_payload['device']['name']}], planner "
              f"calibration spread {spreads}"
              + (" (contracts re-blessed)"
                 if artifact_payload.get("blessed") else ""))

    if args.json:
        out = root / args.json
        out.parent.mkdir(parents=True, exist_ok=True)
        payload = rep.to_json()
        payload["rules"] = {r: {"name": n, "invariant": i}
                            for r, (n, i) in RULES.items()}
        if artifact_payload is not None:
            payload["artifact"] = artifact_payload
        out.write_text(json.dumps(payload, indent=2, sort_keys=True))
        try:
            shown = out.relative_to(root)
        except ValueError:            # --json outside the repo root
            shown = out
        print(f"wrote {shown}")

    if args.dead_code:
        dc = dead_code_report(root, cfg.lint_exempt)
        out = root / REPORT_DIR / "dead_code_report.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(dc, indent=2, sort_keys=True))
        s = dc["summary"]
        n_ex = sum(1 for u in dc["unreachable"] if u["exempt"])
        print(f"dead-code: {s['n_reachable']}/{s['n_modules']} modules "
              f"reachable; {s['n_unreachable']} unreachable "
              f"({n_ex} exempt, {s['loc_unreachable']} LoC) -> "
              f"{out.relative_to(root)}")

    if args.check and rep.unsuppressed:
        return 1
    return 0
