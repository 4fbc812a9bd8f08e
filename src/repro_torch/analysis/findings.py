"""Finding/suppression model for the port's contract linter.

A finding is one named-rule violation at a file:line. Suppressions are
inline comments of the form::

    some_code()  # repro-torch-lint: disable=RL003(timing barrier), RL006(x)

i.e. ``disable=`` followed by one or more ``RULE(reason)`` entries. The
reason string is MANDATORY: a bare ``disable=RL003`` or an empty
``RL003()`` does not suppress and instead raises an RL000
bad-suppression finding, so every silenced contract carries its
justification in the diff. A suppression on a line silences findings of
that rule on the same line; a suppression comment on its OWN line
silences the next code line (for lines too long to annotate inline).

The committed suppression count is itself a contract: the registry's
``max_suppressions`` baseline can only be lowered silently, never
raised (RL000 fires when the tree carries more suppressions than the
baseline allows).
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

#: rule id -> (title, invariant one-liner); the single source the CLI,
#: the ROADMAP section and the fixture tests enumerate
RULES = {
    "RL000": ("bad-suppression",
              "suppressions need a RULE(reason) with a non-empty reason,"
              " and their committed count may only go down"),
    "RL001": ("traced-control-flow",
              "no Python control flow or host coercion (if/while/assert,"
              " float()/int()/bool()/.item()/.tolist()) on tensor values"
              " inside functions a CUDA graph captures or the tick"
              " reaches: each is a host sync the capture refuses"),
    "RL002": ("compile-site-registry",
              "every CUDA-graph capture, kernel library binding and"
              " torch.library operator definition is declared in"
              " compile_sites.toml with its multiplicity, and the"
              " registry tracks the CAPTURE_COUNT pin"),
    "RL003": ("host-transfer-smell",
              "no .item()/.cpu()/.tolist()/.numpy()/.to('cpu')/"
              "synchronize() in hot-loop modules outside the blessed"
              " fetch points"),
    "RL004": ("scenario-leaf-sync",
              "every Scenario/SimParams knob is registered in the"
              " scenario contract (fingerprint + validation + schema"
              " version): no silent knob drift"),
    "RL005": ("prng-discipline",
              "a core.prng key feeds at most one sampling call without"
              " an intervening split/fold_in"),
    "RL006": ("dtype-discipline",
              "no float64 literals/dtypes in bit-exact kernel/ref/gating"
              " code outside the registry's per-function x64 exemptions"),
    "RL007": ("artifact-contract-drift",
              "every registry site is covered by an audit unit (or"
              " skipped with a reason) and the audited tick's counted"
              " FLOPs/bytes, peak live bytes and fold dtype stay inside"
              " the blessed bands of artifact_contracts.toml (re-bless"
              " via --bless-artifacts)"),
    "RL008": ("artifact-collective-callback",
              "the audited tick holds no c10d collective, no"
              " _local_scalar_dense/item and no copy to another device,"
              " and its captured CUDA graph no host node and no"
              " device-to-host copy"),
    "RL009": ("donation-aliasing-loss",
              "step_into writes every SimState leaf in place: each"
              " leaf's storage is the same after a tick and after a"
              " graph replay"),
}

_SUPPRESS_RE = re.compile(r"#\s*repro-torch-lint:\s*disable=(.*)$")
_ENTRY_RE = re.compile(r"(RL\d{3})\s*(?:\(([^()]*)\))?")


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str            # repo-relative
    line: int
    message: str
    severity: str = "error"
    suppressed: bool = False
    suppress_reason: str = ""

    def format(self) -> str:
        tag = f" [suppressed: {self.suppress_reason}]" \
            if self.suppressed else ""
        return (f"{self.path}:{self.line}: {self.rule}"
                f"({RULES[self.rule][0]}) {self.message}{tag}")

    def to_json(self) -> dict:
        return {"rule": self.rule, "name": RULES[self.rule][0],
                "path": self.path, "line": self.line,
                "message": self.message, "severity": self.severity,
                "suppressed": self.suppressed,
                "suppress_reason": self.suppress_reason}


@dataclass
class Suppressions:
    """Per-file map of line -> {rule: reason} plus the RL000 findings
    malformed suppressions raise."""
    by_line: dict = field(default_factory=dict)
    bad: list = field(default_factory=list)     # Finding (RL000)
    count: int = 0                              # well-formed entries

    def reason_for(self, rule: str, line: int) -> str | None:
        ent = self.by_line.get(line)
        if ent is None:
            return None
        return ent.get(rule)


def scan_suppressions(path: str, source: str) -> Suppressions:
    """Extract ``# repro-torch-lint: disable=...`` comments from a file.

    An annotation on a code line applies to that line; an annotation on
    a comment-only line applies to the NEXT line (so long statements
    can carry their justification above themselves).
    """
    sup = Suppressions()
    for ln, raw in enumerate(source.splitlines(), 1):
        m = _SUPPRESS_RE.search(raw)
        if not m:
            continue
        own_line = raw.lstrip().startswith("#")
        target = ln + 1 if own_line else ln
        body = m.group(1)
        matched_any = False
        for em in _ENTRY_RE.finditer(body):
            matched_any = True
            rule, reason = em.group(1), (em.group(2) or "").strip()
            if rule not in RULES:
                sup.bad.append(Finding(
                    "RL000", path, ln,
                    f"suppression names unknown rule {rule}"))
                continue
            if not reason:
                sup.bad.append(Finding(
                    "RL000", path, ln,
                    f"suppression of {rule} carries no reason string "
                    f"(write {rule}(why it is safe))"))
                continue
            sup.by_line.setdefault(target, {})[rule] = reason
            sup.count += 1
        if not matched_any:
            sup.bad.append(Finding(
                "RL000", path, ln,
                f"malformed repro-torch-lint suppression: "
                f"{body.strip()!r}"))
    return sup


def apply_suppressions(findings: list, sup: Suppressions) -> list:
    """Mark findings covered by a same-line suppression of their rule."""
    out = []
    for f in findings:
        reason = sup.reason_for(f.rule, f.line)
        if reason is not None and not f.suppressed:
            f = Finding(f.rule, f.path, f.line, f.message, f.severity,
                        suppressed=True, suppress_reason=reason)
        out.append(f)
    return out
