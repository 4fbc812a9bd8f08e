"""Artifact contract auditor (rules RL007-RL009) for the port.

The source-level rules (RL001-RL006) prove properties of the Python
tree; the contracts that decide the sweep's efficiency live in what it
runs: one tick of fixed shapes, captured once as a CUDA graph and
replayed, with no host round trip, a fold buffer whose type follows the
x64 mode, a carry written in place, a bounded working set. The
reference reads those off XLA's compiled chunk program; the port reads
them off one tick, built through the SAME seams the engine runs
(``simulator._prepare_sweep_args``, ``make_sim_step``, ``step_into``,
``_TickGraph``; ``ici_gating._reactive_program``), and checks them
against the committed contracts in ``artifact_contracts.toml``:

* **RL008** - the tick's op inventory (``hlo.TickCounter``) holds no
  collective, no ``_local_scalar_dense``/``item`` and no copy between
  devices; on the card its captured graph (``hlo.graph_nodes``) holds
  no host node and no device-to-host copy.
* **RL009** - the port's donation: ``step_into`` writes every
  ``SimState`` leaf in place, so each leaf's ``data_ptr()`` is the same
  after a tick and, on the card, after graph replays.
* **RL007** - contract drift: the fold buffer's type under each mode,
  FLOPs and bytes of one tick per scenario (counted by
  ``launch.hlo_analysis.CostCounter`` under XLA's rules) and of one
  chunk boundary (the fold, and the guards of a ``validate`` case)
  within ``cost_rtol`` of the blessed band of the mode, an op without a
  cost rule (a finding, not a 0), the tick's peak live bytes on the
  card against the case's budget for the mode (not measured on the
  CPU), registry
  coverage (every RL002 site audited or skipped with a reason), and the
  planner calibration (``planner.site_cost`` against the counted FLOPs,
  spread <= ``max_ratio_spread``; the same table serves
  ``planner.plan_sites(cost_model="hlo")``).

Both modes run in one process: the x64 mode is the ``x64=True``
argument of the engine, not a process-wide switch. Every count is one
operator per kernel call on every device, so the card's count of a case
equals the CPU's.

Bless workflow: ``python -m repro_torch.analysis --bless-artifacts``
measures the tree in both modes and rewrites the measured tables
(budgets and skips stay reviewed edits; RL008/RL009 violations are never
blessable). The checkers below are pure functions over counts and
inventories, so the fixture tests pin their rule IDs without a tick.
"""
from __future__ import annotations

import math
from pathlib import Path

from . import toml_lite
from .findings import Finding

ARTIFACT_RELPATH = "src/repro_torch/analysis/artifact_contracts.toml"

#: bump when the contract schema or the audit semantics change
ARTIFACT_SCHEMA_VERSION = 1

MODES = ("x32", "x64")

#: the measured keys of a case, per mode: one tick per scenario, and
#: one chunk boundary (the fold, the guards of a validate case) per
#: scenario
COST_KEYS = (("flops_per_tick_scen", "tick FLOPs"),
             ("bytes_per_tick_scen", "tick bytes"),
             ("flops_per_boundary_scen", "boundary FLOPs"),
             ("bytes_per_boundary_scen", "boundary bytes"))


def load_contracts(root: Path, path: Path | None = None) -> dict:
    p = path or (Path(root) / ARTIFACT_RELPATH)
    return toml_lite.load(p)


# ---------------------------------------------------------------------------
# checkers (pure: the fixture tests drive these)
# ---------------------------------------------------------------------------

def check_op_inventory(collectives: dict, host_reads: dict,
                       crossings: dict, path: str, where: str) -> list:
    """RL008: collectives, host reads and device crossings in a tick."""
    out = []
    for label, found in (("collective", collectives),
                         ("host read", host_reads),
                         ("copy to another device", crossings)):
        if found:
            out.append(Finding(
                "RL008", path, 1,
                f"{where}: the tick runs {label} op(s) {sorted(found)} "
                f"({sum(found.values())} in all): the tick must stay on "
                "its device, scenarios are independent lanes"))
    return out


def check_graph_nodes(nodes: dict, path: str, where: str) -> list:
    """RL008: host nodes and device-to-host copies in a captured tick."""
    bad = {}
    if nodes.get("kinds", {}).get("host"):
        bad["host node"] = nodes["kinds"]["host"]
    for way, n in nodes.get("copies", {}).items():
        if way.startswith("device->") and not way.endswith("device"):
            bad[f"{way} copy"] = n
    if not bad:
        return []
    return [Finding(
        "RL008", path, 1,
        f"{where}: the captured tick holds {bad}: every replay would "
        "round-trip through the host")]


def check_in_place(moved: list, path: str, where: str) -> list:
    """RL009: ``moved`` names the SimState leaves whose storage changed
    (the carry must be written in place, as a replayed graph needs)."""
    if not moved:
        return []
    return [Finding(
        "RL009", path, 1,
        f"{where}: step_into left {len(moved)} SimState leaf/leaves in "
        f"new storage ({', '.join(moved[:4])}{', ...' if len(moved) > 4 else ''}):"
        " a replayed graph would read a stale carry")]


def check_fold_dtype(found: str, expected: str, path: str,
                     where: str) -> list:
    """RL007: the fold buffer's type must follow the x64 mode."""
    if found == expected:
        return []
    return [Finding(
        "RL007", path, 1,
        f"{where}: fold buffer dtype is {found}, contract expects "
        f"{expected} for this mode: the Kahan fold precision contract "
        "(_prepare_sweep_args) drifted")]


def check_unknown_ops(unknown: dict, path: str, where: str) -> list:
    """RL007: an op without a cost rule is a gap in the count, not 0."""
    if not unknown:
        return []
    return [Finding(
        "RL007", path, 1,
        f"{where}: {sum(unknown.values())} op(s) without a cost rule in "
        f"launch/hlo_analysis.py: {sorted(unknown)}")]


def check_memory_budget(peak: int | None, budget: int, path: str,
                        where: str) -> list:
    """RL007: the tick's peak live bytes on the card within the case's
    budget for the mode (None: not measured, the CPU; a budget of 0:
    none set, itself a finding where the peak was measured)."""
    if peak is None:
        return []
    if not budget:
        return [Finding(
            "RL007", path, 1,
            f"{where}: the tick's peak of {peak} B has no budget: set "
            "the case's peak_bytes_budget_<mode> in "
            "artifact_contracts.toml (a reviewed edit)")]
    if peak > budget:
        return [Finding(
            "RL007", path, 1,
            f"{where}: the tick holds {peak} B live at its peak, more "
            f"than the contract budget {budget} B; raise the budget only "
            "after reviewing what grew")]
    return []


def check_cost_drift(measured: dict, blessed: dict | None, rtol: float,
                     mode: str, path: str, where: str) -> list:
    """RL007: counted FLOPs and bytes vs the blessed per-mode band."""
    if blessed is None:
        return [Finding(
            "RL007", path, 1,
            f"{where}: no blessed {mode} measurement in "
            "artifact_contracts.toml: run `python -m repro_torch.analysis "
            "--bless-artifacts --device cpu` and commit the contract "
            "update")]
    out = []
    for key, label in COST_KEYS:
        m, b = measured.get(key), blessed.get(key)
        if not b:
            continue
        if abs(m - b) > rtol * b:
            out.append(Finding(
                "RL007", path, 1,
                f"{where}: counted {label} {m:.0f} drifted beyond "
                f"±{rtol:.0%} of the blessed {b:.0f} ({mode}): the "
                "tick's cost moved; review and re-bless"))
    return out


def check_coverage(cfg, art: dict) -> list:
    """RL007: every RL002 compile site maps to an audit unit's covers
    list or an [[artifact.skip]] entry with a reason."""
    out = []
    covers = []
    for u in art.get("unit", []):
        covers.extend(u.get("covers", []))
    skips = {}
    for s in art.get("skip", []):
        key = f"{s.get('file', '')}::{s.get('qualname', '')}"
        skips[key] = s
        if not str(s.get("reason", "")).strip():
            out.append(Finding(
                "RL007", ARTIFACT_RELPATH, 1,
                f"artifact.skip entry {key} carries no reason"))
    for e in cfg.raw.get("compile_site", []):
        key = f"{e.get('file', '')}::{e.get('qualname', '')}"
        covered = key in skips or any(
            key == c or key.startswith(c + ".") for c in covers)
        if not covered:
            out.append(Finding(
                "RL007", ARTIFACT_RELPATH, 1,
                f"registry compile site {key} is not covered by any "
                "artifact audit unit: add it to a unit's covers list "
                "or declare an [[artifact.skip]] with a reason"))
    return out


def check_calibration(cal: dict, max_spread: float) -> list:
    """RL007: the hand cost model must track the counted cost: the
    per-hull model-vs-counted ratio spread stays bounded."""
    spread = cal.get("ratio_spread", 1.0)
    if spread <= max_spread:
        return []
    hulls = ", ".join(f"{h['tag']}:{h['ratio']:.1f}"
                      for h in cal.get("hulls", []))
    return [Finding(
        "RL007", "src/repro_torch/core/planner.py", 1,
        f"planner cost-model calibration: model-vs-counted ratio "
        f"spread {spread:.2f} exceeds max_ratio_spread {max_spread} "
        f"across hulls ({hulls}): site_cost mis-scales with hull "
        "size and would mis-bucket sweeps; recalibrate the footprint "
        "model or switch the sweep to cost_model='hlo'")]


# ---------------------------------------------------------------------------
# unit builders (torch and the engine imported lazily: a lint-only run
# never imports them)
# ---------------------------------------------------------------------------

def _case_site(case: dict):
    from repro_torch.core.topology import FBSite
    return FBSite(n_clusters=int(case["ncl"]),
                  racks_per_cluster=int(case["rpc"]),
                  servers_per_rack=int(case["spr"]),
                  csw_per_cluster=int(case["cpc"]),
                  n_fc=int(case["nfc"]))


def _carry_items(S, state) -> list:
    """(name, tensor) of every SimState leaf, by the reference's names."""
    out = []
    S._map_carry(state, lambda name, t: out.append((name, t)))
    return out


def _leaf_ptrs(S, state) -> dict:
    return {name: t.data_ptr() for name, t in _carry_items(S, state)}


def _moved(before: dict, after: dict) -> list:
    return [n for n, p in before.items() if after.get(n) != p]


def _per_scen(cc, n: int, prefix: str) -> dict:
    return {f"flops_per_{prefix}_scen": cc.flops / n,
            f"bytes_per_{prefix}_scen": cc.bytes_accessed / n}


def _tick_payload(tc) -> dict:
    return {"counts": tc.counts(), "unknown": dict(tc.unknown),
            "collectives": tc.collectives(),
            "host_reads": tc.host_reads(),
            "crossings": dict(tc.crossings)}


def _audit_case_common(unit, case, art, mode, bless, where, measured,
                       tick, memory, findings):
    """The checks every builder shares, then the case's payload."""
    path = unit.get("file", ARTIFACT_RELPATH)
    findings += check_op_inventory(tick["collectives"], tick["host_reads"],
                                   tick["crossings"], path, where)
    findings += check_unknown_ops(tick["unknown"], path, where)
    findings += check_memory_budget(
        None if memory is None else memory["peak"],
        int(case.get(f"peak_bytes_budget_{mode}", 0)), ARTIFACT_RELPATH,
        where)
    if not bless:
        findings += check_cost_drift(
            measured, case.get("measured", {}).get(mode),
            float(art.get("cost_rtol", 0.5)), mode, ARTIFACT_RELPATH,
            where)
    else:
        case.setdefault("measured", {})[mode] = {
            k: round(v, 1) for k, v in measured.items()}
    return {"tag": case.get("tag"), "mode": mode, "measured": measured,
            "tick": tick,
            "memory": memory if memory is not None else "not measured"}


def _audit_tick_case(unit: dict, case: dict, art: dict, mode: str,
                     bless: bool, dev, *, label: str = "sweep_tick",
                     n: int | None = None):
    """One sweep tick of a small batch (``n`` scenarios, default the
    case's) on ``dev``, as ``run_sweep`` runs it; on the card also
    captured and replayed as ``_TickGraph`` does."""
    import torch

    from repro_torch.analysis import hlo
    from repro_torch.core import simulator as S
    from repro_torch.core.traffic import TRAFFIC_SPECS

    x64 = mode == "x64"
    site = _case_site(case)
    n = int(case.get("n_scenarios", 2)) if n is None else n
    validate = bool(case.get("validate", False))
    spec = TRAFFIC_SPECS[case.get("spec", "fb_hadoop")]
    batch = S.make_batch([(S.SimParams(spec=spec, site=site), i)
                          for i in range(n)])
    scen, state, fold, guard, tol = S._prepare_sweep_args(
        batch, dev, validate=validate, x64=x64)
    step = S.make_sim_step(batch.hull, scen, flows=batch.flows, x64=x64)
    where = f"{label}[{case.get('tag', '?')}, {mode}, {dev.type}]"
    path = unit.get("file", ARTIFACT_RELPATH)
    findings = []

    ptrs = _leaf_ptrs(S, state)
    with hlo.TickCounter() as tc:
        S.step_into(step, state)
    block = S._Block(scen, state, fold, guard, step, None)
    with hlo.TickCounter() as bc:
        block.advance(0, 0, validate, tol)
    measured = {**_per_scen(tc, n, "tick"), **_per_scen(bc, n, "boundary")}
    moved = _moved(ptrs, _leaf_ptrs(S, state))

    fold_dtype = str(fold[0].dtype).removeprefix("torch.")
    findings += check_fold_dtype(
        fold_dtype, unit.get(f"fold_dtype_{mode}",
                             "float64" if x64 else "float32"), path, where)

    memory = nodes = launches = None
    if dev.type == "cuda":
        ticks = S._TickGraph(step, state, site=batch.hull, keep_graph=True)
        # the eager warm-up, the capture, 2 replays
        peak = hlo.peak_bytes(lambda: ticks.run(3), dev)
        moved += [m for m in _moved(ptrs, _leaf_ptrs(S, state))
                  if m not in moved]
        nodes = hlo.graph_nodes(ticks.graph.raw_cuda_graph())
        memory = {"peak": peak, "reserved": hlo.pool_bytes(ticks.graph)}
        launches = ticks.launches
        findings += check_graph_nodes(nodes, path, where)
    findings += check_in_place(moved, path, where)
    bad_state = [name for name, t in _carry_items(S, state)
                 if t.is_floating_point() and not bool(torch.isfinite(t).all())]
    if bad_state:
        findings.append(Finding(
            "RL007", path, 1, f"{where}: non-finite carry after the "
            f"audited ticks: {bad_state}"))

    tick = _tick_payload(tc)
    tick["boundary"] = _tick_payload(bc)
    payload = _audit_case_common(unit, case, art, mode, bless, where,
                                 measured, tick, memory, findings)
    payload.update({"validate": validate, "fold_dtype": fold_dtype,
                    "leaves_in_place": not moved,
                    "graph": nodes if nodes is not None else "not measured",
                    "launches_per_replay": launches,
                    "hull": _full_tag(batch.hull)})
    return findings, payload


def _full_tag(site) -> str:
    from repro_torch.core.topology import full_site_tag
    return full_site_tag(site)


def _audit_run_sim_case(unit: dict, case: dict, art: dict, mode: str,
                        bless: bool, dev):
    """``run_sim``'s tick: a batch of one scenario in one chunk."""
    return _audit_tick_case(unit, case, art, mode, bless, dev,
                            label="run_sim", n=1)


def _audit_ici_case(unit: dict, case: dict, art: dict, mode: str,
                    bless: bool, dev):
    """The reactive ICI timeline of ``n_ticks`` ticks, run eagerly under
    the counter (per tick: the count over the run / n_ticks), its demand
    uploaded first."""
    import numpy as np
    import torch

    from repro_torch.analysis import hlo
    from repro_torch.core import constants as C
    from repro_torch.core import ici_gating
    from repro_torch.device import upload

    n_ticks = int(case.get("n_ticks", 256))
    tick_us = float(case.get("tick_us", 1.0))
    links = C.TPU_ICI_LINKS_PER_CHIP
    bw_link_tick = C.TPU_ICI_LINK_BW * 1e-6 * tick_us
    up_delay = max(int(np.ceil(C.LASER_ON_US / tick_us)), 1)
    run = ici_gating._reactive_program(links, bw_link_tick, tick_us,
                                       8 * bw_link_tick, up_delay,
                                       device=dev, x64=mode == "x64")
    # the timeline goes up before the count: the ticks read it there
    demand = upload(torch.zeros(n_ticks, dtype=torch.float64 if mode == "x64"
                                else torch.float32), dev)
    with hlo.TickCounter() as tc:
        run(demand)
    measured = {"flops_per_tick_scen": tc.flops / n_ticks,
                "bytes_per_tick_scen": tc.bytes_accessed / n_ticks}
    where = f"ici_reactive[{case.get('tag', '?')}, {mode}, {dev.type}]"
    findings = []
    payload = _audit_case_common(unit, case, art, mode, bless, where,
                                 measured, _tick_payload(tc), None,
                                 findings)
    return findings, payload


_BUILDERS = {
    "sweep_tick": _audit_tick_case,
    "run_sim": _audit_run_sim_case,
    "ici_reactive": _audit_ici_case,
}


# ---------------------------------------------------------------------------
# planner cost-model calibration
# ---------------------------------------------------------------------------

def calibration(art: dict, unit_payloads: dict, mode: str) -> dict:
    """Model-vs-counted cost per audited hull: ratio = counted FLOPs
    per (scenario, tick) over ``planner.site_cost`` units. Only RATIOS
    matter for bucketing, so the hand model is healthy iff the ratio is
    stable across hulls (``ratio_spread`` = max/min). Each hull also
    reports the tick's arithmetic intensity (counted FLOPs / bytes):
    ``site_cost`` models the step as bandwidth-bound elementwise work."""
    from repro_torch.core import planner
    from repro_torch.core.topology import site_tag

    hulls = []
    for u in art.get("unit", []):
        if u.get("builder") != "sweep_tick":
            continue
        pays = unit_payloads.get(u.get("name"), {}).get("cases", [])
        by_tag = {p.get("tag"): p for p in pays if p.get("mode") == mode}
        for case in u.get("case", []):
            if case.get("validate"):
                continue
            p = by_tag.get(case.get("tag"))
            if not p:
                continue
            site = _case_site(case)
            model = planner.site_cost(site)
            meas = p["measured"]["flops_per_tick_scen"]
            hulls.append({"tag": site_tag(site), "model_cost": model,
                          "measured_flops_per_tick_scen": meas,
                          "ratio": meas / max(model, 1e-12),
                          "arith_intensity": meas / max(
                              p["measured"]["bytes_per_tick_scen"], 1e-12)})
    ratios = [h["ratio"] for h in hulls]
    spread = (max(ratios) / max(min(ratios), 1e-12)) if ratios else 1.0
    k = math.exp(sum(math.log(max(r, 1e-12)) for r in ratios)
                 / len(ratios)) if ratios else 1.0
    return {"hulls": hulls, "ratio_spread": spread, "mean_ratio": k}


# ---------------------------------------------------------------------------
# contract file emitter (the --bless-artifacts writer)
# ---------------------------------------------------------------------------

_HEADER = """\
# Artifact contracts for repro_torch.analysis.artifact (RL007-RL009; see
# ROADMAP "Static contracts of the port"). Measured tables are per mode
# (x32, x64) and written by `python -m repro_torch.analysis
# --bless-artifacts --device cpu`: one tick's FLOPs and bytes per
# scenario, and one chunk boundary's, as launch/hlo_analysis.py's
# CostCounter counts them (equal on the card and the CPU). Budgets
# (peak_bytes_budget_<mode>: the tick's peak live bytes on the card),
# skips and covers are reviewed edits: blessing never writes them.
"""


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, int):
        return str(v)
    if isinstance(v, list):
        return "[" + ", ".join(_fmt(x) for x in v) + "]"
    raise TypeError(f"cannot emit {type(v).__name__} in contracts file")


def _emit_pairs(d: dict, lines: list):
    for k, v in d.items():
        if isinstance(v, dict):
            continue                      # sub-tables emit their own header
        if isinstance(v, list) and v and isinstance(v[0], dict):
            continue                      # arrays-of-tables likewise
        lines.append(f"{k} = {_fmt(v)}")


def dump_contracts(contracts: dict) -> str:
    art = contracts.get("artifact", {})
    lines = [_HEADER, "[artifact]"]
    _emit_pairs(art, lines)
    for s in art.get("skip", []):
        lines += ["", "[[artifact.skip]]"]
        _emit_pairs(s, lines)
    for u in art.get("unit", []):
        lines += ["", "[[artifact.unit]]"]
        _emit_pairs(u, lines)
        for c in u.get("case", []):
            lines += ["", "[[artifact.unit.case]]"]
            _emit_pairs(c, lines)
            meas = c.get("measured", {})
            for mode in sorted(meas):
                lines += ["", f"[artifact.unit.case.measured.{mode}]"]
                _emit_pairs(meas[mode], lines)
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# running the audit
# ---------------------------------------------------------------------------

def run_audit(root: Path, cfg, contracts_path: Path | None = None, *,
              bless: bool = False, units=None, device="cuda"):
    """Audit every contract unit in both modes (``MODES``) on
    ``device``; returns ``(findings, payload)``.

    With ``bless=True`` the per-mode measured tables are rewritten in
    place; drift checks are skipped (a fresh bless is definitionally
    in-band) but RL008/RL009 violations still fire. ``units`` restricts
    the audit to the named units (the coverage check is skipped for
    partial audits). ``device="cuda"`` raises without a CUDA device.
    """
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    root = Path(root)
    cpath = Path(contracts_path) if contracts_path \
        else root / ARTIFACT_RELPATH
    contracts = toml_lite.load(cpath)
    art = contracts.get("artifact", {})

    findings = []
    if int(art.get("schema_version", 0)) != ARTIFACT_SCHEMA_VERSION:
        findings.append(Finding(
            "RL007", ARTIFACT_RELPATH, 1,
            f"artifact contract schema_version "
            f"{art.get('schema_version')} != auditor "
            f"{ARTIFACT_SCHEMA_VERSION} (bump both together)"))
    if units is None:
        findings += check_coverage(cfg, art)

    unit_payloads = {}
    for u in art.get("unit", []):
        name = u.get("name", "?")
        if units is not None and name not in units:
            continue
        builder = _BUILDERS.get(u.get("builder", ""))
        if builder is None:
            findings.append(Finding(
                "RL007", ARTIFACT_RELPATH, 1,
                f"artifact unit {name!r} names unknown builder "
                f"{u.get('builder')!r} (known: {sorted(_BUILDERS)})"))
            continue
        cases = []
        for mode in MODES:
            for case in u.get("case", []):
                f, p = builder(u, case, art, mode, bless, dev)
                findings += f
                cases.append(p)
        unit_payloads[name] = {"builder": u.get("builder"),
                               "cases": cases}

    cal = {mode: calibration(art, unit_payloads, mode) for mode in MODES}
    for mode in MODES:
        if cal[mode]["hulls"]:
            findings += check_calibration(
                cal[mode], float(art.get("max_ratio_spread", 2.0)))

    if bless:
        cpath.write_text(dump_contracts(contracts))

    payload = {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "modes": list(MODES),
        "device": {"type": dev.type,
                   "name": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu",
                   "torch": torch.__version__},
        "blessed": bless,
        "units": unit_payloads,
        "calibration": cal,
    }
    return findings, payload


def hlo_cost_table(root: Path | None = None,
                   contracts_path: Path | None = None,
                   mode: str = "x32") -> dict:
    """Blessed per-hull cost table for ``planner.plan_sites(
    cost_model="hlo")``: ``full_site_tag -> {"flops_per_tick_scen",
    "site"}``. Reads only the committed contract file (no tick runs).
    It reads the port's file (one tick counted, ``flops_per_tick_scen``)
    and the reference's format too (a chunk program of ``length`` ticks,
    ``flops_per_scen``)."""
    from repro_torch.core.topology import full_site_tag

    if contracts_path is None:
        base = Path(root) if root is not None \
            else Path(__file__).resolve().parents[3]
        contracts_path = base / ARTIFACT_RELPATH
    art = toml_lite.load(contracts_path).get("artifact", {})
    table = {}
    for u in art.get("unit", []):
        if u.get("builder") not in ("sweep_tick", "sweep_chunk"):
            continue
        for case in u.get("case", []):
            if case.get("validate"):
                continue
            blessed = case.get("measured", {}).get(mode)
            if not blessed:
                continue
            site = _case_site(case)
            if "flops_per_tick_scen" in blessed:
                flops = float(blessed["flops_per_tick_scen"])
            else:
                flops = float(blessed["flops_per_scen"]) / max(
                    int(case.get("length", 16)), 1)
            table[full_site_tag(site)] = {"flops_per_tick_scen": flops,
                                          "site": site}
    return table
