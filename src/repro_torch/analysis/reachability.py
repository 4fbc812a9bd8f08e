"""--dead-code: module-level reachability over the port's import graph.

Roots are the things that actually execute: the sweep engine's entry
points (``repro_torch.core.simulator``: ``run_sweep``,
``run_sweep_planned``, ``resume_sweep``, ``run_sim``), the ICI policy
(``repro_torch.core.ici_gating.reactive_policy``), every
``repro_torch.launch`` module that runs as ``python -m`` (it has a
``__main__`` block), ``repro_torch.trace_sweep``, the linter's own
``python -m repro_torch.analysis`` entry and its runtime sanitizer,
and the scripts that import the port: ``examples/torch_*.py`` and
``chip_smoke.py``. Tests are deliberately NOT roots: a module only a
test imports is exactly the inventory this report exists to surface.

Modules of the registry's ``lint_exempt`` trees that no root reaches
are marked ``exempt`` rather than reported as dead.
"""
from __future__ import annotations

import ast
from pathlib import Path

PACKAGE = "repro_torch"

#: library modules whose entry points are roots
ENTRY_MODULES = ("repro_torch.core.simulator", "repro_torch.core.ici_gating",
                 "repro_torch.trace_sweep", "repro_torch.analysis.__main__",
                 "repro_torch.analysis.sanitizer")


def _modname(path: Path, src: Path) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports(tree: ast.Module, cur_mod: str, known: set,
             is_pkg: bool = False) -> set:
    out = set()

    def add(name: str):
        # an import of a package also executes its __init__; an
        # imported symbol may itself be a submodule
        if name in known:
            out.add(name)
        parts = name.split(".")
        for i in range(1, len(parts)):
            pkg = ".".join(parts[:i])
            if pkg in known:
                out.add(pkg)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == PACKAGE:
                    add(a.name)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = cur_mod.split(".")
                up = node.level - 1 if is_pkg else node.level
                parent = parent[:len(parent) - up]
                base = ".".join(parent + ([base] if base else []))
            if base.split(".")[0] != PACKAGE:
                continue
            add(base)
            for a in node.names:
                add(f"{base}.{a.name}")
    return out


def _has_main(tree: ast.Module) -> bool:
    return any(isinstance(n, ast.If) and "__main__" in ast.dump(n.test)
               for n in tree.body)


def dead_code_report(root: Path, exempt_trees: list) -> dict:
    src = root / "src"
    files = {}
    for p in sorted((src / PACKAGE).rglob("*.py")):
        files[_modname(p, src)] = p
    known = set(files)

    edges, trees = {}, {}
    for mod, p in files.items():
        try:
            trees[mod] = ast.parse(p.read_text())
        except SyntaxError:
            edges[mod] = set()
            continue
        edges[mod] = _imports(trees[mod], mod, known,
                              p.name == "__init__.py")

    roots = set(ENTRY_MODULES)
    roots |= {m for m, t in trees.items()
              if m.startswith(f"{PACKAGE}.launch.") and _has_main(t)}
    scripts = sorted(root.glob("examples/torch_*.py"))
    if (root / "chip_smoke.py").is_file():
        scripts.append(root / "chip_smoke.py")
    script_files = []
    for p in scripts:
        script_files.append(p.relative_to(root).as_posix())
        try:
            roots |= _imports(ast.parse(p.read_text()), "", known)
        except SyntaxError:
            continue
    roots &= known

    reachable = set()
    work = sorted(roots)
    while work:
        m = work.pop()
        if m in reachable:
            continue
        reachable.add(m)
        work.extend(edges.get(m, ()))

    def relpath(mod):
        return files[mod].relative_to(root).as_posix()

    def is_exempt(mod):
        rp = relpath(mod)
        return any(rp.startswith(e.rstrip("/") + "/") or rp == e
                   for e in exempt_trees)

    unreachable = []
    loc_dead = 0
    for mod in sorted(known - reachable):
        loc = len(files[mod].read_text().splitlines())
        loc_dead += loc
        unreachable.append({"module": mod, "path": relpath(mod),
                            "loc": loc, "exempt": is_exempt(mod)})
    exempt_but_reachable = sorted(
        mod for mod in reachable if is_exempt(mod))

    return {
        "roots": sorted(roots),
        "entry_scripts": script_files,
        "reachable": {m: relpath(m) for m in sorted(reachable)},
        "unreachable": unreachable,
        "exempt_but_reachable": exempt_but_reachable,
        "summary": {
            "n_modules": len(known),
            "n_reachable": len(reachable),
            "n_unreachable": len(unreachable),
            "loc_unreachable": loc_dead,
        },
    }
