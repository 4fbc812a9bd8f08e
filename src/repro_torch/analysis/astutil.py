"""AST indexing for the port's contract linter: modules, functions,
imports, and cross-module call resolution (the port's own copy of the
reference's ``analysis/astutil.py``).

The linter works on a closed set of files (the lint scope). Each file
becomes a :class:`ModuleIndex` — its parsed tree, every function
definition (top-level, nested, lambdas get synthetic names) with a
dotted qualname, and the module's import aliases — and
:class:`Project` stitches them into one symbol table so a call like
``ops.switch_tiers(...)`` in ``core/simulator.py`` resolves to the
``switch_tiers`` function object in ``kernels/ops.py``.

Resolution is deliberately name-based and approximate: a miss means a
checker under-reports, never crashes. That is the right tradeoff for a
lint pass — the runtime sanitizers (analysis/sanitizer.py) backstop
what static resolution cannot see.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FuncInfo:
    module: "ModuleIndex"
    qualname: str
    node: ast.AST                   # FunctionDef / Lambda
    parent: "FuncInfo | None" = None
    children: dict = field(default_factory=dict)   # name -> FuncInfo

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def params(self) -> list[str]:
        a = self.node.args
        names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
        if a.vararg:
            names.append(a.vararg.arg)
        if a.kwarg:
            names.append(a.kwarg.arg)
        return names

    def key(self) -> tuple:
        return (self.module.modname, self.qualname)


@dataclass
class ModuleIndex:
    path: str                       # repo-relative, posix
    modname: str                    # e.g. "repro_torch.core.simulator"
    tree: ast.Module
    source: str
    funcs: dict = field(default_factory=dict)       # qualname -> FuncInfo
    top_level: dict = field(default_factory=dict)   # name -> FuncInfo
    imports: dict = field(default_factory=dict)     # alias -> module path
    from_imports: dict = field(default_factory=dict)  # name -> "mod.name"

    def func_of_node(self, fnode: ast.AST) -> "FuncInfo | None":
        for fi in self.funcs.values():
            if fi.node is fnode:
                return fi
        return None


def _module_name(path: Path, root: Path) -> str:
    rel = path.relative_to(root)
    parts = list(rel.with_suffix("").parts)
    if parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def index_module(path: Path, root: Path, source: str | None = None
                 ) -> ModuleIndex:
    src = path.read_text() if source is None else source
    tree = ast.parse(src, filename=str(path))
    mi = ModuleIndex(path=path.relative_to(root).as_posix(),
                     modname=_module_name(path, root), tree=tree,
                     source=src)

    lambda_n = [0]

    def visit(node, parent: FuncInfo | None, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}" if prefix else child.name
                fi = FuncInfo(mi, q, child, parent)
                mi.funcs[q] = fi
                if parent is None:
                    mi.top_level[child.name] = fi
                else:
                    parent.children[child.name] = fi
                visit(child, fi, q + ".")
            elif isinstance(child, ast.Lambda):
                lambda_n[0] += 1
                q = f"{prefix}<lambda#{lambda_n[0]}>"
                fi = FuncInfo(mi, q, child, parent)
                mi.funcs[q] = fi
                if parent is not None:
                    parent.children.setdefault(q.rsplit('.', 1)[-1], fi)
                visit(child, fi, q + ".")
            elif isinstance(child, ast.ClassDef):
                # methods get Class.name qualnames; no nesting support
                # needed beyond that for this codebase
                visit(child, parent, (prefix + child.name + "."))
            else:
                visit(child, parent, prefix)

    visit(tree, None, "")

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                mi.imports[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mi.from_imports[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
    return mi


@dataclass
class Project:
    root: Path
    modules: dict = field(default_factory=dict)   # modname -> ModuleIndex

    def add(self, mi: ModuleIndex):
        self.modules[mi.modname] = mi

    def by_path(self, relpath: str) -> ModuleIndex | None:
        for mi in self.modules.values():
            if mi.path == relpath:
                return mi
        return None

    # ---- call resolution -------------------------------------------------
    def resolve_call(self, call_func: ast.AST, scope: FuncInfo | None,
                     mi: ModuleIndex) -> FuncInfo | None:
        """Resolve a call's func expression to a FuncInfo in scope.

        Handles: bare names (lexical scope chain, then module top
        level, then from-imports), ``alias.attr`` where ``alias`` is an
        imported module in the project, and ``from x import f`` names.
        """
        if isinstance(call_func, ast.Name):
            name = call_func.id
            f = scope
            while f is not None:
                if name in f.children:
                    return f.children[name]
                f = f.parent
            if name in mi.top_level:
                return mi.top_level[name]
            target = mi.from_imports.get(name)
            if target:
                modname, _, fname = target.rpartition(".")
                other = self.modules.get(modname)
                if other:
                    return other.top_level.get(fname)
            return None
        dn = dotted_name(call_func)
        if dn and "." in dn:
            base, _, attr = dn.rpartition(".")
            # alias.attr -> imported module's top-level function.
            # ``from repro_torch.core import gating`` lands in
            # from_imports with value "repro_torch.core.gating" (module,
            # not symbol).
            target_mod = mi.imports.get(base) or mi.from_imports.get(base)
            if target_mod and target_mod in self.modules:
                return self.modules[target_mod].top_level.get(attr)
        return None


def load_project(root: Path, paths: list[Path]) -> Project:
    proj = Project(root=root)
    for p in paths:
        proj.add(index_module(p, root))
    return proj


def resolves_to(mi: ModuleIndex, node: ast.AST, *dotted: str) -> bool:
    """True if ``node`` is a reference to any of the given fully-dotted
    names, honouring the module's import aliases (``np.float64``
    matches ``numpy.float64`` when np aliases numpy), and a bare name
    of a function the module defines itself (``uniform`` inside
    ``core/prng.py`` is ``repro_torch.core.prng.uniform``)."""
    dn = dotted_name(node)
    if dn is None:
        return False
    for want in dotted:
        if dn == want:
            return True
        if dn in mi.top_level and f"{mi.modname}.{dn}" == want:
            return True
        head, _, rest = dn.partition(".")
        real = mi.imports.get(head)
        if real and rest and f"{real}.{rest}" == want:
            return True
        frm = mi.from_imports.get(head)
        if frm:
            cand = f"{frm}.{rest}" if rest else frm
            if cand == want:
                return True
    return False
