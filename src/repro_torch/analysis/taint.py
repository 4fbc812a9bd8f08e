"""Tensor-value taint analysis for RL001/RL003.

The port's traced code is the tick a CUDA graph captures: a host sync
in it (a Python branch on a tensor, ``.item()``) is exactly what the
capture refuses on the card, and on the CPU or with ``graph=False`` it
is a stall every tick. This pass finds it on the CPU first, from the
source.

Roots:

* every function called inside a ``with torch.cuda.graph(...):`` body
  (the capture), and every function handed to ``torch.compile``,
  ``torch.jit.script``/``trace``, ``torch.vmap``/``torch.func.vmap``
  or ``torch.cuda.make_graphed_callables`` (as a decorator or a
  callsite argument, possibly wrapped in ``functools.partial``);
* the registry's ``[[traced_root]]`` entries: the functions a capture
  reaches through a parameter, which no static resolution follows
  (``simulator.step_into`` and the step ``make_sim_step`` returns,
  ``ici_gating._reactive_program``'s tick, ``ops.switch_tiers``).

Every parameter of a root is a tensor value (tainted) except the ones
an entry names ``static`` and the ones ``functools.partial`` binds.
Closure constants of a factory are not parameters, so they stay clean.

Propagation is interprocedural to a fixpoint: when a traced function
passes a tainted value into another function the linter can resolve,
that callee joins the traced-reachable set with those parameters
tainted (a ``*args`` argument taints every parameter from its position
on). Taint sets only grow, so the worklist terminates.

Untaint rules (the false-positive killers, each load-bearing for the
shipped tree):

* ``x is None`` / ``x is not None`` comparisons are static;
* ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device`` / ``.is_cuda`` /
  ``.layout`` reads and ``.numel()`` / ``.dim()`` / ``.size()`` /
  ``.stride()`` / ``.element_size()`` / ``.data_ptr()`` /
  ``.is_contiguous()`` calls are metadata, known without the device;
* ``len()``, ``isinstance()``, ``type()``, ``range()`` results are
  static, and so is the result of a project function every ``return``
  of which is static whatever its arguments (``lcdc_switch._float_type``
  returns a tensor's ``.dtype``).

Within traced-reachable functions the engine emits:

* RL001 for ``if``/``while``/``assert``/ternary tests on tainted
  values and for ``float()/int()/bool()/complex()`` or
  ``.item()/.tolist()`` coercions of tainted values;
* RL003 for ``np.asarray``/``np.array``, ``.cpu()``/``.numpy()`` over
  tainted values and for ``for``-loops over a tensor a ``torch``
  function made from tainted values (each element a device read the
  host waits for, once it is used).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .astutil import (FuncInfo, ModuleIndex, Project, dotted_name,
                      resolves_to)
from .findings import Finding

_ONE_FN = {  # transform dotted name -> positions of function-valued args
    "torch.compile": (0,), "torch.jit.script": (0,),
    "torch.jit.trace": (0,), "torch.vmap": (0,), "torch.func.vmap": (0,),
    "torch.cuda.make_graphed_callables": (0,),
}
_CAPTURE = ("torch.cuda.graph",)
_STATIC_META = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "is_meta", "requires_grad"}
_STATIC_METHODS = {"numel", "dim", "size", "stride", "element_size",
                   "data_ptr", "is_contiguous", "is_floating_point",
                   "get_device", "storage_offset", "nelement"}
_STATIC_CALLS = {"len", "isinstance", "type", "range", "hasattr",
                 "enumerate", "zip", "sorted", "list", "tuple", "dict",
                 "set", "min", "max", "getattr", "id", "callable"}
# min/max/list/... of a tainted value IS tainted-ish, but branch-on-it
# is what RL001 cares about and those appear over static shape math in
# this tree; keep them static except the true coercions below
_COERCE_CALLS = {"float", "int", "bool", "complex"}
_COERCE_METHODS = {"item", "tolist"}
_HOST_METHODS = {"cpu", "numpy"}


@dataclass
class TaintResult:
    findings: list = field(default_factory=list)
    #: (modname, qualname) -> set of tainted parameter names
    traced: dict = field(default_factory=dict)


def _own_returns(fnode):
    """Return statements of a def, skipping nested function bodies."""
    out = []

    def scan(body):
        for s in body:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                continue
            if isinstance(s, ast.Return):
                out.append(s)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(s, attr, None)
                if isinstance(sub, list):
                    scan(sub)
            for h in getattr(s, "handlers", []):
                scan(h.body)

    scan(fnode.body)
    return out


def _func_from_expr(expr, scope, mi: ModuleIndex, proj: Project,
                    depth: int = 0):
    """Resolve a function-valued expression to (FuncInfo, static_params).

    Peels ``functools.partial`` (bound kwargs and leading positionals
    become static params) and nested transform wrappers like
    ``torch.compile(partial(f, ...))``; follows local aliases
    (``step = make_sim_step(hull)``) and closure factories (a project
    function whose return value is one of its own nested defs).
    """
    if depth > 8:
        return None, set()
    if isinstance(expr, ast.Lambda):
        return mi.func_of_node(expr), set()
    if isinstance(expr, (ast.Name, ast.Attribute)):
        fi = proj.resolve_call(expr, scope, mi)
        if fi is not None:
            return fi, set()
        if isinstance(expr, ast.Name):
            f = scope
            while f is not None:
                for node in ast.walk(f.node):
                    if (isinstance(node, ast.Assign)
                            and len(node.targets) == 1
                            and isinstance(node.targets[0], ast.Name)
                            and node.targets[0].id == expr.id):
                        got, st = _func_from_expr(node.value, f, mi,
                                                  proj, depth + 1)
                        if got is not None:
                            return got, st
                f = f.parent
        return None, set()
    if isinstance(expr, ast.Call):
        if resolves_to(mi, expr.func, "functools.partial") and expr.args:
            fi, statics = _func_from_expr(expr.args[0], scope, mi, proj,
                                          depth + 1)
            if fi is not None:
                statics = set(statics)
                statics |= {kw.arg for kw in expr.keywords if kw.arg}
                n_pos = len(expr.args) - 1
                statics |= set(fi.params[:n_pos])
            return fi, statics
        if any(resolves_to(mi, expr.func, t) for t in _ONE_FN
               ) and expr.args:
            return _func_from_expr(expr.args[0], scope, mi, proj,
                                   depth + 1)
        # closure factory: f() returning one of f's own nested defs
        target = proj.resolve_call(expr.func, scope, mi)
        if target is not None and isinstance(
                target.node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for ret in _own_returns(target.node):
                if (isinstance(ret.value, ast.Name)
                        and ret.value.id in target.children):
                    return target.children[ret.value.id], set()
    return None, set()


def _transform_target(mi, call: ast.Call):
    """Dotted transform name if this call is a transform we root."""
    for t in _ONE_FN:
        if resolves_to(mi, call.func, t):
            return t
    return None


def _enclosing(mi: ModuleIndex, node) -> FuncInfo | None:
    """Innermost FuncInfo whose node contains ``node`` (by position)."""
    best = None
    for fi in mi.funcs.values():
        fn = fi.node
        if (fn.lineno <= node.lineno <= getattr(fn, "end_lineno",
                                                fn.lineno)):
            if best is None or fn.lineno >= best.node.lineno:
                best = fi
    return best


def discover_roots(proj: Project, declared=()):
    """Yield (FuncInfo, tainted_param_names) for every traced root:
    transform decorators and arguments, the calls inside a
    ``torch.cuda.graph`` capture, and the ``declared`` entries
    (``{"file", "qualname", "static"}`` dicts)."""
    for mi in proj.modules.values():
        # decorator roots
        for fi in mi.funcs.values():
            node = fi.node
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                d = dec.func if isinstance(dec, ast.Call) else dec
                if any(resolves_to(mi, d, t) for t in _ONE_FN):
                    yield fi, set(fi.params)
        for node in ast.walk(mi.tree):
            # callsite roots
            if isinstance(node, ast.Call):
                t = _transform_target(mi, node)
                if t is None:
                    continue
                scope = _enclosing(mi, node)
                for pos in _ONE_FN[t]:
                    if pos >= len(node.args):
                        continue
                    fi, pstat = _func_from_expr(node.args[pos], scope,
                                                mi, proj)
                    if fi is not None:
                        yield fi, set(fi.params) - pstat
            # capture roots: what a `with torch.cuda.graph(...)` calls
            elif isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and resolves_to(mi, it.context_expr.func, *_CAPTURE)
                    for it in node.items):
                scope = _enclosing(mi, node)
                for s in node.body:
                    for call in ast.walk(s):
                        if not isinstance(call, ast.Call):
                            continue
                        fi, pstat = _func_from_expr(call.func, scope, mi,
                                                    proj)
                        if fi is not None:
                            yield fi, set(fi.params) - pstat
    for e in declared:
        mi = proj.by_path(e.get("file", ""))
        if mi is None:
            continue
        fi = mi.funcs.get(e.get("qualname", ""))
        if fi is not None:
            yield fi, set(fi.params) - set(e.get("static", []))


class _Engine:
    """One pass of the per-function taint walk (RL001/RL003-traced)."""

    def __init__(self, fi: FuncInfo, tainted: set, proj: Project,
                 on_call, emit, static_returns: dict):
        self.fi = fi
        self.mi = fi.module
        self.tainted = set(tainted)
        self.proj = proj
        self.on_call = on_call
        self.emit = emit
        self.static_returns = static_returns

    def returns_static(self, fi: FuncInfo) -> bool:
        """Whether every ``return`` of ``fi`` is untainted with all its
        parameters tainted (memoized; a function being evaluated counts
        as tainted, so recursion ends)."""
        key = fi.key()
        if key not in self.static_returns:
            self.static_returns[key] = False
            node = fi.node
            eng = _Engine(fi, set(fi.params), self.proj,
                          lambda *_: None, lambda *_: None,
                          self.static_returns)
            if isinstance(node, ast.Lambda):
                static = not eng.tval(node.body)
            else:
                eng.stmts(node.body)
                rets = _own_returns(node)
                static = bool(rets) and not any(eng.tval(r.value)
                                                for r in rets)
            self.static_returns[key] = static
        return self.static_returns[key]

    # ---- expression taint ----------------------------------------------
    def tval(self, e) -> bool:
        if e is None or isinstance(e, ast.Constant):
            return False
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_META:
                self.tval(e.value)
                return False
            return self.tval(e.value)
        if isinstance(e, ast.Subscript):
            return self.tval(e.value) | self.tval(e.slice)
        if isinstance(e, ast.Compare):
            operand_taint = self.tval(e.left) | any(
                self.tval(c) for c in e.comparators)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in e.ops):
                return False          # None-ness is static
            return operand_taint
        if isinstance(e, ast.BoolOp):
            return any(self.tval(v) for v in e.values)
        if isinstance(e, ast.BinOp):
            return self.tval(e.left) | self.tval(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.tval(e.operand)
        if isinstance(e, ast.IfExp):
            if self.tval(e.test):
                self.emit("RL001", e.lineno,
                          "ternary condition on a tensor value in "
                          f"traced function {self.fi.qualname}")
            return self.tval(e.body) | self.tval(e.orelse)
        if isinstance(e, (ast.Tuple, ast.List, ast.Set)):
            return any(self.tval(x) for x in e.elts)
        if isinstance(e, ast.Dict):
            return any(self.tval(k) for k in e.keys if k is not None) | \
                any(self.tval(v) for v in e.values)
        if isinstance(e, ast.Starred):
            return self.tval(e.value)
        if isinstance(e, ast.JoinedStr):
            return any(self.tval(v) for v in e.values)
        if isinstance(e, ast.FormattedValue):
            return self.tval(e.value)
        if isinstance(e, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                          ast.DictComp)):
            t = False
            for gen in e.generators:
                it = self.tval(gen.iter)
                t |= it
                self.bind(gen.target, it)
                for cond in gen.ifs:
                    if self.tval(cond):
                        self.emit("RL001", cond.lineno,
                                  "comprehension filter on a tensor "
                                  "value in traced function "
                                  f"{self.fi.qualname}")
            if isinstance(e, ast.DictComp):
                t |= self.tval(e.key) | self.tval(e.value)
            else:
                t |= self.tval(e.elt)
            return t
        if isinstance(e, ast.Call):
            return self.call(e)
        if isinstance(e, ast.Lambda):
            return False
        if isinstance(e, ast.NamedExpr):
            t = self.tval(e.value)
            self.bind(e.target, t)
            return t
        # conservative default: tainted if any child expression is
        return any(self.tval(c) for c in ast.iter_child_nodes(e)
                   if isinstance(c, ast.expr))

    # ---- calls ----------------------------------------------------------
    def call(self, e: ast.Call) -> bool:
        arg_taints = [self.tval(a) for a in e.args]
        kw_taints = {kw.arg: self.tval(kw.value) for kw in e.keywords}
        any_taint = any(arg_taints) or any(kw_taints.values())

        fname = e.func.id if isinstance(e.func, ast.Name) else None
        if fname in _STATIC_CALLS:
            return False
        if fname in _COERCE_CALLS and any_taint:
            self.emit("RL001", e.lineno,
                      f"{fname}() coerces a tensor value to host "
                      f"Python in traced function {self.fi.qualname}")
            return False
        if isinstance(e.func, ast.Attribute):
            attr = e.func.attr
            if attr in _STATIC_METHODS:
                self.tval(e.func.value)
                return False
            if attr in _COERCE_METHODS and self.tval(e.func.value):
                self.emit("RL001", e.lineno,
                          f".{attr}() pulls a tensor value to the host "
                          f"in traced function {self.fi.qualname}")
                return False
            if attr in _HOST_METHODS and self.tval(e.func.value):
                self.emit("RL003", e.lineno,
                          f".{attr}() copies a tensor value to the host "
                          f"inside traced function {self.fi.qualname}")
                return False
            if attr in ("asarray", "array") and resolves_to(
                    self.mi, e.func, "numpy.asarray", "numpy.array"):
                if any_taint:
                    self.emit("RL003", e.lineno,
                              "np." + attr + " on a tensor value forces "
                              "a device->host transfer inside traced "
                              f"function {self.fi.qualname}")
                return any_taint
            any_taint |= self.tval(e.func.value)

        # interprocedural propagation into resolvable project callees
        # (including local aliases / closure-factory results)
        target, _ = _func_from_expr(e.func, self.fi, self.mi, self.proj)
        if target is not None and target.key() != self.fi.key():
            params = target.params
            hit = set()
            for i, (a, t) in enumerate(zip(e.args, arg_taints)):
                if not t:
                    continue
                if isinstance(a, ast.Starred):
                    hit |= set(params[i:])
                elif i < len(params):
                    hit.add(params[i])
            for k, t in kw_taints.items():
                if t and k in params:
                    hit.add(k)
                elif t and k is None:       # **kwargs
                    hit |= set(params[len(e.args):])
            if hit:
                self.on_call(target, hit)
            if self.returns_static(target):
                return False
        return any_taint

    # ---- statements -----------------------------------------------------
    def bind(self, target, tainted: bool):
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind(t, tainted)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, tainted)
        elif isinstance(target, (ast.Attribute, ast.Subscript)):
            self.tval(target.value)

    def stmts(self, body):
        for s in body:
            self.stmt(s)

    def stmt(self, s):
        if isinstance(s, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = s.value
            t = self.tval(value) if value is not None else False
            targets = s.targets if isinstance(s, ast.Assign) else \
                [s.target]
            if isinstance(s, ast.AugAssign):
                t = t or self.tval(s.target)
            for tgt in targets:
                self.bind(tgt, t)
        elif isinstance(s, ast.If):
            if self.tval(s.test):
                self.emit("RL001", s.test.lineno,
                          "if-statement on a tensor value in traced "
                          f"function {self.fi.qualname}")
            self.stmts(s.body)
            self.stmts(s.orelse)
        elif isinstance(s, ast.While):
            if self.tval(s.test):
                self.emit("RL001", s.test.lineno,
                          "while-loop on a tensor value in traced "
                          f"function {self.fi.qualname}")
            self.stmts(s.body)
            self.stmts(s.orelse)
        elif isinstance(s, ast.Assert):
            if self.tval(s.test):
                self.emit("RL001", s.lineno,
                          "assert on a tensor value in traced function "
                          f"{self.fi.qualname} (check it at a chunk "
                          "boundary, as validate=True does)")
        elif isinstance(s, ast.For):
            it = self.tval(s.iter)
            # a container of tensors (the state tuple, the accumulator
            # dict) iterates on the host; a tensor a torch function
            # made iterates element by element
            head = (dotted_name(s.iter.func) or "").split(".")[0] \
                if isinstance(s.iter, ast.Call) else ""
            if it and "torch" in (head, self.mi.imports.get(head)):
                self.emit("RL003", s.lineno,
                          "iterating a tensor value reads it element "
                          f"by element in traced function "
                          f"{self.fi.qualname}")
            self.bind(s.target, it)
            self.stmts(s.body)
            self.stmts(s.orelse)
        elif isinstance(s, ast.Return):
            self.tval(s.value)
        elif isinstance(s, ast.Expr):
            self.tval(s.value)
        elif isinstance(s, ast.With):
            for item in s.items:
                t = self.tval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, t)
            self.stmts(s.body)
        elif isinstance(s, ast.Try):
            self.stmts(s.body)
            for h in s.handlers:
                self.stmts(h.body)
            self.stmts(s.orelse)
            self.stmts(s.finalbody)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self.tval(s.exc)
        # nested defs are analyzed when rooted or called;
        # Pass/Break/Continue/Import/Global/Nonlocal/Delete: no taint

    def run(self):
        node = self.fi.node
        body = node.body if not isinstance(node, ast.Lambda) else None
        # two passes so names assigned late but used early (rare, but
        # loops reorder) settle; taint only grows within a run
        for _ in range(2):
            if body is None:
                self.tval(node.body)
            else:
                self.stmts(body)
        return self.tainted


def analyze(proj: Project, declared=()) -> TaintResult:
    res = TaintResult()
    seen_findings = set()
    state: dict = {}          # key -> set of tainted params
    processed: set = set()
    work: list = []
    static_returns: dict = {}

    def ensure(fi: FuncInfo, params: set):
        key = fi.key()
        cur = state.setdefault(key, set())
        grew = not params <= cur
        cur |= params
        if grew or key not in processed:
            if key not in [k for k, _ in work]:
                work.append((key, fi))

    for fi, params in discover_roots(proj, declared):
        ensure(fi, params)

    rounds = 0
    while work and rounds < 10_000:
        rounds += 1
        key, fi = work.pop(0)
        processed.add(key)

        def emit(rule, line, msg, _fi=fi):
            f = Finding(rule, _fi.module.path, line, msg)
            if (rule, f.path, line, msg) not in seen_findings:
                seen_findings.add((rule, f.path, line, msg))
                res.findings.append(f)

        eng = _Engine(fi, state[key], proj, ensure, emit, static_returns)
        eng.run()

    res.traced = {k: set(v) for k, v in state.items()}
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return res
