"""Non-taint checkers: RL003 (host syncs in hot modules), RL005 (PRNG
key discipline), RL006 (dtype discipline).

RL003 has two halves. The taint engine (taint.py) catches transfers of
*tensor* values inside the traced tick; this module catches the
host-side half: ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
``.to("cpu")`` and ``synchronize()`` (``torch.cuda.synchronize``,
``Stream.synchronize``, ``Event.synchronize``) anywhere in a hot-loop
module outside the blessed fetch points declared in compile_sites.toml.
The blessed points are the contract: the fetches HOST_TRANSFER_COUNT
counts and the waits that go with them; at run time they are the
places the simulator lifts the sync sanitizer (sanitizer.py).

RL005 walks every function linearly, tracking PRNG-key names: a name
assigned from ``core.prng.key/split/fold_in`` is *fresh*; a sampling
call (``prng.uniform``, ``normal``, ``random_bits``, ``hash_counters``,
``hash_counters64``) consumes it; a second sampling call on a consumed
name without re-derivation is the finding. Passing a key into an
opaque call marks it consumed (the callee may sample) but is not itself
a finding. Loop bodies run twice so a key consumed across iterations is
caught.

RL006 flags float64 in the bit-exact modules (kernels, gating):
``torch.float64`` / ``torch.double`` / ``np.float64`` attributes,
``.double()``, ``dtype="float64"`` / ``dtype=float`` and
``.astype("float64")``. The port's x64 mode is a dtype argument, not a
process-wide switch, so the float64 a mode needs lives in named
functions, each a ``[[dtype_exempt]]`` of the registry with its reason
(never the whole module); anything else there would make an x32 result
depend on float64 arithmetic.
"""
from __future__ import annotations

import ast
import re

from .astutil import ModuleIndex, dotted_name, resolves_to
from .findings import Finding

#: parameter names treated as PRNG keys on function entry (a key that
#: *arrives* as an argument is fresh; reuse inside the body is still
#: reuse even though the derivation happened in the caller)
_KEYISH = re.compile(r"(^|_)(key|keys|rng|prng)(_|$)", re.IGNORECASE)

_PRNG = "repro_torch.core.prng"
_SAMPLER_DOTTED = tuple(f"{_PRNG}.{s}" for s in (
    "uniform", "normal", "random_bits", "hash_counters",
    "hash_counters64"))
_DERIVER_DOTTED = tuple(f"{_PRNG}.{d}" for d in ("split", "fold_in",
                                                  "key"))

_F64_ATTRS = ("torch.float64", "torch.double", "torch.complex128",
              "torch.cdouble", "numpy.float64", "numpy.double",
              "numpy.longdouble", "numpy.complex128")
_F64_STRINGS = {"float64", "f8", "double", "complex128"}

#: tensor methods that copy to the host or wait for the device
_SYNC_METHODS = {
    "item": ".item() copies a scalar to the host and waits for it",
    "cpu": ".cpu() copies to the host and waits for it",
    "tolist": ".tolist() copies to the host and waits for it",
    "numpy": ".numpy() hands a host array out of a tensor",
    "synchronize": "synchronize() blocks the host on the device",
}


def _is_cpu_target(node) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as a ``.to`` target."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and dotted_name(node.func)
            in ("torch.device", "device") and node.args
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def _covers(mi: ModuleIndex, node, qualnames: set) -> bool:
    """Whether ``node`` lies in one of ``qualnames`` (or a function
    nested in one); ``<module>`` covers module-level statements."""
    inside_any = False
    for fi in mi.funcs.values():
        fn = fi.node
        if (fn.lineno <= node.lineno
                <= getattr(fn, "end_lineno", fn.lineno)):
            inside_any = True
            q = fi.qualname
            if q in qualnames or any(q.startswith(b + ".")
                                     for b in qualnames):
                return True
    return not inside_any and "<module>" in qualnames


# ---------------------------------------------------------------------------
# RL003 - host syncs in hot modules
# ---------------------------------------------------------------------------

def check_host_transfers(mi: ModuleIndex, blessed: set) -> list:
    """Host syncs outside blessed qualnames. ``blessed`` is a set of
    function qualnames for this file (a finding inside a blessed
    function, or nested under one, is the declared fetch point)."""
    out = []
    for node in ast.walk(mi.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        what = _SYNC_METHODS.get(attr)
        if what is None and attr == "to" and (
                any(_is_cpu_target(a) for a in node.args[:1])
                or any(kw.arg == "device" and _is_cpu_target(kw.value)
                       for kw in node.keywords)):
            what = '.to("cpu") copies to the host and waits for it'
        if what is None or _covers(mi, node, blessed):
            continue
        out.append(Finding(
            "RL003", mi.path, node.lineno,
            f"{what}: a hot-loop module syncs outside the blessed "
            "fetch points (declare it in compile_sites.toml "
            "[[blessed_transfer]] or move it out of the loop)"))
    return out


# ---------------------------------------------------------------------------
# RL005 - PRNG key discipline
# ---------------------------------------------------------------------------

class _KeyWalk:
    def __init__(self, mi: ModuleIndex, path: str):
        self.mi = mi
        self.path = path
        self.state: dict = {}        # name -> "fresh" | "consumed"
        self.findings: list = []

    def _is(self, call: ast.Call, dotted: tuple) -> bool:
        return resolves_to(self.mi, call.func, *dotted)

    def _key_args(self, call: ast.Call):
        names = []
        for a in list(call.args) + [kw.value for kw in call.keywords]:
            if isinstance(a, ast.Name) and a.id in self.state:
                names.append(a.id)
        return names

    # -- expression scan (in evaluation-ish order) -----------------------
    def expr(self, e):
        if e is None:
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr) and not isinstance(
                    e, ast.Call):
                self.expr(child)
        if isinstance(e, ast.Call):
            for a in e.args:
                self.expr(a)
            for kw in e.keywords:
                self.expr(kw.value)
            if self._is(e, _SAMPLER_DOTTED):
                keys = self._key_args(e)
                for k in keys[:1]:   # first key-typed arg is the key
                    if self.state.get(k) == "consumed":
                        self.findings.append(Finding(
                            "RL005", self.path, e.lineno,
                            f"PRNG key {k!r} feeds a second sampling "
                            "call without an intervening split/"
                            "fold_in"))
                    else:
                        self.state[k] = "consumed"
            elif self._is(e, _DERIVER_DOTTED):
                pass                  # derivation: does not consume
            else:
                # opaque call: assume the callee may sample the key
                for k in self._key_args(e):
                    self.state[k] = "consumed"

    # -- statements ------------------------------------------------------
    def bind_fresh(self, target):
        if isinstance(target, ast.Name):
            self.state[target.id] = "fresh"
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind_fresh(t)
        elif isinstance(target, ast.Starred):
            self.bind_fresh(target.value)

    def bind_clear(self, target):
        if isinstance(target, ast.Name):
            self.state.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self.bind_clear(t)
        elif isinstance(target, ast.Starred):
            self.bind_clear(target.value)

    def stmts(self, body):
        for s in body:
            self.stmt(s)

    def stmt(self, s):
        if isinstance(s, (ast.Assign, ast.AnnAssign)):
            v = s.value
            self.expr(v)
            targets = s.targets if isinstance(s, ast.Assign) else \
                [s.target]
            derive = isinstance(v, ast.Call) and \
                self._is(v, _DERIVER_DOTTED)
            alias = isinstance(v, ast.Name) and v.id in self.state
            for t in targets:
                if derive:
                    self.bind_fresh(t)
                elif alias and isinstance(t, ast.Name):
                    self.state[t.id] = self.state[v.id]
                else:
                    self.bind_clear(t)
        elif isinstance(s, ast.AugAssign):
            self.expr(s.value)
            self.bind_clear(s.target)
        elif isinstance(s, ast.If):
            self.expr(s.test)
            before = dict(self.state)
            self.stmts(s.body)
            after_body = self.state
            self.state = dict(before)
            self.stmts(s.orelse)
            merged = {}
            for k in set(after_body) | set(self.state):
                a, b = after_body.get(k), self.state.get(k)
                merged[k] = "consumed" if "consumed" in (a, b) else \
                    (a or b)
            self.state = merged
        elif isinstance(s, (ast.For, ast.While)):
            if isinstance(s, ast.For):
                self.expr(s.iter)
                self.bind_clear(s.target)
            else:
                self.expr(s.test)
            # run the body twice: a key consumed on iteration 1 and
            # sampled again on iteration 2 is the classic reuse bug
            self.stmts(s.body)
            self.stmts(s.body)
            self.stmts(s.orelse)
        elif isinstance(s, ast.Return):
            self.expr(s.value)
        elif isinstance(s, ast.Expr):
            self.expr(s.value)
        elif isinstance(s, ast.With):
            for item in s.items:
                self.expr(item.context_expr)
            self.stmts(s.body)
        elif isinstance(s, ast.Try):
            self.stmts(s.body)
            for h in s.handlers:
                self.stmts(h.body)
            self.stmts(s.orelse)
            self.stmts(s.finalbody)
        # nested defs and classes are walked as functions of their own


def check_prng(mi: ModuleIndex) -> list:
    out = []
    seen = set()
    for fi in mi.funcs.values():
        node = fi.node
        if isinstance(node, ast.Lambda):
            continue
        w = _KeyWalk(mi, mi.path)
        for p in fi.params:
            if _KEYISH.search(p):
                w.state[p] = "fresh"
        w.stmts(node.body)
        for f in w.findings:
            k = (f.rule, f.line, f.message)
            if k not in seen:
                seen.add(k)
                out.append(f)
    return out


# ---------------------------------------------------------------------------
# RL006 - dtype discipline in bit-exact modules
# ---------------------------------------------------------------------------

def check_dtypes(mi: ModuleIndex, exempt: set = frozenset()) -> list:
    """float64 in a bit-exact module outside the ``exempt`` qualnames
    (the registry's ``[[dtype_exempt]]`` functions of this file)."""
    out = []

    def hit(node, msg):
        if not _covers(mi, node, exempt):
            out.append(Finding("RL006", mi.path, node.lineno,
                               f"{msg} in a bit-exact module: an x32 "
                               "result must not depend on float64"))

    for node in ast.walk(mi.tree):
        if isinstance(node, ast.Attribute) and resolves_to(
                mi, node, *_F64_ATTRS):
            hit(node, dotted_name(node))
        elif isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg != "dtype":
                    continue
                v = kw.value
                if isinstance(v, ast.Constant) and v.value in \
                        _F64_STRINGS:
                    hit(node, f'dtype="{v.value}"')
                elif isinstance(v, ast.Name) and v.id == "float":
                    hit(node, "dtype=float (float64)")
            if isinstance(node.func, ast.Attribute):
                if node.func.attr == "double" and not node.args:
                    hit(node, ".double()")
                elif node.func.attr == "astype" and node.args:
                    a = node.args[0]
                    if isinstance(a, ast.Constant) and a.value in \
                            _F64_STRINGS:
                        hit(node, f'.astype("{a.value}")')
    out.sort(key=lambda f: f.line)
    return out
