"""The dry run's accounting (counterpart of ``repro/launch/hlo_analysis.py``,
the reference's shim over ``repro/analysis/hlo.py``): the collective
statistics under the reference's names, its HLO text parser, and the
port's own counter of FLOPs and bytes.

The reference compiles a step and reads XLA's numbers off the compiled
module: ``cost_analysis()`` (``flops``, ``bytes accessed``), the
collectives parsed from the post-SPMD HLO text, ``memory_analysis()``.
PyTorch has no compile-without-run, so the port runs rank 0's step and
counts what it does:

* ``CostCounter``, a ``TorchDispatchMode``, sees every aten op of the
  step (forward, autograd's backward, a remat recompute) and counts
  FLOPs as XLA's ``HloCostAnalysis`` does: a matmul, batched matmul or
  convolution 2 x output elements x contracted size (kept apart as
  ``dot_flops`` too); an elementwise arithmetic op (a compare, a select
  and a dtype conversion among them) one per output element; a
  reduction one per input element; a scatter-add one per added element;
  exponentials, logarithms, square roots and the like go to
  ``transcendentals``, not to ``flops`` (XLA keeps them apart). A fused
  op counts the ops XLA would see (``silu`` = a logistic and a product;
  ``_softmax`` a max, a difference, an exp, a sum and a quotient). Data
  movement (views, copies, gathers, sorts, concatenations, factories)
  is 0 FLOPs. An op without a rule is listed in ``unknown``.
* ``bytes_accessed``: the operand bytes plus the result bytes of every
  op that is not a view (each tensor at its logical size, numel x
  element size). This is an eager, unfused count: XLA's
  ``bytes accessed`` of a fused module is smaller (an elementwise chain
  fused into one loop reads its inputs once); the ratio is reported,
  not tuned. A kernel operator below is one op: its inputs read once
  and its outputs written once (the wkv forward's saved states among
  them). Under the fake process group a collective's result is a
  ``new_zeros`` of its shape, counted as its written bytes.
* The hand kernels' calls are operators of their own
  (``torch.ops.repro_torch.attention``, ``attention_lse``,
  ``attention_bwd``, ``wkv``, ``wkv_ckpt``, ``wkv_bwd``, and the sweep
  tick's ``switch_tiers`` and ``switch_step``; see ``kernels.ops``), one
  op on every device, counted by name from ``KERNEL_COST`` whatever
  computes them (the kernel on the card, the plain version on the CPU,
  shapes on ``meta``), so a record does not depend on the device. The
  switch datapath is counted as what this counter counts of its plain
  version at the call's shapes (``kernels.ops.PLAIN``, run once a
  signature on ``meta`` copies of the arguments). Attention is counted over the whole T x S score
  matrix whether causal or not, as the reference's accounting pass
  computes it at one chunk (the wgmma kernel visits only the blocks a
  causal or windowed mask leaves, about half of a causal T x S, so it
  does less work than it is counted for); wkv by the reference's
  roofline formula, 10 B T H dh^2 a forward, twice that a backward.
* Collectives come from ``distributed.collectives.COLLECTIVE_LOG``, one
  record a call, turned by ``collective_stats`` into the reference's
  ``CollectiveStats`` (HLO op names, result bytes, group size and the
  ring-algorithm link bytes below).

The reference's ``parse_collectives`` is kept as a text parser of HLO
(``tests/test_torch_dryrun.py`` holds it on the reference's sample).
Link bytes from result bytes R over a group of g ranks:

    all-gather          R * (g-1)/g
    all-reduce          2 * R * (g-1)/g
    reduce-scatter      R * (g-1)             (operand = R*g)
    all-to-all          R * (g-1)/g
    collective-permute  R
"""
from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}

_COLL_RE = re.compile(
    r"=\s+(?:\([^)]*\)|(?P<dtype>\w+)\[(?P<shape>[\d,]*)\][^ ]*)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")
_TUPLE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _nbytes(dtype: str, shape: str) -> int:
    n = 1
    for s in shape.split(","):
        if s:
            n *= int(s)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclass
class CollectiveStats:
    ops: list = field(default_factory=list)   # (op, result_bytes, group, link_bytes)

    @property
    def total_result_bytes(self) -> float:
        return sum(o[1] for o in self.ops)

    @property
    def total_link_bytes(self) -> float:
        return sum(o[3] for o in self.ops)

    def by_op(self) -> dict:
        out: dict[str, dict] = {}
        for op, rb, g, lb in self.ops:
            d = out.setdefault(op, {"count": 0, "result_bytes": 0.0,
                                    "link_bytes": 0.0})
            d["count"] += 1
            d["result_bytes"] += rb
            d["link_bytes"] += lb
        return out


def _link_bytes(op: str, result_bytes: float, g: int) -> float:
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if op == "all-gather":
        return result_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return result_bytes * (g - 1)
    if op == "all-to-all":
        return result_bytes * (g - 1) / g
    return float(result_bytes)            # collective-permute


def parse_collectives(hlo_text: str) -> CollectiveStats:
    """The collectives of a compiled HLO module's text (the reference's
    parser)."""
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        op = m.group("op")
        if "-done(" in line:
            continue                       # avoid double-count of async pairs
        if m.group("dtype"):
            rb = _nbytes(m.group("dtype"), m.group("shape"))
        else:
            # tuple result: sum the element sizes inside (...)
            head = line.split("=", 1)[1].split(op)[0]
            rb = sum(_nbytes(d, s) for d, s in _TUPLE_RE.findall(head))
        gm = _GROUPS_RE.search(line)
        g = int(gm.group(2)) if gm else 1
        stats.ops.append((op, float(rb), g, _link_bytes(op, float(rb), g)))
    return stats


#: the port's collective -> the HLO op XLA emits for it
HLO_OP = {"psum": "all-reduce", "pmax": "all-reduce",
          "all_gather": "all-gather", "psum_scatter": "reduce-scatter",
          "ppermute": "collective-permute", "all_to_all": "all-to-all"}


def collective_stats(log, sizes=None) -> CollectiveStats:
    """``CollectiveStats`` of the port's per-rank records (``distributed
    .collectives.COLLECTIVE_LOG``: (op, axis, result bytes, group size)
    a call) under the HLO op names. With ``sizes`` ({axis: size}) each
    record's group size is checked against its axes'."""
    stats = CollectiveStats()
    for op, axis, rb, g in log:
        if sizes is not None:
            n = 1
            for a in axis.split("+"):
                n *= sizes[a]
            if n != g:
                raise ValueError(f"{op} over {axis}: group of {g} ranks, "
                                 f"the mesh says {n}")
        name = HLO_OP[op]
        stats.ops.append((name, float(rb), g, _link_bytes(name, float(rb), g)))
    return stats


MEMORY_KEYS = ("generated_code_size_in_bytes", "argument_size_in_bytes",
               "output_size_in_bytes", "alias_size_in_bytes",
               "temp_size_in_bytes")


def memory_stats(counts: dict) -> dict:
    """The reference's ``memory`` keys from the port's per-device
    measurement (``counts``: any of ``MEMORY_KEYS``); there is no
    generated code (0), and a temp size not measured (the ``meta``
    device) stays None."""
    out = {}
    for k in MEMORY_KEYS:
        v = counts.get(k, 0)
        out[k] = None if v is None else int(v)
    return out


def cost_stats(counts: dict) -> dict:
    """The reference's ``cost`` keys from the port's count
    (``CostCounter.counts()``)."""
    return {"flops": float(counts["flops"]),
            "bytes_accessed": float(counts["bytes_accessed"])}


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot", "addmv",
        "_scaled_mm", "convolution"}
#: FLOPs an output element
_ELEMENTWISE = {
    "add": 1, "sub": 1, "rsub": 1, "mul": 1, "div": 1, "neg": 1, "abs": 1,
    "maximum": 1, "minimum": 1, "clamp": 1, "clamp_min": 1, "clamp_max": 1,
    "where": 1, "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,
    "logical_and": 1, "logical_or": 1, "logical_not": 1, "logical_xor": 1,
    "bitwise_and": 1, "bitwise_or": 1, "bitwise_not": 1, "bitwise_xor": 1,
    "reciprocal": 1, "sign": 1, "sgn": 1, "floor": 1, "ceil": 1, "round": 1,
    "trunc": 1, "remainder": 1, "fmod": 1, "masked_fill": 1, "addcmul": 2,
    "addcdiv": 2, "lerp": 3, "square": 1,
    # the operator forms (``a & b``, ``a << 3``; names lose their
    # trailing underscores), the threefry hash's among them
    "__and": 1, "__iand": 1, "__or": 1, "__ior": 1, "__xor": 1,
    "__ixor": 1, "__lshift": 1, "__ilshift": 1, "__rshift": 1,
    "__irshift": 1, "bitwise_left_shift": 1, "bitwise_right_shift": 1,
    "isfinite": 1, "isnan": 1, "isinf": 1, "signbit": 1, "nextafter": 1,
    "copysign": 1, "fmin": 1, "fmax": 1,
}
#: (FLOPs, transcendentals) an output element
_TRANSCENDENTAL = {
    "exp": (0, 1), "exp2": (0, 1), "expm1": (0, 1), "log": (0, 1),
    "log1p": (0, 1), "log2": (0, 1), "log10": (0, 1), "tanh": (0, 1),
    "sigmoid": (0, 1), "rsqrt": (0, 1), "sqrt": (0, 1), "sin": (0, 1),
    "cos": (0, 1), "tan": (0, 1), "erf": (0, 1), "erfc": (0, 1),
    "erfinv": (0, 1), "atan": (0, 1), "atan2": (0, 1), "pow": (0, 1),
    # x * logistic(x); its gradient g s (1 + x (1 - s))
    "silu": (1, 1), "silu_backward": (5, 1),
    # jax.nn.gelu(approximate=True): 0.5 x (1 + tanh(c (x + a x^3)))
    "gelu": (7, 1), "gelu_backward": (12, 1),
    "sigmoid_backward": (2, 0), "tanh_backward": (2, 0),
    "relu": (1, 0), "threshold_backward": (1, 0),
    # max(a, b) + log1p(exp(-|a - b|))
    "logaddexp": (4, 2),
}
#: (FLOPs, transcendentals) an input element of a reduction along a dim
_ROW_OPS = {
    "_softmax": (4, 1), "_log_softmax": (4, 1),
    "_softmax_backward_data": (4, 0), "_log_softmax_backward_data": (3, 1),
    "logsumexp": (3, 1),
}
_REDUCTION = {"sum": 1, "mean": 1, "amax": 1, "amin": 1, "max": 1, "min": 1,
              "prod": 1, "argmax": 1, "argmin": 1, "any": 1, "all": 1,
              "cumsum": 1, "cumprod": 1, "norm": 2, "linalg_vector_norm": 2,
              "var": 3, "std": 3, "var_mean": 3, "std_mean": 3}
#: one FLOP an element added into the destination
_SCATTER_ADD = {"scatter_add": 3, "index_add": 3, "embedding_dense_backward": 0}
#: data movement and bookkeeping: no FLOPs
_MOVE = {
    "clone", "copy", "_to_copy", "cat", "stack", "index", "_unsafe_index",
    "index_select", "gather", "scatter", "index_put", "_index_put_impl",
    "_unsafe_index_put", "masked_scatter", "masked_select", "embedding",
    "repeat", "repeat_interleave", "roll", "flip", "constant_pad_nd", "fill",
    "zero", "zeros", "ones", "full", "empty", "empty_like", "empty_strided",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full", "new_empty", "new_empty_strided", "arange", "sort", "topk",
    "argsort", "tril", "triu", "slice_scatter", "select_scatter",
    "diagonal_scatter", "as_strided_scatter", "_local_scalar_dense",
    "nonzero", "lift_fresh", "lift_fresh_copy", "detach", "alias",
    "select_backward", "slice_backward", "index_select_backward", "set",
    "resize", "split_with_sizes_copy", "unbind_copy", "normal", "uniform",
    "bernoulli", "randn", "rand", "_pin_memory", "is_pinned",
    "_has_compatible_shallow_copy_type", "one_hot", "scalar_tensor",
    "_unsafe_view", "view_copy", "expand_copy", "t_copy", "transpose_copy",
    "permute_copy", "narrow_copy", "unfold_copy", "_reshape_copy",
    "_copy_from", "_copy_from_and_resize", "linspace", "diag_embed",
    "expand_as", "contiguous", "record_stream", "_foreach_copy",
    "_foreach_zero",
}
#: ops that read and write nothing (an allocation, an alias, a scalar)
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "_local_scalar_dense", "_unsafe_view",
             "detach", "alias", "lift_fresh", "set", "resize", "is_pinned",
             "_has_compatible_shallow_copy_type", "record_stream",
             "promote_types"}
#: collectives: counted from their own log, not here
_SKIP_NAMESPACES = {"c10d", "_c10d_functional", "_dtensor", "profiler"}


def _nb(t) -> int:
    return t.numel() * t.element_size()


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return _nb(x)
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


def _first(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, (list, tuple)):
        for y in x:
            t = _first(y)
            if t is not None:
                return t
    return None


def _attention_cost(q, k, v, *_):
    """(FLOPs, product FLOPs, transcendentals) of one attention forward
    over the whole T x S score matrix (the reference's accounting pass
    computes it at one chunk): the q.k and p.v products, and at each
    score a mask select, a row max, a difference, an exp and a row sum."""
    B, T, H, dq = q.shape
    n = B * H * T * k.shape[1]
    dots = 2 * n * (dq + v.shape[-1])
    return dots + 4 * n, dots, n


def _attention_bwd_cost(q, k, v, *_):
    """The backward as autodiff of that forward: the four products dP =
    dO v^T, dV = p^T dO, dQ = dS k, dK = dS^T q, and at each score the
    row sum's gradient added, the exp's product with p and the mask's
    select."""
    _, dots, n = _attention_cost(q, k, v)
    return 2 * dots + 3 * n, 2 * dots, 0


def _wkv_cost(r, *_):
    """The reference's roofline formula, 10 B T H dh^2 a forward."""
    B, T, H, dh = r.shape
    return 10 * B * T * H * dh * dh, 0, 0


def _wkv_bwd_cost(r, *_):
    f, _, _ = _wkv_cost(r)
    return 2 * f, 0, 0


def _as_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                   device="meta")
    if isinstance(x, (list, tuple)):
        return type(x)(_as_meta(y) for y in x)
    return x


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(y) for y in x)
    return type(x).__name__


def _plain_cost(name):
    """The rule of operator ``name`` whose plain version
    (``kernels.ops.PLAIN[name]``) this counter counts op by op: that
    count at the call's shapes, made once a signature on ``meta`` copies
    of the arguments (shapes, strides and types kept)."""
    cache = {}

    def cost(*args):
        key = _signature(args)
        if key not in cache:
            from repro_torch.kernels import ops
            with CostCounter() as cc:
                ops.PLAIN[name](*_as_meta(args))
            if cc.unknown:
                raise ValueError(f"{name}: its plain version runs ops "
                                 f"without a cost rule: {dict(cc.unknown)}")
            cache[key] = (cc.flops, cc.dot_flops, cc.transcendentals)
        return cache[key]
    return cost


#: ``repro_torch`` operator (``kernels.ops``) -> its (FLOPs, product
#: FLOPs, transcendentals) from its arguments; its bytes are its
#: operands' and results', as every op's
KERNEL_COST = {"attention": _attention_cost,
               "attention_lse": _attention_cost,
               "attention_bwd": _attention_bwd_cost,
               "wkv": _wkv_cost, "wkv_ckpt": _wkv_cost,
               "wkv_bwd": _wkv_bwd_cost,
               "switch_tiers": _plain_cost("switch_tiers"),
               "switch_step": _plain_cost("switch_step")}


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, transcendentals and bytes of every aten op run
    under it, and of every ``repro_torch`` kernel operator (see the
    module docstring for the rules)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.unknown: collections.Counter = collections.Counter()

    def counts(self) -> dict:
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "transcendentals": self.transcendentals,
                "bytes_accessed": self.bytes_accessed}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace in _SKIP_NAMESPACES or func.is_view:
            return
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _NO_BYTES:
            return
        o = _first(out)
        self.bytes_accessed += _tensor_bytes(list(args)) + \
            _tensor_bytes(list(kwargs.values())) + _tensor_bytes(out)
        n_out = o.numel() if o is not None else 0
        if func.namespace == "repro_torch":
            f, dots, t = KERNEL_COST[name](*args)
            self.flops += f
            self.dot_flops += dots
            self.transcendentals += t
        elif name in _DOT:
            self._dot(name, args, o)
        elif name in _ELEMENTWISE:
            self.flops += _ELEMENTWISE[name] * n_out
        elif name in _TRANSCENDENTAL:
            f, t = _TRANSCENDENTAL[name]
            if name == "pow" and len(args) > 1 and \
                    not isinstance(args[1], torch.Tensor) and args[1] == 2:
                f, t = 1, 0                      # x ** 2: a product
            self.flops += f * n_out
            self.transcendentals += t * n_out
        elif name in _ROW_OPS:
            f, t = _ROW_OPS[name]
            n_in = _first(args).numel()
            self.flops += f * n_in
            self.transcendentals += t * n_in
        elif name in _REDUCTION:
            n_in = _first(args).numel()
            self.flops += _REDUCTION[name] * n_in
            if name == "mean":
                self.flops += n_out              # the division
        elif name in _SCATTER_ADD:
            self.flops += args[_SCATTER_ADD[name]].numel()
        elif name in ("_to_copy", "copy"):
            src = args[1] if name == "copy" else args[0]
            if o is not None and src.dtype != o.dtype:
                self.flops += n_out              # a conversion
        elif name in ("index_put", "_index_put_impl", "_unsafe_index_put"):
            acc = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
            if acc:
                self.flops += args[2].numel()
        elif name not in _MOVE:
            self.unknown[str(func)] += 1

    def _dot(self, name, args, o) -> None:
        if name == "convolution":
            w = args[1]
            k = w.numel() // w.shape[0]
        elif name in ("addmm", "baddbmm", "addbmm", "addmv"):
            k = args[1].shape[-1]
            self.flops += o.numel()              # the added term
        else:
            k = args[0].shape[-1]
        f = 2 * o.numel() * k
        self.flops += f
        self.dot_flops += f
