"""Device dispatch for the port's kernels (counterpart of
``repro/kernels/ops.py``).

A kernel entry point looks at the device of the tensors it is given: a
CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version. There is no fallback
from one to the other.

``attention`` and ``wkv`` are differentiable. When an input requires
grad (a training step), each runs as a ``torch.autograd.Function``
whose forward also returns what the backward needs (flash: the rows'
log-sum-exp; wkv: the state every 16 tokens) and whose backward is, on
CUDA tensors, the hand-written backward kernel, on CPU tensors the
plain backward (``ref.attention_bwd_ref``, ``ref.wkv_bwd_ref``); when
none does, the forward launches exactly as serving's (nothing written
or saved beside the output).

Each of those forwards and backwards, and the simulator's switch
datapath, is one operator of the ``repro_torch`` library
(``torch.ops.repro_torch.switch_tiers``, ``switch_step``,
``attention``, ``attention_lse``, ``attention_bwd``, ``wkv``,
``wkv_ckpt``, ``wkv_bwd``): its CUDA implementation the kernel's
wrapper, its CPU one the plain version, its Meta one the output shapes.
So a ``TorchDispatchMode`` sees a call as one op, whatever the device
(``launch.hlo_analysis.CostCounter`` counts it by name, for the dry run
and for the artifact audit of the sweep tick).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lcdc_switch as _sw
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_wkv as _wkv


def _on_cuda(kernel, t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


# ---------------------------------------------------------------------------
# the kernels as operators: CUDA the kernel, CPU the plain version,
# Meta the shapes
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")


def _op(schema, cuda, cpu, meta):
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    for fn, key in ((cuda, "CUDA"), (cpu, "CPU"), (meta, "Meta")):
        _LIB.impl(name, fn, key)
    return getattr(torch.ops.repro_torch, name).default


def _contiguous(*ts):
    return (t.contiguous() for t in ts)


def _like(*ts):
    """Contiguous ``meta`` outputs shaped as ``ts`` (as the kernels'
    wrappers allocate theirs, whatever the inputs' strides)."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for t in ts)


def _switch_step_impl(fn):
    def impl(queues, stage, arrivals, draining, valid, cap_t, cap, hi_t,
             hi, lo_t, lo, serve_rate):
        return fn(queues, stage, arrivals, draining, valid=valid,
                  cap=cap if cap_t is None else cap_t,
                  hi=hi if hi_t is None else hi_t,
                  lo=lo if lo_t is None else lo_t, serve_rate=serve_rate)
    return impl


def _switch_step_meta(queues, stage, arrivals, draining, valid, cap_t, cap,
                      hi_t, hi, lo_t, lo, serve_rate):
    S = queues.shape[0]
    return (queues.new_empty(queues.shape), queues.new_empty(queues.shape),
            stage.new_empty((S,)), stage.new_empty((S,)),
            *(queues.new_empty((S,)) for _ in range(4)))


#: operator name -> its implementation by the plain version (its CPU
#: kernel), which ``launch.hlo_analysis.KERNEL_COST`` counts op by op
PLAIN = {"switch_step": _switch_step_impl(_ref.switch_step_ref)}

_switch_step_op = _op(
    "switch_step(Tensor queues, Tensor stage, Tensor arrivals, "
    "Tensor? draining, Tensor? valid, Tensor? cap_t, float cap, "
    "Tensor? hi_t, float hi, Tensor? lo_t, float lo, float serve_rate) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)",
    _switch_step_impl(_sw.switch_step), PLAIN["switch_step"],
    _switch_step_meta)


def _tiers_impl(fn):
    """A ``Tiers`` function as the operator's implementation: the
    TIER_ACC accumulators a list in and out."""
    def impl(*args):
        *head, acc = args
        t = fn(*head, dict(zip(_sw.TIER_ACC, acc)))
        return (*t[:6], [t.acc[n] for n in _sw.TIER_ACC])
    return impl


def _tiers_meta(rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
                rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
                csw_valid, cap, acc):
    B, R, P, _ = rsw_q.shape
    NC, CUP = csw_q.shape[1:]
    new = rsw_q.new_empty
    return (new(rsw_q.shape), new((B, R)), new((B, NC // P, P, 2)),
            new(csw_q.shape), new((B, NC)), new((B, CUP)),
            [a.new_empty(a.shape) for a in acc])


PLAIN["switch_tiers"] = _tiers_impl(_ref.switch_tiers_ref)
_switch_tiers_op = _op(
    "switch_tiers(Tensor rsw_q, Tensor rsw_stage, Tensor rsw_draining, "
    "Tensor rsw_timer, Tensor rack_valid, Tensor rsw_arrivals, "
    "Tensor csw_q, Tensor csw_stage, Tensor csw_draining, "
    "Tensor csw_timer, Tensor csw_valid, Tensor cap, Tensor[] acc) -> "
    "(Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor[])",
    _tiers_impl(_sw.switch_tiers), PLAIN["switch_tiers"], _tiers_meta)


def _knob(v):
    """A switch knob as the operator takes it: a per-switch tensor, or
    a Python number kept as it is (the plain version computes with it
    in the queues' type)."""
    return (v, 0.0) if isinstance(v, torch.Tensor) else (None, float(v))


def switch_step(queues, stage, arrivals, draining=None, *, valid=None,
                cap=20.0, hi=0.75, lo=0.22, serve_rate=1.0):
    """One LC/DC switch tick (the simulator's datapath): the CUDA kernel
    for CUDA tensors, ``ref.switch_step_ref`` for CPU tensors, as the
    operator ``torch.ops.repro_torch.switch_step``. See
    ``ref.switch_step_ref`` for the argument and return contract."""
    _on_cuda("switch_step", queues)
    return _switch_step_op(queues, stage, arrivals, draining, valid,
                           *_knob(cap), *_knob(hi), *_knob(lo),
                           float(serve_rate))


def switch_tiers(rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
                 rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
                 csw_valid, cap, acc):
    """Both switch tiers of one simulator tick: the CUDA kernel (one
    launch) for CUDA tensors, ``ref.switch_tiers_ref`` for CPU tensors,
    as the operator ``torch.ops.repro_torch.switch_tiers``. See
    ``ref.switch_tiers_ref`` for the argument and return contract."""
    _on_cuda("switch_tiers", rsw_q)
    *out, tier_acc = _switch_tiers_op(
        rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid, rsw_arrivals,
        csw_q, csw_stage, csw_draining, csw_timer, csw_valid, cap,
        [acc[n] for n in _sw.TIER_ACC])
    return _sw.Tiers(*out, dict(zip(_sw.TIER_ACC, tier_acc)))


def _attention_meta(q, k, v, causal, swa_window):
    return q.new_empty(q.shape[:3] + v.shape[-1:])


def _lse_meta(q):
    B, T, H, _ = q.shape
    return q.new_empty((B, H, T), dtype=torch.float32)


_attention_op = _op(
    "attention(Tensor q, Tensor k, Tensor v, bool causal, int swa_window)"
    " -> Tensor",
    lambda q, k, v, causal, swa_window: _fa.flash_attention(
        *_contiguous(q, k, v), causal=causal, swa_window=swa_window),
    lambda q, k, v, causal, swa_window: _ref.attention_ref(
        q, k, v, causal=causal, swa_window=swa_window),
    _attention_meta)

_attention_lse_op = _op(
    "attention_lse(Tensor q, Tensor k, Tensor v, bool causal, "
    "int swa_window) -> (Tensor, Tensor)",
    lambda q, k, v, causal, swa_window: _fa.flash_attention_lse(
        *_contiguous(q, k, v), causal=causal, swa_window=swa_window),
    lambda q, k, v, causal, swa_window: (
        _ref.attention_ref(q, k, v, causal=causal, swa_window=swa_window),
        _ref.attention_lse_ref(q, k, causal=causal, swa_window=swa_window)),
    lambda q, k, v, causal, swa_window: (
        _attention_meta(q, k, v, causal, swa_window), _lse_meta(q)))


def _attention_bwd_cpu(q, k, v, out, lse, dout, causal, swa_window):
    grads = _ref.attention_bwd_ref(q, k, v, out, lse, dout, causal=causal,
                                   swa_window=swa_window)
    return tuple(g.to(t.dtype).contiguous() for g, t in zip(grads,
                                                             (q, k, v)))


_attention_bwd_op = _op(
    "attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
    "Tensor dout, bool causal, int swa_window) -> (Tensor, Tensor, Tensor)",
    lambda q, k, v, out, lse, dout, causal, swa_window:
        _fa.flash_attention_bwd(*_contiguous(q, k, v), out, lse,
                                dout.contiguous(), causal=causal,
                                swa_window=swa_window),
    _attention_bwd_cpu,
    lambda q, k, v, out, lse, dout, causal, swa_window: _like(q, k, v))


def _wkv_meta(r, k, v, w, u, state):
    return _like(r, state.float())


_wkv_op = _op(
    "wkv(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor state)"
    " -> (Tensor, Tensor)",
    lambda *args: _wkv.wkv(*_contiguous(*args)), _ref.wkv_ref, _wkv_meta)

_wkv_ckpt_op = _op(
    "wkv_ckpt(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor state) -> (Tensor, Tensor, Tensor)",
    lambda *args: _wkv.wkv_ckpt(*_contiguous(*args)), _ref.wkv_ckpt_ref,
    lambda r, k, v, w, u, state: _wkv_meta(r, k, v, w, u, state) + (
        r.new_empty(_wkv.ckpt_shape(r), dtype=torch.float32),))


def _wkv_bwd_cpu(r, k, v, w, u, ckpt, dy, ds_out):
    grads = _ref.wkv_bwd_ref(r, k, v, w, u, ckpt[:, :, 0], dy, ds_out)
    return tuple(g.to(t.dtype).contiguous() for g, t in zip(
        grads, (r, k, v, w, u, grads[5])))


_wkv_bwd_op = _op(
    "wkv_bwd(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor ckpt, Tensor dy, Tensor? ds_out) -> (Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor)",
    lambda r, k, v, w, u, ckpt, dy, ds_out: _wkv.wkv_bwd(
        *_contiguous(r, k, v, w, u), ckpt, dy, ds_out),
    _wkv_bwd_cpu,
    lambda r, k, v, w, u, ckpt, dy, ds_out: _like(r, k, v, w, u) + (
        r.new_empty(ckpt.shape[:2] + ckpt.shape[3:], dtype=torch.float32),))


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Attention(torch.autograd.Function):
    """The attention forward with the rows' log-sum-exp and its
    backward (on CUDA the flash kernel and its hand-written backward
    kernel)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, swa_window):
        out, lse = _attention_lse_op(q, k, v, causal, swa_window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, swa_window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attention_bwd_op(q, k, v, out, lse, dout, *ctx.mask)
        return dq, dk, dv, None, None


class _Wkv(torch.autograd.Function):
    """The wkv forward with the state every 16 tokens and its backward
    (on CUDA the wkv kernel and its hand-written backward kernel)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out, ckpt = _wkv_ckpt_op(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.set_materialize_grads(False)   # an unused output's is None
        return y, s_out

    @staticmethod
    def backward(ctx, dy, ds_out):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return _wkv_bwd_op(r, k, v, w, u, ckpt, dy.contiguous(),
                           None if ds_out is None else ds_out.contiguous())


def attention(q, k, v, *, causal=True, swa_window=0):
    """Online-softmax attention, q (B,T,H,dq), k (B,S,H,dq), v
    (B,S,H,dv) -> (B,T,H,dv): the CUDA flash kernel for CUDA tensors
    (with its backward kernel when an input requires grad),
    ``ref.attention_ref`` for CPU tensors (``ref.attention_bwd_ref`` its
    backward). dv may differ from dq (MLA's 96 and 64): the kernel takes
    it as it is, nothing is padded. The kernel takes contiguous inputs:
    a view (one kv head repeated over a rank's q heads, stride 0) is
    copied first."""
    _on_cuda("attention", q)
    if _wants_grad(q, k, v):
        return _Attention.apply(q, k, v, causal, swa_window)
    return _attention_op(q, k, v, causal, swa_window)


def wkv(r, k, v, w, u, state):
    """The RWKV-6 wkv recurrence: the CUDA kernel for CUDA tensors (with
    its backward kernel when an input requires grad; head dim 64),
    ``ref.wkv_ref`` for CPU tensors (``ref.wkv_bwd_ref`` its backward).
    The kernel takes contiguous inputs: a view (a rank's columns of the
    decays, cut from the whole width) is copied first. Returns (y, final
    state)."""
    if _wants_grad(r, k, v, w, u, state):
        if _on_cuda("wkv", r) and r.shape[-1] not in _wkv.BWD_HEAD_DIMS:
            raise ValueError(
                f"wkv: the backward kernel takes head dims "
                f"{_wkv.BWD_HEAD_DIMS}, got {r.shape[-1]}")
        return _Wkv.apply(r, k, v, w, u, state)
    _on_cuda("wkv", r)
    return _wkv_op(r, k, v, w, u, state)


def model_kernel_fns() -> dict:
    """``kernel_fns`` for ``repro_torch.models.model``'s entry points:
    attention and wkv through this dispatch."""
    return {"attention": attention, "wkv": wkv}
