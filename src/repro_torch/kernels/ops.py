"""Device dispatch for the port's kernels (counterpart of
``repro/kernels/ops.py``).

A kernel entry point looks at the device of the tensors it is given: a
CUDA tensor goes to the hand-written kernel, which launches or raises;
a CPU tensor goes to the plain PyTorch version. There is no fallback
from one to the other.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lcdc_switch as _sw
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rwkv6_wkv as _wkv


def _on_cuda(kernel, t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel}: no kernel for device {t.device}")


def switch_step(queues, stage, arrivals, draining=None, *, valid=None,
                cap=20.0, hi=0.75, lo=0.22, serve_rate=1.0):
    """One LC/DC switch tick (the simulator's datapath): the CUDA kernel
    for CUDA tensors, ``ref.switch_step_ref`` for CPU tensors. See
    ``ref.switch_step_ref`` for the argument and return contract."""
    kw = dict(valid=valid, cap=cap, hi=hi, lo=lo, serve_rate=serve_rate)
    if _on_cuda("switch_step", queues):
        return _sw.switch_step(queues, stage, arrivals, draining, **kw)
    return _ref.switch_step_ref(queues, stage, arrivals, draining, **kw)


def switch_tiers(rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
                 rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
                 csw_valid, cap, acc):
    """Both switch tiers of one simulator tick: the CUDA kernel (one
    launch) for CUDA tensors, ``ref.switch_tiers_ref`` for CPU tensors.
    See ``ref.switch_tiers_ref`` for the argument and return contract."""
    args = (rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
            rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
            csw_valid, cap, acc)
    if _on_cuda("switch_tiers", rsw_q):
        return _sw.switch_tiers(*args)
    return _ref.switch_tiers_ref(*args)


def attention(q, k, v, *, causal=True, swa_window=0):
    """Online-softmax attention, q (B,T,H,dq), k (B,S,H,dq), v
    (B,S,H,dv) -> (B,T,H,dv): the CUDA flash kernel for CUDA tensors,
    ``ref.attention_ref`` for CPU tensors. dv may differ from dq (MLA's
    96 and 64): the kernel takes it as it is, nothing is padded."""
    if _on_cuda("attention", q):
        return _fa.flash_attention(q, k, v, causal=causal,
                                   swa_window=swa_window)
    return _ref.attention_ref(q, k, v, causal=causal, swa_window=swa_window)


def wkv(r, k, v, w, u, state):
    """The RWKV-6 wkv recurrence: the CUDA kernel for CUDA tensors,
    ``ref.wkv_ref`` for CPU tensors. Returns (y, final state)."""
    if _on_cuda("wkv", r):
        return _wkv.wkv(r, k, v, w, u, state)
    return _ref.wkv_ref(r, k, v, w, u, state)


def model_kernel_fns() -> dict:
    """``kernel_fns`` for ``repro_torch.models.model``'s entry points:
    attention and wkv through this dispatch."""
    return {"attention": attention, "wkv": wkv}
