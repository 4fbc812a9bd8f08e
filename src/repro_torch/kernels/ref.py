"""Plain PyTorch versions of the port's kernels (the allclose targets).

* switch_step_ref - one LC/DC switch tick, the counterpart of
  ``repro/kernels/ref.py::switch_step_ref``. It is the semantic
  definition the CUDA kernel (csrc/lcdc_switch.cu) is held against on
  the card, and the path ``ops.switch_step`` takes for CPU tensors. The
  usable-link and watermark predicates come from core/gating.py, the
  controller's own definitions.
* attention_ref   - the model's chunked online-softmax attention
  (models/attention.py), held against csrc/flash_attention.cu.
* attention_naive - the direct (T, S) softmax (small shapes only).
* wkv_ref         - the sequential RWKV-6 recurrence (models/rwkv6.py),
  held against csrc/rwkv6_wkv.cu.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gating
from repro_torch.models.attention import chunked_attention as attention_ref  # noqa: F401
from repro_torch.models.rwkv6 import wkv_scan as wkv_ref  # noqa: F401

BIG = 1e30


def attention_naive(q, k, v, *, causal=True, swa_window=0):
    """q: (B,T,H,dq), k/v: (B,S,H,d) -> (B,T,H,dv): one float32 softmax
    over the whole (T, S) score matrix, masked scores at -1e30."""
    T, S, dq = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * dq ** -0.5
    qp = torch.arange(T, device=q.device)[:, None]
    kp = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if swa_window:
        mask &= (qp - kp) < swa_window
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(v.dtype)


def fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add.

    The reference runs compiled (XLA contracts a product feeding an add
    into one FMA), so wherever its float32 state is updated as
    ``c + a * b`` this is the operation to match. The float32 product is
    exact in float64; the sum rounds there and then to float32.
    """
    return (a.double() * b.double() + c.double()).float()


def switch_step_ref(queues, stage, arrivals, draining=None, *,
                    valid=None, cap=20.0, hi=0.75, lo=0.22,
                    serve_rate=1.0):
    """One switch tick for a tier of S switches with L output ports.

    queues:   (S, L, K) float32 per-port backlogs split into K traffic
              components, or (S, L) for the K=1 shorthand.
    stage:    (S,) int32 active-stage counts (ports [0, stage) enabled).
    arrivals: (S, K) — or (S,) with 2-D queues — per-switch arrival
              vector enqueued onto the min-backlog usable port.
    draining: (S,) bool; a draining top port serves but does not accept.
    valid:    (S,) bool padding mask, or (S, L) bool per-link usability
              mask (a hard-faulted transceiver is a dead port). A switch
              with no valid port is inert, but any arrival fed to it is
              counted as a drop.
    cap/hi/lo: scalars or per-switch (S,) float32.

    Per switch: (1) pick the usable port with the least total backlog
    (ties to the lowest index), (2) enqueue the arrival vector there,
    scaled so the port total never exceeds ``cap`` (the excess is
    dropped), (3) serve up to ``serve_rate`` pkts per active port, split
    proportionally across the K components, (4) raise hi/lo watermark
    triggers on the post-serve backlogs, (5) emit the taps ``enq_wait``
    (the pick's pre-enqueue backlog / serve_rate), ``occ_m1`` and
    ``occ_m2`` (sum and sum of squares of the post-serve per-port
    backlogs).

    Returns (new_queues, served, hi_trig, lo_trig, dropped, enq_wait,
    occ_m1, occ_m2): queues' shape twice, int32 (S,) twice, float (S,)
    four times.
    """
    squeeze = queues.dim() == 2
    if squeeze:
        queues = queues[..., None]
        arrivals = arrivals[..., None]
    S, L, K = queues.shape
    dev = queues.device
    if draining is None:
        draining = torch.zeros((S,), dtype=torch.bool, device=dev)
    if valid is None:
        valid = torch.ones((S,), dtype=torch.bool, device=dev)
    link_valid = valid[:, None] if valid.dim() == 1 else valid.bool()
    vswitch = torch.any(link_valid, dim=1)              # (S,)

    act = (torch.arange(L, device=dev)[None, :] < stage[:, None]) \
        & link_valid
    usable = gating.usable_links(stage, draining, L) & link_valid
    qtot = torch.sum(queues, dim=2)                     # (S, L)

    # (1) min-backlog usable port, ties to the lowest index
    masked = torch.where(usable, qtot, BIG)
    mn = torch.amin(masked, dim=1, keepdim=True)
    pick = masked == mn
    pick &= torch.cumsum(pick.to(torch.int32), dim=1) == 1
    # per-link faults can leave a live switch with NO usable port: keep
    # the BIG sentinel out of the taps and drop the whole arrival below
    has_usable = torch.any(usable, dim=1)
    mn0 = torch.where(has_usable, mn[:, 0], 0.0)

    # (5a) backlog-age of the pick: what an arrival queues behind
    # (a division by the static rate compiles to a product with its
    # float32 reciprocal in the reference)
    enq_wait = torch.where(vswitch, mn0, 0.0) \
        * float(np.float32(1.0 / serve_rate))

    # (2) enqueue with capacity clamp (proportional over components)
    add_tot = torch.sum(arrivals, dim=1)                # (S,)
    room = torch.where(has_usable, torch.clamp(cap - mn0, min=0.0), 0.0)
    scale = torch.clamp(room / torch.clamp(add_tot, min=1e-9), max=1.0)
    dropped = torch.where(vswitch, add_tot * (1.0 - scale), add_tot)
    q = queues + pick.to(queues.dtype)[..., None] \
        * (arrivals * scale[:, None])[:, None, :]

    # (3) serve up to serve_rate pkts per active port, proportional
    # across components (a draining top port keeps draining)
    qtot = torch.sum(q, dim=2)
    serve_tot = torch.clamp(qtot, max=serve_rate) * act
    frac = serve_tot / torch.clamp(qtot, min=1e-9)
    served = q * frac[..., None]
    q = fma(-q, frac[..., None], q)          # q - q*frac, fused


    # (5b) post-serve occupancy moments over the switch's output ports
    qpost = qtot - serve_tot
    occ_m1 = torch.where(vswitch, torch.sum(qpost, dim=1), 0.0)
    m2 = qpost[:, 0] * qpost[:, 0]
    for l in range(1, L):                    # fused sum of squares
        m2 = fma(qpost[:, l], qpost[:, l], m2)
    occ_m2 = torch.where(vswitch, m2, 0.0)

    # (4) watermark triggers on post-serve backlogs, restricted to the
    # valid ports; invalid switches never trigger
    hi_t, lo_t = gating.watermark_triggers(qpost, stage, cap=cap, hi=hi,
                                           lo=lo, link_valid=link_valid)
    hi_t, lo_t = hi_t & vswitch, lo_t & vswitch
    if squeeze:
        q, served = q[..., 0], served[..., 0]
    return (q, served, hi_t.to(torch.int32), lo_t.to(torch.int32),
            dropped, enq_wait, occ_m1, occ_m2)
