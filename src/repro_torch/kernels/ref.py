"""Plain PyTorch versions of the port's kernels (the allclose targets).

* switch_step_ref - one LC/DC switch tick, the counterpart of
  ``repro/kernels/ref.py::switch_step_ref``. It is the semantic
  definition the CUDA kernel (csrc/lcdc_switch.cu) is held against on
  the card, and the path ``ops.switch_step`` takes for CPU tensors. The
  usable-link and watermark predicates come from core/gating.py, the
  controller's own definitions.
* switch_tiers_ref - both switch tiers of one simulator tick: the two
  ``switch_step_ref`` calls and the glue around them, exactly as the
  tick ran them before the tiers had a kernel of their own. Held
  against ``lcdc_switch.switch_tiers`` (csrc/lcdc_switch.cu) on the
  card; the path ``ops.switch_tiers`` takes for CPU tensors.
* attention_ref   - the model's chunked online-softmax attention
  (models/attention.py), held against csrc/flash_attention.cu.
* attention_naive - the direct (T, S) softmax (small shapes only).
* wkv_ref         - the sequential RWKV-6 recurrence (models/rwkv6.py),
  held against csrc/rwkv6_wkv.cu.
* attention_lse_ref, wkv_ckpt_ref, attention_bwd_ref, wkv_bwd_ref - the
  training side: the rows' log-sum-exp the flash forward writes, the
  states the wkv forward keeps, and the gradients the two backward
  kernels compute, step by step in float32 (not through autograd).
  The training path runs them on CPU tensors (``ops.attention``,
  ``ops.wkv``), the kernels on CUDA tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import gating
from repro_torch.kernels.lcdc_switch import (CSW_SERVE_RATE,
                                             RSW_SERVE_RATE, TIER_ACC,
                                             Tiers)
from repro_torch.models.attention import chunked_attention as attention_ref  # noqa: F401
from repro_torch.kernels.rwkv6_wkv import CHUNK
from repro_torch.models.rwkv6 import wkv_scan as wkv_ref  # noqa: F401

BIG = 1e30


def _visible(T, S, causal, swa_window, device):
    qp = torch.arange(T, device=device)[:, None]
    kp = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if swa_window:
        mask &= (qp - kp) < swa_window
    return mask


def attention_naive(q, k, v, *, causal=True, swa_window=0):
    """q: (B,T,H,dq), k/v: (B,S,H,d) -> (B,T,H,dv): one float32 softmax
    over the whole (T, S) score matrix, masked scores at -1e30."""
    T, S, dq = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * dq ** -0.5
    s = torch.where(_visible(T, S, causal, swa_window, q.device), s, -BIG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(v.dtype)


def fma(a, b, c):
    """``a * b + c`` rounded once, as a fused multiply-add, in the
    promoted float type of the three tensors.

    The reference runs compiled (XLA contracts a product feeding an add
    into one FMA), so wherever its state is updated as ``c + a * b``
    this is the operation to match. In float32 the product is exact in
    float64; the sum rounds there and then to float32. In float64 it is
    ``fma64``.
    """
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype), c.dtype)
    if dt == torch.float64:
        return fma64(a.double(), b.double(), c.double())
    return (a.double() * b.double() + c.double()).float()


# Veltkamp's splitter for binary64: 2**27 + 1
_SPLIT = 134217729.0


def _two_sum(a, b):
    """(s, t) with s = fl(a + b) and a + b = s + t exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def veltkamp_split(a):
    """Veltkamp's split: (hi, lo) with a = hi + lo exactly, each with at
    most 26 significant bits."""
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def _two_prod(a, b, b_split=None):
    """(p, e) with p = fl(a * b) and a * b = p + e exactly (Dekker), for
    |a|, |b| < 2**995 and a product whose error term does not underflow
    (|a * b| >= 2**-969, or a * b = 0). ``b_split`` is
    ``veltkamp_split(b)``, when the caller reuses one ``b``."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b) if b_split is None else b_split
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _add_odd(a, b):
    """a + b rounded to odd: of the two floats around an inexact sum,
    the one whose last mantissa bit is 1 (an exact sum stays as it is)."""
    s, err = _two_sum(a, b)
    keep = (err == 0) | ((s.view(torch.int64) & 1) == 1)
    return torch.where(keep, s, torch.nextafter(s, err * float("inf")))


def fma64_finite(a, b, c, b_split=None):
    """``fma64`` for operands whose products and sums stay finite, where
    the sign of an exact zero result does not matter (a Horner step with
    nonzero coefficients): the same rounding with fewer operations.
    ``b_split`` as in ``_two_prod``."""
    p, e = _two_prod(a, b, b_split)
    th, tl = _two_sum(c, p)
    return th + _add_odd(tl, e)


def fma64(a, b, c):
    """float64 ``a * b + c`` rounded once (round to nearest, ties to
    even), from error-free transformations: PyTorch has no fused
    multiply-add, and float64 has no wider type to round through.

    Boldo and Melquiond's emulation (IEEE Trans. Computers 57(4), 2008):
    the exact product p + e (Dekker's two-product over Veltkamp's split),
    the exact sum c + p = th + tl (Knuth's two-sum), then
    ``th + RO(tl + e)`` with the inner sum rounded to odd, which makes
    the one outer rounding the correct one. Exact for finite inputs with
    |a|, |b|, |c| < 2**995 whose product is 0 or at least 2**-969 in
    magnitude (its error term must not underflow); results may be
    subnormal. Zeros, infinities and NaN take IEEE's ``a * b + c``,
    which is exact there. Runs the same on every device.
    """
    p = a * b
    special = (p == 0) | ~torch.isfinite(p) | ~torch.isfinite(c)
    return torch.where(special, p + c, fma64_finite(a, b, c))


def switch_step_ref(queues, stage, arrivals, draining=None, *,
                    valid=None, cap=20.0, hi=0.75, lo=0.22,
                    serve_rate=1.0):
    """One switch tick for a tier of S switches with L output ports.

    queues:   (S, L, K) float32 or float64 per-port backlogs split into
              K traffic components, or (S, L) for the K=1 shorthand.
    stage:    (S,) int32 active-stage counts (ports [0, stage) enabled).
    arrivals: (S, K) — or (S,) with 2-D queues — per-switch arrival
              vector enqueued onto the min-backlog usable port.
    draining: (S,) bool; a draining top port serves but does not accept.
    valid:    (S,) bool padding mask, or (S, L) bool per-link usability
              mask (a hard-faulted transceiver is a dead port). A switch
              with no valid port is inert, but any arrival fed to it is
              counted as a drop.
    cap/hi/lo: scalars or per-switch (S,) float32.

    Types follow the reference's promotion, so one body serves both
    modes: under x64 the queues are float64 and the arrivals float64
    (CSW tier) or float32 (RSW tier, summed in float32), and every float
    output is float64.

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
    # reciprocal, in the queues' type, in the reference)
    inv_rate = 1.0 / serve_rate if queues.dtype == torch.float64 \
        else float(np.float32(1.0 / serve_rate))
    enq_wait = torch.where(vswitch, mn0, 0.0) * inv_rate

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


def switch_tiers_ref(rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
                     rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
                     csw_valid, cap, acc) -> Tiers:
    """Both switch tiers of one simulator tick for B scenarios on a hull
    of NCL clusters x RPC racks, P planes (CSWs per cluster, RSW
    uplinks) and CUP CSW uplinks, served at RSW_SERVE_RATE and
    CSW_SERVE_RATE.

    RSW tier: queues (B, R, P, 2) [intra, inter], stage/draining (B, R),
    per-link fault timers (B, R, P) int32, rack_valid (B, R), arrivals
    (B, R, 2). A link is valid iff its rack is and its timer is 0. The
    served inter packets of uplink p summed over a cluster's racks are
    the arrivals of CSW (cluster, p).
    CSW-uplink tier: queues (B, NC, CUP), stage/draining/csw_valid
    (B, NC), timers (B, NC, CUP).
    cap: (B,) per-scenario queue cap. acc: the accumulators, a dict
    holding at least TIER_ACC, (B,) each; the tier sums are added to
    them in the tick's order.

    Returns ``Tiers``: the post-serve queues and enq_wait of both tiers,
    to_csw (B, NCL, P, 2), fc_in (B, CUP) and the TIER_ACC accumulators
    with this tick's sums added.
    """
    B, R, P, _ = rsw_q.shape
    NC, CUP = csw_q.shape[1:]
    NCL = NC // P

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    out = switch_step_ref(
        flat(rsw_q), flat(rsw_stage), flat(rsw_arrivals),
        flat(rsw_draining), valid=flat(rack_valid[..., None]
                                       & (rsw_timer == 0)),
        cap=cap.repeat_interleave(R), serve_rate=RSW_SERVE_RATE)
    rsw_q_new = out[0].reshape(B, R, P, 2)
    served = out[1].reshape(B, R, P, 2)
    rsw_drop, rsw_wait, rsw_m1, rsw_m2 = (x.reshape(B, R) for x in out[4:])
    new = {}
    new["drops"] = acc["drops"] + torch.sum(rsw_drop, dim=1)
    new["rsw_backlog"] = acc["rsw_backlog"] \
        + (torch.sum(rsw_q_new, dim=(1, 2, 3))
           + torch.sum(served, dim=(1, 2, 3)))
    new["rsw_served"] = acc["rsw_served"] + torch.sum(served, dim=(1, 2, 3))
    new["rsw_occ_m1"] = acc["rsw_occ_m1"] + torch.sum(rsw_m1, dim=1)
    new["rsw_occ_m2"] = acc["rsw_occ_m2"] + torch.sum(rsw_m2, dim=1)

    # uplink p of rack r lands on CSW (cluster(r), p)
    to_csw = torch.sum(served.reshape(B, NCL, R // NCL, P, 2), dim=2)
    inter_in = to_csw[..., 1].reshape(B, NC)

    out = switch_step_ref(
        flat(csw_q), flat(csw_stage), inter_in.reshape(-1),
        flat(csw_draining), valid=flat(csw_valid[..., None]
                                       & (csw_timer == 0)),
        cap=cap.repeat_interleave(NC), serve_rate=CSW_SERVE_RATE)
    csw_q_new = out[0].reshape(B, NC, CUP)
    cserve = out[1].reshape(B, NC, CUP)
    csw_drop, csw_wait, csw_m1, csw_m2 = (x.reshape(B, NC)
                                          for x in out[4:])
    new["drops"] = new["drops"] + torch.sum(csw_drop, dim=1)
    new["csw_up_backlog"] = acc["csw_up_backlog"] \
        + torch.sum(csw_q, dim=(1, 2))
    new["csw_up_served"] = acc["csw_up_served"] \
        + torch.sum(cserve, dim=(1, 2))
    new["csw_occ_m1"] = acc["csw_occ_m1"] + torch.sum(csw_m1, dim=1)
    new["csw_occ_m2"] = acc["csw_occ_m2"] + torch.sum(csw_m2, dim=1)
    # uplink f of every CSW lands on FC f
    fc_in = torch.sum(cserve, dim=1)
    return Tiers(rsw_q_new, rsw_wait, to_csw, csw_q_new, csw_wait, fc_in,
                 {k: new[k] for k in TIER_ACC})


def attention_lse_ref(q, k, *, causal=True, swa_window=0):
    """Each row's log-sum-exp of its visible scaled scores, float32
    (B, H, T): what the flash forward writes for the backward."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) \
        * q.shape[-1] ** -0.5
    mask = _visible(q.shape[1], k.shape[1], causal, swa_window, q.device)
    return torch.logsumexp(torch.where(mask, s, -BIG), dim=-1)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, swa_window=0):
    """(dq, dk, dv) float32 of attention ``o`` = softmax(scale q k^T) v
    given the rows' log-sum-exp ``lse`` (B, H, T) and ``do``, the
    gradient of ``o``: P = exp(scale q.k - lse) on visible pairs,
    D = rowsum(do * o), dS = P (do.v - D), dv = P^T do,
    dk = scale dS^T q, dq = scale dS k."""
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    s = torch.einsum("bthd,bshd->bhts", qf, kf) * scale
    mask = _visible(q.shape[1], k.shape[1], causal, swa_window, q.device)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    d = torch.einsum("bthd,bthd->bht", dof, of)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    ds = p * (dp - d[..., None])
    dv = torch.einsum("bhts,bthd->bshd", p, dof)
    dk = torch.einsum("bhts,bthd->bshd", ds, qf) * scale
    dq = torch.einsum("bhts,bshd->bthd", ds, kf) * scale
    return dq, dk, dv


def wkv_ckpt_ref(r, k, v, w, u, state):
    """``wkv_ref``'s (y, final state) and, as ``rwkv6_wkv.wkv_ckpt``
    keeps for the backward, the float32 state before every chunk of
    ``rwkv6_wkv.CHUNK`` tokens (B, H, ceil(T / CHUNK), dh, dh): the
    recurrence run chunk by chunk, the same bits as one run."""
    ys, ckpt, s = [], [], state.float()
    for t0 in range(0, r.shape[1], CHUNK):
        ckpt.append(s)
        y, s = wkv_ref(*(a[:, t0:t0 + CHUNK] for a in (r, k, v, w)), u, s)
        ys.append(y)
    return torch.cat(ys, dim=1), s, torch.stack(ckpt, dim=2)


def wkv_bwd_ref(r, k, v, w, u, s0, dy, dsT=None):
    """(dr, dk, dv, dw, du, ds0) float32 of ``wkv_ref``'s (y, final
    state) given ``dy`` and ``dsT`` (the final state's gradient; None:
    zeros). The states S_{t-1} are kept from a forward pass (never
    recovered by dividing by w); G, the gradient of the state after
    token t, runs backwards:
        dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)
        dk_t = G_t v_t + r_t u (v_t . dy_t)
        dv_t = G_t^T k_t + (sum r_t u k_t) dy_t
        dw_t = rowsum(G_t * S_{t-1})
        du   = sum_t r_t k_t (v_t . dy_t)
        G_{t-1} = w_t G_t + r_t dy_t^T,  ds0 = G_0."""
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    T = r.shape[1]
    s = s0.float()
    states = []
    for t in range(T):
        states.append(s)
        s = wf[:, t, :, :, None] * s + kf[:, t, :, :, None] \
            * vf[:, t, :, None, :]
    g = torch.zeros_like(s) if dsT is None else dsT.float()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(T)):
        sp = states[t]
        rt, kt, vt, wt, dyt = (a[:, t] for a in (rf, kf, vf, wf, dyf))
        b = (vt * dyt).sum(-1)                              # (B, H)
        a = (rt * uf * kt).sum(-1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) \
            + uf * kt * b[..., None]
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) \
            + rt * uf * b[..., None]
        dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + a[..., None] * dyt
        dw[:, t] = (g * sp).sum(-1)
        du += (rt * kt * b[..., None]).sum(0)
        g = wt[..., None] * g + rt[..., None] * dyt[..., None, :]
    return dr, dk, dv, dw, du, g
