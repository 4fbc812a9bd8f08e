"""LC/DC switch datapath: the wrappers of the hand-written CUDA kernels.

Replaces the Pallas TPU kernel ``src/repro/kernels/lcdc_switch.py``
(``switch_step``, body ``_kernel``). The source (csrc/lcdc_switch.cu)
holds one switch row's tick as a body templated on the port count, and
two kernels built on it; see the note at the top of the source for what
bounds them on an H100 (latency, not bytes) and how the design follows
from that.

* ``switch_step`` - one tick of a tier of switch rows, the contract of
  ``ref.switch_step_ref`` (all 8 outputs, any row count, 1 <= L <= 16
  ports, K in {1, 2} components).
* ``switch_tiers`` - both tiers of one simulator tick in one launch, one
  block per scenario: the contract of ``ref.switch_tiers_ref``, which is
  what ``core/simulator.py``'s tick runs.

Each runs in float32, or in float64 when its queues are float64 (the
sweep's x64 mode; the source's ``_f64`` entries), and checks what its
kernel accepts (CUDA tensors of the right type and shape), allocates the
outputs with ``torch.empty`` and launches on the current CUDA stream.
``LAUNCHES`` counts launches on the card; a launch recorded into a CUDA
graph being captured counts in ``CAPTURED`` instead, and the graph's
owner adds its launches to ``LAUNCHES`` each time it replays the graph
(``credit_replays``). ``LAUNCHES_F64`` counts the float64 launches
among them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_LINKS = 16
#: shared memory a float32 switch_tiers block may take (the H100's 227
#: KB of opt-in shared memory, less the kernel's static reduction
#: buffer of 8 warps x 10 partial sums)
TIERS_SMEM_LIMIT = 232_448 - 320
#: the same for the float64 kernel (its reduction buffer is twice as big)
TIERS_SMEM_LIMIT_F64 = 232_448 - 640

#: number of kernel launches on the card (incremented only where a
#: kernel is launched, or where a graph holding launches is replayed)
LAUNCHES = 0
#: the float64 kernels' share of LAUNCHES (the sweep's x64 mode)
LAUNCHES_F64 = 0
#: number of launches recorded into CUDA graphs during capture
CAPTURED = 0

#: serve rates of the simulator's two tiers, packets a tick a port: a
#: 10G RSW uplink and a 40G CSW uplink
RSW_SERVE_RATE = 1.0
CSW_SERVE_RATE = 4.0

#: the accumulators ``switch_tiers`` adds its per-scenario tier sums to
TIER_ACC = ("drops", "rsw_backlog", "rsw_served", "rsw_occ_m1",
            "rsw_occ_m2", "csw_up_backlog", "csw_up_served", "csw_occ_m1",
            "csw_occ_m2")

#: per float type: (symbol suffix, the ctypes type of its scalars)
_FLOAT_TYPES = {torch.float32: ("", ctypes.c_float),
                torch.float64: ("_f64", ctypes.c_double)}


def _step_argtypes(c_float):
    return [ctypes.c_void_p] * 8 + [c_float] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 9


def _tiers_argtypes(c_float):
    return [ctypes.c_void_p] * 6 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 7 + [c_float] * 2 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p] * 8


def _float_type(kernel, t):
    """The kernel's float type, from its queues: float32 or float64."""
    if t.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{kernel}: queues must be float32 or float64, "
                        f"got {t.dtype}")
    return t.dtype


class Tiers(NamedTuple):
    """What one tick's two switch tiers hand to the rest of the tick."""
    rsw_q: torch.Tensor     # (B, R, P, 2) post-serve RSW queues
    rsw_wait: torch.Tensor  # (B, R) RSW enq_wait
    to_csw: torch.Tensor    # (B, NCL, P, 2) RSW-served packets per
    #                         (cluster, plane): the cluster-CSWs' inputs
    csw_q: torch.Tensor     # (B, NC, CUP) post-serve CSW-uplink queues
    csw_wait: torch.Tensor  # (B, NC) CSW enq_wait
    fc_in: torch.Tensor     # (B, CUP) CSW-served packets per FC
    acc: dict               # TIER_ACC -> (B,) accumulator + tier sum


def _count(dtype):
    global LAUNCHES, LAUNCHES_F64, CAPTURED
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
        LAUNCHES_F64 += dtype == torch.float64


def credit_replays(launches: int, dtype) -> None:
    """Count ``launches`` launches of a replayed CUDA graph whose kernels
    run in ``dtype``."""
    global LAUNCHES, LAUNCHES_F64
    LAUNCHES += launches
    if dtype == torch.float64:
        LAUNCHES_F64 += launches


def _check(name, t, dtype, shape, device, kernel="switch_step"):
    _build.check(kernel, name, t, dtype, shape, device)


def _column(v, S, device):
    """Scalar or (S,) float32 knob -> contiguous (S,) device column."""
    if isinstance(v, torch.Tensor):
        if v.dim() == 0:
            return v.to(device=device, dtype=torch.float32).expand(S) \
                .contiguous()
        _check("per-switch knob", v, torch.float32, (S,), device)
        return v
    return torch.full((S,), float(v), dtype=torch.float32, device=device)


def _require_cuda(kernel, t):
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        raise ValueError(f"lcdc_switch.{kernel} runs on CUDA tensors only; "
                         f"ops.{kernel} takes CPU tensors to the plain "
                         f"version")


def switch_step(queues, stage, arrivals, draining=None, *, valid=None,
                cap=20.0, hi=0.75, lo=0.22, serve_rate=1.0):
    """One switch tick on the card; same contract as
    ``ref.switch_step_ref``: returns (new_queues, served, hi_trig,
    lo_trig, dropped, enq_wait, occ_m1, occ_m2). The per-switch
    ``cap``/``hi``/``lo`` become per-row float32 columns and a (S,)
    ``valid`` mask is broadcast to the kernel's per-link (S, L) operand.
    float64 queues take the float64 kernel, with float64 arrivals (the
    CSW tier's under x64)."""
    _require_cuda("switch_step", queues)
    squeeze = queues.dim() == 2
    if squeeze:
        queues, arrivals = queues[..., None], arrivals[..., None]
    if queues.dim() != 3:
        raise ValueError(f"switch_step: queues must be (S, L, K) or "
                         f"(S, L), got {tuple(queues.shape)}")
    S, L, K = queues.shape
    dev = queues.device
    if not 1 <= L <= MAX_LINKS:
        raise ValueError(f"switch_step: the kernel takes 1..{MAX_LINKS} "
                         f"ports, got L={L}")
    if K not in (1, 2):
        raise ValueError(f"switch_step: the kernel takes K in {{1, 2}} "
                         f"components, got K={K}")
    ft = _float_type("switch_step", queues)
    _check("queues", queues, ft, (S, L, K), dev)
    _check("stage", stage, torch.int32, (S,), dev)
    _check("arrivals", arrivals, ft, (S, K), dev)
    if draining is None:
        draining = torch.zeros((S,), dtype=torch.bool, device=dev)
    _check("draining", draining, torch.bool, (S,), dev)
    if valid is None:
        valid = torch.ones((S, L), dtype=torch.bool, device=dev)
    elif valid.dim() == 1:
        _check("valid", valid, torch.bool, (S,), dev)
        valid = valid[:, None].expand(S, L).contiguous()
    _check("valid", valid, torch.bool, (S, L), dev)
    cap_c, hi_c, lo_c = (_column(v, S, dev) for v in (cap, hi, lo))

    q_out = torch.empty_like(queues)
    served = torch.empty_like(queues)
    hi_t = torch.empty((S,), dtype=torch.int32, device=dev)
    lo_t = torch.empty((S,), dtype=torch.int32, device=dev)
    drop, wait, m1, m2 = (torch.empty((S,), dtype=ft, device=dev)
                          for _ in range(4))
    suffix, c_float = _FLOAT_TYPES[ft]
    fn = _build.function("lcdc_switch", "lcdc_switch_step" + suffix,
                         _step_argtypes(c_float))
    _build.launch("lcdc_switch", fn, dev, queues.data_ptr(),
                  stage.data_ptr(), arrivals.data_ptr(), draining.data_ptr(),
                  valid.data_ptr(), cap_c.data_ptr(), hi_c.data_ptr(),
                  lo_c.data_ptr(), float(serve_rate), S, L, K,
                  q_out.data_ptr(), served.data_ptr(), hi_t.data_ptr(),
                  lo_t.data_ptr(), drop.data_ptr(), wait.data_ptr(),
                  m1.data_ptr(), m2.data_ptr())
    _count(ft)
    if squeeze:
        q_out, served = q_out[..., 0], served[..., 0]
    return q_out, served, hi_t, lo_t, drop, wait, m1, m2


def load_tiers(dtype=torch.float32):
    """The C entry of ``switch_tiers`` for queues of ``dtype``, built and
    loaded (call it before capturing a CUDA graph that launches the
    kernel)."""
    suffix, c_float = _FLOAT_TYPES[dtype]
    return _build.function("lcdc_switch", "lcdc_switch_tiers" + suffix,
                           _tiers_argtypes(c_float))


def switch_tiers(rsw_q, rsw_stage, rsw_draining, rsw_timer, rack_valid,
                 rsw_arrivals, csw_q, csw_stage, csw_draining, csw_timer,
                 csw_valid, cap, acc) -> Tiers:
    """Both switch tiers of one simulator tick on the card, one launch;
    same contract as ``ref.switch_tiers_ref``. ``rsw_arrivals`` (B, R, 2)
    may be a strided view (the tick passes ``by_dest[..., 1:]``) whose
    components are adjacent; every other tensor is contiguous.

    The queues' type picks the kernel: float32, or float64 (the sweep's
    x64 mode), where the queues, the accumulators and every output are
    float64 and ``rsw_arrivals`` and ``cap`` stay float32, the types the
    reference's x64 tick hands its datapath."""
    k = "switch_tiers"
    _require_cuda(k, rsw_q)
    if rsw_q.dim() != 4 or rsw_q.shape[-1] != 2 or csw_q.dim() != 3:
        raise ValueError(f"{k}: queues must be (B, R, P, 2) and (B, NC, "
                         f"CUP), got {tuple(rsw_q.shape)} and "
                         f"{tuple(csw_q.shape)}")
    B, R, P, _ = rsw_q.shape
    NC, CUP = csw_q.shape[1:]
    if not (1 <= P <= MAX_LINKS and 1 <= CUP <= MAX_LINKS):
        raise ValueError(f"{k}: the kernel takes 1..{MAX_LINKS} ports a "
                         f"tier, got P={P}, CUP={CUP}")
    if NC % P or R % (NC // P):
        raise ValueError(f"{k}: {NC} CSWs of {P} planes and {R} racks do "
                         f"not form whole clusters")
    NCL = NC // P
    ft = _float_type(k, rsw_q)
    item = rsw_q.element_size()
    smem = item * (R * P * 2 + NC * CUP + NC)
    limit = TIERS_SMEM_LIMIT_F64 if ft == torch.float64 \
        else TIERS_SMEM_LIMIT
    if smem > limit:
        raise ValueError(f"{k}: a hull of {R} racks x {P} planes needs "
                         f"{smem} bytes of shared memory a block in "
                         f"{ft}, more than the {limit} an H100 block has")
    dev = rsw_q.device
    _check("rsw_q", rsw_q, ft, (B, R, P, 2), dev, k)
    _check("rsw_stage", rsw_stage, torch.int32, (B, R), dev, k)
    _check("rsw_draining", rsw_draining, torch.bool, (B, R), dev, k)
    _check("rsw_timer", rsw_timer, torch.int32, (B, R, P), dev, k)
    _check("rack_valid", rack_valid, torch.bool, (B, R), dev, k)
    _check("csw_q", csw_q, ft, (B, NC, CUP), dev, k)
    _check("csw_stage", csw_stage, torch.int32, (B, NC), dev, k)
    _check("csw_draining", csw_draining, torch.bool, (B, NC), dev, k)
    _check("csw_timer", csw_timer, torch.int32, (B, NC, CUP), dev, k)
    _check("csw_valid", csw_valid, torch.bool, (B, NC), dev, k)
    _check("cap", cap, torch.float32, (B,), dev, k)
    a = rsw_arrivals
    if not (isinstance(a, torch.Tensor) and a.device == dev
            and a.dtype == torch.float32 and tuple(a.shape) == (B, R, 2)
            and a.stride(2) == 1 and a.stride(0) == R * a.stride(1)):
        raise ValueError(f"{k}: rsw_arrivals must be a float32 (B, R, 2) "
                         f"tensor on {dev} with adjacent components and "
                         f"evenly spaced rows")
    acc_in = [acc[n] for n in TIER_ACC]
    for n, t in zip(TIER_ACC, acc_in):
        _check(f"acc[{n!r}]", t, ft, (B,), dev, k)

    out = Tiers(
        rsw_q=torch.empty_like(rsw_q),
        rsw_wait=torch.empty((B, R), dtype=ft, device=dev),
        to_csw=torch.empty((B, NCL, P, 2), dtype=ft, device=dev),
        csw_q=torch.empty_like(csw_q),
        csw_wait=torch.empty((B, NC), dtype=ft, device=dev),
        fc_in=torch.empty((B, CUP), dtype=ft, device=dev),
        acc={n: torch.empty_like(t) for n, t in zip(TIER_ACC, acc_in)})
    ptrs_in = (ctypes.c_void_p * len(TIER_ACC))(
        *(t.data_ptr() for t in acc_in))
    ptrs_out = (ctypes.c_void_p * len(TIER_ACC))(
        *(out.acc[n].data_ptr() for n in TIER_ACC))
    _build.launch(
        "lcdc_switch", load_tiers(ft), dev, rsw_q.data_ptr(),
        rsw_stage.data_ptr(), rsw_draining.data_ptr(), rsw_timer.data_ptr(),
        rack_valid.data_ptr(), a.data_ptr(), a.stride(1), csw_q.data_ptr(),
        csw_stage.data_ptr(), csw_draining.data_ptr(), csw_timer.data_ptr(),
        csw_valid.data_ptr(), cap.data_ptr(), ptrs_in, RSW_SERVE_RATE,
        CSW_SERVE_RATE, B, NCL, R // NCL, P, CUP, out.rsw_q.data_ptr(),
        out.rsw_wait.data_ptr(), out.to_csw.data_ptr(), out.csw_q.data_ptr(),
        out.csw_wait.data_ptr(), out.fc_in.data_ptr(), ptrs_out)
    _count(ft)
    return out
