"""LC/DC stage controller: watermark-driven link activation/deactivation.

Counterpart of ``repro/core/gating.py``. Vectorized over a leading
switch axis, so the same controller runs the RSW tier and the CSW tier;
the batched sweep engine flattens its scenario axis into that switch
axis and passes per-switch knobs as ``(S,)`` tensors.

Semantics (Sec III-A):
  * stage k active -> uplinks [0, k) usable; stage >= 1 always (full
    connectivity invariant - this is what hides the laser turn-on).
  * any active queue backlog > hi watermark -> raise stage-up trigger:
    after STAGE_UP_DELAY ticks (control msg + ack + laser on + CDR) the
    next link becomes usable.
  * all active backlogs < lo watermark -> stage-down: the top link stops
    accepting traffic (drain), and once its queue is empty it powers off
    after STAGE_OFF_DELAY ticks, during which it is still charged at
    full power (conservative, Sec VI-B).

Optical fault model (opt-in): ``gate_step`` grows a fault mode (engaged
by passing ``link_ok``) with per-event wake-time jitter, transient wake
failures that retry after ``WAKE_RETRY_BACKOFF_TICKS`` plus a fresh
turn-on delay, and the min-connectivity fallback that force-wakes the
cheapest healthy link of a switch left with no usable healthy link,
charging the turn-on delay to the ``fault_stall`` carry
(``FaultState.wake``). Each effect is selected away bit-exactly when
its knob is zero.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import constants as C


class GateState(NamedTuple):
    stage: torch.Tensor       # (S,) int32 in [1, n_links]
    up_timer: torch.Tensor    # (S,) int32, >0 while a link is turning on
    draining: torch.Tensor    # (S,) bool, top stage is draining
    off_timer: torch.Tensor   # (S,) int32, >0 while top link powers off
    hold: torch.Tensor        # (S,) int32 anti-flap dwell after activation
    # links charged as ON: active + turning-on + draining + turning-off
    powered: torch.Tensor     # (S, L) bool


class FaultState(NamedTuple):
    """Per-link hard-fault carry + the fault-forced wake stall."""
    timer: torch.Tensor   # (S, L) int32, > 0 while a transceiver is dead
    wake: torch.Tensor    # (S,) int32 remaining fault-forced wake stall


def fault_init(n_switches: int, n_links: int, device=None) -> FaultState:
    return FaultState(
        torch.zeros((n_switches, n_links), dtype=torch.int32,
                    device=device),
        torch.zeros((n_switches,), dtype=torch.int32, device=device))


def fault_arrivals(timer, u, powered, link_real, fault_prob, repair_ticks,
                   plane_u=None, plane_fail_prob=0.0):
    """One tick of hard transceiver faults: Bernoulli arrivals on
    powered, healthy, REAL links, then the repair countdown.

    timer: (S, L) int32 fault carry; u: (S, L) per-link uniforms;
    powered/link_real: (S, L) bool; fault_prob/repair_ticks/
    plane_fail_prob: scalars or tensors broadcastable against ``timer``
    (per-switch knobs as ``(S, 1)``). ``plane_u`` is an (S, L) uniform
    field in which all links of one correlated failure domain carry the
    same draw. Returns (new_timer, new_fault) with new_fault the (S, L)
    bool arrival mask. Zero hazards leave an all-zero timer all-zero.
    """
    healthy = timer == 0
    hazard = u < fault_prob
    if plane_u is not None:
        hazard = hazard | (plane_u < plane_fail_prob)
    new_fault = healthy & powered & link_real & hazard
    repair = torch.as_tensor(repair_ticks, dtype=torch.int32,
                             device=timer.device)
    timer = torch.where(new_fault, repair, torch.clamp(timer - 1, min=0))
    return timer.to(torch.int32), new_fault


def fault_stall_ticks(fault: FaultState):
    """(S,) float32: remaining ticks of a fault-forced link wake."""
    return fault.wake.to(torch.float32)


def gate_init(n_switches: int, n_links: int, device=None) -> GateState:
    stage = torch.ones((n_switches,), dtype=torch.int32, device=device)
    powered = torch.zeros((n_switches, n_links), dtype=torch.bool,
                          device=device)
    powered[:, 0] = True
    z = torch.zeros((n_switches,), dtype=torch.int32, device=device)
    return GateState(stage, z, torch.zeros_like(stage, dtype=torch.bool),
                     z.clone(), z.clone(), powered)


def usable_links(stage, draining, n_links: int):
    """(S, L) bool: links a scheduler may enqueue to this tick: links
    [0, stage) minus a draining top link (which still serves its backlog
    but accepts no new packets; stage 1 never drains)."""
    idx = torch.arange(n_links, device=stage.device)[None, :]
    st = stage[:, None]
    usable = idx < st
    top = idx == (st - 1)
    return usable & ~(draining[:, None] & top & (st > 1))


def active_mask(state: GateState, n_links: int):
    """(S, L) bool: links the scheduler may use this tick."""
    return usable_links(state.stage, state.draining, n_links)


def wake_stall_ticks(state: GateState):
    """(S,) float32: remaining ticks of an in-flight stage-up (zero
    with gating disabled, where ``up_timer`` never leaves 0)."""
    return state.up_timer.to(torch.float32)


def stall_attribution(gate: GateState, fault: FaultState, gating_on):
    """(wake_stall, fault_stall) per switch, (S,) float32 each, masked
    to exactly 0.0 where ``gating_on`` (bool scalar or (S,)) is False."""
    on = torch.as_tensor(gating_on, device=gate.up_timer.device)
    wake = torch.where(on, wake_stall_ticks(gate), 0.0)
    fstall = torch.where(on, fault_stall_ticks(fault), 0.0)
    return wake, fstall


def _per_switch(v):
    v = torch.as_tensor(v)
    return v[:, None] if v.dim() == 1 else v   # broadcast over ports


def watermark_triggers(queues, stage, *, cap, hi, lo, link_valid=None):
    """Shared hi/lo backlog-monitor definition (Sec III-B).

    queues: (S, L) per-port monitored backlogs. Returns (hi_trig,
    lo_trig) bool (S,). cap/hi/lo may each be scalar or per-switch
    (S,). ``link_valid`` (optional (S, L) bool) restricts the monitor
    to the valid/healthy ports.
    """
    cap, hi, lo = _per_switch(cap), _per_switch(hi), _per_switch(lo)
    idx = torch.arange(queues.shape[1], device=queues.device)[None, :]
    act = idx < stage[:, None]
    if link_valid is not None:
        act = act & link_valid
    hi_t = torch.any((queues > hi * cap) & act, dim=1)
    lo_t = torch.all(torch.where(act, queues < lo * cap, True), dim=1)
    return hi_t, lo_t


def gate_step(state: GateState, queues, *, cap=C.QUEUE_CAP_PKTS,
              hi=C.HI_WATERMARK, lo=C.LO_WATERMARK,
              up_delay: int = C.STAGE_UP_DELAY_TICKS,
              off_delay: int = C.STAGE_OFF_DELAY_TICKS,
              dwell=C.STAGE_DWELL_TICKS, max_stage=None,
              link_ok=None, link_real=None, u_jitter=None, u_fail=None,
              wake_fail_prob=0.0, wake_jitter_frac=0.0,
              fault_wake=None, fallback=True,
              backoff: int = C.WAKE_RETRY_BACKOFF_TICKS):
    """One controller tick. queues: (S, L) backlogs in packets.

    ``max_stage`` caps the stage per switch (scalar or (S,) int); it
    defaults to L. Per-switch knobs (dwell, wake_fail_prob,
    wake_jitter_frac, fallback) may be scalars or (S,) tensors.

    Fault mode engages when ``link_ok`` — the (S, L) healthy-transceiver
    mask — is passed; it then returns ``(GateState, fault_wake', diag)``
    with ``diag`` a dict of (S,) bools ``retries`` (a wake attempt
    failed this tick) and ``forced`` (the fallback fired). With zero
    wake knobs and ``link_ok`` all-True the GateState equals the
    fault-free path's.
    """
    S, L = queues.shape
    dev = queues.device
    idx = torch.arange(L, device=dev)[None, :]
    max_stage = torch.as_tensor(L if max_stage is None else max_stage,
                                dtype=torch.int32, device=dev)
    fault_mode = link_ok is not None

    hi_trig, lo_trig = watermark_triggers(queues, state.stage,
                                          cap=cap, hi=hi, lo=lo)

    stage, up_timer, draining, off_timer, hold = (
        state.stage, state.up_timer, state.draining, state.off_timer,
        state.hold)
    hold = torch.clamp(hold - 1, min=0)

    if fault_mode:
        # per-event turn-on delay draw around nominal; jitter 0 -> the
        # round() is exactly the nominal (zero-rate bit-parity)
        eff_delay = torch.clamp(torch.round(
            float(up_delay)
            * (1.0 + wake_jitter_frac * (2.0 * u_jitter - 1.0))),
            min=1.0).to(torch.int32)                            # (S,)
    else:
        eff_delay = up_delay

    # --- stage-up: start turn-on unless at max / rising / powering off
    can_up = hi_trig & (stage < max_stage) & (up_timer == 0) \
        & (off_timer == 0)
    up_timer = torch.where(can_up, eff_delay, up_timer)
    # cancel a drain if load returned
    draining = draining & ~hi_trig
    # countdown; on expiry the new link becomes usable
    fired = up_timer == 1
    if fault_mode:
        # transient wake failure: the firing attempt fails and re-arms
        # after a bounded backoff plus a fresh turn-on delay
        failed = fired & (u_fail < wake_fail_prob)
        fired = fired & ~failed
    stage = torch.where(fired, torch.minimum(stage + 1, max_stage), stage)
    hold = torch.where(fired, torch.as_tensor(dwell, dtype=torch.int32,
                                              device=dev), hold)
    up_timer = torch.clamp(up_timer - 1, min=0)
    if fault_mode:
        up_timer = torch.where(failed, backoff + eff_delay, up_timer)

    # --- stage-down: mark the top link draining (never stage 1)
    start_drain = lo_trig & (stage > 1) & ~draining & (up_timer == 0) \
        & (off_timer == 0) & (hold == 0)
    draining = draining | start_drain

    # drained? (top queue empty) -> drop the stage NOW (link unusable) and
    # begin the power-off transition (still charged: off_timer)
    top_q = torch.gather(queues, 1, (stage - 1).long()[:, None])[:, 0]
    begin_off = draining & (top_q <= 0) & (stage > 1)
    stage = torch.where(begin_off, stage - 1, stage)
    off_timer = torch.where(begin_off, off_delay, off_timer)
    draining = draining & ~begin_off
    off_timer = torch.clamp(off_timer - 1, min=0)

    diag = None
    if fault_mode:
        # --- min-connectivity fallback: a switch whose usable prefix is
        # all dead force-wakes the cheapest healthy link (lowest index)
        # the same tick; the turn-on delay is charged to the fault_stall
        # attribution carry instead of stalling the fluid
        ok = link_ok if link_real is None else (link_ok & link_real)
        usable_ok = usable_links(stage, draining, L) & ok
        has_ok = torch.any(ok, dim=1)
        do_fb = ~torch.any(usable_ok, dim=1) & has_ok & fallback
        first_ok = torch.argmax(ok.to(torch.int32), dim=1).to(torch.int32)
        tgt = torch.minimum(first_ok + 1, max_stage)
        stage = torch.where(do_fb, torch.maximum(stage, tgt), stage)
        draining = draining & ~do_fb
        off_timer = torch.where(do_fb, 0, off_timer)
        hold = torch.where(do_fb, torch.as_tensor(dwell, dtype=torch.int32,
                                                  device=dev), hold)
        fwake = torch.clamp(fault_wake - 1, min=0)
        fwake = torch.where(do_fb, eff_delay, fwake).to(torch.int32)
        diag = {"retries": failed, "forced": do_fb}

    # --- power accounting: on, rising, draining or falling => powered
    st = stage[:, None]
    powered = idx < st
    powered = powered | ((up_timer > 0)[:, None] & (idx == st))  # rising
    powered = powered | ((off_timer > 0)[:, None] & (idx == st))  # falling
    powered = powered | (draining[:, None] & (idx == (st - 1)))

    out = GateState(stage, up_timer, draining, off_timer, hold, powered)
    if fault_mode:
        return out, fwake, diag
    return out
