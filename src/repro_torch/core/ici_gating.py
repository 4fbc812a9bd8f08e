"""Beyond-paper: LC/DC applied to the TPU pod ICI fabric.

Counterpart of ``repro/core/ici_gating.py``. A TPU pod has exactly the
properties LC/DC exploits in the data-center network: per-chip link
redundancy (a 2D torus gives 4 ICI links/chip, two independent ring
directions per axis) and bursty, phase-structured traffic (per-layer
collective bursts separated by compute windows, pipeline bubbles, idle
serving periods).

Two policies are evaluated on every (arch x shape) dry-run cell:

  * ``reactive``  - the paper's watermark controller (core/gating.py,
    the very same ``gate_step``) driven by outstanding collective bytes
    per link; pays the turn-on latency when a burst arrives faster than
    the stage can rise.
  * ``scheduled`` - beyond-paper: the training step is a *static*,
    compile-time-known schedule, so the runtime can raise links
    LASER_ON_US ahead of each collective window (the sendmsg-intercept
    trick, but with perfect foresight instead of a 3.2 us heads-up).
    Zero latency cost by construction; energy = collective duty cycle
    plus turn-on/off transition charge.

Inputs come from the dry-run accounting (per-layer HLO flops / HBM bytes
/ collective link-bytes); timings use the modelled TPU v5e pod's
parameters in core/constants.py (inputs of the analysis, not a speed of
the hardware the port runs on).

The reference runs the reactive controller as one jitted ``lax.scan``;
here it is a loop of ticks on the device (``_reactive_program``), the
same ``gating.gate_step`` on (1, links) tensors, with the reference's
compiled arithmetic (see there); on the card one tick is captured as a
CUDA graph and replayed, as the sweep replays its tick.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import gating
from repro_torch.device import fetch_point, resolve_device, upload

#: the port's dry-run records (``launch.dryrun``: its own counter, so not
#: the reference's ``results/dryrun``)
RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


@dataclass(frozen=True)
class StepPhases:
    """One training/serving step as alternating compute/collective phases."""
    arch: str
    shape: str
    n_layers: int
    t_compute_us: float        # per layer
    t_collective_us: float     # per layer
    t_tail_us: float           # embeddings / loss / optimizer tail
    coll_tail_us: float        # gradient all-reduce tail (DP sync)

    @property
    def step_us(self) -> float:
        return (self.n_layers * (self.t_compute_us + self.t_collective_us)
                + self.t_tail_us + self.coll_tail_us)

    @property
    def collective_duty(self) -> float:
        return (self.n_layers * self.t_collective_us + self.coll_tail_us) \
            / max(self.step_us, 1e-12)


def phases_from_dryrun(rec: dict, n_chips: int = 256) -> StepPhases | None:
    """Derive the per-layer phase structure from a dry-run record."""
    acct = rec.get("acct")
    if not acct:
        return None
    per_flops = max(acct["per_layer_flops"], 0.0) / n_chips
    per_bytes = max(acct["per_layer_bytes"], 0.0) / n_chips
    per_coll = max(acct["per_layer_coll_link_bytes"], 0.0) / n_chips
    tail_flops = max(acct["total_flops"]
                     - acct["per_layer_flops"] * _n_scan(rec), 0.0) / n_chips
    tail_coll = max(acct["total_coll_link_bytes"]
                    - acct["per_layer_coll_link_bytes"] * _n_scan(rec),
                    0.0) / n_chips

    links = C.TPU_ICI_LINKS_PER_CHIP
    t_comp = max(per_flops / C.TPU_PEAK_BF16_FLOPS,
                 per_bytes / C.TPU_HBM_BW) * 1e6
    t_coll = per_coll / (links * C.TPU_ICI_LINK_BW) * 1e6
    t_tail = tail_flops / C.TPU_PEAK_BF16_FLOPS * 1e6
    coll_tail = tail_coll / (links * C.TPU_ICI_LINK_BW) * 1e6
    return StepPhases(rec["arch"], rec["shape"], _n_scan(rec),
                      t_comp, t_coll, t_tail, coll_tail)


def _n_scan(rec: dict) -> int:
    a = rec.get("acct", {})
    d = a.get("per_layer_flops", 0.0)
    if d <= 0:
        return 1
    return max(int(round((a["total_flops"] - a["L1"]["cost"]["flops"]) / d))
               + 1, 1)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def scheduled_policy(ph: StepPhases, *, idle_frac: float = 0.0) -> dict:
    """Compile-time link schedule: links power up LASER_ON_US before each
    collective window and power down after (charged LASER_OFF_US), with
    one link-pair always on (connectivity invariant, carries control).

    idle_frac models serving gaps / pipeline bubbles between steps.
    """
    on_per_burst = ph.t_collective_us + C.LASER_ON_US + C.LASER_OFF_US
    on_us = ph.n_layers * min(on_per_burst,
                              ph.t_compute_us + ph.t_collective_us)
    on_us += min(ph.coll_tail_us + C.LASER_ON_US + C.LASER_OFF_US,
                 ph.coll_tail_us + ph.t_tail_us)
    step = ph.step_us / max(1e-9, 1.0 - idle_frac)   # stretch with idleness

    # one of the 4 links stays up; the other 3 follow the schedule
    links = C.TPU_ICI_LINKS_PER_CHIP
    gated = links - 1
    duty = min(on_us / max(step, 1e-9), 1.0)
    on_frac = (1.0 + gated * duty) / links
    return {
        "policy": "scheduled",
        "step_us": step,
        "collective_duty": ph.collective_duty * (1.0 - idle_frac),
        "link_on_frac": on_frac,
        "ici_energy_savings": 1.0 - on_frac,
        "latency_penalty": 0.0,           # turn-on is pre-scheduled
    }


def _replay(tick_into, n: int, device) -> None:
    """Run ``tick_into`` (a tick writing back into fixed tensors) ``n``
    times on the CUDA ``device``: the first eagerly on a side stream (the
    warm-up, a real tick), the rest as replays of one captured CUDA
    graph; returns once they are done (the graph dies with this call)."""
    with torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            tick_into()
        torch.cuda.current_stream(device).wait_stream(side)
        if n > 1:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                tick_into()
            for _ in range(n - 1):
                graph.replay()
        with fetch_point():
            torch.cuda.synchronize(device)


def _reactive_program(links: int, bw_link_tick: float, tick_us: float,
                      cap_q: float, up_delay: int, *, device,
                      x64: bool = False, graph: bool = False):
    """The watermark-controller timeline ``reactive_policy`` runs:
    ``run(demand) -> (powered_sum, stall_us)``, 0-d tensors on
    ``device`` (``demand`` a sequence of numbers, or already a 1-D
    tensor of the run's float type on ``device``), one tick of ``gating.gate_step`` on (1, ``links``)
    tensors per entry of ``demand``. With ``graph`` (a CUDA device) one
    tick is captured as a CUDA graph and replayed for the others, the
    tick reading its demand through a counter on the device; without
    it every tick runs eagerly, op by op.

    It computes what the reference's jitted scan computes, in its
    types: the queue, the stall and the backlog in the float type of the
    run (float32; float64 with ``x64``), the serve rate in float32
    (``stage * bw_link_tick``, converted after the product), and the
    stall summed one tick after another. XLA bakes the Python floats in
    as constants of those types and folds the backlog's
    ``queue / cap_q * QUEUE_CAP_PKTS / links`` into one product with
    ``(1 / cap_q) * QUEUE_CAP_PKTS * (1 / links)``, each factor rounded
    to the run's type; so does this. Everything stays on the device
    until the caller reads the two results."""
    dt = torch.float64 if x64 else torch.float32

    def const(v, dtype=dt):
        return upload(torch.tensor(v, dtype=dtype), device)

    one = np.float64 if x64 else np.float32
    scale = one(one(one(1.0) / one(cap_q)) * one(C.QUEUE_CAP_PKTS)) \
        * one(one(1.0) / one(links))
    bw = const(bw_link_tick, torch.float32)
    k_scale, k_tick, k_zero = const(scale), const(tick_us), const(0.0)
    # the controller's knobs as device tensors: a Python scalar that
    # gate_step would put on the device itself is a blocking copy a tick
    knobs = dict(cap=const(C.QUEUE_CAP_PKTS), hi=const(C.HI_WATERMARK),
                 lo=const(C.LO_WATERMARK),
                 max_stage=const(links, torch.int32),
                 dwell=const(8, torch.int32))

    def tick(state, queue, stall, powered, d):
        queue = queue + d
        serve = (state.stage[0].to(torch.float32) * bw).to(dt)
        queue = queue - torch.minimum(queue, serve)
        stall = stall + torch.where(queue > 0, k_tick, k_zero)
        q = (queue * k_scale).expand(1, links)
        state = gating.gate_step(state, q, up_delay=up_delay, **knobs)
        return state, queue, stall, powered + torch.sum(state.powered)

    def run(demand):
        d_all = demand if isinstance(demand, torch.Tensor) \
            else upload(np.asarray(demand, dtype=one), device)
        carry = (gating.gate_init(1, links, device),
                 torch.zeros((), dtype=dt, device=device),
                 torch.zeros((), dtype=dt, device=device),
                 torch.zeros((), dtype=torch.int64, device=device))
        if not graph:
            for d in d_all:
                carry = tick(*carry, d)
            return carry[3], carry[2]
        t = torch.zeros((1,), dtype=torch.int64, device=device)
        static = [*carry[0], *carry[1:], t]

        def tick_into():
            state, queue, stall, powered = tick(
                gating.GateState(*static[:6]), *static[6:9],
                d_all.index_select(0, t)[0])
            torch._foreach_copy_(static, [*state, queue, stall, powered,
                                          t + 1])

        _replay(tick_into, len(d_all), device)
        return static[8], static[7]

    return run


def reactive_policy(ph: StepPhases, *, idle_frac: float = 0.0,
                    max_ticks: int = 4096, x64: bool = False,
                    device=None, graph=None) -> dict:
    """The paper's watermark controller on a synthetic timeline of
    outstanding collective bytes per link (reuses core/gating.gate_step,
    a loop of ticks on ``device``; ``None`` means CUDA). The tick size
    adapts so one step is at most `max_ticks` ticks; sub-tick laser
    delays round up to one tick (conservative for the reactive policy).
    ``x64`` runs it as the reference runs under ``JAX_ENABLE_X64=1``.
    ``graph`` (default: yes on a CUDA device) replays the tick from a
    CUDA graph; ``graph=False`` runs every tick eagerly, as the CPU
    does. Both give the same result."""
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    elif graph and dev.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {dev}")
    links = C.TPU_ICI_LINKS_PER_CHIP
    step_us = ph.step_us / max(1e-9, 1.0 - idle_frac)
    tick_us = max(1.0, step_us / max_ticks)
    n_ticks = max(int(step_us / tick_us), 1)
    t_layer = ph.t_compute_us + ph.t_collective_us
    demand = np.zeros(n_ticks)
    bw_link_tick = C.TPU_ICI_LINK_BW * 1e-6 * tick_us
    coll_bytes_layer = ph.t_collective_us * C.TPU_ICI_LINK_BW * 1e-6 * links
    for i in range(ph.n_layers):
        t0 = min(int((i * t_layer + ph.t_compute_us) / tick_us), n_ticks - 1)
        demand[t0] += coll_bytes_layer
    if ph.coll_tail_us > 0:
        t0 = min(int((ph.n_layers * t_layer + ph.t_tail_us) / tick_us),
                 n_ticks - 1)
        demand[t0] += ph.coll_tail_us * C.TPU_ICI_LINK_BW * 1e-6 * links

    cap_q = 8 * bw_link_tick
    up_delay = max(int(np.ceil(C.LASER_ON_US / tick_us)), 1)

    run = _reactive_program(links, bw_link_tick, tick_us, cap_q,
                            up_delay, device=dev, x64=x64, graph=graph)
    powered_sum, stall_us = run(demand)
    with fetch_point():
        powered_sum, stall_us = float(powered_sum), float(stall_us)
    on_frac = powered_sum / (n_ticks * links)
    return {
        "policy": "reactive",
        "step_us": step_us,
        "tick_us": tick_us,
        "link_on_frac": on_frac,
        "ici_energy_savings": 1.0 - on_frac,
        "latency_penalty": stall_us / max(step_us, 1e-9),
    }


def analyze_cell(arch: str, shape: str, *, idle_frac: float = 0.0,
                 mesh: str = "single", device=None) -> dict | None:
    """Both policies on one dry-run record (None when it is missing or
    failed); the reactive one runs on ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    f = RESULTS / f"{arch}__{shape}__{mesh}.json"
    if not f.exists():
        return None
    rec = json.loads(f.read_text())
    if not rec.get("ok"):
        return None
    ph = phases_from_dryrun(rec)
    if ph is None:
        return None
    return {
        "arch": arch, "shape": shape,
        "collective_duty": ph.collective_duty,
        "t_compute_us": ph.t_compute_us,
        "t_collective_us": ph.t_collective_us,
        "scheduled": scheduled_policy(ph, idle_frac=idle_frac),
        "reactive": reactive_policy(ph, idle_frac=idle_frac, device=dev),
    }


def analyze_all(idle_frac: float = 0.0, device=None) -> list[dict]:
    """Both policies on every single-mesh dry-run record under
    ``RESULTS`` (none until ``launch.dryrun`` writes them), on
    ``device`` (``None``: CUDA)."""
    dev = resolve_device(device)
    out = []
    for f in sorted(RESULTS.glob("*__single.json")):
        arch, shape, _ = f.stem.split("__")
        r = analyze_cell(arch, shape, idle_frac=idle_frac, device=dev)
        if r:
            out.append(r)
    return out
