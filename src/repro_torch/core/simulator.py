"""LC/DC network simulator: 1 us-slotted batched sweep engine in PyTorch.

Counterpart of ``repro/core/simulator.py``. It models the Fig 2
Facebook-style site end to end:

  server NICs --(node-gated links)--> RSW --(stage-gated uplinks)--> CSW
      --(stage-gated 40G uplinks)--> FC --> CSW --> RSW --> server

Edge traffic is stochastic (per-rack flow slots driven by the
``TrafficSpec`` knobs, or the flow-level engine at ``flow_mode=1``);
the aggregation tiers are fluid (float packet counts). Every tick draws
its randomness from the same threefry streams as the reference
(core/prng.py), keyed by each rack's LOGICAL id, so padded hull rows are
inert and a port run sees the reference's uniforms.

How the reference's JAX structure maps here:

* ``vmap`` over scenarios becomes an explicit leading batch axis ``B``
  on every ``Scenario`` and ``SimState`` leaf. The two switch tiers go
  through ``kernels.ops.switch_tiers`` — one hand-written CUDA kernel
  launch a tick on the card (one block per scenario), the reference's
  two ``switch_step`` calls and their glue in plain PyTorch on the CPU.
* ``lax.scan`` over ticks becomes a loop. Chunks keep the reference's
  boundaries (``chunk_ticks``); a remainder chunk simply runs fewer
  ticks, and at every boundary the accumulators fold into a Kahan
  ``(sum, comp)`` pair on the device, float32 or (``x64=True``)
  float64, exactly as the reference's device fold does in its mode (or,
  with ``fold="host"``, into float64 on the host, one fetch a chunk).
* The reference's process-wide ``JAX_ENABLE_X64`` becomes the ``x64``
  argument of every entry point: 64-bit draws, float64 state, fold and
  checkpoints, and the float64 switch kernel on the card.
* The reference's one compiled program per (hull, batch, chunk) becomes
  one CUDA graph per run on a CUDA device: a single tick of
  ``step_into`` (the step writing its result back into fixed state
  buffers) is captured once and replayed for every tick of every chunk
  (``CAPTURE_COUNT`` counts captures as the reference's ``TRACE_COUNT``
  counts traces). ``run_sweep(graph=False)`` and the CPU run the ticks
  eagerly, op by op.
* The reference's in-program guards (``validate=True``) and the device
  fold run as eager ops at each chunk boundary, after the replays;
  neither syncs with the host. ``run_sweep`` fetches the fold (with the
  guard riding along) once at the end (``HOST_TRANSFER_COUNT`` counts
  it) and finalizes the paper's metrics on the host.
* JAX arrays are immutable, the replayed carry is not: a checkpoint
  (``checkpoint=``, ``resume_sweep``) clones the carry on the device at
  its chunk boundary and copies the clone to the host on a side stream
  while the next chunk runs. The files are the reference's format
  (core/checkpoint.py), so either engine resumes the other's.
* ``run_sweep_planned`` splits a heterogeneous-site sweep into hull
  buckets (core/planner.py), one capture each, with the reference's
  isolation, retry and salvage contract.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device, they raise.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import checkpoint as _ckpt
from repro_torch.core import constants as C
from repro_torch.core import gating
from repro_torch.core import prng
from repro_torch.core import workloads
from repro_torch.core.checkpoint import CheckpointError, CheckpointSpec
from repro_torch.core.topology import (FBSite, full_site_tag, pad_hull,
                                       site_tag)
from repro_torch.core.traffic import (TRAFFIC_SPECS, TrafficSpec,
                                      flow_arrival_rate_per_tick,
                                      rack_flow_rate_per_tick, stack_specs)
from repro_torch.device import resolve_device
from repro_torch.kernels import lcdc_switch, ops
from repro_torch.kernels.ref import fma

F_SLOTS = 64              # concurrent flow slots per rack
MAX_FAULT_LINKS = 16      # fixed per-switch fault-draw width: hull link
#                           axes must fit so every draw is
#                           padding-invariant
NODE_IDLE_TICKS = 50      # server-link idle timeout (us)
WIRE_HOP_US = 0.5         # fiber + switch pipeline per hop
STACK_US = 3.75           # TCP/IP + NIC (Sec IV-C)

CHUNK_TICKS = 10_000      # default chunk (accumulator fold period)

#: bump whenever the per-tick dynamics change (checkpoints record it and
#: resume refuses another version); the reference's, whose dynamics the
#: port reproduces
SIM_SCHEMA_VERSION = 8

#: number of accumulator host transfers the sweep engine has performed:
#: exactly ONE per device-fold run_sweep (the final fold fetch, the
#: validate guard riding along) plus one per checkpoint written; one per
#: chunk on the host fold
HOST_TRANSFER_COUNT = 0

#: number of CUDA graphs captured of the sweep tick: exactly ONE per
#: run_sweep on a CUDA device (remainder chunk included), none on the CPU
#: or with graph=False
CAPTURE_COUNT = 0

#: scalar metrics two runs of the same scenarios must agree on (the
#: reference's parity contract)
PARITY_KEYS = (
    "mean_latency_us", "injected_pkts", "delivered_pkts", "drop_frac",
    "switch_energy_savings_frac", "rsw_link_on_frac", "csw_link_on_frac",
    "node_link_on_frac", "transceiver_power_w", "half_off_frac",
    "delay_p50_us", "delay_p99_us", "delay_queue_us",
    "delay_wake_stall_us", "delivered_frac", "fault_drop_frac",
    "delay_fault_stall_us", "flows_completed", "flow_evicted_frac",
    "fct_slowdown_p99",
)


def worst_parity(ref_results, new_results, keys=PARITY_KEYS):
    """Worst relative divergence over ``keys`` between two result lists
    (zipped pairwise); returns (diff, "label:key")."""
    worst_key, worst = None, 0.0
    for r_a, r_b in zip(ref_results, new_results):
        for k in keys:
            a, b = r_a[k], r_b[k]
            d = abs(a - b) / max(abs(a), abs(b), 1e-9)
            if d > worst:
                worst_key, worst = f"{r_b['label']}:{k}", d
    return worst, worst_key


def _log_bin_edges(min_val: float, bins: int, bpo: float) -> np.ndarray:
    """Edges of a log-spaced histogram frame (len bins + 1): bin 0 is
    linear [0, min_val); bin i >= 1 covers [min * 2**((i-1)/bpo),
    min * 2**(i/bpo)); the last bin absorbs overflow."""
    return np.concatenate([
        [0.0],
        min_val * 2.0 ** (np.arange(bins, dtype=np.float64) / bpo)])


DELAY_BIN_EDGES_US = _log_bin_edges(
    C.DELAY_HIST_MIN_US, C.DELAY_HIST_BINS, C.DELAY_HIST_BINS_PER_OCTAVE)
FCT_BIN_EDGES_US = _log_bin_edges(
    C.FCT_HIST_MIN_US, C.FCT_HIST_BINS, C.FCT_HIST_BINS_PER_OCTAVE)
FCT_SLOWDOWN_BIN_EDGES = _log_bin_edges(
    C.FCT_SLOWDOWN_HIST_MIN, C.FCT_SLOWDOWN_HIST_BINS,
    C.FCT_SLOWDOWN_HIST_BINS_PER_OCTAVE)

def _delay_hist_add(hist, d, w, *, min_val=C.DELAY_HIST_MIN_US,
                    bpo=C.DELAY_HIST_BINS_PER_OCTAVE,
                    bins=C.DELAY_HIST_BINS):
    """Bin weighted delay samples into a log-spaced histogram.

    hist: (..., bins); d, w: (..., N) sample values (us) and packet
    weights, added into their bins with ``scatter_add``. Zero-weight
    rows contribute nothing, so padded hull rows are inert. The keyword
    frame defaults to the packet-delay histogram; the flow engine reuses
    it for its FCT frames. (On CUDA the adds into one bin land in no
    fixed order; with the integer weights of the rate-based edge and of
    flow completions every such sum is exact.)

    A NaN sample (a run gone non-finite, which the ``validate`` guards
    report) lands in bin 0: ``fmax`` drops the NaN where ``clamp`` would
    keep it, and a NaN index would be out of bounds for the scatter (an
    error on the CPU, a device-side assert that poisons the CUDA
    context on the card). The reference's one-hot add puts it in bin 1
    (XLA converts a NaN to the integer 0).
    """
    # the 1e-4 nudge keeps exact edge values in their own (half-open)
    # bin under f32 log2 rounding
    floor = _DELAY_FLOOR64 if d.dtype == torch.float64 else _DELAY_FLOOR
    idx = torch.clamp(
        torch.floor(torch.log2(torch.fmax(d, floor) / min_val) * bpo
                    + 1e-4), -1, bins - 2).to(torch.int64) + 1
    if w.dtype == hist.dtype:
        return torch.scatter_add(hist, -1, idx, w)
    # x64: float32 weights into a float64 histogram. The reference sums
    # each bin's weights in float32, then adds the bin sums.
    bin_sums = torch.zeros(hist.shape, dtype=w.dtype, device=w.device)
    return hist + torch.scatter_add(bin_sums, -1, idx, w)


#: the histogram's floor of a sample, as CPU scalar tensors of the two
#: sample types (``fmax`` takes a tensor; a 0-d CPU tensor rides into a
#: CUDA kernel as a scalar)
_DELAY_FLOOR = torch.tensor(1e-9, dtype=torch.float32)
_DELAY_FLOOR64 = torch.tensor(1e-9, dtype=torch.float64)


def on_frac_bucket(frac_on):
    """Quartile bucket of an on-fraction: (0,25], (25,50], (50,75],
    (75,100] — half-open-LEFT intervals (0 falls into the first)."""
    return torch.clamp(torch.ceil(frac_on * 4.0).to(torch.int32) - 1, 0, 3)


class Scenario(NamedTuple):
    """Per-scenario knobs as (B,) tensors (axis 0 = scenario).

    The batch builders stack one value per scenario, so one step
    advances the whole batch. The last block is the scenario's REAL
    site shape inside the padded hull (equal to the hull for a
    single-site batch).
    """
    # traffic (TrafficSpec fields; p_spawn folds iat + rate_scale)
    p_spawn: torch.Tensor          # f32: P(new flow)/rack/tick while ON
    p_on_off: torch.Tensor         # f32
    p_off_on: torch.Tensor         # f32
    size_w: torch.Tensor           # f32 lognormal mixture weight
    size_mu1: torch.Tensor         # f32
    size_s1: torch.Tensor          # f32
    size_mu2: torch.Tensor         # f32
    size_s2: torch.Tensor          # f32
    p_intra_rack: torch.Tensor     # f32
    p_intra_cluster: torch.Tensor  # f32
    pace: torch.Tensor             # f32
    burst_pace_boost: torch.Tensor  # f32
    elephant_pkts: torch.Tensor    # int32
    elephant_pace: torch.Tensor    # f32
    # controller / datapath
    gating_enabled: torch.Tensor   # bool
    queue_cap: torch.Tensor        # f32
    hi: torch.Tensor               # f32
    lo: torch.Tensor               # f32
    dwell: torch.Tensor            # int32
    # optical fault model (all zero => bit-identical to the fault-free
    # path; sweepable with zero new compile sites)
    wake_fail_prob: torch.Tensor   # f32 P(stage-up firing fails)
    wake_jitter_frac: torch.Tensor  # f32 turn-on delay jitter (+- fraction)
    fault_prob: torch.Tensor       # f32 per-tick hard-fault hazard (1/MTBF)
    repair_ticks: torch.Tensor     # int32 hard-fault repair delay
    fault_fallback: torch.Tensor   # bool min-connectivity force-wake on/off
    plane_fail_prob: torch.Tensor  # f32 per-tick correlated whole-plane
    #                             hazard (one draw per laser comb)
    # flow-level workload engine (flow_mode=0 => the rate-based path
    # above, bit-identical; sweepable with zero new compile sites)
    flow_mode: torch.Tensor        # int32 0=rate-based, 1=flow engine
    flow_rate: torch.Tensor        # f32 P(arrival event)/rack/tick
    flow_dist: torch.Tensor        # int32 index into workloads.FLOW_DIST_NAMES
    incast: torch.Tensor           # int32 flows per arrival event (fan-in)
    flow_cap: torch.Tensor         # int32 usable flow-table slots (<= static)
    # site shape (real dims; <= the hull's static dims)
    ncl: torch.Tensor              # int32 n_clusters
    rpc: torch.Tensor              # int32 racks_per_cluster
    cpc: torch.Tensor              # int32 csw_per_cluster (= rsw uplinks)
    nfc: torch.Tensor              # int32 n_fc (= csw uplinks)
    spr: torch.Tensor              # f32 servers_per_rack
    csw_ring: torch.Tensor         # f32 cluster-ring pkts/tick budget
    fc_ring: torch.Tensor          # f32 FC-ring pkts/tick budget


class SimState(NamedTuple):
    """The per-scenario carry; every leaf has a leading batch axis B
    (shapes below are per scenario)."""
    key: torch.Tensor          # (2,) threefry key words (int64)
    burst_on: torch.Tensor        # (R,) bool
    flow_rem: torch.Tensor        # (R, F) int32 remaining packets
    flow_dest: torch.Tensor       # (R, F) int32 0=rack 1=cluster 2=inter
    flow_fast: torch.Tensor       # (R, F) bool: line-rate elephant
    # flow engine (flow_mode=1): the fixed-capacity per-rack flow table
    # (FT = C.FLOW_TABLE_SLOTS static slots; a slot is live while
    # ft_rem > 0). All-zero and bit-inert at flow_mode=0.
    tick: torch.Tensor            # () int32 tick counter (arrival stamps)
    ft_start: torch.Tensor        # (R, FT) int32 arrival tick
    ft_rem: torch.Tensor          # (R, FT) f32 remaining packets
    ft_size: torch.Tensor        # (R, FT) int32 total flow size (pkts)
    ft_dst: torch.Tensor          # (R, FT) int32 0=rack 1=cluster 2=inter
    ft_cwnd: torch.Tensor         # (R, FT) f32 AIMD window (pkts/tick)
    rsw_q: torch.Tensor           # (R, P, 2) float [intra, inter]
    csw_up_q: torch.Tensor        # (NC, CUP) float
    csw_down_q: torch.Tensor      # (NC, RPC) float
    fc_down_q: torch.Tensor       # (NF, NC) float
    rsw_gate: gating.GateState
    csw_gate: gating.GateState
    rsw_fault: gating.FaultState   # per-uplink hard-fault carries
    csw_fault: gating.FaultState
    node_on: torch.Tensor         # (R,) float servers-links held on
    acc: dict                  # accumulators, (B,) or (B, ...) each


#: SimParams fields forming the fault model's cache/meta fingerprint
FAULT_KNOBS = ("wake_fail_prob", "wake_jitter_frac", "link_mtbf_ticks",
               "repair_ticks", "fault_fallback", "plane_fail_prob")

#: SimParams fields forming the flow engine's cache/meta fingerprint
FLOW_KNOBS = ("flow_mode", "flow_arrival_rate", "flow_size_dist",
              "incast_degree", "flow_table_cap")


@dataclass(frozen=True)
class SimParams:
    spec: TrafficSpec
    site: FBSite = FBSite()
    gating_enabled: bool = True
    rate_scale: float = 1.0
    queue_cap: float = C.QUEUE_CAP_PKTS
    hi: float = C.HI_WATERMARK
    lo: float = C.LO_WATERMARK
    dwell: int = C.STAGE_DWELL_TICKS
    # optical fault model (defaults = the paper's perfect plane)
    wake_fail_prob: float = 0.0    # P(a stage-up firing fails), [0, 1)
    wake_jitter_frac: float = 0.0  # turn-on delay jitter fraction [0, 1]
    link_mtbf_ticks: float = 0.0   # mean ticks between hard faults per
    #                                powered link; 0 disables hard faults
    repair_ticks: int = 0          # hard-fault repair delay (>= 1 when
    #                                link_mtbf_ticks > 0)
    fault_fallback: bool = True    # min-connectivity force-wake
    plane_fail_prob: float = 0.0   # per-tick correlated whole-plane
    #                                hazard (shared laser comb dies ->
    #                                every link it feeds faults at
    #                                once); 0 disables plane faults
    # flow-level workload engine (default = the legacy rate-based path)
    flow_mode: int = 0             # 0=rate-based, 1=flow engine
    flow_arrival_rate: float = 0.0  # P(arrival event)/rack/tick; 0 =>
    #                                 derive from spec * rate_scale
    #                                 (traffic.flow_arrival_rate_per_tick)
    flow_size_dist: str = "websearch"  # workloads.FLOW_DIST_NAMES
    incast_degree: int = 1         # flows per arrival event (fan-in),
    #                                [1, C.MAX_INCAST_DEGREE]
    flow_table_cap: int = C.FLOW_TABLE_SLOTS  # usable slots per rack

    def __post_init__(self):
        """Reject out-of-range knobs with a clear error instead of
        silent NaN/garbage downstream (satellite of the fault PR)."""
        def bad(msg):
            raise ValueError(f"SimParams: {msg}")
        if not self.rate_scale >= 0.0:
            bad(f"rate_scale must be >= 0, got {self.rate_scale}")
        if not self.queue_cap > 0.0:
            bad(f"queue_cap must be > 0, got {self.queue_cap}")
        if not 0.0 < self.hi <= 1.0:
            bad(f"hi watermark must be in (0, 1], got {self.hi}")
        if not self.lo >= 0.0:
            bad(f"lo watermark must be >= 0, got {self.lo}")
        if self.lo >= self.hi:
            bad(f"inverted watermarks: lo ({self.lo}) >= hi ({self.hi})")
        if self.dwell < 0:
            bad(f"dwell must be >= 0, got {self.dwell}")
        if not 0.0 <= self.wake_fail_prob < 1.0:
            bad("wake_fail_prob must be in [0, 1), got "
                f"{self.wake_fail_prob}")
        if not 0.0 <= self.wake_jitter_frac <= 1.0:
            bad("wake_jitter_frac must be in [0, 1], got "
                f"{self.wake_jitter_frac}")
        if self.link_mtbf_ticks < 0.0:
            bad(f"link_mtbf_ticks must be >= 0 (0 disables hard "
                f"faults), got {self.link_mtbf_ticks}")
        if 0.0 < self.link_mtbf_ticks < 1.0:
            bad(f"link_mtbf_ticks must be >= 1 tick when nonzero, got "
                f"{self.link_mtbf_ticks}")
        if self.repair_ticks < 0:
            bad(f"repair_ticks must be >= 0, got {self.repair_ticks}")
        if self.link_mtbf_ticks > 0.0 and self.repair_ticks < 1:
            bad("repair_ticks must be >= 1 when hard faults are "
                f"enabled (link_mtbf_ticks={self.link_mtbf_ticks})")
        if not 0.0 <= self.plane_fail_prob < 1.0:
            bad("plane_fail_prob must be in [0, 1), got "
                f"{self.plane_fail_prob}")
        if self.plane_fail_prob > 0.0 and self.repair_ticks < 1:
            bad("repair_ticks must be >= 1 when plane faults are "
                f"enabled (plane_fail_prob={self.plane_fail_prob})")
        if self.flow_mode not in (0, 1):
            bad(f"flow_mode must be 0 (rate-based) or 1 (flow "
                f"engine), got {self.flow_mode}")
        if not 0.0 <= self.flow_arrival_rate <= 1.0:
            bad("flow_arrival_rate must be in [0, 1] (per-tick "
                f"Bernoulli; 0 derives from the trace), got "
                f"{self.flow_arrival_rate}")
        if self.flow_size_dist not in workloads.FLOW_DIST_NAMES:
            bad(f"flow_size_dist must be one of "
                f"{workloads.FLOW_DIST_NAMES}, got "
                f"{self.flow_size_dist!r}")
        if not 1 <= self.incast_degree <= C.MAX_INCAST_DEGREE:
            bad(f"incast_degree must be in [1, "
                f"{C.MAX_INCAST_DEGREE}] (the fixed draw width), got "
                f"{self.incast_degree}")
        if not 1 <= self.flow_table_cap <= C.FLOW_TABLE_SLOTS:
            bad(f"flow_table_cap must be in [1, "
                f"{C.FLOW_TABLE_SLOTS}] (the static table width), got "
                f"{self.flow_table_cap}")


def fault_fingerprint(p: "SimParams | None" = None) -> dict:
    """The fault-knob dict joined into result-cache keys / metadata so
    fault-free cached results never alias faulted runs. With no
    argument, returns the defaults (the perfect optical plane)."""
    if p is None:
        return {f.name: f.default for f in dataclasses.fields(SimParams)
                if f.name in FAULT_KNOBS}
    return {k: getattr(p, k) for k in FAULT_KNOBS}


def flow_fingerprint(p: "SimParams | None" = None) -> dict:
    """The flow-knob dict joined into result-cache keys / metadata so
    flow-free cached results never alias flow runs. With no argument,
    returns the defaults (the rate-based path)."""
    if p is None:
        return {f.name: f.default for f in dataclasses.fields(SimParams)
                if f.name in FLOW_KNOBS}
    return {k: getattr(p, k) for k in FLOW_KNOBS}


@dataclass(frozen=True)
class ScenarioBatch:
    """A stack of scenarios sharing one padded hull.

    ``hull`` is the static shape the step runs on (the per-axis max
    over ``sites``); ``sites`` holds each scenario's real FBSite for
    metric normalization. ``scen`` leaves are (B,) CPU tensors;
    ``run_sweep`` moves them to its device.
    """
    scen: Scenario             # leaves shape (B,)
    hull: FBSite
    sites: tuple               # FBSite per scenario
    names: tuple               # trace name per scenario
    labels: tuple              # unique human label per scenario
    gating: tuple              # python bools (for metric finalization)
    seeds: tuple

    def __len__(self) -> int:
        return len(self.labels)


def _run_label(p: SimParams, seed: int, *, tag_site: bool) -> str:
    """THE scenario label format (identical to the reference's)."""
    return (f"{p.spec.name}|{'lcdc' if p.gating_enabled else 'base'}"
            f"|x{p.rate_scale:g}|s{seed}"
            + (f"|{site_tag(p.site)}" if tag_site else ""))


def _build_batch(runs: Sequence[tuple[SimParams, int]],
                 tag_sites: bool) -> ScenarioBatch:
    if not runs:
        raise ValueError("empty scenario batch")
    params = [p for p, _ in runs]
    sites = tuple(p.site for p in params)
    tf = stack_specs([p.spec for p in params])

    def f32(xs):
        return torch.as_tensor(np.asarray(xs, np.float32))

    def i32(xs):
        return torch.as_tensor(np.asarray(xs, np.int32))

    def b(xs):
        return torch.as_tensor(np.asarray(xs, bool))

    scen = Scenario(
        p_spawn=f32([min(rack_flow_rate_per_tick(p.spec,
                                                 p.site.servers_per_rack)
                         * p.rate_scale, 1.0) for p in params]),
        p_on_off=f32(tf["p_on_off"]), p_off_on=f32(tf["p_off_on"]),
        size_w=f32(tf["size_w"]),
        size_mu1=f32(tf["size_mu1"]), size_s1=f32(tf["size_s1"]),
        size_mu2=f32(tf["size_mu2"]), size_s2=f32(tf["size_s2"]),
        p_intra_rack=f32(tf["p_intra_rack"]),
        p_intra_cluster=f32(tf["p_intra_cluster"]),
        pace=f32(tf["pace"]),
        burst_pace_boost=f32(tf["burst_pace_boost"]),
        elephant_pkts=i32(tf["elephant_pkts"]),
        elephant_pace=f32(tf["elephant_pace"]),
        gating_enabled=b([p.gating_enabled for p in params]),
        queue_cap=f32([p.queue_cap for p in params]),
        hi=f32([p.hi for p in params]), lo=f32([p.lo for p in params]),
        dwell=i32([p.dwell for p in params]),
        wake_fail_prob=f32([p.wake_fail_prob for p in params]),
        wake_jitter_frac=f32([p.wake_jitter_frac for p in params]),
        # per-tick hazard: 1/MTBF (0 disables hard faults)
        fault_prob=f32([1.0 / p.link_mtbf_ticks
                        if p.link_mtbf_ticks > 0 else 0.0
                        for p in params]),
        repair_ticks=i32([p.repair_ticks for p in params]),
        fault_fallback=b([p.fault_fallback for p in params]),
        plane_fail_prob=f32([p.plane_fail_prob for p in params]),
        flow_mode=i32([p.flow_mode for p in params]),
        # explicit rate wins; 0 derives the rate-based generator's
        # expected spawn rate so the two modes offer comparable load
        flow_rate=f32([p.flow_arrival_rate if p.flow_arrival_rate > 0.0
                       else flow_arrival_rate_per_tick(
                           p.spec, p.site.servers_per_rack,
                           p.rate_scale) for p in params]),
        flow_dist=i32([workloads.FLOW_DIST_NAMES.index(p.flow_size_dist)
                       for p in params]),
        incast=i32([p.incast_degree for p in params]),
        flow_cap=i32([p.flow_table_cap for p in params]),
        ncl=i32([p.site.n_clusters for p in params]),
        rpc=i32([p.site.racks_per_cluster for p in params]),
        cpc=i32([p.site.csw_per_cluster for p in params]),
        nfc=i32([p.site.n_fc for p in params]),
        spr=f32([p.site.servers_per_rack for p in params]),
        # 1 pkt/tick per 10G ring link
        csw_ring=f32([p.site.csw_ring_links for p in params]),
        fc_ring=f32([p.site.fc_ring_links for p in params]))
    labels = tuple(_run_label(p, seed, tag_site=tag_sites)
                   for p, seed in runs)
    return ScenarioBatch(
        scen=scen, hull=pad_hull(sites), sites=sites,
        names=tuple(p.spec.name for p, _ in runs), labels=labels,
        gating=tuple(bool(p.gating_enabled) for p, _ in runs),
        seeds=tuple(int(s) for _, s in runs))


def make_batch(runs: Sequence[tuple[SimParams, int]]) -> ScenarioBatch:
    """Stack (SimParams, seed) pairs sharing ONE site into a batch."""
    if not runs:
        raise ValueError("empty scenario batch")
    site = runs[0][0].site
    if not all(p.site == site for p, _ in runs):
        raise ValueError("make_batch takes one site topology; "
                         "heterogeneous sites go through "
                         "make_multi_site_batch (padded hull)")
    return _build_batch(runs, tag_sites=False)


def make_multi_site_batch(
        runs: Sequence[tuple[SimParams, int]]) -> ScenarioBatch:
    """Stack (SimParams, seed) pairs on ARBITRARY FBSite variants into
    one batch on their padded hull; labels gain a site tag. Each
    scenario's metrics match its single-site run."""
    return _build_batch(runs, tag_sites=True)


def grid_runs(traces=None, gating=(True, False), seeds=(0,),
              rate_scales=(1.0,), site: FBSite = FBSite(),
              **params_kw) -> list:
    """(SimParams, seed) pairs for the standard scenario grid: traces x
    {LC/DC, always-on} x utilization (rate) scales x seeds — the
    Fig 9/10 evaluation matrix."""
    if traces is None:       # explicit () stays empty (make_batch rejects)
        traces = tuple(TRAFFIC_SPECS)
    return [(SimParams(spec=TRAFFIC_SPECS[t], site=site, gating_enabled=g,
                       rate_scale=rs, **params_kw), s)
            for t in traces
            for g in gating for rs in rate_scales for s in seeds]


def sweep_grid(traces=None, gating=(True, False), seeds=(0,),
               rate_scales=(1.0,), site: FBSite = FBSite(),
               **params_kw) -> ScenarioBatch:
    """The standard scenario grid as one batch."""
    return make_batch(grid_runs(traces, gating, seeds, rate_scales, site,
                                **params_kw))


def _site_masks(hull: FBSite, scen: Scenario):
    """Validity masks + logical ids of each scenario's real site inside
    the hull (racks and CSWs occupy blocked cluster-major positions).
    Returns (rack_valid (B,R), csw_valid (B,NC), rack_uid (B,R),
    rsw_max_stage (B,R), csw_max_stage (B,NC)); invalid switches get
    max stage 1."""
    dev = scen.ncl.device
    kk = torch.arange(hull.n_clusters, device=dev)[None, :, None]
    rr = torch.arange(hull.racks_per_cluster, device=dev)[None, None, :]
    cc = torch.arange(hull.csw_per_cluster, device=dev)[None, None, :]
    ncl, rpc, cpc = (x[:, None, None] for x in (scen.ncl, scen.rpc,
                                                 scen.cpc))
    B = scen.ncl.shape[0]
    cl_valid = kk < ncl
    rack_valid = (cl_valid & (rr < rpc)).reshape(B, -1)
    csw_valid = (cl_valid & (cc < cpc)).reshape(B, -1)
    # logical id: position in the site's OWN (unpadded) rack order; the
    # PRNG is keyed on this, making traffic independent of hull padding
    rack_uid = (kk * rpc + rr).reshape(B, -1).to(torch.int32)
    rsw_max = torch.where(rack_valid, scen.cpc[:, None], 1).to(torch.int32)
    csw_max = torch.where(csw_valid, scen.nfc[:, None], 1).to(torch.int32)
    return rack_valid, csw_valid, rack_uid, rsw_max, csw_max


#: accumulator names and per-scenario shapes, in fold-buffer order
ACC_SHAPES = {
    "rsw_backlog": (), "rsw_served": (),
    "csw_up_backlog": (), "csw_up_served": (),
    "csw_down_backlog": (), "csw_down_served": (),
    "fc_backlog": (), "fc_served": (),
    "ring_pkts": (), "fc_ring_pkts": (),
    "injected": (), "intra_rack": (), "drops": (),
    "rsw_powered": (), "csw_powered": (), "node_on": (),
    "half_off_ticks": (),
    "on_frac_hist": (4,),   # (0-25,25-50,50-75,75-100]% on
    # in-scan packet-delay distribution + the attribution split
    "delay_hist": (C.DELAY_HIST_BINS,),
    "delay_sum": (), "delay_wt": (), "delay_wt_inter": (),
    "delay_queue_sum": (), "delay_stall_sum": (), "wake_stall_pkts": (),
    # optical fault model (all exactly 0 with zero fault knobs)
    "fault_drops": (), "delay_fault_sum": (), "fault_stall_pkts": (),
    "wake_retries": (), "forced_wakes": (), "fault_link_ticks": (),
    "conn_loss_rack_ticks": (), "conn_loss_csw_ticks": (),
    # post-serve occupancy moments from the switch kernel
    "rsw_occ_m1": (), "rsw_occ_m2": (), "csw_occ_m1": (),
    "csw_occ_m2": (),
    # flow engine (all exactly 0 at flow_mode=0)
    "flows_started": (), "flows_completed": (), "flows_evicted": (),
    "fct_sum": (), "fct_slow_sum": (),
    "fct_hist": (3, C.FCT_HIST_BINS),
    "fct_slow_hist": (3, C.FCT_SLOWDOWN_HIST_BINS),
}


def _float_dtype(x64: bool):
    """The type of the reference's default floats: float32, or float64
    under x64 (``jnp.zeros(())`` without a dtype)."""
    return torch.float64 if x64 else torch.float32


def _zero_acc(B: int, device, x64: bool = False) -> dict:
    return {k: torch.zeros((B,) + shp, dtype=_float_dtype(x64),
                           device=device)
            for k, shp in ACC_SHAPES.items()}


def _init_state(hull: FBSite, scen: Scenario, keys,
                x64: bool = False) -> SimState:
    """Initial carry of every scenario; ``keys`` is (B, 2). Each leaf
    has the reference's type in its mode: under x64 the queues,
    ``node_on`` and every accumulator are float64 (the reference makes
    them without a dtype), the flow table's ``ft_rem``/``ft_cwnd`` stay
    float32, and integers and flags keep their types."""
    s = hull
    R, P = s.n_racks, s.csw_per_cluster
    NC, RPC, NF = s.n_csw, s.racks_per_cluster, s.n_fc
    dev = keys.device
    B = keys.shape[0]
    g = scen.gating_enabled
    _, _, _, rsw_max, csw_max = _site_masks(hull, scen)

    def tier_gate(n, links, pin):
        # gating on: stage floor 1; off: every REAL link up, pinned
        # there (padded links beyond the site's own never power on)
        base = gating.gate_init(B * n, links, dev)
        base = gating.GateState(*(x.reshape((B, n) + x.shape[1:])
                                  for x in base))
        stage = torch.where(g[:, None], base.stage, pin)
        powered = torch.where(
            g[:, None, None], base.powered,
            torch.arange(links, device=dev) < pin[..., None])
        return base._replace(stage=stage, powered=powered)

    def fault(n, links):
        f = gating.fault_init(B * n, links, dev)
        return gating.FaultState(f.timer.reshape(B, n, links),
                                 f.wake.reshape(B, n))

    def zeros(*shape, dtype=_float_dtype(x64)):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    FT = C.FLOW_TABLE_SLOTS
    return SimState(
        key=keys,
        burst_on=torch.ones((B, R), dtype=torch.bool, device=dev),
        flow_rem=zeros(R, F_SLOTS, dtype=torch.int32),
        flow_dest=zeros(R, F_SLOTS, dtype=torch.int32),
        flow_fast=zeros(R, F_SLOTS, dtype=torch.bool),
        tick=zeros(dtype=torch.int32),
        ft_start=zeros(R, FT, dtype=torch.int32),
        ft_rem=zeros(R, FT, dtype=torch.float32),
        ft_size=zeros(R, FT, dtype=torch.int32),
        ft_dst=zeros(R, FT, dtype=torch.int32),
        ft_cwnd=zeros(R, FT, dtype=torch.float32),
        rsw_q=zeros(R, P, 2),
        csw_up_q=zeros(NC, s.csw_uplinks),
        csw_down_q=zeros(NC, RPC),
        fc_down_q=zeros(NF, NC),
        rsw_gate=tier_gate(R, P, rsw_max),
        csw_gate=tier_gate(NC, s.csw_uplinks, csw_max),
        rsw_fault=fault(R, P),
        csw_fault=fault(NC, s.csw_uplinks),
        node_on=zeros(R),
        acc=_zero_acc(B, dev, x64),
    )


# the reference's compiled code turns a division by a constant into a
# product with the reciprocal in the dividend's type; these are those
# reciprocals (float32, and float64 for the x64 packet sizes)
_PER_PKT = float(np.float32(1.0 / 1250.0))          # bytes -> packets
_PER_PKT64 = 1.0 / 1250.0
_PER_IDLE = float(np.float32(1.0 / NODE_IDLE_TICKS))


def _spawn_flows(scen: Scenario, u, z, rack_valid, burst_on, flow_rem,
                 flow_dest, flow_fast):
    """Per-rack flow arrivals: Bernoulli spawn into the first free slot.

    ``u`` (B, R, 5+F_SLOTS) and ``z`` (B, R, 2) are the rack's uniform
    and normal draws of this tick (keyed by its LOGICAL id, see
    ``make_sim_step``), float64 under x64: the float32 knobs meet them
    in float64 there, as in the reference. Returns the updated flow
    state plus this tick's per-flow pace uniforms (B, R, F_SLOTS).
    """
    def col(x):
        return x[:, None]

    # ON/OFF burst Markov
    stay_on = u[..., 0] > col(scen.p_on_off)
    wake = u[..., 1] < col(scen.p_off_on)
    burst_on = torch.where(burst_on, stay_on, wake)

    # padded hull rows never spawn; with the flow engine selected
    # (flow_mode=1) the rate-based table never fills
    spawn = (u[..., 2] < col(scen.p_spawn)) & burst_on & rack_valid \
        & col(scen.flow_mode == 0)

    # lognormal mixture sizes -> packets (1250 B per packet)
    pick_mix = u[..., 3] < col(scen.size_w)
    size_b = torch.where(
        pick_mix,
        torch.exp(fma(col(scen.size_s1), z[..., 0], col(scen.size_mu1))),
        torch.exp(fma(col(scen.size_s2), z[..., 1], col(scen.size_mu2))))
    per_pkt = _PER_PKT64 if size_b.dtype == torch.float64 else _PER_PKT
    size_p = torch.clamp(torch.ceil(size_b * per_pkt), min=1.0) \
        .to(torch.int32)

    ud = u[..., 4]
    dest = _dest_class(ud, scen)

    free = flow_rem == 0
    first_free = torch.argmax(free.to(torch.int32), dim=2)     # (B,R)
    has_free = torch.any(free, dim=2)
    do = spawn & has_free
    # dense one-hot slot update instead of a scatter
    slot = do[..., None] & (
        torch.arange(F_SLOTS, device=u.device) == first_free[..., None])
    flow_rem = flow_rem + torch.where(slot, size_p[..., None], 0)
    flow_dest = torch.where(slot, dest[..., None], flow_dest)
    fast = size_p >= col(scen.elephant_pkts)
    flow_fast = torch.where(slot, fast[..., None], flow_fast)
    return burst_on, flow_rem, flow_dest, flow_fast, u[..., 5:]


def _dest_class(ud, scen: Scenario):
    """Destination class of uniform(s) ``ud`` (B, R): 0=rack,
    1=cluster, 2=inter-cluster."""
    p_r = scen.p_intra_rack[:, None]
    p_c = (scen.p_intra_rack + scen.p_intra_cluster)[:, None]
    return torch.where(ud < p_r, 0, torch.where(ud < p_c, 1, 2)) \
        .to(torch.int32)


class _Draws(NamedTuple):
    """One tick's random draws, every one from the reference's stream."""
    u_rack: torch.Tensor   # (B, R, 5+F_SLOTS) traffic-edge uniforms
    z_rack: torch.Tensor   # (B, R, 2) flow-size normals
    u_fr: torch.Tensor     # (B, R, 2+MAX_FAULT_LINKS) RSW fault block
    u_fc: torch.Tensor     # (B, NC, 2+MAX_FAULT_LINKS) CSW fault block
    u_pl_cl: torch.Tensor  # (B, NCL, MAX_FAULT_LINKS) RSW plane hazards
    u_pc: torch.Tensor     # (B, MAX_FAULT_LINKS) CSW plane hazards
    u_arr: torch.Tensor    # (B, R, 2) flow-engine arrival + destination
    u_size: torch.Tensor   # (B, R, MAX_INCAST_DEGREE) flow-engine sizes


# fold_in branches of the tick key (constants far above any logical
# switch id): RSW faults, CSW faults, RSW planes, CSW planes, flow
# arrivals, flow sizes
_BRANCHES = (0x7F000001, 0x7F000002, 0x7F000005, 0x7F000006,
             0x7F000003, 0x7F000004)


class _DrawPlan:
    """The tick's key tree as four batched threefry hashes.

    The reference derives, per tick: ``key, k_u, k_z = split(key, 3)``;
    six branch keys ``fold_in(k_u, c)``; per-switch keys
    ``fold_in(branch, logical id)``; and fixed-width uniform blocks from
    each. Here each level is ONE hash over every key of that level, so
    a tick costs four hash calls whatever the site size. Under x64
    (``x64=True``) the uniforms are float64 from 64 random bits each,
    as ``jax.random.uniform`` draws them there: one hash a value too,
    both of its output words kept (``prng.counter_words``).
    """

    def __init__(self, hull: FBSite, rack_uid, csw_uid,
                 partitionable: bool = True, x64: bool = False):
        self.partitionable = partitionable
        self.x64 = x64
        R, NC, NCL = hull.n_racks, hull.n_csw, hull.n_clusters
        dev = rack_uid.device
        B = rack_uid.shape[0]
        W = MAX_FAULT_LINKS
        self.branches = torch.tensor(_BRANCHES, dtype=torch.int64,
                                     device=dev)
        # level 3: (index into [k_u, k_z, fr, fc, pr, pc, fa, fs], ids)
        segs = [(0, rack_uid), (1, rack_uid), (2, rack_uid),
                (3, csw_uid), (4, torch.arange(NCL, device=dev)
                               .expand(B, NCL)),
                (6, rack_uid), (7, rack_uid)]
        self.l3_base = torch.cat([
            torch.full((d.shape[1],), i, dtype=torch.int64, device=dev)
            for i, d in segs])
        self.l3_data = torch.cat([d.to(torch.int64) for _, d in segs], 1)
        # level 4: (keys, width) blocks in level-3 order, then k_pc
        blocks = [(R, 5 + F_SLOTS), (R, 2), (R, 2 + W), (NC, 2 + W),
                  (NCL, W), (R, 2), (R, C.MAX_INCAST_DEGREE), (1, W)]
        key_idx, words, off = [], [], 0
        for n, w in blocks:
            key_idx.append(torch.arange(off, off + n, device=dev)
                           .repeat_interleave(w))
            x1, x2, take2 = prng.counter_words(w, partitionable, dev,
                                               64 if x64 else 32)
            if take2 is None:
                take2 = torch.zeros_like(x1, dtype=torch.bool)
            words.append(torch.stack([x1, x2, take2.long()]).repeat(1, n))
            off += n
        self.key_idx = torch.cat(key_idx)
        x1, x2, take2 = torch.cat(words, dim=1)
        self.words = (x1, x2, None if partitionable or x64
                      else take2.bool())
        self.blocks = blocks

    def draw(self, key):
        """(new key (B, 2), _Draws) of tick key(s) ``key`` (B, 2)."""
        B = key.shape[0]
        keys3 = prng.split(key, 3, self.partitionable)
        k_u, k_z = keys3[:, 1], keys3[:, 2]
        br = prng.fold_in(k_u[:, None, :], self.branches)      # (B, 6, 2)
        base = torch.cat([k_u[:, None], k_z[:, None], br], 1)   # (B, 8, 2)
        l3 = prng.fold_in(base[:, self.l3_base], self.l3_data)
        l4 = torch.cat([l3, base[:, 5:6]], 1)[:, self.key_idx]
        if self.x64:
            u = prng.words_to_unit64(
                *prng.hash_counters64(l4, *self.words[:2]))
        else:
            u = prng.bits_to_unit(prng.hash_counters(l4, *self.words))
        parts, off = [], 0
        for n, w in self.blocks:
            parts.append(u[:, off:off + n * w].reshape(B, n, w))
            off += n * w
        u_rack, u_z, u_fr, u_fc, u_pl, u_arr, u_size, u_pc = parts
        return keys3[:, 0], _Draws(
            u_rack, prng.unit_to_normal(u_z), u_fr, u_fc, u_pl,
            u_pc[:, 0], u_arr, u_size)


def _sum_in_order(x, dim: int):
    """``x`` summed over ``dim`` one term after another in index order,
    each partial sum rounded in ``x``'s type: the order in which XLA's
    CPU backend reduces a row, which ``torch.sum`` does not keep."""
    x = x.movedim(dim, 0)
    s = x[0]
    for v in x[1:]:
        s = s + v
    return s


def _flat(x):
    """(B, S, ...) -> (B*S, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _flat_gate(g):
    return type(g)(*(_flat(x) for x in g))


def _unflat_gate(g, B: int):
    return type(g)(*(x.reshape((B, -1) + tuple(x.shape[1:])) for x in g))


def make_sim_step(hull: FBSite, scen: Scenario, *,
                  threefry_partitionable: bool = True, x64: bool = False):
    """One tick for every scenario of ``scen`` (leaves (B,), on the
    device the step runs on) on the static padded ``hull``: returns
    ``step(state) -> state``. Everything derived from the scenarios
    alone (site masks, logical ids, per-row knob columns, the PRNG
    plan) is built here once instead of every tick.
    ``threefry_partitionable`` picks JAX's threefry counter scheme
    (see core/prng.py). ``x64`` steps a state of ``_init_state(...,
    x64=True)`` the way the reference steps its state under
    ``JAX_ENABLE_X64=1``: float64 draws, and float64 wherever they or
    the float64 leaves meet float32 operands (PyTorch promotes a
    float32 and a float64 tensor with dims as JAX does; no operand
    here is a 0-d tensor, whose type PyTorch would not promote)."""
    s = hull
    NCL, RPC = s.n_clusters, s.racks_per_cluster
    P = s.csw_per_cluster     # plane axis: RSW uplink c IS cluster-CSW c
    NF = s.n_fc
    CUP = s.csw_uplinks       # == NF (FBSite invariant: uplink f -> FC f)
    R, NC = s.n_racks, s.n_csw
    FT = C.FLOW_TABLE_SLOTS
    if P > MAX_FAULT_LINKS or CUP > MAX_FAULT_LINKS:
        raise ValueError(f"hull link axes ({P}, {CUP}) exceed the fixed "
                         f"fault-draw width MAX_FAULT_LINKS="
                         f"{MAX_FAULT_LINKS}")
    dev = scen.ncl.device
    B = scen.ncl.shape[0]
    f32 = torch.float32

    rack_valid, csw_valid, rack_uid, rsw_max, csw_max = \
        _site_masks(hull, scen)
    rpcf = scen.rpc.to(f32)
    nclf = scen.ncl.to(f32)
    nc_idx = torch.arange(NC, device=dev)
    csw_uid = ((nc_idx // P)[None, :] * scen.cpc[:, None]
               + (nc_idx % P)[None, :]).to(torch.int32)
    plan = _DrawPlan(hull, rack_uid, csw_uid, threefry_partitionable, x64)
    link_idx_p = torch.arange(P, device=dev)
    link_idx_c = torch.arange(CUP, device=dev)
    rsw_link_real = rack_valid[..., None] & (link_idx_p
                                             < rsw_max[..., None])
    csw_link_real = csw_valid[..., None] & (link_idx_c
                                            < csw_max[..., None])
    size_tab, prob_tab = workloads.cdf_tables(scen.flow_dist, dev)
    g_on = scen.gating_enabled                              # (B,)

    def rows(x, n):
        # per-scenario knob -> per-switch-row column of a (B*n) tier
        return x.repeat_interleave(n)

    def tier_knobs(n):
        return dict(cap=rows(scen.queue_cap, n), hi=rows(scen.hi, n),
                    lo=rows(scen.lo, n))

    rsw_kn, csw_kn = tier_knobs(R), tier_knobs(NC)

    def gate_knobs(n):
        return dict(dwell=rows(scen.dwell, n),
                    wake_fail_prob=rows(scen.wake_fail_prob, n),
                    wake_jitter_frac=rows(scen.wake_jitter_frac, n),
                    fallback=rows(scen.fault_fallback, n))

    rsw_gk, csw_gk = gate_knobs(R), gate_knobs(NC)
    g_rsw, g_csw = rows(g_on, R), rows(g_on, NC)
    fault_kn = dict(fault_prob=scen.fault_prob[:, None, None],
                    repair_ticks=scen.repair_ticks[:, None, None],
                    plane_fail_prob=scen.plane_fail_prob[:, None, None])
    cpcf = scen.cpc.to(f32)
    nfcf = scen.nfc.to(f32)
    # gated-link population of the REAL site:
    # ncl*rpc*cpc (RSW-CSW) + ncl*cpc*nfc (CSW-FC)
    n_gated = nclf * cpcf * (rpcf + nfcf)
    base_i = STACK_US + 4.0 * WIRE_HOP_US
    slot_i = torch.arange(FT, device=dev)
    usable_slot = slot_i[None, None, :] < scen.flow_cap[:, None, None]
    cand = torch.arange(C.MAX_INCAST_DEGREE, device=dev)
    plane_i = torch.arange(P, device=dev)
    cup_i = torch.arange(CUP, device=dev)
    nf_i = torch.arange(NF, device=dev)
    bins4 = torch.arange(4, device=dev)
    # The flow engine's per-rack emissions are float32 sums of
    # fractional rates over the FT table slots, and they feed the
    # queues: a batch with the flow engine on sums them in the
    # reference's order, one slot after another (FT - 1 more small ops
    # a tick; the set-up reads the knob once). In another order their
    # last bits differ, and under heavy faults the queues' watermark
    # decisions amplify that over a run (ROADMAP Queue 3). The
    # tick's other float32 sums over racks go to accumulators only; the
    # reference's compiled code vectorizes those in shape-dependent
    # orders (tests/test_torch_x64.py says which).
    ordered = bool(torch.any(scen.flow_mode > 0))

    def col(x):
        return x[:, None]

    def sel(new, old, on):
        # per-row gating select over every GateState leaf
        return type(new)(*(torch.where(on.reshape((-1,) + (1,) * (a.dim()
                                                               - 1)), a, b)
                           for a, b in zip(new, old)))

    def step(state: SimState) -> SimState:
        acc = dict(state.acc)

        def add(k, v):
            acc[k] = acc[k] + v

        key, dr = plan.draw(state.key)
        u_plane_r = dr.u_pl_cl[:, :, None, :P].expand(B, NCL, RPC, P) \
            .reshape(B, R, P)
        u_plane_c = dr.u_pc[:, None, :CUP].expand(B, NC, CUP)
        rsw_ok = state.rsw_fault.timer == 0                 # (B,R,P)
        csw_ok = state.csw_fault.timer == 0                 # (B,NC,CUP)

        # 1. traffic edge ------------------------------------------------
        burst_on, flow_rem, flow_dest, flow_fast, pace_u = _spawn_flows(
            scen, dr.u_rack, dr.z_rack, rack_valid, state.burst_on,
            state.flow_rem, state.flow_dest, state.flow_fast)
        active = flow_rem > 0                                  # (B,R,F)
        # paced emission: mice trickle below line rate (boosted during
        # bursts); elephants transmit at line rate
        pace_eff = torch.clamp(
            col(scen.pace) * torch.where(burst_on,
                                         col(scen.burst_pace_boost), 1.0),
            max=1.0)[..., None]
        pace_flow = torch.where(flow_fast, scen.elephant_pace[:, None, None],
                                pace_eff)
        emit = active & (pace_u < pace_flow)
        n_holding = torch.sum(active, dim=2).to(f32)           # (B,R)
        by_dest = torch.stack(
            [torch.sum(emit & (flow_dest == d), dim=2) for d in (0, 1, 2)],
            dim=2).to(f32)                                      # (B,R,3)
        flow_rem = torch.clamp(flow_rem - emit.to(torch.int32), min=0)

        # 1b. flow-level workload engine (flow_mode=1), selected against
        # the rate-based edge by torch.where so flow_mode=0 is untouched
        flow_on = scen.flow_mode > 0                            # (B,)
        tick_now = state.tick + 1
        arrive = (dr.u_arr[..., 0] < col(scen.flow_rate)) & rack_valid \
            & col(flow_on)
        n_new = torch.where(arrive, col(scen.incast), 0)        # (B,R)
        sizes = workloads.sample_from_tables(      # float32 uniforms,
            dr.u_size.to(f32), size_tab, prob_tab)  # as the reference's
        fdst = _dest_class(dr.u_arr[..., 1], scen)              # (B,R)
        # admission: match candidate k to the k-th usable free slot;
        # overflow is EVICTION (counted)
        pre_live = (state.ft_rem > 0.0) & usable_slot           # (B,R,FT)
        free = ~pre_live & usable_slot
        rank = torch.cumsum(free.to(torch.int32), dim=2) - 1
        want = cand < n_new[..., None]                          # (B,R,W)
        place = (free[..., None] & (rank[..., None] == cand)
                 & want[:, :, None, :])                         # (B,R,FT,W)
        admitted = torch.any(place, dim=2)                      # (B,R,W)
        placed = torch.any(place, dim=3)                        # (B,R,FT)
        new_sz = torch.sum(torch.where(place, sizes[:, :, None, :], 0.0),
                           dim=3)                               # (B,R,FT)
        # AIMD on the PREVIOUS tick's live flows: halve on the rack's
        # hi-watermark signal (previous tick's RSW queues), additive
        # increase toward line rate otherwise
        cong, _ = gating.watermark_triggers(
            _flat(torch.sum(state.rsw_q, dim=3)),
            _flat(state.rsw_gate.stage), **rsw_kn)
        cong = cong.reshape(B, R)
        ft_cwnd = torch.where(
            pre_live,
            torch.where(cong[..., None],
                        torch.clamp(state.ft_cwnd * C.FLOW_AIMD_DECREASE,
                                    min=C.FLOW_CWND_MIN_PPT),
                        torch.clamp(state.ft_cwnd
                                    + C.FLOW_AIMD_INCREASE_PPT,
                                    max=C.FLOW_LINE_RATE_PPT)),
            state.ft_cwnd)
        ft_start = torch.where(placed, tick_now[:, None, None],
                               state.ft_start)
        ft_rem = torch.where(placed, new_sz, state.ft_rem)
        ft_size = torch.where(placed, new_sz.to(torch.int32), state.ft_size)
        ft_dst = torch.where(placed, fdst[..., None], state.ft_dst)
        ft_cwnd = torch.where(placed, C.FLOW_CWND_INIT_PPT, ft_cwnd)
        # emission: every live flow sends min(rem, cwnd) this tick
        ft_live = (ft_rem > 0.0) & usable_slot
        emit_f = torch.where(ft_live, torch.minimum(ft_rem, ft_cwnd), 0.0)
        ft_rem = ft_rem - emit_f
        done = ft_live & (ft_rem <= 0.0)                        # (B,R,FT)
        if ordered:
            per_dest = torch.stack([torch.where(ft_dst == d, emit_f, 0.0)
                                    for d in (0, 1, 2)], dim=2)  # (B,R,3,FT)
            by_dest = torch.where(flow_on[:, None, None],
                                  _sum_in_order(per_dest, 3), by_dest)
        n_holding = torch.where(col(flow_on),
                                torch.sum(ft_live, dim=2).to(f32),
                                n_holding)
        add("flows_started", torch.sum(n_new, dim=1).to(f32))
        add("flows_evicted", (torch.sum(n_new, dim=1)
                              - torch.sum(admitted, dim=(1, 2))).to(f32))

        add("injected", torch.sum(by_dest[..., 1:], dim=(1, 2)))
        add("intra_rack", torch.sum(by_dest[..., 0], dim=1))

        # 2+3+5. both switch tiers in one call (one CUDA kernel launch on
        # the card): the RSW datapath tick, min-backlog enqueue of the
        # [intra, inter] arrival split + 1 pkt/tick serve per active
        # uplink, on flat (B*R, P, 2) rows; the served packets summed per
        # cluster-CSW (uplink c of rack r lands on CSW (cluster(r), c));
        # the CSW uplink datapath tick (40G: 4 pkt/tick) -> FC on flat
        # (B*NC, CUP) rows, fed the inter share. Valid masks are per
        # LINK: hull padding AND hard-faulted transceivers.
        tiers = ops.switch_tiers(
            state.rsw_q, state.rsw_gate.stage, state.rsw_gate.draining,
            state.rsw_fault.timer, rack_valid, by_dest[..., 1:],
            state.csw_up_q, state.csw_gate.stage, state.csw_gate.draining,
            state.csw_fault.timer, csw_valid, scen.queue_cap, acc)
        acc.update(tiers.acc)
        rsw_q, rsw_wait, to_csw = tiers.rsw_q, tiers.rsw_wait, tiers.to_csw
        csw_up_q, csw_wait = tiers.csw_q, tiers.csw_wait
        inter_in = to_csw[..., 1].reshape(B, NC)

        # stage-aware down-plane weights: traffic for rack r rides plane
        # c with weight active(r,c)/stage(r); padded rows weigh zero
        rsw_stage = state.rsw_gate.stage
        plane_w = (plane_i < rsw_stage[..., None]) \
            / rsw_stage.to(f32)[..., None] * rack_valid[..., None]
        plane_w_c = plane_w.reshape(B, NCL, RPC, P)

        # 4. CSW: intra-cluster traffic -> down queues; the CSW ring is
        # charged for the up-plane / down-plane mismatch
        intra_cl = torch.sum(to_csw[..., 0], dim=2)             # (B,NCL)
        dest_share = (intra_cl / col(rpcf))[:, :, None, None] \
            * plane_w_c.transpose(2, 3)                         # (B,NCL,P,RPC)
        csw_down_q = state.csw_down_q + dest_share.reshape(B, NC, RPC)
        up_share = to_csw[..., 0] / torch.clamp(intra_cl[..., None],
                                                min=1e-9)
        mean_down = torch.sum(plane_w_c, dim=2) / rpcf[:, None, None]
        same_plane = torch.sum(torch.minimum(up_share, mean_down), dim=2)
        add("ring_pkts", torch.sum(intra_cl * (1.0 - same_plane), dim=1))

        # uplink f of csw c lands on FC f; the FC routes traffic for
        # cluster k down an ACTIVE (f, c') plane of that cluster
        fc_in = tiers.fc_in                                     # (B,CUP)
        csw_stage = state.csw_gate.stage
        fc_w = (cup_i < csw_stage[..., None]) \
            / csw_stage.to(f32)[..., None]                      # (B,NC,CUP)
        # csw c's share of its cluster's down traffic
        csw_share = (torch.sum(plane_w_c, dim=2)
                     / rpcf[:, None, None]).reshape(B, NC)
        # total inter-cluster down traffic splits over the REAL clusters
        down_cl = torch.sum(fc_in, dim=1) / nclf                # (B,)
        fc_down_add = down_cl[:, None, None] * csw_share[:, None, :] \
            * fc_w.transpose(1, 2)                              # (B,NF,NC)
        fc_down_q = state.fc_down_q + fc_down_add

        # 6. FC down serve: link (f,c) active iff csw stage[c] > f AND
        # csw c's uplink-f transceiver is healthy; residue on an
        # inactive/dead plane rides the FC ring to the f=0 plane
        fc_active = (nf_i[None, :, None] < csw_stage[:, None, :]) \
            & csw_ok.transpose(1, 2)                            # (B,NF,NC)
        fserve = torch.clamp(fc_down_q, max=4.0) * fc_active
        fc_down_q = fc_down_q - fserve
        stranded = torch.where(~fc_active, fc_down_q, 0.0)
        st_tot = torch.sum(stranded, dim=(1, 2))
        mig = torch.minimum(st_tot, scen.fc_ring)
        mfrac = (mig / torch.clamp(st_tot, min=1e-9))[:, None, None]
        moved_fc = stranded * mfrac
        fc_down_q = fc_down_q - moved_fc
        fc_down_q = torch.cat(
            [fc_down_q[:, :1] + torch.sum(moved_fc, dim=1, keepdim=True),
             fc_down_q[:, 1:]], dim=1)
        add("fc_ring_pkts", mig)
        add("fc_backlog", torch.sum(state.fc_down_q, dim=(1, 2)))
        add("fc_served", torch.sum(fserve, dim=(1, 2)))

        # FC-served packets land on csw c -> its down queues, weighted by
        # each rack's active planes
        per_csw_down = torch.sum(fserve, dim=1)                 # (B,NC)
        pw_cr = plane_w_c.transpose(2, 3).reshape(B, NC, RPC)
        row_w = torch.sum(pw_cr, dim=2)                         # (B,NC)
        pw_norm = pw_cr / torch.clamp(row_w[..., None], min=1e-9)
        routable = row_w > 0.0
        csw_down_q = csw_down_q + \
            torch.where(routable, per_csw_down, 0.0)[..., None] * pw_norm
        # FC backlog for a plane no rack rides any more rides the
        # cluster ring to the always-on plane 0 (conservation)
        orphan = torch.where(routable, 0.0, per_csw_down)       # (B,NC)
        orphan_cl = torch.sum(orphan.reshape(B, NCL, P), dim=2)  # (B,NCL)
        dest0 = pw_norm.reshape(B, NCL, P, RPC)[:, :, 0, :]     # (B,NCL,RPC)
        dq = csw_down_q.reshape(B, NCL, P, RPC)
        dq = torch.cat([(dq[:, :, 0] + orphan_cl[..., None] * dest0)
                        [:, :, None], dq[:, :, 1:]], dim=2)
        add("ring_pkts", torch.sum(orphan_cl, dim=1))

        # 7. CSW down serve: link (r, c) active iff rsw stage[r] > c AND
        # rack r's uplink-c transceiver is healthy; stranded traffic
        # rides the cluster ring to c=0
        rsw_stage_c = rsw_stage.reshape(B, NCL, RPC)
        rsw_ok_pl = rsw_ok.reshape(B, NCL, RPC, P).transpose(2, 3)
        down_act = (plane_i[None, None, :, None]
                    < rsw_stage_c[:, :, None, :]) & rsw_ok_pl  # (B,NCL,P,RPC)
        dserve = torch.clamp(dq, max=1.0) * down_act
        dq = dq - dserve
        stranded_d = torch.where(~down_act, dq, 0.0)
        tot_str = torch.sum(stranded_d, dim=(2, 3))             # (B,NCL)
        migd = torch.minimum(tot_str, col(scen.csw_ring))
        dfrac = (migd / torch.clamp(tot_str, min=1e-9))[..., None, None]
        moved = stranded_d * dfrac
        dq = dq - moved
        dq = torch.cat([dq[:, :, :1] + torch.sum(moved, dim=2, keepdim=True),
                        dq[:, :, 1:]], dim=2)
        csw_down_q = dq.reshape(B, NC, RPC)
        add("ring_pkts", torch.sum(migd, dim=1))
        add("csw_down_backlog", torch.sum(state.csw_down_q, dim=(1, 2)))
        delivered_r = torch.sum(dserve, dim=2).reshape(B, R)
        add("csw_down_served", torch.sum(dserve, dim=(1, 2, 3)))

        # 8. node-level link gating (OS intercept: zero latency cost)
        need = torch.minimum(n_holding + delivered_r, col(scen.spr))
        if x64:
            # the decrement is a float32 product, the subtraction float64
            idle = state.node_on - col(scen.spr) * _PER_IDLE
        else:
            idle = fma(col(-scen.spr), torch.full_like(state.node_on,
                                                       _PER_IDLE),
                       state.node_on)
        node_on = torch.maximum(need, idle)
        add("node_on", torch.sum(node_on, dim=1))

        # 8.5 in-scan delay sampling: one sample per rack per
        # destination class for the packets injected THIS tick
        down_rc = csw_down_q.reshape(B, NCL, P, RPC).transpose(2, 3) \
            .reshape(B, R, P)
        down_wait = torch.sum(plane_w * down_rc, dim=2)         # (B,R)
        win = inter_in.reshape(B, NCL, P)
        win_tot = torch.clamp(torch.sum(win, dim=2), min=1e-9)

        def cl_avg(x):
            # arrival-weighted per-cluster mean over the cluster's CSWs
            return torch.sum(win * x.reshape(B, NCL, P), dim=2) / win_tot

        w_csw_cl = cl_avg(csw_wait)
        fc_cap = 4.0 * torch.sum((fc_active & csw_valid[:, None, :])
                                 .to(f32), dim=(1, 2))
        fc_wait = torch.sum(fc_down_q, dim=(1, 2)) \
            / torch.clamp(fc_cap, min=1e-9)
        # wake + fault-forced stalls through the ONE attribution seam;
        # both exactly 0 when gating is off
        stall_rsw, fstall_rsw = (x.reshape(B, R) for x in
                                 gating.stall_attribution(
                                     _flat_gate(state.rsw_gate),
                                     _flat_gate(state.rsw_fault), g_rsw))
        stall_csw, fstall_csw = (x.reshape(B, NC) for x in
                                 gating.stall_attribution(
                                     _flat_gate(state.csw_gate),
                                     _flat_gate(state.csw_fault), g_csw))
        stall_csw_cl = cl_avg(stall_csw)
        fstall_csw_cl = cl_avg(fstall_csw)

        def per_rack(x_cl):                        # (B,NCL) -> (B,R)
            return x_cl[..., None].expand(B, NCL, RPC).reshape(B, R)

        wt_i, wt_x = by_dest[..., 1], by_dest[..., 2]  # intra-cl / inter
        q_i = rsw_wait + down_wait                     # queue-wait parts
        q_x = q_i + per_rack(w_csw_cl) + col(fc_wait)
        s_i = stall_rsw                                # wake-stall parts
        s_x = stall_rsw + per_rack(stall_csw_cl)
        f_i = fstall_rsw                               # fault-stall parts
        f_x = fstall_rsw + per_rack(fstall_csw_cl)
        d_i = base_i + q_i + s_i + f_i
        d_x = base_i + 2.0 * WIRE_HOP_US + q_x + s_x + f_x
        hist = _delay_hist_add(acc["delay_hist"], d_i, wt_i)
        acc["delay_hist"] = _delay_hist_add(hist, d_x, wt_x)

        def wsum(w, x):
            return torch.sum(w * x, dim=1)

        add("delay_sum", wsum(wt_i, d_i) + wsum(wt_x, d_x))
        add("delay_wt", torch.sum(wt_i, dim=1) + torch.sum(wt_x, dim=1))
        add("delay_wt_inter", torch.sum(wt_x, dim=1))
        add("delay_queue_sum", wsum(wt_i, q_i) + wsum(wt_x, q_x))
        add("delay_stall_sum", wsum(wt_i, s_i) + wsum(wt_x, s_x))
        add("delay_fault_sum", wsum(wt_i, f_i) + wsum(wt_x, f_x))
        add("wake_stall_pkts", wsum(wt_i, s_i > 0) + wsum(wt_x, s_x > 0))
        add("fault_stall_pkts", wsum(wt_i, f_i > 0) + wsum(wt_x, f_x > 0))

        # 8.6 flow completion times (every weight exactly 0 at
        # flow_mode=0): table residence + this tick's path-delay sample
        wdone = done.to(f32)                                    # (B,R,FT)
        residence = (tick_now[:, None, None] - ft_start + 1).to(f32)
        path_us = torch.where(
            ft_dst == 2, d_x[..., None],
            torch.where(ft_dst == 1, d_i[..., None], STACK_US))
        fct_us = residence * C.TICK_US + path_us
        ideal_base = torch.where(
            ft_dst == 2, base_i + 2.0 * WIRE_HOP_US,
            torch.where(ft_dst == 1, base_i, STACK_US))
        ideal_us = workloads.ideal_fct_us(ft_size, ideal_base)
        slow = fct_us / ideal_us
        cls = workloads.flow_size_class(ft_size)                # (B,R,FT)
        fct_flat = fct_us.reshape(B, -1)
        slow_flat = slow.reshape(B, -1)
        fct_rows, slow_rows = [], []
        for c in range(3):
            wc = (wdone * (cls == c)).reshape(B, -1)
            fct_rows.append(_delay_hist_add(
                acc["fct_hist"][:, c], fct_flat, wc,
                min_val=C.FCT_HIST_MIN_US, bpo=C.FCT_HIST_BINS_PER_OCTAVE,
                bins=C.FCT_HIST_BINS))
            slow_rows.append(_delay_hist_add(
                acc["fct_slow_hist"][:, c], slow_flat, wc,
                min_val=C.FCT_SLOWDOWN_HIST_MIN,
                bpo=C.FCT_SLOWDOWN_HIST_BINS_PER_OCTAVE,
                bins=C.FCT_SLOWDOWN_HIST_BINS))
        acc["fct_hist"] = torch.stack(fct_rows, dim=1)
        acc["fct_slow_hist"] = torch.stack(slow_rows, dim=1)
        add("flows_completed", torch.sum(wdone, dim=(1, 2)))
        add("fct_sum", torch.sum(fct_us * wdone, dim=(1, 2)))
        add("fct_slow_sum", torch.sum(slow * wdone, dim=(1, 2)))

        # 9a. hard-fault evolution FIRST (LC/DC and always-on alike):
        # arrivals on powered healthy real links, repair countdown, and
        # the dying link's queued packets move to the fault-drop bin
        rsw_timer, rsw_new_f = gating.fault_arrivals(
            state.rsw_fault.timer, dr.u_fr[..., 2:2 + P],
            state.rsw_gate.powered, rsw_link_real,
            fault_kn["fault_prob"], fault_kn["repair_ticks"],
            plane_u=u_plane_r, plane_fail_prob=fault_kn["plane_fail_prob"])
        csw_timer, csw_new_f = gating.fault_arrivals(
            state.csw_fault.timer, dr.u_fc[..., 2:2 + CUP],
            state.csw_gate.powered, csw_link_real,
            fault_kn["fault_prob"], fault_kn["repair_ticks"],
            plane_u=u_plane_c, plane_fail_prob=fault_kn["plane_fail_prob"])
        add("fault_drops",
            torch.sum(torch.where(rsw_new_f[..., None], rsw_q, 0.0),
                      dim=(1, 2, 3))
            + torch.sum(torch.where(csw_new_f, csw_up_q, 0.0), dim=(1, 2)))
        rsw_q = torch.where(rsw_new_f[..., None], 0.0, rsw_q)
        csw_up_q = torch.where(csw_new_f, 0.0, csw_up_q)
        add("fault_link_ticks", torch.sum(rsw_timer > 0, dim=(1, 2))
            + torch.sum(csw_timer > 0, dim=(1, 2)))

        # 9b. the controllers, fault-aware; the monitors watch all
        # output queues (uplinks and the down-plane pressure)
        rsw_gated, rsw_fwake, rsw_diag = gating.gate_step(
            _flat_gate(state.rsw_gate),
            _flat(torch.maximum(torch.sum(rsw_q, dim=3), down_rc)),
            **rsw_kn, **rsw_gk, max_stage=_flat(rsw_max),
            link_ok=_flat(rsw_timer == 0), link_real=_flat(rsw_link_real),
            u_jitter=_flat(dr.u_fr[..., 0]), u_fail=_flat(dr.u_fr[..., 1]),
            fault_wake=_flat(state.rsw_fault.wake))
        csw_gated, csw_fwake, csw_diag = gating.gate_step(
            _flat_gate(state.csw_gate),
            _flat(torch.maximum(csw_up_q, fc_down_q.transpose(1, 2))),
            **csw_kn, **csw_gk, max_stage=_flat(csw_max),
            link_ok=_flat(csw_timer == 0), link_real=_flat(csw_link_real),
            u_jitter=_flat(dr.u_fc[..., 0]), u_fail=_flat(dr.u_fc[..., 1]),
            fault_wake=_flat(state.csw_fault.wake))

        rsw_gate = _unflat_gate(
            sel(rsw_gated, _flat_gate(state.rsw_gate), g_rsw), B)
        csw_gate = _unflat_gate(
            sel(csw_gated, _flat_gate(state.csw_gate), g_csw), B)
        # the fallback (and its stall) only exists under gating
        rsw_fwake = torch.where(g_rsw, rsw_fwake, 0).reshape(B, R)
        csw_fwake = torch.where(g_csw, csw_fwake, 0).reshape(B, NC)
        add("wake_retries", torch.where(
            g_on, torch.sum(rsw_diag["retries"].reshape(B, R), dim=1)
            + torch.sum(csw_diag["retries"].reshape(B, NC), dim=1), 0))
        add("forced_wakes", torch.where(
            g_on, torch.sum(rsw_diag["forced"].reshape(B, R), dim=1)
            + torch.sum(csw_diag["forced"].reshape(B, NC), dim=1), 0))

        # 9c. min-connectivity audit on the END-of-tick state: a valid
        # switch with a healthy real link but zero usable ones
        rsw_healthy = (rsw_timer == 0) & rsw_link_real
        csw_healthy = (csw_timer == 0) & csw_link_real
        rsw_usable_f = gating.usable_links(
            _flat(rsw_gate.stage), _flat(rsw_gate.draining), P) \
            .reshape(B, R, P) & rsw_healthy
        csw_usable_f = gating.usable_links(
            _flat(csw_gate.stage), _flat(csw_gate.draining), CUP) \
            .reshape(B, NC, CUP) & csw_healthy
        add("conn_loss_rack_ticks", torch.sum(
            rack_valid & torch.any(rsw_healthy, dim=2)
            & ~torch.any(rsw_usable_f, dim=2), dim=1))
        add("conn_loss_csw_ticks", torch.sum(
            csw_valid & torch.any(csw_healthy, dim=2)
            & ~torch.any(csw_usable_f, dim=2), dim=1))

        # power accounting: a hard-faulted transceiver draws nothing
        rsw_pow = torch.sum(rack_valid[..., None] & (rsw_timer == 0)
                            & rsw_gate.powered, dim=(1, 2))
        csw_pow = torch.sum(csw_valid[..., None] & (csw_timer == 0)
                            & csw_gate.powered, dim=(1, 2))
        add("rsw_powered", rsw_pow)
        add("csw_powered", csw_pow)
        frac_on = (rsw_pow + csw_pow) / n_gated
        add("half_off_ticks", frac_on <= 0.5)
        add("on_frac_hist", bins4 == on_frac_bucket(frac_on)[:, None])

        return SimState(key, burst_on, flow_rem, flow_dest, flow_fast,
                        tick_now, ft_start, ft_rem, ft_size, ft_dst,
                        ft_cwnd, rsw_q, csw_up_q, csw_down_q, fc_down_q,
                        rsw_gate, csw_gate,
                        gating.FaultState(rsw_timer, rsw_fwake),
                        gating.FaultState(csw_timer, csw_fwake),
                        node_on, acc)

    return step


def _fold_flat(acc: dict):
    """The accumulators as one (B, N) buffer of their type (float32, or
    float64 under x64), ACC_SHAPES order."""
    B = acc["injected"].shape[0]
    return torch.cat([acc[k].reshape(B, -1) for k in ACC_SHAPES], dim=1)


def _unfold_flat(flat: np.ndarray) -> dict:
    out, off = {}, 0
    for k, shp in ACC_SHAPES.items():
        n = int(np.prod(shp, dtype=np.int64))
        out[k] = flat[:, off:off + n].reshape((flat.shape[0],) + shp)
        off += n
    return out


def _leaf_pairs(dst, src):
    """(dst leaf, src leaf) tensor pairs of two states of one structure
    (SimState, its NamedTuple parts and the accumulator dict), in
    ``dst``'s order."""
    if isinstance(dst, torch.Tensor):
        yield dst, src
    elif isinstance(dst, dict):
        for k in dst:
            yield from _leaf_pairs(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            yield from _leaf_pairs(d, s)


def step_into(step, static: SimState) -> None:
    """One tick of ``step`` written back into ``static``'s tensors in
    place: the form of the tick a CUDA graph replays, since a replayed
    graph reads and writes fixed buffers. Runs on any device and leaves
    ``static`` bit-identical to ``step(static)``. The copies go one
    batched copy per dtype."""
    groups = {}
    for d, s in _leaf_pairs(static, step(static)):
        if d is not s:
            dl, sl = groups.setdefault(d.dtype, ([], []))
            dl.append(d)
            sl.append(s)
    for dl, sl in groups.values():
        torch._foreach_copy_(dl, sl)


class _TickGraph:
    """The sweep tick as one CUDA graph over the static state ``static``.

    The first ``run`` runs the run's first tick eagerly on a side stream
    (torch's capture recipe: it loads every kernel and warms the
    allocator, and it is a real tick, so the run does not shift), then
    captures ONE tick of ``step_into`` and replays it for every later
    tick. A capture that meets an op syncing with the host raises; there
    is no eager fallback. Replays credit the switch kernel's
    ``LAUNCHES`` with the launches the graph holds.

    The tick's intermediates live in the graph's private memory pool:
    its owner keeps the graph alive until the replays queued against it
    are done (freeing the pool earlier would hand memory they still
    write to other work).
    """

    def __init__(self, step, static: SimState):
        self.step, self.static = step, static
        self.graph = None
        self.launches = 0          # switch kernel launches per replay

    def run(self, n: int) -> None:
        """Advance ``static`` by ``n`` ticks."""
        global CAPTURE_COUNT
        if n > 0 and self.graph is None:
            lcdc_switch.load_tiers(self.static.rsw_q.dtype)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step_into(self.step, self.static)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            before = lcdc_switch.CAPTURED
            with torch.cuda.graph(self.graph):
                step_into(self.step, self.static)
            self.launches = lcdc_switch.CAPTURED - before
            CAPTURE_COUNT += 1
            n -= 1
        for _ in range(n):
            self.graph.replay()
        lcdc_switch.credit_replays(n * self.launches,
                                   self.static.rsw_q.dtype)


class SweepValidationError(RuntimeError):
    """Raised by ``validate=True`` sweeps when the chunk-boundary guards
    (finite values / conservation, see ``run_sweep``) tripped. Carries
    ``labels`` (the failing scenarios) and ``first_bad_chunk`` (the
    earliest chunk index at which any of them first failed)."""

    def __init__(self, labels, first_bad_chunk):
        self.labels = tuple(labels)
        self.first_bad_chunk = int(first_bad_chunk)
        super().__init__(
            f"sweep validation failed for scenario(s) {list(labels)} "
            f"(first failing chunk: {first_bad_chunk})")


#: test hook for the fault-tolerant planned executor: when set, called
#: as ``BUCKET_FAIL_HOOK(bucket_index, phase)`` with phase in
#: {"dispatch", "fetch", "retry"} before the corresponding stage of
#: each bucket; raising from it simulates a bucket failure
BUCKET_FAIL_HOOK = None

#: preemption-injection seam for the durable executor: when set, called
#: as ``CHUNK_HOOK(chunk_index)`` at the top of every chunk-loop
#: iteration (before that chunk is dispatched); raising from it
#: simulates a crash/preemption at an exact chunk boundary
CHUNK_HOOK = None

#: replaceable sleep used by the retry-backoff loop, so tests can pin the
#: exact backoff sequence without waiting wall-clock time
RETRY_SLEEP = time.sleep


@dataclass(frozen=True)
class BucketRetryPolicy:
    """Retry/deadline policy for ``run_sweep_planned`` bucket failures.

    The default is ONE serial retry on the conservative path
    (``fold="host"``, eager ticks), immediately, with no deadline.
    ``backoff_s(r)`` is the sleep before retry attempt ``r`` (1-based):
    ``min(backoff_base_s * backoff_mult**(r-1), backoff_max_s)``, or 0
    when ``backoff_base_s`` is 0 (no sleep). ``deadline_s`` bounds each
    bucket's cumulative wall-clock time across its attempts: once
    exceeded, remaining retries are abandoned and the bucket degrades to
    a structured error entry. The deadline never discards finished work:
    a bucket that completed (however slowly) keeps its results; only
    further RETRIES are cut off.
    """
    max_retries: int = 1
    backoff_base_s: float = 0.0
    backoff_mult: float = 2.0
    backoff_max_s: float = 60.0
    deadline_s: float | None = None

    def __post_init__(self):
        def bad(msg):
            raise ValueError(f"BucketRetryPolicy: {msg}")
        if self.max_retries < 0:
            bad(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base_s < 0.0:
            bad(f"backoff_base_s must be >= 0, got {self.backoff_base_s}")
        if self.backoff_mult < 1.0:
            bad(f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if self.backoff_max_s < 0.0:
            bad(f"backoff_max_s must be >= 0, got {self.backoff_max_s}")
        if self.deadline_s is not None and self.deadline_s < 0.0:
            bad(f"deadline_s must be >= 0, got {self.deadline_s}")

    def backoff_s(self, attempt: int) -> float:
        """Sleep (seconds) before 1-based retry ``attempt``."""
        if self.backoff_base_s <= 0.0:
            return 0.0
        return min(self.backoff_base_s * self.backoff_mult ** (attempt - 1),
                   self.backoff_max_s)


def _use_graph(graph, dev: torch.device) -> bool:
    """Whether a run on ``dev`` replays its tick from a CUDA graph:
    ``graph=None`` means yes on a CUDA device."""
    if graph is None:
        return dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {dev}")
    return bool(graph)


def _carry_tensors(state: SimState, fold, guard) -> dict:
    """The carry a checkpoint holds, by the reference's member names:
    ``state`` plus JAX's key path of each ``SimState`` leaf
    (``state.rsw_q``, ``state.rsw_gate.stage``,
    ``state.acc['injected']``), ``fold_sum/<k>`` and ``fold_comp/<k>``
    (views into the flat fold buffers) and ``guard``."""
    out = {}
    _map_carry(state, lambda name, t: out.setdefault(name, t))
    if fold is not None:
        for d, flat in zip(("fold_sum", "fold_comp"), fold):
            for k, v in _unfold_flat(flat).items():
                out[f"{d}/{k}"] = v
    if guard is not None:
        out["guard"] = guard
    return out


def _map_carry(x, fn, name="state"):
    """``x`` (a SimState, its NamedTuple parts, the accumulator dict)
    with ``fn(name, leaf)`` applied to every tensor leaf, named as
    JAX's ``keystr`` names the reference's leaves."""
    if isinstance(x, torch.Tensor):
        return fn(name, x)
    if isinstance(x, dict):
        return {k: _map_carry(v, fn, f"{name}[{k!r}]") for k, v in x.items()}
    return type(x)(*(_map_carry(v, fn, f"{name}.{f}")
                     for f, v in zip(x._fields, x)))


class _Stash(NamedTuple):
    """A carry cloned on the device at a chunk boundary: what a
    checkpoint of that boundary writes once the next chunk is queued."""
    chunk_index: int
    tensors: dict          # member name -> device clone
    ready: object          # CUDA event after the clones (None on the CPU)


def _stash(ci: int, state: SimState, fold, guard) -> _Stash:
    """Clone the carry at boundary ``ci`` on the device, in stream order
    after the chunk that ends there: the next chunk's replays overwrite
    the state buffers in place, so the snapshot must not alias them."""
    tensors = {n: t.clone() for n, t in
               _carry_tensors(state, fold, guard).items()}
    ready = None
    if state.key.is_cuda:
        ready = torch.cuda.Event()
        ready.record()
    return _Stash(ci, tensors, ready)


def _fetch_stash(snap: _Stash) -> dict:
    """The stash's tensors as host numpy arrays: ONE transfer. On the
    card the copies run on a side stream that waits only for the clones,
    so they overlap the chunk queued behind them on the sweep's stream
    (a copy on that stream would wait for its replays)."""
    ts = list(snap.tensors.values())
    if snap.ready is None:
        host = ts
    else:
        side = torch.cuda.Stream(ts[0].device)
        side.wait_event(snap.ready)
        with torch.cuda.stream(side):
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    .copy_(t, non_blocking=True) for t in ts]
        side.synchronize()
    return {n: h.numpy() for n, h in zip(snap.tensors, host)}


def _snapshot_sweep(spec: CheckpointSpec, batch: ScenarioBatch,
                    snap: _Stash, *, n_ticks: int, chunk: int,
                    validate: bool, tol, threefry_partitionable: bool,
                    plan_meta: dict | None = None):
    """Write one checkpoint of a running sweep's carry (stashed by
    ``_stash``): one host transfer (``HOST_TRANSFER_COUNT``, so a
    checkpointed run's count is exactly ``1 + n_checkpoints``), then an
    atomic write in the reference's format, with the port's threefry
    scheme as one more meta key. The arrays keep their types, so an x64
    run writes float64 leaves and fold buffers and ``fold_dtype:
    "float64"``, as the reference does under x64."""
    global HOST_TRANSFER_COUNT
    arrays = _fetch_stash(snap)
    HOST_TRANSFER_COUNT += 1
    # the port holds the threefry key words in int64; the format (and
    # the reference) hold them as uint32
    arrays["state.key"] = arrays["state.key"].astype(np.uint32)
    for name, leaf in zip(Scenario._fields, batch.scen):
        arrays[f"scen/{name}"] = leaf.numpy()
    meta = {
        "sim_schema": SIM_SCHEMA_VERSION,
        "fault_knobs": list(FAULT_KNOBS),
        "flow_knobs": list(FLOW_KNOBS),
        "scenario_fields": list(Scenario._fields),
        "fold_dtype": str(snap.tensors["fold_sum/injected"].dtype)
        .removeprefix("torch."),
        "n_ticks": int(n_ticks), "chunk_ticks": int(chunk),
        "chunk_index": int(snap.chunk_index), "n_real": len(batch),
        "validate": bool(validate),
        "validate_tol": float(tol) if tol is not None else None,
        "hull": dataclasses.asdict(batch.hull),
        "sites": [dataclasses.asdict(s) for s in batch.sites],
        "names": list(batch.names), "labels": list(batch.labels),
        "gating": [bool(g) for g in batch.gating],
        "seeds": [int(s) for s in batch.seeds],
        "plan": plan_meta, "tag": spec.tag,
        "threefry_partitionable": bool(threefry_partitionable),
    }
    path = _ckpt.write_checkpoint(spec.path_for(snap.chunk_index), meta,
                                  arrays)
    _ckpt.prune(spec)
    return path


@dataclass
class _PendingSweep:
    """A dispatched-but-not-fetched sweep: every chunk is queued on the
    device; what is left is the fold fetch in ``_finish_sweep``. It
    holds the run's tick graph, so the graph's pool outlives the
    replays queued against it."""
    batch: ScenarioBatch
    n_ticks: int
    state: SimState              # the final carry, on the device
    fold: tuple | None           # flat (B, N) (sum, comp), float32 or
    #                              float64 (x64)
    acc64: np.ndarray | None     # host float64 (B, N) (fold="host")
    guard: torch.Tensor | None   # (B,) int32 first failing chunk, or -1
    guard_h: np.ndarray | None   # the guard as the host fold last saw it
    ticks: _TickGraph | None

    def release(self) -> None:
        """Wait for the queued replays, then drop the tick graph."""
        if self.ticks is not None:
            torch.cuda.synchronize(self.state.key.device)
            self.ticks = None


def _prepare_sweep_args(batch: ScenarioBatch, dev: torch.device, *,
                        fold: str = "device", validate: bool = False,
                        validate_tol: float | None = None,
                        x64: bool = False):
    """A fresh run's operands on ``dev``: the scenario leaves, the
    initial carry, the zeroed Kahan fold buffers (``fold="device"``, of
    the accumulators' type: float64 under x64) and the validate guard
    and tolerance (float32 in both modes, as the reference's). Returns
    ``(scen, state, dev_fold, guard, tol)``."""
    scen = Scenario(*(x.to(dev) for x in batch.scen))
    state = _init_state(batch.hull, scen,
                        prng.key(batch.seeds, device=dev, x64=x64), x64)
    dev_fold = None
    if fold == "device":
        fsum = torch.zeros_like(_fold_flat(state.acc))
        dev_fold = (fsum, torch.zeros_like(fsum))
    guard = tol = None
    if validate:
        guard = torch.full((len(batch),), -1, dtype=torch.int32,
                           device=dev)
        tol = float(np.float32(C.VALIDATE_CONS_REL_TOL
                               if validate_tol is None else validate_tol))
    return scen, state, dev_fold, guard, tol


def _guard_chunk(scen: Scenario, state: SimState, dev_fold, guard, ci: int,
                 tol: float):
    """The validate guards at the end of chunk ``ci`` (eager ops, no
    host sync): per scenario, finite queues; on the device fold finite
    running totals and the two conservation identities within ``tol``
    relative, on the host fold finite chunk accumulators. Scenarios
    failing a check for the first time record ``ci``."""
    B = guard.shape[0]

    def finite(arrs):
        ok = torch.ones((B,), dtype=torch.bool, device=guard.device)
        for a in arrs:
            ok = ok & torch.all(torch.isfinite(a.reshape(B, -1)), dim=1)
        return ok

    queues = (state.rsw_q, state.csw_up_q, state.csw_down_q, state.fc_down_q)
    ok = finite(queues)
    if dev_fold is not None:
        flat = dev_fold[0] - dev_fold[1]
        ok = ok & finite((flat,))
        tot = _unfold_flat(flat)
        in_flight = sum(torch.sum(q.reshape(B, -1), dim=1) for q in queues)
        inj = tot["injected"]
        # injected == delivered + drops + fault_drops + in-flight
        resid = inj - (tot["csw_down_served"] + tot["drops"]
                       + tot["fault_drops"] + in_flight)
        ok = ok & (torch.abs(resid) <= tol * torch.clamp(inj, min=1.0))
        # started == completed + evicted + live usable table slots
        usable = torch.arange(C.FLOW_TABLE_SLOTS, device=guard.device) \
            < scen.flow_cap[:, None, None]
        in_table = torch.sum((state.ft_rem > 0.0) & usable, dim=(1, 2))
        started = tot["flows_started"]
        fresid = started - (tot["flows_completed"] + tot["flows_evicted"]
                            + in_table.to(started.dtype))
        ok = ok & (torch.abs(fresid)
                   <= tol * torch.clamp(started, min=1.0))
    else:
        ok = ok & finite(tuple(state.acc.values()))
    return torch.where((guard < 0) & ~ok, ci, guard)


def _guard_column(guard, flat):
    """The (B,) int32 guard as one more (B, 1) column of ``flat``'s type,
    so it rides the fold's single host transfer and comes back exactly:
    a float32 fold carries the guard's bits (a float32 view of the
    int32 words), a float64 fold its values (float64 holds every int32
    exactly; a view would need two float32 words a row)."""
    if flat.dtype == torch.float64:
        return guard.to(torch.float64)[:, None]
    return guard.view(torch.float32)[:, None]


def _guard_from_column(col: np.ndarray) -> np.ndarray:
    """``_guard_column``'s host copy back to the int32 guard."""
    if col.dtype == np.float64:
        return col.astype(np.int32)
    return col.copy().view(np.int32)


def _dispatch_chunks(batch: ScenarioBatch, scen: Scenario, state: SimState,
                     dev_fold, guard, tol, *, n_ticks: int, chunk: int,
                     fold: str, validate: bool, graph: bool,
                     threefry_partitionable: bool, x64: bool = False,
                     start_chunk: int = 0,
                     checkpoint: CheckpointSpec | None = None,
                     plan_meta: dict | None = None) -> _PendingSweep:
    """THE chunk loop, shared by ``_start_sweep`` (fresh runs, from chunk
    0) and ``resume_sweep`` (from the checkpoint's chunk index), so a
    resumed run runs exactly the ticks and boundaries the fresh run would
    have from there. ``chunk`` is the EFFECTIVE chunk length
    (``max(1, min(chunk_ticks, n_ticks))``); a checkpoint records it and
    resume reuses it.

    Each chunk queues its ticks (graph replays, or eager steps), then the
    fold (device: Kahan into ``dev_fold``; host: one fetch of the chunk's
    accumulators, the guard riding along, folded into float64), then the
    guards, then re-zeroes the accumulators.

    Checkpointing (``checkpoint`` set; device fold only) snapshots the
    carry at every ``every_chunks`` boundary, DEFERRED BY ONE CHUNK: the
    carry is cloned on the device at boundary ``ci`` and written only
    after chunk ``ci`` (the next one) has been queued, so the card has
    work while the host fetches and serializes. The final boundary is
    never snapshotted (the run is finished, not resumable, there).
    """
    global HOST_TRANSFER_COUNT
    step = make_sim_step(batch.hull, scen,
                         threefry_partitionable=threefry_partitionable,
                         x64=x64)
    ticks = _TickGraph(step, state) if graph else None
    acc64 = guard_h = None
    done = start_chunk * chunk
    ci = start_chunk
    pending_snap = None
    try:
        while done < n_ticks:
            if CHUNK_HOOK is not None:
                CHUNK_HOOK(ci)
            n = min(chunk, n_ticks - done)
            if ticks is not None:
                ticks.run(n)               # the graph's state buffers
            else:
                for _ in range(n):
                    state = step(state)
            flat = _fold_flat(state.acc)
            if dev_fold is not None:
                # Kahan: sum carries the running total, comp the rounding
                # error still to subtract
                fsum, fcomp = dev_fold
                y = flat - fcomp
                t = fsum + y
                dev_fold = (t, (t - fsum) - y)
            if validate:
                guard = _guard_chunk(scen, state, dev_fold, guard, ci, tol)
            if fold == "host":
                # one fetch of this chunk's accumulators (the guard as an
                # extra column, see _guard_column), folded in float64
                if guard is not None:
                    flat = torch.cat([flat, _guard_column(guard, flat)],
                                     dim=1)
                host = flat.cpu().numpy()
                HOST_TRANSFER_COUNT += 1
                N = host.shape[1] - (guard is not None)
                if acc64 is None:
                    acc64 = np.zeros((host.shape[0], N), np.float64)
                acc64 += host[:, :N].astype(np.float64)
                if guard is not None:
                    guard_h = _guard_from_column(host[:, N])
            torch._foreach_zero_(list(state.acc.values()))
            ci += 1
            done += n
            if pending_snap is not None:
                _snapshot_sweep(checkpoint, batch, pending_snap,
                                n_ticks=n_ticks, chunk=chunk,
                                validate=validate, tol=tol,
                                threefry_partitionable=threefry_partitionable,
                                plan_meta=plan_meta)
                pending_snap = None
            if (checkpoint is not None and done < n_ticks
                    and ci % checkpoint.every_chunks == 0):
                pending_snap = _stash(ci, state, dev_fold, guard)
    except BaseException:
        # the graph dies with this frame: let its queued replays finish
        if ticks is not None:
            torch.cuda.synchronize(state.key.device)
        raise
    return _PendingSweep(batch=batch, n_ticks=n_ticks, state=state,
                         fold=dev_fold, acc64=acc64, guard=guard,
                         guard_h=guard_h, ticks=ticks)


def _start_sweep(batch: ScenarioBatch, n_ticks: int, *,
                 chunk_ticks: int = CHUNK_TICKS, fold: str = "device",
                 validate: bool = False, validate_tol: float | None = None,
                 checkpoint: CheckpointSpec | None = None,
                 plan_meta: dict | None = None, device=None,
                 threefry_partitionable: bool = True, x64: bool = False,
                 graph=None) -> _PendingSweep:
    """Queue a sweep's chunks without fetching results.

    With ``fold="device"`` (default) on the card this returns once the
    last chunk is queued (the host runs ahead of the card by up to the
    launch queue's depth). ``fold="host"`` synchronizes at every chunk
    boundary.

    ``checkpoint`` (a :class:`CheckpointSpec`) snapshots the carry at
    the spec's chunk cadence; device fold only (the host path already
    synchronizes per chunk, so checkpointing it would pin a second fetch
    discipline for no benefit).
    """
    if fold not in ("device", "host"):
        raise ValueError(f"fold must be 'device' or 'host', got {fold!r}")
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    if checkpoint is not None and fold != "device":
        raise ValueError(
            "checkpointing requires the device-resident fold "
            f"(fold='device'); got fold={fold!r}")
    dev = resolve_device(device)
    use_graph = _use_graph(graph, dev)
    scen, state, dev_fold, guard, tol = _prepare_sweep_args(
        batch, dev, fold=fold, validate=validate, validate_tol=validate_tol,
        x64=x64)
    return _dispatch_chunks(
        batch, scen, state, dev_fold, guard, tol, n_ticks=n_ticks,
        chunk=max(1, min(chunk_ticks, n_ticks)), fold=fold,
        validate=validate, graph=use_graph,
        threefry_partitionable=threefry_partitionable, x64=x64,
        checkpoint=checkpoint, plan_meta=plan_meta)


def _finish_sweep(p: _PendingSweep, return_state: bool = False):
    """Fetch a queued sweep's fold buffer (the run's single host transfer
    on the device fold: the sum, the compensation and the guard as one
    more column, ``_guard_column``, in one copy) and finalize
    per-scenario metrics. A ``validate=True`` sweep whose guards tripped
    raises ``SweepValidationError`` here."""
    global HOST_TRANSFER_COUNT
    guard_h = p.guard_h
    if p.fold is not None:
        fsum, fcomp = p.fold
        parts = [fsum, fcomp]
        if p.guard is not None:
            parts.append(_guard_column(p.guard, fsum))
        host = torch.cat(parts, dim=1).cpu().numpy()
        HOST_TRANSFER_COUNT += 1
        N = fsum.shape[1]
        acc64 = host[:, :N].astype(np.float64) \
            - host[:, N:2 * N].astype(np.float64)
        if p.guard is not None:
            guard_h = _guard_from_column(host[:, 2 * N])
    else:
        acc64 = p.acc64
    p.release()                    # the fetch waited for every replay
    batch = p.batch
    if guard_h is not None:
        bad = [i for i in range(len(batch)) if int(guard_h[i]) >= 0]
        if bad:
            raise SweepValidationError(
                [batch.labels[i] for i in bad],
                min(int(guard_h[i]) for i in bad))
    acc64 = _unfold_flat(acc64)
    res = [
        _finalize({k: v[i] for k, v in acc64.items()}, batch.sites[i],
                  p.n_ticks, batch.gating[i], batch.names[i],
                  batch.labels[i])
        for i in range(len(batch))
    ]
    if return_state:
        return res, _to_cpu(p.state)
    return res


def run_sweep(batch: ScenarioBatch, n_ticks: int, *,
              chunk_ticks: int = CHUNK_TICKS, return_state: bool = False,
              fold: str = "device", validate: bool = False,
              validate_tol: float | None = None,
              checkpoint: CheckpointSpec | None = None,
              device=None, threefry_partitionable: bool = True,
              graph=None, x64: bool = False):
    """Run every scenario of ``batch`` for n_ticks us; returns one
    metrics dict per scenario (the reference's schema, with the
    scenario ``label``). With ``return_state=True`` also returns the
    final state (leaves batched over scenarios, on the CPU).

    Ticks run in chunks of ``chunk_ticks`` (the last one may be
    shorter). ``fold="device"`` (default) folds the accumulators at
    every chunk boundary into a Kahan ``(sum, comp)`` buffer on the
    device (float32, float64 with ``x64``), as the reference's device
    fold does, and
    makes ONE host transfer of results, the final fetch of that buffer
    (``HOST_TRANSFER_COUNT``). ``fold="host"`` fetches each chunk's
    accumulators and folds them in float64 on the host (one transfer a
    chunk; within 1e-6 of the device fold). ``device=None`` means CUDA.

    ``validate=True`` runs guards at every chunk boundary (eager ops
    after the chunk's ticks, no host sync): per scenario, finite queues
    and, on the device fold, finite running totals and the conservation
    identities injected == delivered + drops + fault_drops + in-flight
    and started == completed + evicted + in-table within
    ``validate_tol`` (relative; default ``C.VALIDATE_CONS_REL_TOL``); on
    the host fold, finite chunk accumulators. A tripped guard raises
    ``SweepValidationError`` at fetch time, naming the failing scenario
    labels and the FIRST failing chunk index. The (B,) int32 guard rides
    the fold fetch, so it adds no transfer (and no capture); a clean
    pass changes no result.

    ``checkpoint`` (a :class:`CheckpointSpec`; device fold only)
    snapshots the full carry at the spec's chunk cadence so an
    interrupted run restarts from ``resume_sweep(path)`` bit-identically.
    Checkpointing only observes the run; each snapshot adds one host
    transfer (``HOST_TRANSFER_COUNT`` becomes ``1 + n_checkpoints``).

    ``threefry_partitionable`` picks JAX's threefry counter scheme: True
    (the default of the JAX release the reference pins) draws what the
    reference draws today; False draws what it drew under the older
    default, the scheme ``tests/data/preflow_golden.json["results"]``
    was captured with.

    ``graph`` picks how ticks run on a CUDA device: True (the default
    there) captures one tick as a CUDA graph and replays it for every
    later tick (one capture per run, ``CAPTURE_COUNT``); False runs
    every tick eagerly, op by op, as the CPU does (for comparisons).
    Both give the same results.

    ``x64=True`` runs the sweep as the reference runs it under
    ``JAX_ENABLE_X64=1`` (the default, False, is the reference's default
    mode): seeds are int64 (``prng.key``), every uniform and normal is
    float64 from 64 random bits, the queues, ``node_on`` and the
    accumulators are float64 (the flow table's float32 leaves stay
    float32), the device fold is a float64 Kahan pair, checkpoints are
    float64 files, and on the card the tick launches the float64
    ``switch_tiers`` kernel. It draws other numbers than the x32 mode,
    not just wider ones.
    """
    return _finish_sweep(
        _start_sweep(batch, n_ticks, chunk_ticks=chunk_ticks, fold=fold,
                     validate=validate, validate_tol=validate_tol,
                     checkpoint=checkpoint, device=device,
                     threefry_partitionable=threefry_partitionable,
                     x64=x64, graph=graph),
        return_state=return_state)


def resume_sweep(path, *, return_state: bool = False,
                 checkpoint: CheckpointSpec | None = None, device=None,
                 threefry_partitionable: bool | None = None, graph=None,
                 x64: bool = False):
    """Restart an interrupted sweep from a checkpoint file (written by
    this engine or by the reference) and run it to completion,
    bit-identically to the uninterrupted run of this engine.

    The checkpoint carries the full per-scenario carry at a chunk
    boundary plus the run geometry, so the remaining chunks run exactly
    the ticks and boundaries the original run would have (same
    effective chunk length, same per-tick ``fold_in`` PRNG streams). On
    the card the resumed run captures its own tick graph (one more
    ``CAPTURE_COUNT``). The draws use the threefry scheme the file
    records (a file without the key, as the reference writes it, means
    the partitionable scheme of the reference's jax); passing
    ``threefry_partitionable`` that disagrees with it is rejected. The
    x64 mode is the caller's, as the reference's process-wide mode is:
    ``x64`` must match the mode the file was written in.

    Raises :class:`CheckpointError` (reason naming the first mismatch:
    "format"/"checksum"/"ckpt_schema" from the file layer, "sim_schema",
    "fingerprint", "scenario_fields", "x64_mode" (the file's fold dtype
    is not this call's: float64 iff ``x64``), "threefry_scheme",
    "state_schema" from the engine checks) rather than resuming from a
    checkpoint this engine cannot reproduce. Pass ``checkpoint`` to KEEP
    checkpointing the resumed run at the same absolute chunk cadence.
    """
    meta, arrays = _ckpt.read_checkpoint(path)

    def reject(reason, detail):
        raise CheckpointError(reason, f"{path}: {detail}")

    if meta.get("sim_schema") != SIM_SCHEMA_VERSION:
        reject("sim_schema",
               f"written at SIM_SCHEMA_VERSION={meta.get('sim_schema')!r}"
               f", this engine is {SIM_SCHEMA_VERSION}")
    if meta.get("fault_knobs") != list(FAULT_KNOBS) \
            or meta.get("flow_knobs") != list(FLOW_KNOBS):
        reject("fingerprint",
               f"fault/flow knob inventory {meta.get('fault_knobs')!r}/"
               f"{meta.get('flow_knobs')!r} != this engine's "
               f"{list(FAULT_KNOBS)!r}/{list(FLOW_KNOBS)!r}")
    if meta.get("scenario_fields") != list(Scenario._fields):
        reject("scenario_fields",
               f"scenario leaves {meta.get('scenario_fields')!r} != "
               f"this engine's {list(Scenario._fields)!r}")
    fold_dtype = "float64" if x64 else "float32"
    if meta.get("fold_dtype") != fold_dtype:
        reject("x64_mode",
               f"written with fold dtype {meta.get('fold_dtype')!r} "
               f"(JAX_ENABLE_X64={meta.get('fold_dtype') == 'float64'}),"
               f" this call folds in {fold_dtype!r} (x64={x64})")
    recorded = bool(meta.get("threefry_partitionable", True))
    if threefry_partitionable is not None \
            and bool(threefry_partitionable) != recorded:
        reject("threefry_scheme",
               f"written with threefry_partitionable={recorded}, asked "
               f"to resume with {threefry_partitionable}")
    missing_scen = [f for f in Scenario._fields
                    if f"scen/{f}" not in arrays]
    if missing_scen:
        reject("scenario_fields",
               f"scenario leaf arrays missing: {missing_scen}")

    dev = resolve_device(device)
    hull = FBSite(**meta["hull"])
    batch = ScenarioBatch(
        scen=Scenario(**{f: torch.as_tensor(arrays[f"scen/{f}"])
                         for f in Scenario._fields}),
        hull=hull, sites=tuple(FBSite(**d) for d in meta["sites"]),
        names=tuple(meta["names"]), labels=tuple(meta["labels"]),
        gating=tuple(bool(g) for g in meta["gating"]),
        seeds=tuple(int(s) for s in meta["seeds"]))
    validate = bool(meta["validate"])
    scen, tmpl, dev_fold, guard, _ = _prepare_sweep_args(
        batch, dev, validate=validate, x64=x64)

    # place every saved leaf into the initial carry's structure: any
    # drift in the carry inventory (a missing, re-shaped or re-typed
    # leaf) is a structured rejection
    def load(name, t):
        if name not in arrays:
            reject("state_schema", f"carry array {name!r} missing")
        a = arrays[name]
        want = np.dtype(np.uint32) if name == "state.key" \
            else torch.empty((), dtype=t.dtype).numpy().dtype
        if tuple(a.shape) != tuple(t.shape) or a.dtype != want:
            reject("state_schema",
                   f"carry array {name!r} is {a.dtype}{a.shape}, this "
                   f"engine expects {want}{tuple(t.shape)}")
        return torch.as_tensor(a.astype(np.int64) if name == "state.key"
                               else a).to(dev)

    state = _map_carry(tmpl, load)
    folded = []
    for d in ("fold_sum", "fold_comp"):
        parts = {}
        for k, shp in ACC_SHAPES.items():
            name = f"{d}/{k}"
            if name not in arrays:
                reject("state_schema", f"fold buffer {name!r} missing")
            if tuple(arrays[name].shape) != (len(batch),) + shp:
                reject("state_schema",
                       f"fold buffer {name!r} is {arrays[name].shape}")
            parts[k] = torch.as_tensor(
                arrays[name].astype(fold_dtype)).to(dev)
        folded.append(_fold_flat(parts))
    dev_fold = tuple(folded)
    tol = None
    if validate:
        if "guard" not in arrays:
            reject("state_schema", "validate guard array missing")
        guard = torch.as_tensor(arrays["guard"].astype(np.int32)).to(dev)
        tol = float(np.float32(meta["validate_tol"]))

    pend = _dispatch_chunks(
        batch, scen, state, dev_fold, guard, tol,
        n_ticks=int(meta["n_ticks"]), chunk=int(meta["chunk_ticks"]),
        fold="device", validate=validate, graph=_use_graph(graph, dev),
        threefry_partitionable=recorded, x64=x64,
        start_chunk=int(meta["chunk_index"]), checkpoint=checkpoint,
        plan_meta=meta.get("plan"))
    return _finish_sweep(pend, return_state=return_state)


def run_sweep_planned(runs: Sequence[tuple[SimParams, int]], n_ticks: int,
                      *, max_compiles: int = 4,
                      chunk_ticks: int = CHUNK_TICKS,
                      return_plan: bool = False, fold: str = "device",
                      pipeline: bool = True, validate: bool = False,
                      validate_tol: float | None = None,
                      retry: BucketRetryPolicy | None = None,
                      checkpoint: CheckpointSpec | None = None,
                      device=None, threefry_partitionable: bool = True,
                      graph=None, x64: bool = False):
    """Run a heterogeneous-site sweep through the hull-bucketing planner
    (core/planner.py): the (SimParams, seed) pairs are partitioned into
    <= ``max_compiles`` hull buckets by estimated padded cost, each
    bucket runs as its own ``make_multi_site_batch`` + sweep (one tick
    capture per bucket on the card), and the per-scenario metric dicts
    come back in CALLER order, each annotated with its ``plan_bucket``
    index and ``plan_hull`` tag.

    With ``pipeline=True`` (default) every bucket's chunks are queued
    first, in the planner's ``dispatch_order`` (largest padded cost
    first), then results are fetched: one blocking transfer per bucket.
    (On the card the set-up of bucket k+1 still waits for bucket k's
    queued replays: its copies from pageable host memory and the graph
    capture synchronize, so the two modes take about the same time.)
    The pipeline keeps every bucket's state, fold buffers and tick graph
    resident at once; ``pipeline=False`` runs buckets strictly serially
    (dispatch + fetch per bucket, caller order, one bucket resident at a
    time) and gives bit-identical results.

    With ``return_plan=True`` also returns ``SweepPlan.report()``.
    ``max_compiles=1`` is the single-hull case, identical to
    ``run_sweep(make_multi_site_batch(runs), ...)``.

    Bucket failures are ISOLATED: a Python exception while dispatching
    or fetching one bucket (a scenario tripping ``validate`` guards, a
    failed graph capture, an out-of-memory error) never takes down the
    other buckets. The failed bucket is retried per the ``retry``
    policy (:class:`BucketRetryPolicy`; default ONE immediate retry, no
    deadline), each retry strictly serial in the most conservative
    mode: ``fold="host"`` and ``graph=False`` (eager ticks) on the SAME
    device (never the CPU instead of the card; the switch kernel still
    launches), with the policy's backoff between attempts and its
    ``deadline_s`` bounding each bucket's cumulative wall-clock time. On
    exhaustion that bucket's runs come back as structured error entries
    (``{"label", "plan_bucket", "plan_hull", "error": {"type",
    "message", "stage", "retried"}}``, ``stage`` the phase of the
    ORIGINAL failure, "dispatch" or "fetch", ``message`` the final
    attempt's) in caller order beside the other buckets' results. All
    pending buckets are drained (their replays waited for) even when a
    fetch raises. Isolation covers Python exceptions only: a sticky CUDA
    error (an illegal address, a device-side assert) poisons the CUDA
    context, and every later bucket and retry on it fails too.

    ``checkpoint`` checkpoints every bucket under a per-bucket tag
    (``<tag>-<plan.bucket_tag(k)>``), and an exhausted bucket carries
    ``error["checkpoint"]``: the path of its newest cadence snapshot, or
    a freshly written chunk-0 snapshot of its initial carry when it
    never reached a boundary (None only if even that write failed), so
    ``resume_sweep`` can finish it later.

    ``x64`` (see ``run_sweep``) holds for every bucket, its retries and
    its salvage checkpoints.
    """
    # local import, as the reference's: only the execution path needs
    # the planner
    from repro_torch.core import planner

    if checkpoint is not None and fold != "device":
        raise ValueError(
            "checkpointing requires the device-resident fold "
            f"(fold='device'); got fold={fold!r}")
    dev = resolve_device(device)
    runs = list(runs)
    plan = planner.plan_sites([p.site for p, _ in runs], max_compiles)
    order = plan.dispatch_order if pipeline \
        else tuple(range(len(plan.buckets)))
    policy = retry if retry is not None else BucketRetryPolicy()
    engine = dict(device=dev, threefry_partitionable=threefry_partitionable,
                  x64=x64)
    pending: dict[int, _PendingSweep] = {}
    fetched: dict[int, list] = {}
    errors: dict[int, dict] = {}
    elapsed: dict[int, float] = {}

    def hook(k, phase):
        if BUCKET_FAIL_HOOK is not None:
            BUCKET_FAIL_HOOK(k, phase)

    def timed(k, fn):
        # per-bucket wall-clock ledger: cumulative across the bucket's
        # dispatch, fetch and retry attempts; the policy's deadline_s
        # is checked against it before each retry
        t0 = time.monotonic()
        try:
            return fn()
        finally:
            elapsed[k] = elapsed.get(k, 0.0) + (time.monotonic() - t0)

    def bucket_batch(k):
        return make_multi_site_batch(
            [runs[i] for i in plan.buckets[k].indices])

    def bucket_spec(k):
        if checkpoint is None:
            return None
        return dataclasses.replace(
            checkpoint, tag=f"{checkpoint.tag}-{plan.bucket_tag(k)}")

    def bucket_plan_meta(k):
        return {"fingerprint": plan.fingerprint, "bucket": k,
                "hull": full_site_tag(plan.buckets[k].hull)}

    def salvage_checkpoint(k, spec_k):
        # a resumable artifact for the exhausted bucket: its newest
        # cadence snapshot if it reached a boundary, else a fresh
        # chunk-0 snapshot of its INITIAL carry (resuming that runs the
        # whole bucket). Best effort: None if even this fails.
        existing = _ckpt.latest_checkpoint(spec_k.directory, spec_k.tag)
        if existing is not None:
            return str(existing)
        try:
            batch = bucket_batch(k)
            _, state, dev_fold, guard, tol = _prepare_sweep_args(
                batch, dev, validate=validate, validate_tol=validate_tol,
                x64=x64)
            return str(_snapshot_sweep(
                spec_k, batch, _stash(0, state, dev_fold, guard),
                n_ticks=n_ticks, chunk=max(1, min(chunk_ticks, n_ticks)),
                validate=validate, tol=tol,
                threefry_partitionable=threefry_partitionable,
                plan_meta=bucket_plan_meta(k)))
        except Exception:                  # noqa: BLE001 — best effort
            return None

    def retry_bucket(k, stage, exc):
        # bounded retries on the most conservative path; on exhaustion
        # record a structured error for the bucket (stage = the
        # ORIGINAL failure's phase, message = the final failure's)
        last = exc
        retried = False
        for attempt in range(1, policy.max_retries + 1):
            if (policy.deadline_s is not None
                    and elapsed.get(k, 0.0) >= policy.deadline_s):
                break
            delay = policy.backoff_s(attempt)
            if delay > 0.0:
                RETRY_SLEEP(delay)
            retried = True

            def one_retry():
                hook(k, "retry")
                return _finish_sweep(_start_sweep(
                    bucket_batch(k), n_ticks, chunk_ticks=chunk_ticks,
                    fold="host", validate=validate,
                    validate_tol=validate_tol, graph=False, **engine))

            try:
                fetched[k] = timed(k, one_retry)
                return
            except Exception as exc2:      # noqa: BLE001 — isolation
                last = exc2
        errors[k] = {"type": type(last).__name__, "message": str(last),
                     "stage": stage, "retried": retried}
        spec_k = bucket_spec(k)
        if spec_k is not None:
            errors[k]["checkpoint"] = salvage_checkpoint(k, spec_k)

    def fetch(k):
        def go():
            hook(k, "fetch")
            return _finish_sweep(pending[k])

        try:
            fetched[k] = timed(k, go)
        except Exception as exc:           # noqa: BLE001 — isolation
            pending.pop(k).release()
            retry_bucket(k, "fetch", exc)
        else:
            pending.pop(k)

    try:
        for k in order:
            def dispatch(k=k):
                hook(k, "dispatch")
                return _start_sweep(
                    bucket_batch(k), n_ticks, chunk_ticks=chunk_ticks,
                    fold=fold, validate=validate,
                    validate_tol=validate_tol, checkpoint=bucket_spec(k),
                    plan_meta=bucket_plan_meta(k)
                    if checkpoint is not None else None, graph=graph,
                    **engine)

            try:
                ps = timed(k, dispatch)
            except Exception as exc:       # noqa: BLE001 — isolation
                retry_bucket(k, "dispatch", exc)
                continue
            pending[k] = ps
            if not pipeline:
                # strictly serial: fetch this bucket before the next
                # one is set up, and drop it (one bucket resident)
                fetch(k)
        for k in [k for k in order if k in pending]:
            fetch(k)
    finally:
        # a fetch that raised leaves its bucket queued: wait for the
        # replays before dropping the graphs and buffers they write
        for ps in pending.values():
            ps.release()
        pending.clear()
    results: list = [None] * len(runs)
    for k, bucket in enumerate(plan.buckets):
        # the FULL tag, the format of the plan report's bucket "hull"
        hull_tag = full_site_tag(bucket.hull)
        if k in fetched:
            for i, r in zip(bucket.indices, fetched[k]):
                r["plan_bucket"] = k
                r["plan_hull"] = hull_tag
                results[i] = r
        else:
            for i in bucket.indices:
                p, seed = runs[i]
                results[i] = {
                    "label": _run_label(p, seed, tag_site=True),
                    "plan_bucket": k, "plan_hull": hull_tag,
                    "error": dict(errors[k]),
                }
    if return_plan:
        return results, plan.report()
    return results


def run_sim(params: SimParams, n_ticks: int, seed: int = 0, *,
            device=None, threefry_partitionable: bool = True,
            graph=None, x64: bool = False) -> dict:
    """Run ONE scenario for n_ticks us; returns its aggregate metrics.

    The reference's single-scenario path (one scan, no fold): here a
    batch of one run in ONE chunk of ``n_ticks``, whose Kahan fold of a
    single chunk is the accumulators themselves, exactly. ``x64`` as in
    ``run_sweep``."""
    return run_sweep(make_batch([(params, seed)]), n_ticks,
                     chunk_ticks=n_ticks, device=device,
                     threefry_partitionable=threefry_partitionable,
                     graph=graph, x64=x64)[0]


def compare_traces(n_ticks: int = 200_000, seed: int = 0, traces=None, *,
                   device=None, threefry_partitionable: bool = True,
                   graph=None, x64: bool = False) -> dict:
    """LC/DC vs always-on across every modeled trace (Figs 8-10), as a
    single batched sweep (2 x |traces| scenarios); ``x64`` as in
    ``run_sweep``."""
    names = list(traces or TRAFFIC_SPECS)
    runs = []
    for name in names:
        spec = TRAFFIC_SPECS[name]
        runs.append((SimParams(spec=spec, gating_enabled=True), seed))
        runs.append((SimParams(spec=spec, gating_enabled=False), seed))
    res = run_sweep(make_batch(runs), n_ticks, device=device,
                    threefry_partitionable=threefry_partitionable,
                    graph=graph, x64=x64)
    out = {}
    for i, name in enumerate(names):
        lc, base = res[2 * i], res[2 * i + 1]
        out[name] = {
            "lcdc": lc, "baseline": base,
            "switch_energy_savings": lc["switch_energy_savings_frac"],
            "all_transceiver_savings": lc["all_transceiver_savings_frac"],
            "latency_penalty":
                lc["mean_latency_us"] / base["mean_latency_us"] - 1.0,
        }
    return out


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return type(x)(*(_to_cpu(v) for v in x))


def _hist_quantile(hist: np.ndarray, q: float,
                   edges: np.ndarray = DELAY_BIN_EDGES_US) -> float:
    """Quantile of a log-binned histogram (default frame:
    DELAY_BIN_EDGES_US; the flow engine passes its FCT / slowdown
    frames), log-linearly interpolated within the crossing bin."""
    total = float(np.sum(hist))
    if total <= 0.0:
        return 0.0
    cdf = np.cumsum(hist) / total
    i = min(int(np.searchsorted(cdf, q)), len(hist) - 1)
    lo_e, hi_e = edges[i], edges[i + 1]
    prev = float(cdf[i - 1]) if i > 0 else 0.0
    frac = (q - prev) / max(float(cdf[i]) - prev, 1e-12)
    frac = min(max(frac, 0.0), 1.0)
    if lo_e <= 0.0:                       # bin 0 is linear [0, MIN)
        return float(hi_e * frac)
    return float(lo_e * (hi_e / lo_e) ** frac)


def _finalize(a: dict, site: FBSite, n_ticks: int, gating_enabled: bool,
              trace: str, label: str | None = None) -> dict:
    """Aggregate accumulators -> the paper's metrics (one scenario;
    host numpy, identical to the reference's).

    ``site`` is the scenario's REAL site (not the batch hull): all link
    populations and power normalizations are the scenario's own.
    """
    s = site
    T = float(n_ticks)

    # ---- latency (Little's law per tier + fixed costs) -----------------
    def wait(backlog, served):
        return float(backlog / max(served, 1e-9))

    inj = max(float(a["injected"]), 1e-9)
    frac_inter = float(a["csw_up_served"]) / inj if inj else 0.0
    mean_wait = (
        wait(a["rsw_backlog"], a["rsw_served"])
        + wait(a["csw_down_backlog"], a["csw_down_served"])
        + frac_inter * (wait(a["csw_up_backlog"], a["csw_up_served"])
                        + wait(a["fc_backlog"], a["fc_served"])))
    ring_frac = float(a["ring_pkts"] + a["fc_ring_pkts"]) / inj
    hops = 4.0 + 2.0 * frac_inter + ring_frac
    mean_latency_us = STACK_US + hops * WIRE_HOP_US + mean_wait

    # ---- delay distribution + attribution (see module docstring) -------
    hist = np.asarray(a["delay_hist"], np.float64)
    wt = max(float(a["delay_wt"]), 1e-9)
    occ = {}
    for tier, n_ports in (("rsw", site.n_racks * site.rsw_uplinks),
                          ("csw", site.n_csw * site.csw_uplinks)):
        n = T * n_ports
        m1 = float(a[f"{tier}_occ_m1"]) / n
        occ[f"{tier}_occ_mean_pkts"] = m1
        occ[f"{tier}_occ_var_pkts"] = max(
            float(a[f"{tier}_occ_m2"]) / n - m1 * m1, 0.0)

    # ---- energy ---------------------------------------------------------
    pw = s.transceiver_power_w()
    rsw_on = float(a["rsw_powered"]) / (T * s.n_rsw_csw_links)
    csw_on = float(a["csw_powered"]) / (T * s.n_csw_fc_links)
    node_on = float(a["node_on"]) / (T * s.n_servers)
    if not gating_enabled:
        node_on = rsw_on = csw_on = 1.0

    # Fig 9 metric: the stage-gated switch-tier transceivers (RSW-CSW and
    # CSW-FC). Stage 1 never gates, so 75% is the ceiling.
    switch_w = pw["rsw_csw"] * rsw_on + pw["csw_fc"] * csw_on
    switch_total = pw["rsw_csw"] + pw["csw_fc"]
    switch_savings = 1.0 - switch_w / switch_total

    # All transceivers (feeds the Fig 11 whole-DC estimate): server links
    # gated by the node-level OS mechanism + switch tiers + always-on rings.
    power_w = pw["server"] * node_on + switch_w + pw["ring"]
    total_w = s.total_transceiver_power_w()

    return {
        "trace": trace,
        "label": label or trace,
        "gating": gating_enabled,
        "ticks": n_ticks,
        "mean_latency_us": mean_latency_us,
        "mean_wait_us": float(mean_wait),
        "wait_rsw_us": wait(a["rsw_backlog"], a["rsw_served"]),
        "wait_csw_up_us": wait(a["csw_up_backlog"], a["csw_up_served"]),
        "wait_csw_down_us": wait(a["csw_down_backlog"],
                                 a["csw_down_served"]),
        "wait_fc_us": wait(a["fc_backlog"], a["fc_served"]),
        "injected_pkts": float(a["injected"]),
        "delivered_pkts": float(a["csw_down_served"]),
        "drop_frac": float(a["drops"]) / inj,
        # availability under faults: delivered fraction, the fault-drop
        # conservation bin, wake-retry/fallback counts, and the
        # connectivity-loss audit (all exactly 0 with zero fault knobs)
        "delivered_frac": float(a["csw_down_served"]) / inj,
        "fault_drop_frac": float(a["fault_drops"]) / inj,
        "fault_dropped_pkts": float(a["fault_drops"]),
        "wake_retries": float(a["wake_retries"]),
        "forced_wakes": float(a["forced_wakes"]),
        "conn_loss_rack_ticks": float(a["conn_loss_rack_ticks"]),
        "conn_loss_csw_ticks": float(a["conn_loss_csw_ticks"]),
        "conn_loss_ticks": float(a["conn_loss_rack_ticks"]
                                 + a["conn_loss_csw_ticks"]),
        # fraction of gated-link-ticks spent hard-faulted (availability)
        "link_fault_frac": float(a["fault_link_ticks"])
        / (T * (s.n_rsw_csw_links + s.n_csw_fc_links)),
        "ring_frac": ring_frac,
        "rsw_link_on_frac": rsw_on,
        "csw_link_on_frac": csw_on,
        "node_link_on_frac": node_on,
        "switch_energy_savings_frac": float(switch_savings),
        "transceiver_power_w": float(power_w),
        "all_transceiver_savings_frac": float(1.0 - power_w / total_w),
        "half_off_frac": float(a["half_off_ticks"]) / T,
        "on_frac_hist": (a["on_frac_hist"] / T).tolist(),
        "offered_load_pkts_per_tick": inj / T,
        # in-scan delay distribution (normalized; bins in
        # DELAY_BIN_EDGES_US) + percentiles + the attribution split
        "delay_hist": (hist / wt).tolist(),
        "delay_p50_us": _hist_quantile(hist, 0.50),
        "delay_p95_us": _hist_quantile(hist, 0.95),
        "delay_p99_us": _hist_quantile(hist, 0.99),
        "delay_mean_sampled_us": float(a["delay_sum"]) / wt,
        "delay_queue_us": float(a["delay_queue_sum"]) / wt,
        "delay_wake_stall_us": float(a["delay_stall_sum"]) / wt,
        "delay_fault_stall_us": float(a["delay_fault_sum"]) / wt,
        "delay_ring_us": ring_frac * WIRE_HOP_US,
        "delay_frac_inter": float(a["delay_wt_inter"]) / wt,
        "wake_stall_frac": float(a["wake_stall_pkts"]) / wt,
        "fault_stall_frac": float(a["fault_stall_pkts"]) / wt,
        **occ,
        **_finalize_flows(a),
    }


def _finalize_flows(a: dict) -> dict:
    """Flow-engine metrics (all exactly 0 / empty-normalized at
    flow_mode=0, where every flow accumulator is exactly zero):
    per-size-class FCT p50/p99 + slowdown percentiles vs the
    ideal-bandwidth baseline, and the flow-conservation census."""
    fct_hist = np.asarray(a["fct_hist"], np.float64)       # (3, bins)
    slow_hist = np.asarray(a["fct_slow_hist"], np.float64)
    started = float(a["flows_started"])
    completed = float(a["flows_completed"])
    n_done = max(completed, 1e-9)
    out = {
        "flows_started": started,
        "flows_completed": completed,
        "flows_evicted": float(a["flows_evicted"]),
        "flow_evicted_frac": float(a["flows_evicted"])
        / max(started, 1e-9),
        "fct_mean_us": float(a["fct_sum"]) / n_done,
        "fct_slowdown_mean": float(a["fct_slow_sum"]) / n_done,
        # aggregate (all classes) percentiles
        "fct_p50_us": _hist_quantile(fct_hist.sum(0), 0.50,
                                     FCT_BIN_EDGES_US),
        "fct_p99_us": _hist_quantile(fct_hist.sum(0), 0.99,
                                     FCT_BIN_EDGES_US),
        "fct_slowdown_p50": _hist_quantile(slow_hist.sum(0), 0.50,
                                           FCT_SLOWDOWN_BIN_EDGES),
        "fct_slowdown_p99": _hist_quantile(slow_hist.sum(0), 0.99,
                                           FCT_SLOWDOWN_BIN_EDGES),
        # normalized per-class slowdown distributions (rows in
        # FLOW_CLASS_NAMES order, bins in FCT_SLOWDOWN_BIN_EDGES)
        "fct_slow_hist": (slow_hist / n_done).tolist(),
    }
    for c, cname in enumerate(workloads.FLOW_CLASS_NAMES):
        out[f"flows_completed_{cname}"] = float(fct_hist[c].sum())
        out[f"fct_p50_us_{cname}"] = _hist_quantile(
            fct_hist[c], 0.50, FCT_BIN_EDGES_US)
        out[f"fct_p99_us_{cname}"] = _hist_quantile(
            fct_hist[c], 0.99, FCT_BIN_EDGES_US)
        out[f"fct_slowdown_p50_{cname}"] = _hist_quantile(
            slow_hist[c], 0.50, FCT_SLOWDOWN_BIN_EDGES)
        out[f"fct_slowdown_p99_{cname}"] = _hist_quantile(
            slow_hist[c], 0.99, FCT_SLOWDOWN_BIN_EDGES)
    return out
