"""LC/DC network simulator: 1 us-slotted batched sweep engine in PyTorch.

Counterpart of ``repro/core/simulator.py`` (its ``run_sweep`` main
path). It models the Fig 2 Facebook-style site end to end:

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
  ticks, and at every boundary the accumulators fold into a float32
  Kahan ``(sum, comp)`` pair on the device, exactly as the reference's
  x32 device fold does.
* The reference's one compiled program per (hull, batch, chunk) becomes
  one CUDA graph per run on a CUDA device: a single tick of
  ``step_into`` (the step writing its result back into fixed state
  buffers) is captured once and replayed for every tick of every chunk
  (``CAPTURE_COUNT`` counts captures as the reference's ``TRACE_COUNT``
  counts traces). ``run_sweep(graph=False)`` and the CPU run the ticks
  eagerly, op by op.
* ``run_sweep`` fetches the fold once at the end (``HOST_TRANSFER_COUNT``
  counts it) and finalizes the paper's metrics on the host.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device, ``run_sweep`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import constants as C
from repro_torch.core import gating
from repro_torch.core import prng
from repro_torch.core import workloads
from repro_torch.core.topology import FBSite, pad_hull, site_tag
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

#: number of accumulator host transfers the sweep engine has performed:
#: exactly ONE per run_sweep (the final fold fetch)
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
    """
    # the 1e-4 nudge keeps exact edge values in their own (half-open)
    # bin under f32 log2 rounding
    idx = torch.clamp(
        torch.floor(torch.log2(torch.clamp(d, min=1e-9) / min_val) * bpo
                    + 1e-4), -1, bins - 2).to(torch.int64) + 1
    return torch.scatter_add(hist, -1, idx, w)


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


def _zero_acc(B: int, device) -> dict:
    return {k: torch.zeros((B,) + shp, dtype=torch.float32, device=device)
            for k, shp in ACC_SHAPES.items()}


def _init_state(hull: FBSite, scen: Scenario, keys) -> SimState:
    """Initial carry of every scenario; ``keys`` is (B, 2)."""
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

    def zeros(*shape, dtype=torch.float32):
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
        ft_rem=zeros(R, FT),
        ft_size=zeros(R, FT, dtype=torch.int32),
        ft_dst=zeros(R, FT, dtype=torch.int32),
        ft_cwnd=zeros(R, FT),
        rsw_q=zeros(R, P, 2),
        csw_up_q=zeros(NC, s.csw_uplinks),
        csw_down_q=zeros(NC, RPC),
        fc_down_q=zeros(NF, NC),
        rsw_gate=tier_gate(R, P, rsw_max),
        csw_gate=tier_gate(NC, s.csw_uplinks, csw_max),
        rsw_fault=fault(R, P),
        csw_fault=fault(NC, s.csw_uplinks),
        node_on=zeros(R),
        acc=_zero_acc(B, dev),
    )


# the reference's compiled code turns a division by a constant into a
# product with the float32 reciprocal; these are those reciprocals
_PER_PKT = float(np.float32(1.0 / 1250.0))          # bytes -> packets
_PER_IDLE = float(np.float32(1.0 / NODE_IDLE_TICKS))


def _spawn_flows(scen: Scenario, u, z, rack_valid, burst_on, flow_rem,
                 flow_dest, flow_fast):
    """Per-rack flow arrivals: Bernoulli spawn into the first free slot.

    ``u`` (B, R, 5+F_SLOTS) and ``z`` (B, R, 2) are the rack's uniform
    and normal draws of this tick (keyed by its LOGICAL id, see
    ``make_sim_step``). Returns the updated flow state plus this
    tick's per-flow pace uniforms (B, R, F_SLOTS).
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
    size_p = torch.clamp(torch.ceil(size_b * _PER_PKT), min=1.0) \
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
    a tick costs four hash calls whatever the site size.
    """

    def __init__(self, hull: FBSite, rack_uid, csw_uid,
                 partitionable: bool = True):
        self.partitionable = partitionable
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
            x1, x2, take2 = prng.counter_words(w, partitionable, dev)
            if take2 is None:
                take2 = torch.zeros_like(x1, dtype=torch.bool)
            words.append(torch.stack([x1, x2, take2.long()]).repeat(1, n))
            off += n
        self.key_idx = torch.cat(key_idx)
        x1, x2, take2 = torch.cat(words, dim=1)
        self.words = (x1, x2, None if partitionable else take2.bool())
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
        u = prng.bits_to_unit(prng.hash_counters(l4, *self.words))
        parts, off = [], 0
        for n, w in self.blocks:
            parts.append(u[:, off:off + n * w].reshape(B, n, w))
            off += n * w
        u_rack, u_z, u_fr, u_fc, u_pl, u_arr, u_size, u_pc = parts
        return keys3[:, 0], _Draws(
            u_rack, prng.unit_to_normal(u_z), u_fr, u_fc, u_pl,
            u_pc[:, 0], u_arr, u_size)


def _flat(x):
    """(B, S, ...) -> (B*S, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _flat_gate(g):
    return type(g)(*(_flat(x) for x in g))


def _unflat_gate(g, B: int):
    return type(g)(*(x.reshape((B, -1) + tuple(x.shape[1:])) for x in g))


def make_sim_step(hull: FBSite, scen: Scenario, *,
                  threefry_partitionable: bool = True):
    """One tick for every scenario of ``scen`` (leaves (B,), on the
    device the step runs on) on the static padded ``hull``: returns
    ``step(state) -> state``. Everything derived from the scenarios
    alone (site masks, logical ids, per-row knob columns, the PRNG
    plan) is built here once instead of every tick.
    ``threefry_partitionable`` picks JAX's threefry counter scheme
    (see core/prng.py)."""
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
    plan = _DrawPlan(hull, rack_uid, csw_uid, threefry_partitionable)
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
        sizes = workloads.sample_from_tables(dr.u_size, size_tab,
                                             prob_tab)          # (B,R,W)
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
        flow_by_dest = torch.stack(
            [torch.sum(torch.where(ft_dst == d, emit_f, 0.0), dim=2)
             for d in (0, 1, 2)], dim=2)                        # (B,R,3)
        by_dest = torch.where(flow_on[:, None, None], flow_by_dest, by_dest)
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
        node_on = torch.maximum(need, fma(col(-scen.spr), torch.full_like(
            state.node_on, _PER_IDLE), state.node_on))
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
    """The accumulators as one (B, N) float32 buffer, ACC_SHAPES order."""
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
    """

    def __init__(self, step, static: SimState):
        self.step, self.static = step, static
        self.graph = None
        self.launches = 0          # switch kernel launches per replay

    def run(self, n: int) -> None:
        """Advance ``static`` by ``n`` ticks."""
        global CAPTURE_COUNT
        if n > 0 and self.graph is None:
            lcdc_switch.load_tiers()
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
        lcdc_switch.LAUNCHES += n * self.launches


def run_sweep(batch: ScenarioBatch, n_ticks: int, *,
              chunk_ticks: int = CHUNK_TICKS, return_state: bool = False,
              device=None, threefry_partitionable: bool = True,
              graph=None):
    """Run every scenario of ``batch`` for n_ticks us; returns one
    metrics dict per scenario (the reference's schema, with the
    scenario ``label``). With ``return_state=True`` also returns the
    final state (leaves batched over scenarios, on the CPU).

    Ticks run in chunks of ``chunk_ticks`` (the last one may be
    shorter); at every chunk boundary the accumulators fold into a
    float32 Kahan ``(sum, comp)`` buffer on the device and restart from
    zero, exactly as the reference's x32 device fold does. The run
    makes ONE host transfer of results, the final fetch of that buffer
    (``HOST_TRANSFER_COUNT``). ``device=None`` means CUDA.

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
    """
    global HOST_TRANSFER_COUNT
    if n_ticks < 1:
        raise ValueError(f"n_ticks must be >= 1, got {n_ticks}")
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    elif graph and dev.type != "cuda":
        raise ValueError(f"run_sweep: graph=True needs a CUDA device, "
                         f"got {dev}")
    hull = batch.hull
    scen = Scenario(*(x.to(dev) for x in batch.scen))
    state = _init_state(hull, scen, prng.key(batch.seeds, device=dev))
    step = make_sim_step(hull, scen,
                         threefry_partitionable=threefry_partitionable)
    ticks = _TickGraph(step, state) if graph else None
    chunk = max(1, min(chunk_ticks, n_ticks))
    fsum = torch.zeros_like(_fold_flat(state.acc))
    fcomp = torch.zeros_like(fsum)
    done = 0
    while done < n_ticks:
        n = min(chunk, n_ticks - done)
        if ticks is not None:
            ticks.run(n)               # the graph's state buffers
        else:
            for _ in range(n):
                state = step(state)
        # Kahan: sum carries the running total, comp the rounding error
        # still to subtract
        y = _fold_flat(state.acc) - fcomp
        t = fsum + y
        fcomp = (t - fsum) - y
        fsum = t
        torch._foreach_zero_(list(state.acc.values()))
        done += n
    host = torch.stack([fsum, fcomp]).cpu().numpy()
    HOST_TRANSFER_COUNT += 1
    acc64 = _unfold_flat(host[0].astype(np.float64)
                         - host[1].astype(np.float64))
    res = [
        _finalize({k: v[i] for k, v in acc64.items()}, batch.sites[i],
                  n_ticks, batch.gating[i], batch.names[i],
                  batch.labels[i])
        for i in range(len(batch))
    ]
    if return_state:
        return res, _to_cpu(state)
    return res


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
