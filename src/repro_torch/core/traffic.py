"""Data-center traffic generator parameters (paper Sec V / Fig 6-7).

Counterpart of ``repro/core/traffic.py``: the per-trace
``TrafficSpec`` knobs (2-component lognormal flow sizes, lognormal
inter-arrival times, ON/OFF bursts, destination locality, pacing), the
five published traces, and the helpers the batched sweep engine uses to
stack them into per-scenario arrays. The in-step samplers live in
``core/simulator.py``; the CDF-validation tables wait for the bench
slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class TrafficSpec:
    name: str
    # flow size: lognormal mixture  w*LN(mu1,s1) + (1-w)*LN(mu2,s2)  [bytes]
    size_w: float
    size_mu1: float
    size_s1: float
    size_mu2: float
    size_s2: float
    # inter-arrival per server [us]: lognormal
    iat_mu: float
    iat_s: float
    # ON/OFF burst modulation (per-rack Markov, per-tick transition probs)
    p_on_off: float = 0.002     # leave ON
    p_off_on: float = 0.004     # leave OFF
    # destination split
    p_intra_rack: float = 0.3
    p_intra_cluster: float = 0.45   # rest = inter-cluster
    # per-flow packet pacing: emit probability per tick (1.0 = line rate).
    # Real DC flows rarely run at NIC line rate; pacing keeps server links
    # occupied (node-gating realism) without saturating the uplinks.
    pace: float = 0.05
    # pace multiplier while a rack bursts (shuffle/scatter phases)
    burst_pace_boost: float = 1.0
    # flows >= elephant_pkts packets transmit near line rate: overlapping
    # elephants are what push a queue over the high watermark (hadoop
    # shuffle / cache-warm behaviour). Mice keep `pace`. elephant_pace is
    # slightly below 1.0 so a lone elephant still lets the queue drain.
    elephant_pkts: int = 64
    elephant_pace: float = 0.95


# mu/s in ln(bytes). exp(mu) = median flow size.
TRAFFIC_SPECS: dict[str, TrafficSpec] = {
    # Hadoop: small flows dominate (median <1 kB, Roy Fig.5), heavy rack
    # locality; frequent arrivals (median ~2 ms/server).
    "fb_hadoop": TrafficSpec("fb_hadoop", 0.75, np.log(600), 0.9,
                             np.log(100e3), 1.9, np.log(2000), 1.2,
                             p_on_off=0.003, p_off_on=0.0012,
                             p_intra_rack=0.45, p_intra_cluster=0.40,
                             pace=0.03),
    # Web servers: small request/response flows, cluster-heavy traffic.
    "fb_web": TrafficSpec("fb_web", 0.7, np.log(2e3), 1.0,
                          np.log(120e3), 1.6, np.log(3500), 1.1,
                          p_on_off=0.0025, p_off_on=0.0012,
                          p_intra_rack=0.15, p_intra_cluster=0.25,
                          pace=0.04),
    # Cache followers: medium flows, some MB-scale, mostly inter-cluster.
    "fb_cache": TrafficSpec("fb_cache", 0.55, np.log(6e3), 1.1,
                            np.log(500e3), 1.6, np.log(15000), 1.3,
                            p_on_off=0.002, p_off_on=0.0015,
                            p_intra_rack=0.1, p_intra_cluster=0.45,
                            pace=0.04),
    # Microsoft VL2/IMC09: >80 % of flows < 100 kB with a heavy tail;
    # the most demanding load in Fig 8/9.
    "microsoft": TrafficSpec("microsoft", 0.6, np.log(4e3), 1.3,
                             np.log(400e3), 1.8, np.log(6500), 1.5,
                             p_on_off=0.0015, p_off_on=0.002,
                             p_intra_rack=0.2, p_intra_cluster=0.35,
                             pace=0.04),
    # University DC (Benson IMC'10): low utilization, very bursty.
    "university": TrafficSpec("university", 0.8, np.log(1500), 1.2,
                              np.log(200e3), 1.9, np.log(9000), 1.8,
                              p_on_off=0.005, p_off_on=0.001,
                              p_intra_rack=0.35, p_intra_cluster=0.35,
                              pace=0.02),
}


def stack_specs(specs) -> dict[str, np.ndarray]:
    """Stack TrafficSpec fields into (B,) arrays, one row per scenario.

    The batched sweep engine (core/simulator.py) turns every per-spec
    knob into a (B,) tensor of its ``Scenario`` so one step advances
    every scenario of the batch; this is the traffic half of it.
    """
    out: dict[str, np.ndarray] = {}
    for f in dataclasses.fields(TrafficSpec):
        if f.name == "name":
            continue
        vals = [getattr(s, f.name) for s in specs]
        # f.type is the annotation *string* under future-annotations
        dtype = np.int32 if f.type in (int, "int") else np.float32
        out[f.name] = np.asarray(vals, dtype=dtype)
    return out


def rack_flow_rate_per_tick(spec: TrafficSpec, servers_per_rack: int = 48,
                            duty: float | None = None) -> float:
    """Expected new flows per rack per 1 us tick while the rack is ON."""
    mean_iat_us = float(np.exp(spec.iat_mu + spec.iat_s ** 2 / 2))
    rate = servers_per_rack / mean_iat_us
    if duty is None:
        duty = spec.p_off_on / (spec.p_off_on + spec.p_on_off)
    # compensate for OFF periods so the long-run rate matches the IAT dist
    return rate / max(duty, 1e-6)


def flow_arrival_rate_per_tick(spec: TrafficSpec,
                               servers_per_rack: int = 48,
                               rate_scale: float = 1.0) -> float:
    """Default per-rack flow-ARRIVAL-EVENT rate of the flow engine
    (``flow_mode=1``, P(arrival)/rack/tick, capped at 1): the legacy
    rate-based generator's expected spawn rate under the same
    ``rate_scale``, so the two modes offer comparable load and the
    savings-vs-FCT frontier (benchmarks/bench_flows.py) is an
    apples-to-apples axis. ``SimParams.flow_arrival_rate`` overrides it
    when nonzero."""
    return min(rack_flow_rate_per_tick(spec, servers_per_rack)
               * rate_scale, 1.0)
