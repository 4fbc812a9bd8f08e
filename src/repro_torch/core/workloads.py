"""Flow-level workload models: heavy-tailed DCN flow-size distributions.

Counterpart of ``repro/core/workloads.py``: the websearch (DCTCP/pFabric)
and datamining (VL2/pFabric) flow-size CDFs in PACKETS (1250 B per
packet), sampled by inverse transform with log-linear interpolation
between anchors (sizes integral and >= 1), the pFabric short/medium/long
size classes, and the ideal-bandwidth FCT baseline the simulator's
slowdown metrics divide by. Pure float32 tensor code; the distribution
index may be a per-scenario tensor, so one step samples any mix of
distributions across the batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import constants as C

#: distribution names in CDF table order; the Scenario ``flow_dist``
#: knob is an index into this tuple
FLOW_DIST_NAMES = ("websearch", "datamining")

# CDF anchors as (size_pkts, cum_prob). Published anchor points of the
# DCTCP web-search and VL2 data-mining distributions, converted from
# bytes at 1250 B/pkt and lightly coarsened (log-linear interpolation
# between anchors reproduces the published curves to well under the
# simulator's bin resolution). A repeated size with increasing prob
# encodes an atom (datamining: half of all flows are a single packet).
_WEBSEARCH_CDF = (
    (1, 0.00), (7, 0.15), (15, 0.20), (22, 0.30), (39, 0.40),
    (62, 0.53), (155, 0.60), (779, 0.70), (1557, 0.80),
    (3893, 0.90), (7786, 0.97), (23360, 1.00),
)
_DATAMINING_CDF = (
    (1, 0.00), (1, 0.50), (2, 0.60), (4, 0.70), (8, 0.80),
    (312, 0.90), (2462, 0.95), (77867, 0.99), (778667, 1.00),
)


def _stack_cdfs(*tables):
    """Pad anchor tables to one (D, P) pair of f32 constants (repeating
    each table's last anchor, which is inert under interpolation)."""
    width = max(len(t) for t in tables)
    sizes, probs = [], []
    for t in tables:
        t = tuple(t) + (t[-1],) * (width - len(t))
        sizes.append([s for s, _ in t])
        probs.append([p for _, p in t])
    return (np.asarray(sizes, np.float32), np.asarray(probs, np.float32))


#: (D, P) stacked anchor tables, row order == FLOW_DIST_NAMES
CDF_SIZE_PKTS, CDF_PROB = _stack_cdfs(_WEBSEARCH_CDF, _DATAMINING_CDF)

#: short/medium/long class edges in packets (~100 KB / ~10 MB at
#: 1250 B/pkt) — the pFabric reporting buckets
FLOW_CLASS_EDGES_PKTS = (80, 8000)
FLOW_CLASS_NAMES = ("short", "medium", "long")


def cdf_tables(dist, device=None):
    """The (size, prob) anchor rows of distribution index ``dist`` (an
    int, or a (B,) tensor of per-scenario indices) as float32 tensors
    of shape ``dist.shape + (P,)`` on ``device``."""
    idx = torch.as_tensor(dist, dtype=torch.long, device=device)
    sizes = torch.as_tensor(CDF_SIZE_PKTS, device=idx.device)
    probs = torch.as_tensor(CDF_PROB, device=idx.device)
    return sizes[idx], probs[idx]


def sample_from_tables(u, size_tab, prob_tab):
    """Inverse-CDF sizes of uniforms ``u`` (shape ``lead + rest``) from
    anchor rows ``size_tab``/``prob_tab`` of shape ``lead + (P,)``,
    where ``lead`` may be empty (one distribution for every draw)."""
    npts = prob_tab.shape[-1]
    extra = u.dim() - (prob_tab.dim() - 1)
    shape = prob_tab.shape[:-1] + (1,) * extra + (npts,)
    size_tab = size_tab.reshape(shape).expand(u.shape + (npts,))
    prob_tab = prob_tab.reshape(shape).expand(u.shape + (npts,))
    # segment index: the last anchor with prob <= u (atoms — repeated
    # sizes — collapse to a zero-length segment whose interp is exact)
    seg = torch.clamp(torch.sum(u[..., None] >= prob_tab, dim=-1) - 1,
                      0, npts - 2)[..., None]
    lo_s = torch.gather(size_tab, -1, seg)[..., 0]
    hi_s = torch.gather(size_tab, -1, seg + 1)[..., 0]
    lo_p = torch.gather(prob_tab, -1, seg)[..., 0]
    hi_p = torch.gather(prob_tab, -1, seg + 1)[..., 0]
    frac = torch.clamp((u - lo_p) / torch.clamp(hi_p - lo_p, min=1e-9),
                       0.0, 1.0)
    size = lo_s * (hi_s / lo_s) ** frac
    return torch.clamp(torch.ceil(size), min=1.0)


def sample_flow_size_pkts(u, dist):
    """Inverse-CDF flow sizes: uniforms ``u`` (any shape, in [0, 1))
    -> integral packet counts (float32, >= 1) from distribution index
    ``dist`` (an int into FLOW_DIST_NAMES, or a tensor of indices
    matching ``u``'s leading dims).

    Log-linear interpolation between anchors: within segment
    [(s0, p0), (s1, p1)] the size is s0 * (s1/s0)**frac with
    frac = (u - p0)/(p1 - p0) — monotone in u within and across
    segments, so the sampler itself is monotone.
    """
    u = torch.as_tensor(u, dtype=torch.float32)
    size_tab, prob_tab = cdf_tables(dist, u.device)
    return sample_from_tables(u, size_tab, prob_tab)


def flow_size_class(size_pkts):
    """Size-class index (0=short, 1=medium, 2=long) of integral packet
    counts; edges from FLOW_CLASS_EDGES_PKTS, half-open-left (a flow
    exactly at an edge belongs to the smaller class)."""
    lo, hi = FLOW_CLASS_EDGES_PKTS
    s = torch.as_tensor(size_pkts)
    return (s > lo).to(torch.int32) + (s > hi).to(torch.int32)


def ideal_fct_us(size_pkts, base_path_us):
    """Idealized FCT baseline: unloaded path latency + line-rate
    serialization (C.FLOW_LINE_RATE_PPT pkts/tick, 1 us ticks). The
    denominator of the simulator's FCT slowdown metrics."""
    size = torch.as_tensor(size_pkts).to(torch.float32)
    return (torch.as_tensor(base_path_us, dtype=torch.float32)
            + size / C.FLOW_LINE_RATE_PPT * C.TICK_US)
