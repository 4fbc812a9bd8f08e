"""Hull-bucketing sweep planner: partition a heterogeneous-site sweep
into a few padded hulls so compute stops scaling with the WORST site.

Counterpart of ``repro/core/planner.py``: the same cost model and
bucketing, so the same sites give the same plan and fingerprint.

Why
---
``make_multi_site_batch`` runs arbitrary FBSite mixes as one vmapped
compile by padding every scenario to a single hull — the per-axis max
over the batch. That is perfect for compile count (one) but terrible for
compute once site sizes diverge: a 2x4-rack toy site padded into a
4x32-rack hull steps ~30x more state than it needs, every tick, for
every scenario. Wide design-space sweeps (the Fig 1 axis) are exactly
the mixes where hulls explode.

The planner splits the sweep into K buckets (K compiles instead of
one in the reference, K CUDA-graph captures here) chosen so the total
*padded cost* (estimated step cost of the bucket hull x scenarios in
the bucket) is small, under a caller-set ``max_compiles`` budget.
``simulator.run_sweep_planned`` then executes the buckets as an async
pipeline — dispatched in ``dispatch_order`` (largest padded cost
first, the reference's schedule for overlapping later buckets' set-up
with the big bucket's device execution), each bucket an ordinary
``make_multi_site_batch`` + chunk dispatch, so the one-capture-per-run
contract holds per bucket — and merges results back into caller order.

Cost model
----------
``site_cost(site)`` estimates the per-scenario, per-tick compute of the
compiled step on a hull, as a weighted sum of the step's dense-array
footprints (the step is bandwidth-bound elementwise work, so array
elements touched is the right first-order proxy):

* edge tier — dominant: per-rack flow state (R x F_SLOTS, ~4 arrays of
  it live per tick) plus the per-rack uniform draws;
* RSW tier — (R, planes) queue pair, plane weights, down-queue views;
* CSW tier — (NC, csw_uplinks) uplink queues and (NC, racks_per_cluster)
  down queues, each touched a few times;
* FC tier — (n_fc, NC) down queues.

The units are arbitrary; only RATIOS matter (bucket A vs bucket B vs
the single hull), so constant factors common to all hulls cancel.
``padded_cost(bucket) = site_cost(hull(bucket)) * len(bucket)`` and the
waste is ``1 - ideal/padded`` where ideal charges each scenario its own
site's cost. These are the padding-waste stats surfaced per bucket in
the plan report.

Only ``cost_model="model"`` is ported: the reference's ``"hlo"`` mode
reads the JAX package's blessed XLA cost measurements (its artifact
contracts), which have no counterpart here yet (ROADMAP Queue 1 item
14); asking for it raises ``ValueError``.

Algorithm
---------
Scenarios with identical FBSites are grouped first (they pad to nothing
inside their own bucket). If the number of distinct sites fits the
budget, every distinct site gets its own exact-hull bucket — merging
can only grow a hull, so more buckets are never costlier; the budget
exists because each bucket pays a compile. Over budget, buckets are
merged agglomeratively: repeatedly merge the pair whose merged padded
cost exceeds the pair's current costs by the least, until the budget is
met. (Optimal bucketing is a set-partition problem — NP-hard in
general; greedy pairwise merging is the standard Ward-style heuristic
and is exact for the common bimodal small-vs-large mixes.)

``SweepPlan.fingerprint`` hashes the bucket assignment + every bucket
hull; benchmarks/simcache.py folds it into its cache key so planned and
unplanned runs never serve each other stale results.

K=1 degenerate case: one bucket, hull == the per-axis max over all
sites — bit-identical to the plain ``make_multi_site_batch`` path
(tests/test_torch_planner.py pins the parity).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.topology import FBSite, full_site_tag, pad_hull

#: must match simulator.F_SLOTS (the per-rack flow-slot count, the
#: dominant edge-tier array width); asserted in
#: tests/test_torch_planner.py so the two cannot drift silently. Defined
#: here (not imported) to keep the planner free of torch.
FLOW_SLOTS = 64

#: bump when the cost model or bucketing algorithm changes: the
#: fingerprint feeds cache keys, so plans from an older planner must
#: not collide with new ones
PLAN_SCHEMA_VERSION = 1


def site_cost(site: FBSite) -> float:
    """Estimated per-scenario, per-tick step cost on ``site`` (arbitrary
    units — see the module docstring's cost model)."""
    R, P = site.n_racks, site.csw_per_cluster
    NC, CUP = site.n_csw, site.csw_uplinks
    RPC, NF = site.racks_per_cluster, site.n_fc
    edge = R * (4.0 * FLOW_SLOTS + 8.0)
    rsw = 6.0 * R * P
    csw = NC * (3.0 * CUP + 4.0 * RPC)
    fc = 3.0 * NF * NC
    return edge + rsw + csw + fc


@dataclass(frozen=True)
class PlanBucket:
    """One compile unit: the scenarios at caller positions ``indices``
    run together padded to ``hull``."""
    indices: tuple          # caller positions, ascending
    hull: FBSite
    padded_cost: float      # site_cost(hull) * len(indices)
    ideal_cost: float       # sum of the members' own site_costs

    @property
    def waste_frac(self) -> float:
        """Fraction of this bucket's compute spent on hull padding."""
        return 1.0 - self.ideal_cost / max(self.padded_cost, 1e-12)


@dataclass(frozen=True)
class SweepPlan:
    buckets: tuple          # PlanBucket, ordered by first caller index
    max_compiles: int
    single_hull_cost: float  # the K=1 reference: cost(hull(all)) * N

    @property
    def n_scenarios(self) -> int:
        return sum(len(b.indices) for b in self.buckets)

    @property
    def padded_cost(self) -> float:
        return sum(b.padded_cost for b in self.buckets)

    @property
    def ideal_cost(self) -> float:
        return sum(b.ideal_cost for b in self.buckets)

    @property
    def waste_frac(self) -> float:
        return 1.0 - self.ideal_cost / max(self.padded_cost, 1e-12)

    @property
    def savings_vs_single_hull_frac(self) -> float:
        """Padded-compute cut vs running everything in one hull (the
        pre-planner path); 0 for K=1 by construction."""
        return 1.0 - self.padded_cost / max(self.single_hull_cost, 1e-12)

    @property
    def dispatch_order(self) -> tuple:
        """Bucket indices in descending padded-cost order — the async
        pipeline's dispatch schedule (simulator.run_sweep_planned): the
        most expensive bucket launches first so the cheaper buckets'
        trace/compile time overlaps its device execution. Ties break on
        the caller-order bucket index, keeping the order deterministic
        (result order is unaffected: fetches merge by caller index)."""
        return tuple(sorted(
            range(len(self.buckets)),
            key=lambda k: (-self.buckets[k].padded_cost, k)))

    @property
    def fingerprint(self) -> str:
        """Stable hash of (bucket assignment, bucket hulls) — the cache
        namespace for planned results (benchmarks/simcache.py)."""
        blob = json.dumps(
            {"schema": PLAN_SCHEMA_VERSION,
             "buckets": [{"idx": list(b.indices),
                          "hull": dataclasses.astuple(b.hull)}
                         for b in self.buckets]},
            sort_keys=True)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def bucket_tag(self, k: int) -> str:
        """Stable per-bucket checkpoint-tag component: bucket index +
        the plan fingerprint, so checkpoints from different plans (or
        different buckets of one plan) sharing a directory never
        collide — the durable executor (simulator.run_sweep_planned)
        appends this to the caller's CheckpointSpec tag."""
        return f"b{k:02d}-{self.fingerprint[:8]}"

    def report(self) -> dict:
        """JSON-ready padding-waste report (per bucket + totals)."""
        return {
            "plan_schema": PLAN_SCHEMA_VERSION,
            "max_compiles": self.max_compiles,
            "n_buckets": len(self.buckets),
            "n_scenarios": self.n_scenarios,
            "padded_cost": self.padded_cost,
            "ideal_cost": self.ideal_cost,
            "waste_frac": self.waste_frac,
            "single_hull_cost": self.single_hull_cost,
            "savings_vs_single_hull_frac": self.savings_vs_single_hull_frac,
            "dispatch_order": list(self.dispatch_order),
            "fingerprint": self.fingerprint,
            "buckets": [{
                "hull": full_site_tag(b.hull),
                "n_scenarios": len(b.indices),
                "indices": list(b.indices),
                "padded_cost": b.padded_cost,
                "ideal_cost": b.ideal_cost,
                "waste_frac": b.waste_frac,
            } for b in self.buckets],
        }


def plan_sites(sites: Sequence[FBSite], max_compiles: int = 4, *,
               cost_model: str = "model") -> SweepPlan:
    """Partition scenario sites into <= ``max_compiles`` hull buckets.

    ``sites[i]`` is scenario i's FBSite (caller order). Every index
    lands in exactly one bucket.

    ``cost_model`` selects the bucketing cost function: ``"model"``
    (the only one ported) is the hand model ``site_cost``. The
    reference's ``"hlo"`` mode reads JAX artifact contracts and raises
    ``ValueError`` here (ROADMAP Queue 1 item 14).
    """
    if cost_model == "hlo":
        raise ValueError(
            "cost_model='hlo' reads the JAX package's HLO artifact "
            "contracts, which the port does not have (ROADMAP Queue 1 "
            "item 14); use cost_model='model'")
    if cost_model != "model":
        raise ValueError(
            f"cost_model must be 'model' or 'hlo', got {cost_model!r}")
    cost = site_cost
    sites = list(sites)
    if not sites:
        raise ValueError("plan_sites: empty site list")
    if max_compiles < 1:
        raise ValueError(f"max_compiles must be >= 1, got {max_compiles}")

    # group scenarios on identical sites: they pad to nothing together
    groups: dict[FBSite, list[int]] = {}
    for i, s in enumerate(sites):
        groups.setdefault(s, []).append(i)
    # work items: (distinct member sites, caller indices)
    work = [([s], idx) for s, idx in groups.items()]

    def padded(members, idx):
        return cost(pad_hull(members)) * len(idx)

    # agglomerative merge until the compile budget is met: each round
    # fuse the pair whose merged hull costs the least extra
    while len(work) > max_compiles:
        best = None
        for a in range(len(work)):
            for b in range(a + 1, len(work)):
                ma, ia = work[a]
                mb, ib = work[b]
                delta = (padded(ma + mb, ia + ib)
                         - padded(ma, ia) - padded(mb, ib))
                if best is None or delta < best[0]:
                    best = (delta, a, b)
        _, a, b = best
        ma, ia = work[a]
        mb, ib = work[b]
        work[a] = (ma + mb, ia + ib)
        work.pop(b)

    buckets = []
    for members, idx in work:
        hull = pad_hull(members)
        idx = tuple(sorted(idx))
        buckets.append(PlanBucket(
            indices=idx, hull=hull,
            padded_cost=cost(hull) * len(idx),
            ideal_cost=sum(cost(sites[i]) for i in idx)))
    buckets.sort(key=lambda b: b.indices[0])
    return SweepPlan(
        buckets=tuple(buckets), max_compiles=max_compiles,
        single_hull_cost=cost(pad_hull(sites)) * len(sites))
