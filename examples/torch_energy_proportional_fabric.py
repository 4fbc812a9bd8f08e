"""The paper's feature, end to end, on the PyTorch/CUDA port: run the
LC/DC data-center simulation on one trace, compare fabric designs through
the hull-bucketing planner, then apply the same gating controller to a
TPU training step's ICI traffic (from the dry-run artifacts, if present).

  PYTHONPATH=src python examples/torch_energy_proportional_fabric.py

It runs on the CUDA device (the sweep's tick replayed from a CUDA
graph); without one it stops with an error, unless ``--device cpu`` is
given (slow at this size: the CPU runs every tick op by op).
"""
import argparse
import time

from repro_torch.core import ici_gating
from repro_torch.core.node_model import default_timing
from repro_torch.core.simulator import (SimParams, run_sweep,
                                        run_sweep_planned, sweep_grid)
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS


def main(device=None):
    print("=== node level (Sec IV-C) ===")
    t = default_timing()
    print(f"TCP/IP+NIC budget {t.stack_ns} ns; laser {t.laser_on_ns} ns "
          f"+ CDR {t.cdr_ns:.1f} ns -> hidden={t.hidden} "
          f"(slack {t.slack_ns:.0f} ns)")

    print("\n=== data-center fabric (Fig 2 site, fb_hadoop, 30k us) ===")
    # LC/DC + always-on baseline as one 2-scenario batched sweep
    t0 = time.perf_counter()
    lc, base = run_sweep(sweep_grid(traces=("fb_hadoop",)), 30_000,
                         device=device)
    print(f"switch-tier transceiver savings: "
          f"{lc['switch_energy_savings_frac']:.1%}")
    print(f"latency: {lc['mean_latency_us']:.2f} us vs "
          f"{base['mean_latency_us']:.2f} us "
          f"({lc['mean_latency_us']/base['mean_latency_us']-1:+.1%})")
    print(f"delay distribution (in-scan histogram): "
          f"p50 {lc['delay_p50_us']:.2f} / p95 {lc['delay_p95_us']:.2f} "
          f"/ p99 {lc['delay_p99_us']:.2f} us "
          f"(always-on p99 {base['delay_p99_us']:.2f} us)")
    print(f"delay attribution: queueing {lc['delay_queue_us']:.3f} us, "
          f"laser/CDR wake stalls {lc['delay_wake_stall_us']:.4f} us "
          f"({lc['wake_stall_frac']:.2%} of pkts), "
          f"ring detours {lc['delay_ring_us']:.3f} us")
    print(f"fraction of time >=half the gated links are off: "
          f"{lc['half_off_frac']:.0%}")
    print(f"(sweep: {time.perf_counter() - t0:.1f} s wall)")

    print("\n=== fabric design comparison (hull-bucketed sweep, 10k us) ===")
    # heterogeneous sites through the planner: each hull bucket runs
    # tight instead of padding everything to the worst site
    t0 = time.perf_counter()
    dense = FBSite(n_clusters=8, racks_per_cluster=16, csw_per_cluster=2,
                   n_fc=2, csw_ring_links=4, fc_ring_links=8)
    spec = TRAFFIC_SPECS["fb_hadoop"]
    res, plan = run_sweep_planned(
        [(SimParams(spec=spec), 0),
         (SimParams(spec=spec, site=dense), 0)],
        10_000, max_compiles=2, return_plan=True, device=device)
    print(f"{plan['n_buckets']} hull buckets, padded-compute savings "
          f"{plan['savings_vs_single_hull_frac']:.1%} vs one shared hull")
    for r in res:
        print(f"  {r['plan_hull']:18s} savings="
              f"{r['switch_energy_savings_frac']:.1%} "
              f"latency {r['mean_latency_us']:.2f} us "
              f"(bucket {r['plan_bucket']})")
    print(f"(planned sweep: {time.perf_counter() - t0:.1f} s wall)")

    print("\n=== TPU ICI fabric (beyond-paper) ===")
    rows = ici_gating.analyze_all(device=device)
    if not rows:
        print("(no dry-run artifacts under results/dryrun_torch; "
              "`python -m repro_torch.launch.dryrun --all` writes them)")
        return
    for r in rows[:6]:
        print(f"{r['arch']:22s} {r['shape']:12s} "
              f"collective duty={r['collective_duty']:.2f} "
              f"scheduled-gating savings="
              f"{r['scheduled']['ici_energy_savings']:.1%} "
              f"(reactive: {r['reactive']['ici_energy_savings']:.1%} at "
              f"{r['reactive']['latency_penalty']:.0%} stall)")
    print(f"... ({len(rows)} cells total)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
