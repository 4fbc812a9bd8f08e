"""Where one tick of the sweep goes on the card: a torch.profiler trace.

    PYTHONPATH=src python -m repro_torch.trace_sweep [--ticks 50] [--graph]
        [--x64]

Runs the standard 10-scenario grid on the paper's Fig 2 site
(``FBSite()``) on the CUDA device, warms up, then profiles ``--ticks``
ticks and prints, per tick: wall time, device-busy time (the sum of
kernel times, so the idle share is 1 - busy/wall), launches, and the
kernels that take the most device time, as one JSON object. It also
times the same number of ticks again without the profiler, between two
CUDA events (``event_ms_per_tick``). With ``--graph`` the ticks are
replayed from one captured CUDA graph, as ``run_sweep`` runs them on
the card; without it they run eagerly, op by op (``graph=False``).
With ``--x64`` the grid runs in the sweep's x64 mode (float64 draws,
state and fold; the float64 switch_tiers kernel), as
``run_sweep(x64=True)`` runs it.
Where the profiler reports no kernels inside graph replays, the busy
fields are null and the event time is the measure. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import prng
from repro_torch.core import simulator as S
from repro_torch.kernels import lcdc_switch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--graph", action="store_true",
                    help="replay the tick from a CUDA graph")
    ap.add_argument("--x64", action="store_true",
                    help="run the grid in the sweep's x64 mode")
    args = ap.parse_args()
    dev = S.resolve_device(None)
    batch = S.sweep_grid()
    scen = S.Scenario(*(x.to(dev) for x in batch.scen))
    state = S._init_state(batch.hull, scen,
                          prng.key(batch.seeds, device=dev, x64=args.x64),
                          x64=args.x64)
    step = S.make_sim_step(batch.hull, scen, x64=args.x64)
    for _ in range(args.warmup):
        state = step(state)
    if args.graph:
        graph = S._TickGraph(step, state)
        graph.run(1)                       # the capture

        def run(n):
            graph.run(n)
    else:
        def run(n):
            nonlocal state
            for _ in range(n):
                state = step(state)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = lcdc_switch.LAUNCHES
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(args.ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = args.ticks
    switch_launches = lcdc_switch.LAUNCHES - before
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run(n)
    end.record()
    torch.cuda.synchronize()
    # kernels only (the CPU ops' device totals would count them twice)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    traced = busy_us > 0
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    switch = [e for e in events if "switch_tiers_kernel" in e.key]
    out = {
        "device": torch.cuda.get_device_name(0),
        "mode": "graph" if args.graph else "eager",
        "x64": args.x64,
        "scenarios": len(batch), "ticks": n,
        "wall_ms_per_tick": wall * 1e3 / n,
        "event_ms_per_tick": start.elapsed_time(end) / n,
        "device_busy_ms_per_tick": busy_us / 1e3 / n if traced else None,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if traced else None,
        "kernel_launches_per_tick": launches / n if traced else None,
        "switch_tiers_launches_per_tick": switch_launches / n,
        "switch_tiers_device_us_per_tick":
            sum(e.self_device_time_total for e in switch) / n
            if traced else None,
        "top_kernels": [{"name": e.key[:80], "calls_per_tick": e.count / n,
                         "device_us_per_tick": e.self_device_time_total / n}
                        for e in top],
        "wrapper_launch_count": lcdc_switch.LAUNCHES,
        "captures": S.CAPTURE_COUNT,
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
