"""Where one tick of the sweep goes on the card: a torch.profiler trace.

    PYTHONPATH=src python -m repro_torch.trace_sweep [--ticks 50] [--graph]
        [--x64]
    PYTHONPATH=src python -m repro_torch.trace_sweep --shard-views 2
        [--ticks 1000] [--x64]

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
fields are null and the event time is the measure.

With ``--shard-views K`` it profiles nothing: it steps the grid on the
device and laid over K views of it (as a sharded ``run_sweep`` lays its
rows out, pad rows included), both replayed from CUDA graphs, and
compares every state leaf after every tick, for up to ``--ticks``
ticks. It prints the first tick at which a leaf differs, which leaves,
and by how much, and the same for the first leaf outside the
accumulators (the carry the next tick reads), or that none did.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.core import prng
from repro_torch.core import simulator as S
from repro_torch.kernels import lcdc_switch


def first_divergence(dev, batch, views: int, ticks: int, x64: bool) -> dict:
    """The first tick at which the grid laid over ``views`` views of
    ``dev`` leaves the one-device run, leaf by leaf; and the first tick
    at which a leaf outside the accumulators does. On the card both
    replay CUDA graphs, as a sharded ``run_sweep`` does; elsewhere both
    step eagerly."""
    graph = dev.type == "cuda"
    scen, state, _, _, _ = S._prepare_sweep_args(batch, dev, fold="host",
                                                 shard=False, x64=x64)
    n_pad = len(batch) + (-len(batch)) % views
    copy = S._map_carry(S._pad_rows(state, n_pad), lambda _, t: t.clone())
    blocks = S._split_blocks(batch.hull, S._pad_rows(scen, n_pad), copy,
                             None, None, [dev] * views,
                             S._pad_rows(batch.scen.flow_mode > 0, n_pad),
                             graph=graph, threefry_partitionable=True,
                             x64=x64)
    step = S.make_sim_step(batch.hull, scen, flows=batch.flows, x64=x64)
    one = S._Block(scen, state, None, None, step,
                   S._TickGraph(step, state) if graph else None)
    out = {}
    for tick in range(1, ticks + 1):
        out["ticks_compared"] = tick
        for blk in (one, *blocks):
            if blk.ticks is None:
                S.step_into(blk.step, blk.state)
            else:
                blk.ticks.run(1)
        got = S._carry_tensors(S._gather_carry(blocks, len(batch))[0],
                               None, None)
        diff = {}
        for name, want in S._carry_tensors(state, None, None).items():
            g = got[name]
            if torch.equal(g, want):
                continue
            a, b = g.double(), want.double()
            bad = (a != b).reshape(len(batch), -1).any(dim=1)
            rel = (a - b).abs() / torch.clamp(
                torch.maximum(a.abs(), b.abs()), min=1e-30)
            diff[name] = {"max_abs": float((a - b).abs().max()),
                          "max_rel": float(rel.max()),
                          "rows": [batch.labels[i] for i in
                                   torch.nonzero(bad)[:, 0].tolist()]}
        carry = {k: v for k, v in diff.items()
                 if not k.startswith("state.acc")}
        if diff and "first" not in out:
            out["first"] = {"tick": tick, "leaves": diff}
        if carry:
            out["first_outside_accumulators"] = {"tick": tick,
                                                 "leaves": carry}
            break
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--graph", action="store_true",
                    help="replay the tick from a CUDA graph")
    ap.add_argument("--x64", action="store_true",
                    help="run the grid in the sweep's x64 mode")
    ap.add_argument("--shard-views", type=int, default=0,
                    help="compare the one-device tick with the grid laid "
                         "over this many views of the card, tick by tick")
    args = ap.parse_args()
    dev = S.resolve_device(None)
    batch = S.sweep_grid()
    if args.shard_views:
        out = first_divergence(dev, batch, args.shard_views, args.ticks,
                               args.x64)
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "views": args.shard_views, "x64": args.x64,
                          "scenarios": len(batch), **out}, indent=1))
        return
    scen = S.Scenario(*(x.to(dev) for x in batch.scen))
    state = S._init_state(batch.hull, scen,
                          prng.key(batch.seeds, device=dev, x64=args.x64),
                          x64=args.x64)
    step = S.make_sim_step(batch.hull, scen, flows=batch.flows, x64=args.x64)
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
