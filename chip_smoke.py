"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero and prints no result):

1. the card's name and power limit (nvidia-smi), then the build of every
   CUDA source of the port with nvcc (timed, as set-up);
2. the switch_step kernel against its plain PyTorch version on the
   card, at the simulator's two tier shapes and at odd switch counts;
3. the committed golden results (tests/data/preflow_golden.json,
   "results") reproduced by ``run_sweep`` on the card;
4. the full-size main path: the paper's Fig 2 site (``FBSite()``,
   6,144 servers) under the standard 10-scenario grid, with the
   kernel's launch count and the single fold fetch checked, plus
   per-launch kernel times beside the plain version and the bound.

The line before the last is a JSON object with one entry per kernel;
the last line names the device. Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "preflow_golden.json"

MAIN_TICKS = 2000          # full-grid ticks (>= 2,000; site and batch fixed)
MAIN_CHUNK = 1000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores
# kernel vs plain version: integers exact; floats within 4 float32 ulp
# (the kernel runs the plain version's operations in the same order;
# the plain version emulates the two fused multiply-adds in float64,
# whose double rounding can differ from one hardware FMA in the last
# bit)
FLOAT_RTOL = 4 * 2.0 ** -23
PARITY_TOL = 1e-3          # run level, the reference's own parity band


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def switch_inputs(torch, S, L, K, device, seed):
    """Random switch-tick inputs: queues, stages, arrivals, drains, a
    per-link valid mask with a few all-dead switches, per-row cap."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand((S, L, K), generator=g) * 15
    stage = torch.randint(1, L + 1, (S,), generator=g, dtype=torch.int32)
    arr = torch.rand((S, K), generator=g) * 3
    drain = torch.rand((S,), generator=g) < 0.4
    valid = torch.rand((S, L), generator=g) < 0.8
    valid[: max(1, S // 20)] = False
    cap = 10.0 + torch.rand((S,), generator=g) * 15
    hi = torch.full((S,), 0.75)
    lo = torch.full((S,), 0.22)
    if K == 1:                       # the simulator's (S, L) shorthand
        q, arr = q[..., 0], arr[..., 0]
    t = [x.to(device).contiguous() for x in (q, stage, arr, drain, valid,
                                             cap, hi, lo)]
    return t[:4], dict(valid=t[4], cap=t[5], hi=t[6], lo=t[7])


def compare(torch, got, want):
    """(max abs diff, max rel diff) of the float outputs; raises on an
    integer mismatch or a float beyond FLOAT_RTOL."""
    max_abs = max_rel = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"output {i}: {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        if not a.dtype.is_floating_point:
            if not torch.equal(a, b):
                raise AssertionError(f"output {i}: integer mismatch at "
                                     f"{int((a != b).sum())} rows")
            continue
        d = (a.double() - b.double()).abs()
        scale = torch.maximum(a.double().abs(), b.double().abs())
        bad = d > FLOAT_RTOL * scale
        if bool(bad.any()):
            raise AssertionError(f"output {i}: {int(bad.sum())} values "
                                 f"beyond {FLOAT_RTOL:.2e} relative")
        max_abs = max(max_abs, float(d.max()) if d.numel() else 0.0)
        rel = d / scale.clamp(min=1e-30)
        max_rel = max(max_rel, float(rel.max()) if rel.numel() else 0.0)
    return max_abs, max_rel


def time_ms(torch, fn, reps=200):
    """Mean milliseconds per eager call (host clock and card together:
    CUDA events around ``reps`` back-to-back calls)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=200):
    """Mean milliseconds of card time per call: ``reps`` calls captured
    in one CUDA graph and replayed, so the host's Python and launch
    cost is out of the figure (each launch keeps its graph-node cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def switch_bound(args, kw, out):
    """(bound_ms, bound_by): each input read once and each output
    written once at the HBM rate, against the float operations of the
    tick at the float32 rate (about 4K+8 per port)."""
    tensors = list(args) + [kw[k] for k in ("valid", "cap", "hi", "lo")]
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + sum(t.numel() * t.element_size() for t in out)
    q = args[0]
    S, L = q.shape[0], q.shape[1]
    K = q.shape[2] if q.dim() == 3 else 1
    ops = S * L * (4 * K + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import simulator as S
        from repro_torch.core.topology import FBSite
        from repro_torch.core.traffic import TRAFFIC_SPECS
        from repro_torch.kernels import _build, lcdc_switch, ref
    except ImportError as e:
        fail(f"the port (src/repro_torch) is not importable here: {e}")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    phase("build", f"{len(libs)} CUDA source(s) built with nvcc for sm_90a "
          f"in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()))

    # 2. kernel vs plain version ----------------------------------------
    cases = [("rsw tier", 1280, 4, 2, 1.0), ("csw tier", 160, 4, 1, 4.0),
             ("odd S", 16, 16, 2, 1.0), ("odd S", 100, 16, 1, 4.0),
             ("odd S", 100, 3, 2, 2.0)]
    worst = 0.0
    for i, (name, n, L, K, rate) in enumerate(cases):
        args, kw = switch_inputs(torch, n, L, K, dev, seed=100 + i)
        got = lcdc_switch.switch_step(*args, serve_rate=rate, **kw)
        want = ref.switch_step_ref(*args, serve_rate=rate, **kw)
        torch.cuda.synchronize()
        try:
            mabs, mrel = compare(torch, got, want)
        except AssertionError as e:
            fail(f"switch_step {name} ({n}, {L}, {K}) serve {rate}: {e}")
        worst = max(worst, mrel)
        phase("kernel", f"switch_step {name} ({n}, {L}, {K}) serve {rate:g}:"
              f" ints exact, floats max abs {mabs:.3g} max rel {mrel:.3g}"
              f" (tol {FLOAT_RTOL:.3g} rel)")

    # 3. golden on the card ---------------------------------------------
    golden = json.loads(GOLDEN.read_text())
    cfg = golden["config"]
    site = FBSite(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                  csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                  fc_ring_links=8)

    def params(spec, **kw):
        return S.SimParams(spec=TRAFFIC_SPECS[spec], site=site, **kw)

    runs = [(params("fb_hadoop", gating_enabled=True, rate_scale=1.6), 8),
            (params("fb_hadoop", gating_enabled=False, rate_scale=1.6), 9),
            (params("fb_web", gating_enabled=True), 3)]
    batch = S.make_batch(runs)
    rows = golden["results"]
    if [r["label"] for r in rows] != list(batch.labels):
        fail("golden labels do not match the golden runs")
    t0 = time.perf_counter()
    res = S.run_sweep(batch, cfg["ticks"], chunk_ticks=cfg["chunk_ticks"],
                      device=dev, threefry_partitionable=False)
    torch.cuda.synchronize()
    keys = [k for k in S.PARITY_KEYS if k in rows[0]]
    diff, where = S.worst_parity(rows, res, keys)
    if not diff <= PARITY_TOL:
        fail(f"golden parity {diff:.3g} at {where} > {PARITY_TOL}")
    phase("golden", f"{len(runs)} runs x {cfg['ticks']} ticks on cuda in "
          f"{time.perf_counter() - t0:.1f} s: worst_parity {diff:.3g} "
          f"({where}) <= {PARITY_TOL} over {len(keys)} keys")

    # 4. the full-size main path ----------------------------------------
    batch = S.sweep_grid()
    hull = batch.hull
    lcdc_switch.LAUNCHES = 0
    S.HOST_TRANSFER_COUNT = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, state = S.run_sweep(batch, MAIN_TICKS, chunk_ticks=MAIN_CHUNK,
                             return_state=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lcdc_switch.LAUNCHES
    fetches = S.HOST_TRANSFER_COUNT
    if launches != 2 * MAIN_TICKS:
        fail(f"switch_step launched {launches} times, expected "
             f"{2 * MAIN_TICKS} (2 per tick)")
    if fetches != 1:
        fail(f"{fetches} fold fetches, expected exactly 1")
    for i, r in enumerate(res):
        for k, v in r.items():
            if isinstance(v, float) and not math.isfinite(v):
                fail(f"{r['label']}: {k} = {v}")
        in_flight = sum(float(getattr(state, q)[i].sum())
                        for q in ("rsw_q", "csw_up_q", "csw_down_q",
                                  "fc_down_q"))
        inj = r["injected_pkts"]
        resid = inj - (r["delivered_pkts"] + r["drop_frac"] * inj
                       + r["fault_dropped_pkts"] + in_flight)
        if not abs(resid) <= 1e-3 * max(inj, 1.0):
            fail(f"{r['label']}: conservation residual {resid:.4g} of "
                 f"{inj:.0f} injected")
    lc = [r for r in res if r["gating"]]
    savings = min(r["switch_energy_savings_frac"] for r in lc)
    phase("main", f"FBSite() {hull.n_servers} servers, {len(batch)} "
          f"scenarios x {MAIN_TICKS} ticks (chunk {MAIN_CHUNK}) on cuda: "
          f"{wall:.2f} s wall, {len(batch) * MAIN_TICKS / wall:.1f} "
          f"scenario-ticks/s; switch_step launches {launches} "
          f"(= 2 x ticks), fold fetches {fetches}; conservation holds; "
          f"min LC/DC switch savings {savings:.3f}")

    # per-launch times at the main path's two tier shapes
    B = len(batch)
    shapes = [("rsw", B * hull.n_racks, hull.csw_per_cluster, 2, 1.0),
              ("csw", B * hull.n_csw, hull.csw_uplinks, 1, 4.0)]
    tiers = {}
    for i, (name, n, L, K, rate) in enumerate(shapes):
        args, kw = switch_inputs(torch, n, L, K, dev, seed=200 + i)
        out = lcdc_switch.switch_step(*args, serve_rate=rate, **kw)
        mabs, mrel = compare(torch, out,
                             ref.switch_step_ref(*args, serve_rate=rate,
                                                 **kw))
        def kern():
            return lcdc_switch.switch_step(*args, serve_rate=rate, **kw)

        def plain_fn():
            return ref.switch_step_ref(*args, serve_rate=rate, **kw)

        ms, plain = graph_ms(torch, kern), graph_ms(torch, plain_fn, 50)
        call, plain_call = time_ms(torch, kern), time_ms(torch, plain_fn, 50)
        bound, by = switch_bound(args, kw, out)
        tiers[name] = dict(shape=[n, L, K], serve_rate=rate, ms=ms,
                           plain_ms=plain, bound_ms=bound, bound_by=by,
                           max_abs_err=mabs, eager_call_ms=call,
                           plain_eager_call_ms=plain_call)
        phase("time", f"switch_step {name} tier ({n}, {L}, {K}): card time "
              f"kernel {ms * 1e3:.2f} us/launch, plain version "
              f"{plain * 1e3:.1f} us, bound {bound * 1e3:.4f} us ({by}); "
              f"eager call from Python: kernel {call * 1e3:.1f} us, plain "
              f"{plain_call * 1e3:.1f} us; card {card}")
    mean = {k: sum(t[k] for t in tiers.values()) / len(tiers)
            for k in ("ms", "plain_ms", "bound_ms")}
    kernels = [{
        "name": "switch_step",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lcdc_switch.cu",
        "replaces": "src/repro/kernels/lcdc_switch.py:115",
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for t in tiers.values()),
        # the main path launches the two tier shapes 1:1, so its mean
        # per-launch time is the mean of the two
        "ms": mean["ms"],
        "plain_ms": mean["plain_ms"],
        "bound_ms": mean["bound_ms"],
        "bound_by": "bytes" if all(t["bound_by"] == "bytes"
                                   for t in tiers.values()) else
        "operations",
        "library_ms": None,
        "tiers": tiers,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
