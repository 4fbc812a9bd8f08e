"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

``--serve ARCH`` (repeatable) runs only the build and phase
``serve-ARCH``: copied into an unpacked earlier commit, it times that
tree's serving path with the same code, so that two trees can run in
turns in one call.

Phases (one line each; any failure exits non-zero and prints no result):

1. ``build``: the card's name and power limit (nvidia-smi), then every
   CUDA source of the port built with nvcc, one process per source, all
   started together (timed, as set-up); ptxas's registers, stack frame,
   spills and static shared memory for every kernel (every float32
   lcdc_switch kernel must have a stack frame of 0 bytes: its rows live
   in registers; the float64 ones' frames are printed); and the SASS
   of the flash library (cuobjdump -sass): each bf16 tensor-core kernel
   (``WGMMA_KERNELS``: the forward at (64, 64), (128, 128) and MLA's
   (96, 64), the backward's dK/dV and dQ kernels at d 64 and 128) must
   show wgmma (HGMMA) and TMA loads
   (UTMALDG) and compile with 0 spill bytes; their registers, any ptxas
   warning about serialised wgmma, and the wkv backward's SASS
   instructions a token (what bounds it) are printed;
2. ``kernel``: each kernel against its plain PyTorch version on the
   card, at the shapes its path gives it: switch_step at the
   simulator's two tier shapes and at odd switch counts; switch_tiers
   (both tiers of a tick in one launch) at the main grid's shapes, on a
   padded multi-site hull and with faults striking links; the float64
   instantiations of both (the x64 mode's) on the same cases, in
   float64 ulp;
   flash_attention at the serve shapes of qwen3-8b, ragged, windowed,
   non-causal and d = 64 cases (each through the variant its inputs
   pick, which must be the one whose counter moved; bf16 ones also
   through the CUDA-core variant) and one float32 case, and at
   minicpm3-4b's MLA shapes (q/k 96, v 64, 40 heads: bf16 through the
   wgmma variant and the CUDA-core one) for each batcher prompt, the
   batched prefill, a ragged non-causal batch and float32;
   wkv at the
   serve shapes of rwkv6-7b (prefill at B = 1 and 8, decode T = 1, a
   ragged T, float32), planned and with one thread per column, the
   final state equal to the plain version's bit for bit; then the
   training side: both flash variants' rows' log-sum-exp (wgmma at d
   128 and at MLA's (96, 64)) against the plain logsumexp (the output
   equal to serving's launch), the flash
   backward through the variant its inputs pick (``bwd_variant``, its
   counter checked; bf16 ones also through the CUDA-core design) at
   (8, 256, 32, 128) bf16, d 64, a ragged T, non-causal with T != S, a
   sliding window, (1, 384, 32, 128) float32 and MLA's (2, 256, 40,
   96/64) (the CUDA-core backward, its log-sum-exp from the wgmma
   forward), and the wkv backward kernel at (1, 256), a ragged (2, 77)
   and (2, 1024) in bf16 and float32, each against its plain version
   (``ref.attention_bwd_ref``, ``ref.wkv_bwd_ref``) and equal to itself
   over two runs;
3. ``golden``: the committed golden results
   (tests/data/preflow_golden.json, "results") reproduced by
   ``run_sweep`` on the card with the tick replayed from a CUDA graph
   and a checkpoint at every chunk boundary, then by the last chunk
   again with eager ticks (``graph=False``), resumed with
   ``resume_sweep`` from the graph run's last checkpoint; both within
   1e-3 of the golden, and equal to each other in results and state;
3b. ``golden-x64``: the same in the x64 mode (``x64=True``) against the
   golden's ``results_x64``, every launch the float64 kernel's;
4. ``main``: the sweep path at full size, the paper's Fig 2 site
   (``FBSite()``, 6,144 servers) under the standard 10-scenario grid,
   three times with the CUDA graph, then 1,000 ticks eagerly and again
   with the graph (equal in results and state), with the switch_tiers
   launch count (one a tick), the single capture and the single fold
   fetch checked, and conservation;
4b. ``main-x64``: the same grid in the x64 mode, three times with the
   CUDA graph: its rate beside the x32 rate of this invocation, one
   float64 switch_tiers launch a tick (``LAUNCHES_F64``), one capture,
   one fold fetch, conservation;
4c. ``fabric``: the paper's analytic models, no sweep of their own:
   Fig 11's whole-DC savings at 30/50/70% util from the transceiver
   on-fraction of ``main``'s LC/DC rows, beside the paper's numbers, and
   Fig 1's final network fractions; Fig 7's traffic fidelity (200,000
   flow sizes and intervals a trace drawn on the card, Pearson r against
   the published CDFs within the reference tests' bands; the same draws
   on the CPU: mixture picks equal, values at the ulp level); the node
   timing; the scheduled and reactive ICI gating policies on
   tests/test_hlo_ici.py's step and a 4,096-tick one, the reactive run
   on the card from a CUDA graph equal to its eager run and the CPU's,
   each timed;
4d. ``sharded``: the main grid over two, then three, views of the one
   card (``_local_devices`` replaced): 1,000 ticks against ``main``'s
   one-device graph run of 1,000 (within 1e-6, bit-identity printed),
   results in caller order, pad rows dropped from ``return_state``, one
   fold fetch, one capture and one block of launches a view; a kill at
   chunk 2 on three views resumed on one, and the converse, against the
   same run;
5. ``planned``: ``run_sweep_planned`` at full width on the three fabric
   shapes of benchmarks/bench_multi_site.py (6,144 servers each) x
   {LC/DC, always-on}, fb_hadoop: 1,000 ticks in chunks of 400 (a
   remainder of 200), two buckets pipelined, then serial, then one
   bucket; labels in caller order, one capture and one fold fetch per
   bucket, 1,000 switch_tiers launches per bucket, pipelined equal to
   serial, every bucket equal to a plain ``run_sweep`` of its batch and
   conserving packets, one bucket within 1e-3 of two, no error entry and
   no retry; switch_tiers held to its plain version on each site's hull
   and each bucket's padded hull; the rate of each mode and the host time
   of each bucket's dispatch;
6. ``durable``: the main grid, 1,000 ticks in chunks of 250, plain, with
   ``validate=True``, and with a checkpoint every chunk too (all equal,
   1 + 3 transfers; the guards' and a snapshot's cost, bytes a file); a
   ``CHUNK_HOOK`` kill at chunk 3 (boundaries [1, 2] left) and
   ``resume_sweep`` from 2 (equal, one transfer); ``validate_tol=-1``
   (trips at chunk 0 for every label); ``fold="host"`` (within 1e-6);
7. ``bucket-fault``: tests/test_faults.py's two-bucket runs: a transient
   dispatch failure retried eagerly on the host fold on the card (the
   kernel launching every tick, within 1e-6), and a permanent one giving
   structured error entries and a salvage checkpoint that
   ``resume_sweep`` finishes on the card, equal to the clean bucket;
8. ``serve-qwen3-8b``, 9. ``serve-rwkv6-7b`` and 9b.
   ``serve-minicpm3-4b`` (MLA), ``serve-mixtral-8x7b`` (MoE, sliding
   window) and ``serve-jamba-v0.1-52b`` (Mamba + attention + MoE): the
   serving path at full width (random bf16 weights from a seed, loaded
   one model at a time; mixtral and jamba at 8 layers, SERVE_LAYERS):
   one request's prefill logits through the kernels against the plain
   versions (float32, over the first LOGIT_LAYERS[arch] layers; and in
   bf16 at the served depth beside the effect of a small noise, for
   scale); a ContinuousBatcher of 4 slots (max_len 512) serving 6
   requests of 64-384 prompt tokens, 32 new tokens each; the
   launch.serve path batched (B=8, P=256, gen 32); exact kernel launch
   counts (flash once an attention layer a prefill, every launch
   through the variant the prefill's head dims pick: wgmma at d = 128
   and at MLA's (96, 64); wkv once an rwkv layer a prefill
   and a decode step); prefill and decode tokens/s and the device's
   idle share (torch.profiler); then the batched prefill alone, warm
   (the median of PREFILL_REPS calls; one more under torch.profiler:
   device busy, idle share);
9c. ``train-qwen3-8b`` and ``train-rwkv6-7b``: the training path at
   full width and 8 layers (TRAIN_LAYERS; bf16, remat, AdamW): the
   gradient check (GRAD_TOL), then TRAIN_STEPS steps of B = 2 x 4,096
   tokens from ``batch_at`` through ``Trainer.run`` (no checkpoint):
   a warm-up step, a timed window of TRAIN_WINDOW, one under
   torch.profiler; loss and grad_norm a step (finite), step ms and
   tokens/s over the window, the model FLOPs' share of 989 TFLOP/s, peak
   memory, and exact launch counts (forward twice a layer a step with
   remat, backward once, every backward through the variant
   ``bwd_variant`` picks: wgmma for qwen3-8b); for qwen3-8b also the
   gradients of a 2-layer full-width bf16 model at (1, GRAD_SEQ) through
   the wgmma backward and through the CUDA-core one (``kernel_fns``
   built here), each leaf's difference as a share of its scale (a
   reading, not a gate); 9d. ``train-reduced``: tests/test_system.py's
   30 steps of reduced qwen3-0.6b through the kernels (the loss falls by
   0.5) and tests/test_checkpoint_trainer.py's kill at step 8 and
   resume, the resumed losses against the uninterrupted run's (bit for
   bit, or the difference printed);
10. ``time``: card time under CUDA-graph replay: switch_tiers a tick
   beside its first design (two switch_step launches and their
   glue), the plain version, the bound and an empty kernel's graph
   node (the launch floor); switch_step alone at the two tier shapes
   (printed right after ``main``); the float64 switch_tiers a tick
   beside the float32 kernel on the same inputs, its plain version and
   bound (printed right after ``main-x64``);
   flash_attention and wkv at each serve shape, timed in turns: the
   kernel, the first design on the same inputs (flash's CUDA-core
   variant, wkv with one thread per column), the plain version, the
   bound and, for flash_attention, scaled_dot_product_attention; at the
   training shapes also the training forward (with the log-sum-exp, or
   saving the wkv states), held against the plain versions' outputs
   the timing computed; the two backward kernels at the training
   shapes beside their plain versions (and held against them), their
   bounds and, for flash, SDPA's backward on the same tensors and the
   CUDA-core backward (the first design, ``first_ms``), timed in turns
   in the same call (and held too; the picked design's two runs equal
   bit for bit).

The line before the last is a JSON object with one entry per kernel;
the last line names the device. Imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "preflow_golden.json"

MAIN_TICKS = 2000          # full-grid ticks (>= 2,000; site and batch fixed)
MAIN_CHUNK = 1000
# the eager leg's depth; chunks of 250 give the sharded phase's kill at
# chunk 2 a boundary to resume from
MAIN_EAGER_TICKS, MAIN_EAGER_CHUNK = 1000, 250
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12     # H100 SXM float32, outside the tensor cores
FP64_OPS_PER_S = 34e12     # H100 SXM float64, outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
# kernel vs plain version: integers exact; floats within 4 float32 ulp
# (the kernel runs the plain version's operations in the same order;
# the plain version emulates the two fused multiply-adds in float64,
# whose double rounding can differ from one hardware FMA in the last
# bit)
ULP = 2.0 ** -23
FLOAT_RTOL = 4 * ULP
# the float64 kernels (x64 mode) likewise, in float64 ulp
ULP64 = 2.0 ** -52
# switch_tiers' sums over rows are held looser: to_csw (fc_in) sums n
# racks (CSWs) in index order, the plain version's torch.sum in another
# order; two orders of n non-negative terms differ by at most (n - 1)
# ulp of the sum, and the terms themselves by FLOAT_RTOL, so n + 3 ulp.
# The accumulators (2 R P 2 + 2 non-negative terms a scenario, summed per
# thread and then over the block) likewise, to 2 R P 2 + 5 ulp. The CSW
# tier is held at FLOAT_RTOL on the kernel's own to_csw.


def sum_rtol(n_terms, ulp=ULP):
    return (n_terms + 3) * ulp

PARITY_TOL = 1e-3          # run level, the reference's own parity band

# serving: the full-width models, one at a time, in this order
SERVE_ARCHS = ("qwen3-8b", "rwkv6-7b", "minicpm3-4b", "mixtral-8x7b",
               "jamba-v0.1-52b")
# the depth served on the card where the whole model does not fit its
# 80 GB beside the float32 check: mixtral-8x7b's 32 layers are 93 GB of
# bf16, its first 8 (~11.9 B parameters) 23.7 GB; jamba-v0.1-52b's one
# hybrid period of 8 layers (Mamba at 0-3 and 5-7, attention at 4, MoE
# at the odd layers; ~13.3 B parameters) 26.6 GB. The others serve all
# their layers.
SERVE_LAYERS = {"mixtral-8x7b": 8, "jamba-v0.1-52b": 8}
SERVE_SEED = 0
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW = 4, 512, 32
SERVE_PROMPTS = (64, 96, 128, 200, 256, 384)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 256, 32
# the batched prefill again, warm, after launch.serve's: its wall time
# over PREFILL_REPS calls, then one call under torch.profiler (device
# busy, idle share); launch.serve's own prefill is one cold call
PREFILL_REPS = 5
# attention and wkv kernels vs plain versions (allclose: atol + rtol *
# |plain|), as tests/test_kernels.py holds the TPU kernels: the kernels
# sum in another order, and in bf16 that flips roundings of the output
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
WKV_Y_TOL = {"bfloat16": 5e-2, "float32": 2e-3}
WKV_STATE_TOL = 2e-3
# one request's last-position logits, kernels against plain versions on
# the same weights cast to float32, over the first LOGIT_LAYERS[arch]
# layers, as a share of the logits' largest magnitude. Float32, because these
# random-weight stacks amplify any perturbation with depth: in bf16 a
# relative noise of NOISE on the plain path's own attention or wkv
# output moves the full-depth logits by a large share of their scale
# (the phase prints it beside the kernels' bf16 difference), so bf16
# logits cannot tell a rounding from a fault. In float32 the two paths
# differ only in summation order, some 1e-6 to 1e-5 of the scale at 8
# layers on an H100; a wiring fault (layout, mask, state) moves the
# logits by their own scale.
# The float32 copy is of the first LOGIT_LAYERS[arch] layers and the
# embedding and head, beside the bf16 model: qwen3-8b ~8.3 GB beside
# 16.4, rwkv6-7b ~7.3 beside 15, minicpm3-4b ~3.5 beside 8.5;
# mixtral-8x7b's 2 layers (two 8-expert MoE FFNs) ~12.7 beside 23.7;
# jamba-v0.1-52b's 5 (Mamba 0-3, MoE at 1 and 3, attention at 4) ~29
# beside 26.6 (at 8 layers it would be ~54 GB: the two no longer fit).
LOGIT_LAYERS = {"qwen3-8b": 8, "rwkv6-7b": 8, "minicpm3-4b": 8,
                "mixtral-8x7b": 2, "jamba-v0.1-52b": 5}
LOGIT_TOL = 1e-4
NOISE = 2e-3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: seconds of the run up to each phase line, credited to that line's
#: phase (the work before a line is that phase's); the [done] line
#: prints them
PHASE_SECONDS: dict = {}
_LAST_LINE = [time.perf_counter()]


def phase(name: str, msg: str) -> None:
    now = time.perf_counter()
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + now - _LAST_LINE[0]
    _LAST_LINE[0] = now
    print(f"[{name}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def switch_inputs(torch, S, L, K, device, seed, dtype=None):
    """Random switch-tick inputs: queues, stages, arrivals, drains, a
    per-link valid mask with a few all-dead switches, per-row cap; the
    queues and arrivals in ``dtype`` (float32 by default)."""
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
    if dtype is not None:
        q, arr = q.to(dtype), arr.to(dtype)
    t = [x.to(device).contiguous() for x in (q, stage, arr, drain, valid,
                                             cap, hi, lo)]
    return t[:4], dict(valid=t[4], cap=t[5], hi=t[6], lo=t[7])


def compare(torch, got, want, rtol=FLOAT_RTOL):
    """(max abs diff, max rel diff) of the float outputs; raises on an
    integer mismatch or a float beyond ``rtol``."""
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
        bad = d > rtol * scale
        if bool(bad.any()):
            raise AssertionError(f"output {i}: {int(bad.sum())} values "
                                 f"beyond {rtol:.2e} relative")
        max_abs = max(max_abs, float(d.max()) if d.numel() else 0.0)
        rel = d / scale.clamp(min=1e-30)
        max_rel = max(max_rel, float(rel.max()) if rel.numel() else 0.0)
    return max_abs, max_rel


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


def tiers_inputs(torch, S, batch, seed, fault_share, dev):
    """Random inputs of one tick's two switch tiers on ``batch``'s hull
    with its real valid masks, in ``switch_tiers``' argument order:
    queues, stages, drains, fault timers (``fault_share`` of the links
    struck), arrivals as the tick's strided ``by_dest[..., 1:]`` view,
    per-scenario caps and the accumulators."""
    from repro_torch.kernels import lcdc_switch
    hull = batch.hull
    rack_valid, csw_valid = S._site_masks(hull, batch.scen)[:2]
    B, R, P = len(batch), hull.n_racks, hull.csw_per_cluster
    NC, CUP = hull.n_csw, hull.csw_uplinks
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g)

    def timers(*shape):
        return torch.where(u(*shape) < fault_share,
                           torch.randint(1, 40, shape, generator=g),
                           0).to(torch.int32)

    def stages(n, links):
        return torch.randint(1, links + 1, (B, n), generator=g,
                             dtype=torch.int32)

    t = [u(B, R, P, 2) * 15, stages(R, P), u(B, R) < 0.3, timers(B, R, P),
         rack_valid, u(B, R, 3) * 3, u(B, NC, CUP) * 15, stages(NC, CUP),
         u(B, NC) < 0.3, timers(B, NC, CUP), csw_valid, 10 + u(B) * 15]
    t = [x.to(dev) for x in t]
    t[5] = t[5][..., 1:]
    acc = {k: (u(B) * 50).to(dev) for k in lcdc_switch.TIER_ACC}
    return (*t, acc)


def state_tiers_inputs(torch, S, batch, state, dev):
    """switch_tiers' inputs from a sweep state of ``batch`` (CPU leaves,
    as ``run_sweep(return_state=True)`` gives it), with this tick's
    arrivals drawn as small integer packet counts from a fixed seed."""
    from repro_torch.kernels import lcdc_switch
    hull = batch.hull
    rack_valid, csw_valid = S._site_masks(hull, batch.scen)[:2]
    g = torch.Generator().manual_seed(5)
    by_dest = torch.randint(0, 3, (len(batch), hull.n_racks, 3),
                            generator=g).float()
    t = [state.rsw_q, state.rsw_gate.stage, state.rsw_gate.draining,
         state.rsw_fault.timer, rack_valid, by_dest, state.csw_up_q,
         state.csw_gate.stage, state.csw_gate.draining,
         state.csw_fault.timer, csw_valid, batch.scen.queue_cap]
    t = [x.to(dev) for x in t]
    t[5] = t[5][..., 1:]
    return (*t, {k: state.acc[k].to(dev) for k in lcdc_switch.TIER_ACC})


def compare_tiers(torch, got, want, args, ulp=ULP):
    """Max abs difference of switch_tiers' outputs from the plain
    version's; raises AssertionError beyond the tolerances stated at
    FLOAT_RTOL and sum_rtol, in ``ulp`` (the float64 kernel's: ULP64).
    The CSW tier is held against the plain switch_step on the kernel's
    own to_csw."""
    from repro_torch.kernels import lcdc_switch, ref
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    csw = ref.switch_step_ref(
        args[6].reshape(B * NC, CUP), args[7].reshape(-1),
        got.to_csw[..., 1].reshape(-1), args[8].reshape(-1),
        valid=(args[10][..., None] & (args[9] == 0)).reshape(B * NC, CUP),
        cap=args[11].repeat_interleave(NC),
        serve_rate=lcdc_switch.CSW_SERVE_RATE)
    rt = 4 * ulp
    checks = [("rsw_q", got.rsw_q, want.rsw_q, rt),
              ("rsw_wait", got.rsw_wait, want.rsw_wait, rt),
              ("to_csw", got.to_csw, want.to_csw,
               sum_rtol(R // (NC // P), ulp)),
              ("fc_in", got.fc_in, want.fc_in, sum_rtol(NC, ulp)),
              ("csw_q", got.csw_q, csw[0].reshape(B, NC, CUP), rt),
              ("csw_wait", got.csw_wait, csw[5].reshape(B, NC), rt)]
    checks += [(f"acc[{k!r}]", got.acc[k], want.acc[k],
                sum_rtol(2 * R * P * 2 + 2, ulp))
               for k in lcdc_switch.TIER_ACC]
    for name, a, b, _ in checks:
        if a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.dtype} vs {b.dtype}")
    worst = 0.0
    for name, a, b, rtol in checks:
        d = (a.double() - b.double()).abs()
        bad = d > rtol * torch.maximum(a.double().abs(), b.double().abs())
        if bool(bad.any()):
            raise AssertionError(f"{name}: {int(bad.sum())} values beyond "
                                 f"{rtol:.3g} relative (max abs "
                                 f"{float(d.max()):.3g})")
        worst = max(worst, float(d.max()))
    return worst


def tiers_bound(args, out, ops_per_s=FP32_OPS_PER_S):
    """(bound_ms, bound_by) of switch_tiers: every input read once (the
    two arrival components of a rack, not the view's stride) and every
    output written once, against the float operations of both tiers'
    rows (about 4K+8 per port) at the float rate ``ops_per_s`` (float32,
    or float64 for the x64 kernel)."""
    from repro_torch.kernels import lcdc_switch
    acc = args[12]
    ins = [t for i, t in enumerate(args[:12]) if i != 5] \
        + [acc[k] for k in lcdc_switch.TIER_ACC]
    outs = list(out[:6]) + list(out.acc.values())
    nbytes = sum(t.numel() * t.element_size() for t in ins + outs) \
        + args[5].numel() * args[5].element_size()
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    ops = B * (R * P * (4 * 2 + 8) + NC * CUP * (4 + 8))
    return bound(nbytes, ops, ops_per_s)


def two_launch_tiers(torch, args):
    """A function running the first design of the tick's switch work on
    ``args``: two switch_step launches and the glue the tick ran around
    them (valid masks, contiguous arrivals, the tier sums, to_csw,
    fc_in), with the per-row knob columns built once, as make_sim_step
    built them."""
    from repro_torch.kernels import lcdc_switch
    (rsw_q, rsw_stage, rsw_drain, rsw_timer, rack_valid, arr, csw_q,
     csw_stage, csw_drain, csw_timer, csw_valid, cap, acc) = args
    B, R, P, _ = rsw_q.shape
    NC, CUP = csw_q.shape[1:]

    def cols(n):
        return dict(cap=cap.repeat_interleave(n),
                    hi=torch.full((B * n,), 0.75, device=cap.device),
                    lo=torch.full((B * n,), 0.22, device=cap.device))

    rsw_kn, csw_kn = cols(R), cols(NC)

    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def run():
        a = dict(acc)
        out = lcdc_switch.switch_step(
            flat(rsw_q), flat(rsw_stage), flat(arr).contiguous(),
            flat(rsw_drain), valid=flat(rack_valid[..., None]
                                        & (rsw_timer == 0)),
            **rsw_kn, serve_rate=lcdc_switch.RSW_SERVE_RATE)
        q = out[0].reshape(B, R, P, 2)
        served = out[1].reshape(B, R, P, 2)
        drop, wait, m1, m2 = (x.reshape(B, R) for x in out[4:])
        a["drops"] = a["drops"] + torch.sum(drop, dim=1)
        a["rsw_backlog"] = a["rsw_backlog"] + (
            torch.sum(q, dim=(1, 2, 3)) + torch.sum(served, dim=(1, 2, 3)))
        a["rsw_served"] = a["rsw_served"] + torch.sum(served, dim=(1, 2, 3))
        a["rsw_occ_m1"] = a["rsw_occ_m1"] + torch.sum(m1, dim=1)
        a["rsw_occ_m2"] = a["rsw_occ_m2"] + torch.sum(m2, dim=1)
        to_csw = torch.sum(served.reshape(B, NC // P, -1, P, 2), dim=2)
        inter_in = to_csw[..., 1].reshape(B, NC)
        out = lcdc_switch.switch_step(
            flat(csw_q), flat(csw_stage), inter_in.reshape(-1).contiguous(),
            flat(csw_drain), valid=flat(csw_valid[..., None]
                                        & (csw_timer == 0)),
            **csw_kn, serve_rate=lcdc_switch.CSW_SERVE_RATE)
        cq = out[0].reshape(B, NC, CUP)
        cserve = out[1].reshape(B, NC, CUP)
        cdrop, cwait, cm1, cm2 = (x.reshape(B, NC) for x in out[4:])
        a["drops"] = a["drops"] + torch.sum(cdrop, dim=1)
        a["csw_up_backlog"] = a["csw_up_backlog"] + torch.sum(csw_q,
                                                              dim=(1, 2))
        a["csw_up_served"] = a["csw_up_served"] + torch.sum(cserve,
                                                            dim=(1, 2))
        a["csw_occ_m1"] = a["csw_occ_m1"] + torch.sum(cm1, dim=1)
        a["csw_occ_m2"] = a["csw_occ_m2"] + torch.sum(cm2, dim=1)
        return q, wait, to_csw, cq, cwait, torch.sum(cserve, dim=1), a

    return run


def x64_tiers_args(args):
    """switch_tiers' arguments in the x64 mode's types: float64 queues
    and accumulators, the arrivals and caps float32 (the reference's x64
    tick's types)."""
    args = list(args)
    args[0], args[6] = args[0].double(), args[6].double()
    args[12] = {k: v.double() for k, v in args[12].items()}
    return tuple(args)


def check_run(S, res, state):
    """Fail unless every float metric of a run is finite and packets
    are conserved in every scenario."""
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


def time_switch(torch, dev, card, S, batch, state, launches, tiers_err):
    """Card time of switch_tiers a tick at the main grid's shapes (random
    inputs, and the main run's final ``state``) beside its first
    design, the plain version, the bound and an empty kernel's graph
    node; of switch_step alone at the two tier shapes. Returns the
    kernels-line entry."""
    from repro_torch.kernels import lcdc_switch, ref
    args = tiers_inputs(torch, S, batch, 900, 0.05, dev)
    real = state_tiers_inputs(torch, S, batch, state, dev)
    out = lcdc_switch.switch_tiers(*args)
    try:
        compare_tiers(torch, lcdc_switch.switch_tiers(*real),
                      ref.switch_tiers_ref(*real), real)
    except AssertionError as e:
        fail(f"switch_tiers on the main run's state: {e}")
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    row = turns(torch, {
        "ms": (lambda: lcdc_switch.switch_tiers(*args), 200),
        "state_ms": (lambda: lcdc_switch.switch_tiers(*real), 200),
        "first_ms": (two_launch_tiers(torch, args), 200),
        "plain_ms": (lambda: ref.switch_tiers_ref(*args), 20),
        "floor_ms": (lambda: torch.cuda._sleep(0), 200),
    })
    row["bound_ms"], row["bound_by"] = tiers_bound(args, out)
    phase("time", f"switch_tiers B={B} hull (R, P, NC, CUP) = ({R}, {P}, "
          f"{NC}, {CUP}): {row['ms'] * 1e3:.2f} us a tick on random "
          f"inputs, {row['state_ms'] * 1e3:.2f} us on the main run's final "
          f"state; first design"
          f" (two switch_step launches and their glue) "
          f"{row['first_ms'] * 1e3:.2f} us; plain version "
          f"{row['plain_ms'] * 1e3:.1f} us; empty kernel (launch floor) "
          f"{row['floor_ms'] * 1e3:.2f} us; bound "
          f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}); "
          f"{launches} launches on the path; card {card}")
    tiers = {}
    shapes = [("rsw", B * R, P, 2, 1.0), ("csw", B * NC, CUP, 1, 4.0)]
    for i, (name, n, L, K, rate) in enumerate(shapes):
        sargs, kw = switch_inputs(torch, n, L, K, dev, seed=200 + i)
        sout = lcdc_switch.switch_step(*sargs, serve_rate=rate, **kw)
        try:
            compare(torch, sout, ref.switch_step_ref(*sargs,
                                                     serve_rate=rate, **kw))
        except AssertionError as e:
            fail(f"switch_step {name} tier ({n}, {L}, {K}): {e}")
        t = turns(torch, {
            "ms": (lambda: lcdc_switch.switch_step(
                *sargs, serve_rate=rate, **kw), 200),
            "plain_ms": (lambda: ref.switch_step_ref(
                *sargs, serve_rate=rate, **kw), 50)})
        t["bound_ms"], t["bound_by"] = switch_bound(sargs, kw, sout)
        tiers[name] = dict(shape=[n, L, K], serve_rate=rate, **t)
        phase("time", f"switch_step alone, {name} tier ({n}, {L}, {K}): "
              f"{t['ms'] * 1e3:.2f} us/launch, plain version "
              f"{t['plain_ms'] * 1e3:.1f} us, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bound_by']}); card "
              f"{card}")
    return {
        "name": "switch_tiers",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lcdc_switch.cu",
        "replaces": "src/repro/kernels/lcdc_switch.py:115",
        "launches": launches,
        "max_abs_err": tiers_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "first_ms": row["first_ms"],
        "state_ms": row["state_ms"],
        "floor_ms": row["floor_ms"],
        "shape": {"B": B, "R": R, "P": P, "NC": NC, "CUP": CUP},
        "switch_step": tiers,
    }


def time_switch_f64(torch, dev, card, S, batch, state, launches, tiers_err):
    """Card time of the float64 switch_tiers a tick at the main grid's
    shapes (random inputs, and the main-x64 run's final ``state``)
    beside the float32 kernel on the same inputs (queues and
    accumulators rounded to float32), its plain version and bound.
    Returns the kernels-line entry."""
    from repro_torch.kernels import lcdc_switch, ref
    args = x64_tiers_args(tiers_inputs(torch, S, batch, 900, 0.05, dev))
    real = state_tiers_inputs(torch, S, batch, state, dev)
    out = lcdc_switch.switch_tiers(*args)
    try:
        compare_tiers(torch, lcdc_switch.switch_tiers(*real),
                      ref.switch_tiers_ref(*real), real, ULP64)
    except AssertionError as e:
        fail(f"switch_tiers float64 on the main-x64 run's state: {e}")
    f32 = list(args)
    f32[0], f32[6] = args[0].float(), args[6].float()
    f32[12] = {k: v.float() for k, v in args[12].items()}
    row = turns(torch, {
        "ms": (lambda: lcdc_switch.switch_tiers(*args), 200),
        "state_ms": (lambda: lcdc_switch.switch_tiers(*real), 200),
        "f32_ms": (lambda: lcdc_switch.switch_tiers(*f32), 200),
        "plain_ms": (lambda: ref.switch_tiers_ref(*args), 20),
    })
    row["bound_ms"], row["bound_by"] = tiers_bound(args, out,
                                                   FP64_OPS_PER_S)
    B, R, P, _ = args[0].shape
    NC, CUP = args[6].shape[1:]
    phase("time", f"switch_tiers float64 B={B} hull (R, P, NC, CUP) = "
          f"({R}, {P}, {NC}, {CUP}): {row['ms'] * 1e3:.2f} us a tick on "
          f"random inputs, {row['state_ms'] * 1e3:.2f} us on the main-x64 "
          f"run's final state; the float32 kernel on the same inputs "
          f"{row['f32_ms'] * 1e3:.2f} us; plain version "
          f"{row['plain_ms'] * 1e3:.1f} us; bound "
          f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}); "
          f"{launches} launches on the main-x64 path; card {card}")
    return {
        "name": "switch_tiers_f64",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lcdc_switch.cu",
        "replaces": "src/repro/kernels/lcdc_switch.py:115",
        "launches": launches,
        "max_abs_err": tiers_err,
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "state_ms": row["state_ms"],
        "f32_ms": row["f32_ms"],
        "shape": {"B": B, "R": R, "P": P, "NC": NC, "CUP": CUP},
    }


# the planned, durable and bucket-fault phases --------------------------

#: the three fabric shapes of benchmarks/bench_multi_site.py:41-48 (the
#: same 128 racks x 48 servers: the Fig 2 default, a wide two-cluster
#: build and a dense eight-cluster build)
MULTI_SITES = {
    "fb_clos_4x32": {},
    "wide_2x64": dict(n_clusters=2, racks_per_cluster=64, csw_per_cluster=4,
                      n_fc=4),
    "dense_8x16": dict(n_clusters=8, racks_per_cluster=16, csw_per_cluster=2,
                       n_fc=2, csw_ring_links=4, fc_ring_links=8),
}
PLAN_TICKS, PLAN_CHUNK = 1000, 400      # a remainder chunk of 200
DUR_TICKS, DUR_CHUNK = 1000, 250
HOST_FOLD_TOL = 1e-6
#: tests/test_faults.py's small site and its second bucket's site
FAULT_SITE = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                  csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                  fc_ring_links=8)
FAULT_TICKS, FAULT_CHUNK = 300, 150


def zero_counts(S, lcdc_switch):
    lcdc_switch.LAUNCHES = 0
    S.CAPTURE_COUNT = 0
    S.HOST_TRANSFER_COUNT = 0


def counts(S, lcdc_switch):
    return lcdc_switch.LAUNCHES, S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT


def strip_plan(res):
    return [{k: v for k, v in r.items()
             if k not in ("plan_bucket", "plan_hull")} for r in res]


class HostTimer:
    """Host time of each call of ``module.name`` while in a ``with``
    block (the module attribute is swapped for a timing wrapper, and
    restored on exit)."""

    def __init__(self, module, name):
        self.module, self.name, self.times = module, name, []

    def __enter__(self):
        real = self.real = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.times.append(time.perf_counter() - t0)

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def ms_list(times):
    return ", ".join(f"{t * 1e3:.1f}" for t in times)


def tiers_take_hull(torch, S, batch, label, dev):
    """Fail unless switch_tiers takes ``batch``'s hull and holds its
    plain version there (random inputs, 10% of links faulted)."""
    from repro_torch.kernels import lcdc_switch, ref
    args = tiers_inputs(torch, S, batch, 800, 0.1, dev)
    try:
        err = compare_tiers(torch, lcdc_switch.switch_tiers(*args),
                            ref.switch_tiers_ref(*args), args)
    except (AssertionError, ValueError) as e:
        fail(f"switch_tiers on {label}: {e}")
    h = batch.hull
    smem = 4 * (h.n_racks * h.csw_per_cluster * 2
                + h.n_csw * h.csw_uplinks + h.n_csw)
    return (f"{label} (R, P, NC, CUP) = ({h.n_racks}, {h.csw_per_cluster}, "
            f"{h.n_csw}, {h.csw_uplinks}), {smem} B smem of "
            f"{lcdc_switch.TIERS_SMEM_LIMIT}, max abs {err:.3g}")


def planned_phase(torch, S, dev, card):
    """The planner's path at full width: the three bench_multi_site
    sites x {LC/DC, always-on} on fb_hadoop, planned into 2 buckets
    (pipelined, then serial) and into 1, each against plain run_sweeps
    of its buckets."""
    from repro_torch.core.topology import FBSite, full_site_tag
    from repro_torch.core.traffic import TRAFFIC_SPECS
    from repro_torch.kernels import lcdc_switch
    spec = TRAFFIC_SPECS["fb_hadoop"]
    sites = {n: FBSite(**kw) for n, kw in MULTI_SITES.items()}
    runs = [(S.SimParams(spec=spec, site=s, gating_enabled=g), 0)
            for s in sites.values() for g in (True, False)]
    labels = list(S.make_multi_site_batch(runs).labels)
    hulls = [tiers_take_hull(torch, S, S.make_batch([(S.SimParams(
        spec=spec, site=s), 0)]), n, dev) for n, s in sites.items()]
    out = {}
    for mode, k, pipeline in (("pipelined", 2, True), ("serial", 2, False),
                              ("K=1", 1, True)):
        events = []
        S.BUCKET_FAIL_HOOK = lambda b, ph: events.append(
            (b, ph, time.perf_counter()))
        zero_counts(S, lcdc_switch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with HostTimer(S, "step_into") as ticks:
            res, plan = S.run_sweep_planned(
                runs, PLAN_TICKS, max_compiles=k, chunk_ticks=PLAN_CHUNK,
                return_plan=True, pipeline=pipeline, device=dev)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        S.BUCKET_FAIL_HOOK = None
        nb = plan["n_buckets"]
        got = counts(S, lcdc_switch)
        if got != (PLAN_TICKS * nb, nb, nb):
            fail(f"planned {mode}: switch_tiers launches, captures, fold "
                 f"fetches {got}; expected ({PLAN_TICKS * nb}, {nb}, {nb})")
        if [r["label"] for r in res] != labels:
            fail(f"planned {mode}: labels out of caller order")
        errs = [r["label"] for r in res if "error" in r]
        if errs or any(ph == "retry" for _, ph, _ in events):
            fail(f"planned {mode}: error entries {errs}, hook events "
                 f"{[e[:2] for e in events]}")
        # host time of each bucket's dispatch: from its "dispatch" hook
        # to the next hook call (the next dispatch, or the first fetch)
        disp = {b: events[i + 1][2] - t for i, (b, ph, t) in
                enumerate(events) if ph == "dispatch" and i + 1 < len(events)}
        out[mode] = dict(res=res, plan=plan, wall=wall,
                         rate=len(runs) * PLAN_TICKS / wall)
        phase("planned", f"{mode}: {nb} bucket(s) "
              + "; ".join(f"{b['hull']} x{b['n_scenarios']} (padded cost "
                          f"{b['padded_cost']:.0f}, waste "
                          f"{b['waste_frac']:.3f})" for b in plan["buckets"])
              + f", dispatch order {plan['dispatch_order']}: "
              f"{len(runs)} scenarios x {PLAN_TICKS} ticks (chunk "
              f"{PLAN_CHUNK}) in {wall:.3f} s wall, {out[mode]['rate']:.1f} "
              f"scenario-ticks/s; host time of each dispatch "
              + ", ".join(f"b{b} {t * 1e3:.1f} ms" for b, t in
                          sorted(disp.items()))
              + f", of it each bucket's eager first tick and its capture, in "
              f"dispatch order, {ms_list(ticks.times)} ms"
              + f"; launches {got[0]}, captures {got[1]}, fold fetches "
              f"{got[2]}; card {card}")
    if out["pipelined"]["res"] != out["serial"]["res"]:
        diff, where = S.worst_parity(out["serial"]["res"],
                                     out["pipelined"]["res"])
        fail(f"planned: pipelined differs from serial ({diff:.3g} at "
             f"{where}); they must be equal")
    for mode in ("pipelined", "K=1"):
        res, plan = out[mode]["res"], out[mode]["plan"]
        for b in plan["buckets"]:
            batch = S.make_multi_site_batch([runs[i] for i in b["indices"]])
            hulls.append(tiers_take_hull(torch, S, batch,
                                         f"bucket {b['hull']}", dev))
            if full_site_tag(batch.hull) != b["hull"]:
                fail(f"planned: bucket hull {b['hull']} is not its batch's")
            plain, state = S.run_sweep(batch, PLAN_TICKS,
                                       chunk_ticks=PLAN_CHUNK,
                                       return_state=True, device=dev)
            check_run(S, plain, state)
            if strip_plan([res[i] for i in b["indices"]]) != plain:
                fail(f"planned {mode}: bucket {b['hull']} differs from a "
                     f"plain run_sweep of its make_multi_site_batch")
    diff, where = S.worst_parity(out["pipelined"]["res"], out["K=1"]["res"])
    if not diff <= PARITY_TOL:
        fail(f"planned: K=1 vs K=2 worst_parity {diff:.3g} at {where}")
    phase("planned", "switch_tiers takes every hull: " + "; ".join(hulls))
    phase("planned", f"pipelined equals serial; every bucket equals a plain "
          f"run_sweep of its batch and conserves packets; K=1 vs K=2 "
          f"worst_parity {diff:.3g} ({where}) <= {PARITY_TOL}; rates "
          + ", ".join(f"{m} {o['rate']:.1f}" for m, o in out.items())
          + f" scenario-ticks/s; planner padded cost K=2 "
          f"{out['pipelined']['plan']['padded_cost']:.0f} vs K=1 "
          f"{out['K=1']['plan']['padded_cost']:.0f}; card {card}")


def durable_phase(torch, S, dev, card):
    """The durable path at full width: the main grid with validate=True
    and a checkpoint every chunk, a kill and its resume, a tripped guard
    and the host fold, each against the plain run."""
    import tempfile
    from repro_torch.core import checkpoint as CK
    from repro_torch.kernels import lcdc_switch
    batch = S.sweep_grid()
    n_chunks = DUR_TICKS // DUR_CHUNK

    def run(**kw):
        zero_counts(S, lcdc_switch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = S.run_sweep(batch, DUR_TICKS, chunk_ticks=DUR_CHUNK,
                          device=dev, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, counts(S, lcdc_switch)

    # plain, checked and checked + checkpointed runs, twice in turns
    # (their differences are near the host clock's spread)
    walls = {"plain": [], "validate": [], "checkpoint": []}
    snaps = []
    for _ in range(2):
        plain, t, _ = run()
        walls["plain"].append(t)
        checked, t, c = run(validate=True)
        walls["validate"].append(t)
        if checked != plain or c != (DUR_TICKS, 1, 1):
            fail(f"durable: validate=True changed the results or the "
                 f"counts {c}")
        with tempfile.TemporaryDirectory() as d, \
                HostTimer(S, "_snapshot_sweep") as snap, \
                HostTimer(S, "_fetch_stash") as fetch:
            spec = CK.CheckpointSpec(directory=d, every_chunks=1, keep=8,
                                     tag="dur")
            durable, t, c = run(validate=True, checkpoint=spec)
            walls["checkpoint"].append(t)
            files = CK.list_checkpoints(d, "dur")
            sizes = [p.stat().st_size for _, p in files]
        snaps.append((snap.times, fetch.times))
        if durable != plain or c != (DUR_TICKS, 1, 1 + n_chunks - 1):
            fail(f"durable: the checked, checkpointed run differs from the "
                 f"plain one or made (launches, captures, transfers) {c}")
        if [i for i, _ in files] != list(range(1, n_chunks)):
            fail(f"durable: boundary files {[i for i, _ in files]}")
    best = {k: min(v) for k, v in walls.items()}
    snap_ms = (best["checkpoint"] - best["validate"]) / len(files) * 1e3
    phase("durable", f"FBSite() grid, {len(batch)} scenarios x {DUR_TICKS} "
          f"ticks (chunk {DUR_CHUNK}), twice in turns: plain "
          f"{ms_list(walls['plain'])} ms, validate "
          f"{ms_list(walls['validate'])} ms, validate + a checkpoint every "
          f"chunk {ms_list(walls['checkpoint'])} ms wall; results equal; "
          f"transfers 1 + {len(files)}; best of two: the guards "
          f"{(best['validate'] - best['plain']) * 1e3:.1f} ms a run, a "
          f"snapshot {snap_ms:.1f} ms of wall; host time a snapshot "
          + "; ".join(f"{ms_list(a)} ms, of it the fetch (waiting for the "
                      f"boundary, then the copy) {ms_list(b)} ms"
                      for a, b in snaps)
          + f"; bytes a file {min(sizes)}-{max(sizes)}; card {card}")
    # the guards and a snapshot's clone and copy alone, on a fresh carry
    scen, state, fold, guard, tol = S._prepare_sweep_args(batch, dev,
                                                          validate=True)
    guard_ms = graph_ms(torch, lambda: S._guard_chunk(
        scen, state, fold, guard, 0, tol), 20)
    copy = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        S._fetch_stash(S._stash(1, state, fold, guard))
        copy.append(time.perf_counter() - t0)
    share = n_chunks * guard_ms / (best["plain"] * 1e3)
    phase("durable", f"alone: the guards {guard_ms * 1e3:.1f} us of card "
          f"time a chunk boundary ({share:.4%} of the plain run); a "
          f"snapshot's clone and copy to the host "
          f"{ms_list(copy)} ms with nothing queued; card {card}")
    with tempfile.TemporaryDirectory() as d:
        spec = CK.CheckpointSpec(directory=d, every_chunks=1, keep=8,
                                 tag="kill")

        def kill(ci):
            if ci == 3:
                raise RuntimeError("preempted")

        S.CHUNK_HOOK = kill
        try:
            run(validate=True, checkpoint=spec)
            fail("durable: the CHUNK_HOOK did not stop the run")
        except RuntimeError as e:
            if str(e) != "preempted":
                raise
        finally:
            S.CHUNK_HOOK = None
        files = CK.list_checkpoints(d, "kill")
        if [i for i, _ in files] != [1, 2]:
            fail(f"durable: a kill at chunk 3 left boundaries "
                 f"{[i for i, _ in files]}, expected [1, 2]")
        zero_counts(S, lcdc_switch)
        t0 = time.perf_counter()
        resumed = S.resume_sweep(files[-1][1], device=dev)
        t_resume = time.perf_counter() - t0
        c = counts(S, lcdc_switch)
        left = DUR_TICKS - 2 * DUR_CHUNK
        if resumed != plain or c != (left, 1, 1):
            fail(f"durable: resume from boundary 2 differs from the "
                 f"uninterrupted run or made {c}, expected ({left}, 1, 1)")
    phase("durable", f"a kill at chunk 3 left boundaries [1, 2]; resume from "
          f"2 equals the uninterrupted run ({t_resume:.3f} s, {c[0]} "
          f"launches, 1 capture, 1 transfer)")
    try:
        run(validate=True, validate_tol=-1.0)
        fail("durable: validate_tol=-1 did not trip the guards")
    except S.SweepValidationError as e:
        if e.first_bad_chunk != 0 or set(e.labels) != set(batch.labels):
            fail(f"durable: the guard named chunk {e.first_bad_chunk} and "
                 f"{len(e.labels)} of {len(batch)} labels")
    host, t_host, c = run(fold="host")
    diff, where = S.worst_parity(plain, host)
    if not diff <= HOST_FOLD_TOL or c != (DUR_TICKS, 1, n_chunks):
        fail(f"durable: host fold worst_parity {diff:.3g} at {where}, "
             f"counts {c}")
    phase("durable", f"validate_tol=-1 trips at chunk 0 for all "
          f"{len(batch)} labels; host fold {t_host:.3f} s wall, "
          f"{n_chunks} transfers, worst_parity vs the device fold "
          f"{diff:.3g} ({where}) <= {HOST_FOLD_TOL}; card {card}")


#: Fig 11's whole-DC savings as the paper quotes them at each server
#: utilization: links only / with PHY and NIC (benchmarks/bench_figures.py)
FIG11_PAPER = ((0.30, "12% / 21-27%"), (0.50, "13% / 23%"),
               (0.70, "12% / 21%"))
#: Fig 7: draws a trace and kind, the keys tests/test_traffic.py draws
#: with, and the Pearson bands it holds (sizes, intervals)
FIG7_DRAWS = 200_000
FIG7_BANDS = {"size": (0, 0.95), "interval": (1, 0.89)}
#: the samplers' card-against-CPU band: the float32 ulp of the exponent
#: (|mu + s z| < 32) in exp, as tests/test_torch_traffic.py holds them
LOGNORMAL_RTOL = 4e-6
#: tests/test_hlo_ici.py's synthetic step (1,060 ticks of 1 us) and one
#: long enough to take the reactive timeline's 4,096-tick cap
ICI_STEPS = {
    "test_hlo_ici": ("x", "train_4k", 8, 100.0, 25.0, 50.0, 10.0),
    "61 layers": ("z", "train", 61, 1234.5, 321.1, 999.0, 456.7),
}
#: the sharded phase's layouts: views of the one card (_local_devices)
SHARD_VIEWS = (2, 3)
SHARD_TOL = 1e-6


def fabric_phase(torch, dev, card, lcdc_rows):
    """The paper's analytic models on the port: Fig 11 from the main
    grid's measured transceiver on-fraction, Fig 1's final network
    fractions, Fig 7's traffic fidelity drawn on the card (and the same
    draws on the CPU), the node-level hiding condition and the ICI
    gating policies on the card."""
    from repro_torch.core import energy, ici_gating, node_model, prng
    from repro_torch.core import traffic as T

    # Fig 11 input: the mean over the five traces of the LC/DC rows'
    # transceiver on-fraction (benchmarks/bench_figures.py's arithmetic)
    on = sum(1.0 - r["switch_energy_savings_frac"] for r in lcdc_rows) \
        / len(lcdc_rows)
    if len(lcdc_rows) != 5 or not 0.0 < on < 1.0:
        fail(f"fabric: {len(lcdc_rows)} LC/DC rows, on-fraction {on}")
    for util, paper in FIG11_PAPER:
        r = energy.dc_savings(on, util)["average"]
        phase("fabric", f"Fig 11 at util {util:.0%}: whole-DC savings "
              f"{r.savings_links_only:.3f} links only / "
              f"{r.savings_with_phy_nic:.3f} with PHY and NIC (paper "
              f"{paper}), transceiver on-fraction {on:.4f} from main's "
              f"LC/DC rows, transceivers {r.transceiver_frac:.3f} of DC "
              f"power")
    fr = energy.final_network_fractions(0.30)
    tx = [v["transceivers"] for v in fr.values()]
    full = [v["phy_nic_transceivers"] for v in fr.values()]
    phase("fabric", f"Fig 1 after every server optimization at 30% util: "
          f"transceivers {sum(tx) / len(tx):.3f} of DC power on average "
          f"(paper ~20%), PHY + NIC + transceivers up to {max(full):.3f} "
          f"(paper up to 46%), over {len(fr)} designs")

    # Fig 7 on the card, and the same draws on the CPU
    cpu = torch.device("cpu")
    worst, card_s, fits = 0.0, 0.0, []
    for trace, spec in T.TRAFFIC_SPECS.items():
        for kind, (seed, band) in FIG7_BANDS.items():
            fn = T.sample_flow_sizes if kind == "size" else \
                T.sample_intervals
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(prng.key(seed, device=dev), spec, FIG7_DRAWS)
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t0
            want = fn(prng.key(seed, device=cpu), spec, FIG7_DRAWS)
            g = got.cpu().numpy().astype("float64")
            w = want.numpy().astype("float64")
            rel = float(abs(g / w - 1.0).max())
            if rel > LOGNORMAL_RTOL:
                fail(f"fabric: {trace} {kind}s on the card differ from the "
                     f"CPU's by {rel:.3g} relative (tol {LOGNORMAL_RTOL})")
            worst = max(worst, rel)
            if kind == "size":
                picks = [prng.uniform(prng.split(prng.key(seed, device=d),
                                                 3)[0], FIG7_DRAWS)
                         < torch.tensor(spec.size_w, device=d)
                         for d in (dev, cpu)]
                if not torch.equal(picks[0].cpu(), picks[1]):
                    fail(f"fabric: {trace} mixture picks differ between "
                         f"the card and the CPU")
            r = T.pearson_vs_target(g, T.TARGET_CDFS[trace][kind])
            if r < band:
                fail(f"fabric: {trace} {kind} Pearson r {r:.4f} < {band}")
            fits.append(f"{trace} {r:.4f}" if kind == "size"
                        else f"/{r:.4f}")
    phase("fabric", f"Fig 7: {FIG7_DRAWS} sizes (key 0) and intervals (key "
          f"1) a trace on the card in {card_s * 1e3:.1f} ms in all; "
          f"Pearson r sizes/intervals " + " ".join(
              a + b for a, b in zip(fits[::2], fits[1::2]))
          + f" (bands 0.95 / 0.89); the CPU's draws: picks equal, values "
          f"within {worst:.3g} relative (tol {LOGNORMAL_RTOL})")

    t = node_model.default_timing()
    phase("fabric", f"node level: TCP/IP + NIC {t.stack_ns} ns, laser "
          f"{t.laser_on_ns} ns + CDR {t.cdr_ns:.3f} ns: hidden {t.hidden}, "
          f"slack {t.slack_ns:.3f} ns, added latency "
          f"{t.added_latency_ns} ns")

    for name, fields in ICI_STEPS.items():
        ph = ici_gating.StepPhases(*fields)
        sched = ici_gating.scheduled_policy(ph)
        ms = {}
        for label, kw in (("graph", dict(device=dev)),
                          ("eager", dict(device=dev, graph=False)),
                          ("cpu", dict(device="cpu"))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = ici_gating.reactive_policy(ph, **kw)
            ms[label] = (time.perf_counter() - t0) * 1e3
            if label == "graph":
                react = out
            elif out["link_on_frac"] != react["link_on_frac"] or abs(
                    out["latency_penalty"] - react["latency_penalty"]) \
                    > 1e-6 * abs(react["latency_penalty"]):
                fail(f"fabric: reactive policy on {name}: the card's "
                     f"graph run {react} differs from the {label} run "
                     f"{out}")
        n_ticks = max(int(react["step_us"] / react["tick_us"]), 1)
        phase("fabric", f"ICI gating on the {name} step ({ph.n_layers} "
              f"layers, {ph.step_us:.1f} us): scheduled savings "
              f"{sched['ici_energy_savings']:.3f} at no latency; reactive "
              f"{react['ici_energy_savings']:.4f} at "
              f"{react['latency_penalty']:.4f} stall over {n_ticks} ticks "
              f"of {react['tick_us']:.3f} us, the card's CUDA-graph run "
              f"equal to its eager one and to the CPU's (powered "
              f"link-ticks exact); reactive_policy {ms['graph']:.1f} ms "
              f"on the card from the graph, {ms['eager']:.1f} ms eagerly, "
              f"{ms['cpu']:.1f} ms on the CPU; card {card}")


def sharded_phase(torch, S, dev, card, batch, ref, n_ticks, chunk):
    """The main grid laid over two, then three, views of the one card
    (``_local_devices`` replaced): against ``ref`` (main's one-device
    graph run of ``n_ticks``, results and state), with the layout's
    contracts; then a kill and resume across layouts."""
    import tempfile
    from repro_torch.core import checkpoint as CK
    from repro_torch.kernels import lcdc_switch

    ref_res, ref_state = ref
    local = S._local_devices
    B = len(batch)

    def views(k):
        S._local_devices = lambda d: [d] * k

    def compare(label, res, state=None):
        if [r["label"] for r in res] != list(batch.labels):
            fail(f"sharded: {label}: labels not in caller order")
        diff, where = S.worst_parity(ref_res, res)
        if diff > SHARD_TOL:
            fail(f"sharded: {label}: worst_parity {diff:.3g} at {where} "
                 f"against the one-device run (tol {SHARD_TOL})")
        same = res == ref_res
        if state is not None:
            if state.rsw_q.shape[0] != B:
                fail(f"sharded: {label}: return_state has "
                     f"{state.rsw_q.shape[0]} rows, not {B}")
            same = same and all(torch.equal(a, b) for a, b in
                                S._leaf_pairs(state, ref_state))
        return f"{diff:.3g}" + (f" (at {where})" if where else ""), same

    try:
        for k in SHARD_VIEWS:
            views(k)
            zero_counts(S, lcdc_switch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, state = S.run_sweep(batch, n_ticks, chunk_ticks=chunk,
                                     return_state=True, device=dev)
            wall = time.perf_counter() - t0
            got = counts(S, lcdc_switch)
            if got != (n_ticks * k, k, 1):
                fail(f"sharded: {k} views: switch_tiers launches, "
                     f"captures, fold fetches {got}; expected "
                     f"({n_ticks * k}, {k}, 1)")
            diff, same = compare(f"{k} views", res, state)
            pad = (-B) % k
            phase("sharded", f"{B} scenarios over {k} views of the card "
                  f"({B + pad} rows, {pad} pad), {n_ticks} ticks (chunk "
                  f"{chunk}): {wall:.2f} s wall, {B * n_ticks / wall:.1f} "
                  f"scenario-ticks/s; launches {got[0]}, captures {got[1]}, "
                  f"fold fetches {got[2]}; {len(res)} results in caller "
                  f"order, return_state {state.rsw_q.shape[0]} rows; "
                  f"worst_parity {diff} against the one-device run, "
                  f"{'bit-identical' if same else 'not bit-identical'} in "
                  f"results and state")

        def kill(ci):
            if ci == 2:
                raise RuntimeError("preempted")

        for first, then in ((3, 1), (1, 3)):
            with tempfile.TemporaryDirectory() as d:
                spec = CK.CheckpointSpec(directory=d, every_chunks=1,
                                         keep=8, tag=f"v{first}")
                views(first)
                S.CHUNK_HOOK = kill
                try:
                    S.run_sweep(batch, n_ticks, chunk_ticks=chunk,
                                device=dev, checkpoint=spec)
                    fail("sharded: the kill at chunk 2 did not stop the run")
                except RuntimeError as e:
                    if "preempted" not in str(e):
                        raise
                finally:
                    S.CHUNK_HOOK = None
                found = [c for c, _ in CK.list_checkpoints(d, spec.tag)]
                if found != [1]:
                    fail(f"sharded: the kill left boundaries {found}")
                views(then)
                zero_counts(S, lcdc_switch)
                res = S.resume_sweep(CK.latest_checkpoint(d, spec.tag),
                                     device=dev)
                rest = n_ticks - chunk
                got = counts(S, lcdc_switch)
                if got != (rest * then, then, 1):
                    fail(f"sharded: resume on {then} view(s): counts {got}")
                diff, same = compare(f"{first} -> {then} views", res)
            phase("sharded", f"killed at chunk 2 on {first} view(s), resumed "
                  f"from boundary 1 on {then}: worst_parity {diff} "
                  f"against the uninterrupted run, "
                  f"{'bit-identical' if same else 'not bit-identical'}; "
                  f"resume launches {got[0]}, captures {got[1]}, fetches "
                  f"{got[2]}; card {card}")
    finally:
        S._local_devices = local


def bucket_fault_phase(torch, S, dev):
    """Bucket isolation on the card: a transient failure retried eagerly
    on the host fold (the switch kernel still launching), and a
    permanent one degraded to error entries and a salvage checkpoint
    that resume_sweep finishes."""
    import tempfile
    from repro_torch.core import checkpoint as CK
    from repro_torch.core.topology import FBSite
    from repro_torch.core.traffic import TRAFFIC_SPECS
    from repro_torch.kernels import lcdc_switch
    a = FBSite(**FAULT_SITE)
    b = FBSite(**dict(FAULT_SITE, racks_per_cluster=4))
    spec = TRAFFIC_SPECS["fb_hadoop"]
    runs = [(S.SimParams(spec=spec, site=a), 0),
            (S.SimParams(spec=spec, site=b), 1),
            (S.SimParams(spec=spec, site=a, gating_enabled=False), 2)]

    def planned(**kw):
        return S.run_sweep_planned(runs, FAULT_TICKS, max_compiles=2,
                                   chunk_ticks=FAULT_CHUNK, device=dev, **kw)

    clean = planned()
    events = []

    def transient(k, ph):
        events.append((k, ph))
        if (k, ph) == (0, "dispatch"):
            raise RuntimeError("transient")

    S.BUCKET_FAIL_HOOK = transient
    zero_counts(S, lcdc_switch)
    res = planned()
    S.BUCKET_FAIL_HOOK = None
    c = counts(S, lcdc_switch)
    diff, where = S.worst_parity(clean, res)
    n_chunks = -(-FAULT_TICKS // FAULT_CHUNK)
    if ((0, "retry") not in events or any("error" in r for r in res)
            or not diff <= HOST_FOLD_TOL
            or c != (2 * FAULT_TICKS, 1, 1 + n_chunks)):
        fail(f"bucket-fault: transient retry: events {events}, worst_parity "
             f"{diff:.3g} at {where}, counts {c}")
    phase("bucket-fault", f"a transient dispatch failure of bucket 0 was "
          f"retried eagerly on the host fold on {dev}: worst_parity vs the "
          f"clean run {diff:.3g} <= {HOST_FOLD_TOL}; switch_tiers launches "
          f"{c[0]} (both buckets, every tick), captures {c[1]}, transfers "
          f"{c[2]}")

    def permanent(k, ph):
        if k == 0:
            raise RuntimeError("permanent")

    with tempfile.TemporaryDirectory() as d:
        S.BUCKET_FAIL_HOOK = permanent
        res = planned(checkpoint=CK.CheckpointSpec(directory=d, tag="bf",
                                                   every_chunks=1))
        S.BUCKET_FAIL_HOOK = None
        bad = [(r, c) for r, c in zip(res, clean) if "error" in r]
        good = [(r, c) for r, c in zip(res, clean) if "error" not in r]
        if not bad or not good or any(
                r["plan_bucket"] != 0 or r["error"]["stage"] != "dispatch"
                or not r["error"]["retried"] or not r["error"]["checkpoint"]
                for r, _ in bad):
            fail(f"bucket-fault: permanent failure entries "
                 f"{[r.get('error') for r in res]}")
        if any(r != c for r, c in good):
            fail("bucket-fault: the other bucket's results changed")
        resumed = S.resume_sweep(bad[0][0]["error"]["checkpoint"],
                                 device=dev)
        if resumed != strip_plan([c for _, c in bad]):
            fail("bucket-fault: resuming the salvage checkpoint does not "
                 "give the failed bucket's clean results")
    phase("bucket-fault", f"a permanent failure of bucket 0 gave "
          f"{len(bad)} structured error entries (stage dispatch, retried) "
          f"and a salvage checkpoint; resume_sweep finished it on {dev} "
          f"equal to the bucket's clean run; bucket 1 intact")

# (label, B, T, H, d, causal, window, dtype): the qwen3-8b serve shapes,
# then ragged, non-causal and d = 64 (minicpm3's head dim) bf16 cases,
# and float32 (the CUDA-core variant)
# (label, B, T, H, dq, dv, causal, window, dtype): the serve shapes of
# qwen3-8b, mixtral-8x7b and jamba-v0.1-52b (H 32, d 128) and of
# minicpm3-4b's MLA (H 40, q/k 96, v 64: the wgmma variant in bf16)
FLASH_CASES = [
    ("batched prefill", 8, 256, 32, 128, 128, True, 0, "bfloat16"),
    ("request", 1, 64, 32, 128, 128, True, 0, "bfloat16"),
    ("request", 1, 200, 32, 128, 128, True, 0, "bfloat16"),
    ("request", 1, 384, 32, 128, 128, True, 0, "bfloat16"),
    ("sliding window 128", 1, 384, 32, 128, 128, True, 128, "bfloat16"),
    ("ragged T", 1, 100, 32, 128, 128, True, 0, "bfloat16"),
    ("non-causal", 1, 128, 32, 128, 128, False, 0, "bfloat16"),
    ("head dim 64", 2, 200, 40, 64, 64, True, 0, "bfloat16"),
    ("float32", 2, 200, 8, 128, 128, True, 0, "float32"),
] + [("MLA request", 1, n, 40, 96, 64, True, 0, "bfloat16")
     for n in SERVE_PROMPTS] + [
    ("MLA batched prefill", 8, 256, 40, 96, 64, True, 0, "bfloat16"),
    ("MLA non-causal, ragged T", 2, 100, 40, 96, 64, False, 0, "bfloat16"),
    ("MLA float32", 1, 384, 40, 96, 64, True, 0, "float32"),
]
# (label, B, T, H, dh, dtype): the rwkv6-7b serve shapes
WKV_CASES = [
    ("prefill", 1, 256, 64, 64, "bfloat16"),
    ("batched prefill", 8, 256, 64, 64, "bfloat16"),
    ("decode", 4, 1, 64, 64, "bfloat16"),
    ("ragged T", 2, 100, 64, 64, "bfloat16"),
    ("float32", 1, 100, 64, 64, "float32"),
]
# the flash library's bf16 kernels (the forward at each of its (dq, dv),
# the backward at d 64 and 128) must run on the tensor cores with TMA
# tile copies: SASS opcodes of wgmma and of TMA loads
WGMMA_OPS = ("HGMMA",)
ASYNC_COPY_OPS = ("UTMALDG",)
WGMMA_KERNELS = {
    "flash_wgmma_kernel": ((64, 64), (128, 128), (96, 64)),
    "flash_bwd_wgmma_dkdv_kernel": ((64,), (128,)),
    "flash_bwd_wgmma_dq_kernel": ((64,), (128,)),
}


def allclose_err(torch, got, want, atol, rtol):
    """max |got - want|; raises AssertionError on a shape or dtype
    mismatch, a non-finite value, or any element beyond
    atol + rtol * |want|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} vs "
                             f"{tuple(want.shape)} {want.dtype}")
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    d = (g - w).abs()
    bad = d > atol + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} of {d.numel()} values "
                             f"beyond {atol:g} + {rtol:g}|plain| (max abs "
                             f"{float(d.max()):.3g})")
    return float(d.max()) if d.numel() else 0.0


def attn_inputs(torch, B, T, H, dq, dv, dtype, dev, seed):
    """Random q, k of head dim dq and v of dv."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((B, T, H, d), generator=g, device=dev).to(dtype)
            for d in (dq, dq, dv)]


def wkv_inputs(torch, B, T, H, dh, dtype, dev, seed):
    """r, k, v, w, u, state with RWKV-6's decay range w = exp(-exp(x))."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    return ((n(B, T, H, dh) * 0.5).to(dtype), (n(B, T, H, dh) * 0.5).to(dtype),
            n(B, T, H, dh).to(dtype),
            torch.exp(-torch.exp(n(B, T, H, dh) * 0.5)).to(dtype),
            (n(H, dh) * 0.3).to(dtype), n(B, H, dh, dh) * 0.1)


def visible_pairs(T, S, causal, window):
    """(query, key) pairs the masks leave visible: the work the inputs
    need."""
    n = 0
    for i in range(T):
        hi = min(i, S - 1) if causal else S - 1
        lo = max(0, i - window + 1) if window else 0
        n += max(0, hi - lo + 1)
    return n


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes at the HBM rate and
    operations at ``ops_per_s``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_bound(q, k, v, causal, window):
    """q, k, v read once and the (B, T, H, dv) output written once;
    2 dq + 2 dv operations a visible (query, key) pair (QK^T and PV), at
    the bf16 tensor rate."""
    B, T, H, dq = q.shape
    dv = v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + B * T * H * dv) \
        * q.element_size()
    return bound(nbytes, (2 * dq + 2 * dv) * B * H * visible_pairs(
        T, k.shape[1], causal, window), BF16_OPS_PER_S)


def wkv_bound(args, y, s_out):
    """r, k, v, w, u, the state read once and y, the state written once;
    4 dh^2 float32 operations a token and head (the y contraction and
    the decayed state update), at the float32 rate."""
    B, T, H, dh = args[0].shape
    nbytes = sum(t.numel() * t.element_size() for t in (*args, y, s_out))
    return bound(nbytes, 4 * B * T * H * dh * dh, FP32_OPS_PER_S)


def weighted(entries, key):
    """The launch-weighted mean of ``key`` over per-shape entries: the
    mean per launch on the path."""
    n = sum(e["launches"] for e in entries)
    return sum(e[key] * e["launches"] for e in entries) / n


def profile_busy(torch, fn, kernel_name):
    """(wall s, device-busy s, kernel launches, {kernel: ms} of the
    kernels whose names hold ``kernel_name``, top kernels) of ``fn``
    under torch.profiler; busy is the sum of kernel times."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e6
    launches = sum(e.count for e in events)
    own = {}
    for e in events:
        if kernel_name in e.key:
            k = e.key.replace("(anonymous namespace)::", "")
            k = re.sub(r"^void ", "", k).split("(", 1)[0]
            own[k] = own.get(k, 0.0) + e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    return wall, busy, launches, own, [
        (e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3))
        for e in top]


def check_attention_kernels(torch, dev):
    """flash_attention and wkv against their plain versions, each through
    the path the wrapper picks and through the first design; returns the
    largest abs error of each (of the picked path)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rwkv6_wkv
    worst = {"flash_attention": 0.0, "wkv": 0.0}
    for i, (label, B, T, H, d, dv, causal, win, dt) in enumerate(
            FLASH_CASES):
        q, k, v = attn_inputs(torch, B, T, H, d, dv, getattr(torch, dt),
                              dev, 300 + i)
        before = dict(fa.VARIANT_LAUNCHES)
        got = fa.flash_attention(q, k, v, causal=causal, swa_window=win)
        picked = fa.variant(q.dtype, d, dv)
        moved = {n: fa.VARIANT_LAUNCHES[n] - before[n] for n in before}
        if moved != {n: int(n == picked) for n in before}:
            fail(f"flash_attention {label}: picked {picked}, but the "
                 f"variant counters moved {moved}")
        want = ref.attention_ref(q, k, v, causal=causal, swa_window=win)
        tol = FLASH_TOL[dt]
        try:
            err = allclose_err(torch, got, want, tol, tol)
            also = ""
            if picked != "cuda_core":      # the first design, same inputs
                first = fa._flash_attention_variant(
                    q, k, v, "cuda_core", causal=causal, swa_window=win)
                also = (f", cuda_core variant "
                        f"{allclose_err(torch, first, want, tol, tol):.3g}")
        except AssertionError as e:
            fail(f"flash_attention {label} {(B, T, H, d, dv)}: {e}")
        worst["flash_attention"] = max(worst["flash_attention"], err)
        dims = f"{d}" if dv == d else f"q/k {d}, v {dv}"
        phase("kernel", f"flash_attention {label} ({B}, {T}, {H}, {dims}) "
              f"{dt} causal={causal} window={win}: {picked} variant max abs "
              f"{err:.3g}{also} (tol {tol:g} abs + {tol:g} rel)")
    for i, (label, B, T, H, dh, dt) in enumerate(WKV_CASES):
        args = wkv_inputs(torch, B, T, H, dh, getattr(torch, dt), dev,
                          400 + i)
        layout = rwkv6_wkv.plan(B, T, H)
        y_ref, s_ref = ref.wkv_ref(*args)
        tol = WKV_Y_TOL[dt]
        errs = []
        for lay in (layout, (1, 1)):
            y, s_out = rwkv6_wkv._wkv_planned(*args, *lay)
            torch.cuda.synchronize()
            try:
                err = allclose_err(torch, y, y_ref, tol, tol)
                s_err = allclose_err(torch, s_out, s_ref, WKV_STATE_TOL,
                                     WKV_STATE_TOL)
            except AssertionError as e:
                fail(f"wkv {label} {(B, T, H, dh)} (groups, splits) {lay}: "
                     f"{e}")
            if s_err != 0.0:
                fail(f"wkv {label} {(B, T, H, dh)} (groups, splits) {lay}: "
                     f"final state differs from the plain version's by "
                     f"{s_err:.3g} (must be bit-identical)")
            errs.append(err)
        worst["wkv"] = max(worst["wkv"], errs[0])
        phase("kernel", f"wkv {label} ({B}, {T}, {H}, {dh}) {dt}: planned "
              f"(groups, splits) {layout} y max abs {errs[0]:.3g}, "
              f"one thread a column {errs[1]:.3g} (tol {tol:g} abs + rel);"
              f" final state bit-identical to the plain version in both")
    return worst


def ptxas_report(log):
    """{kernel: (registers, stack frame bytes, spill store bytes, spill
    load bytes, static shared memory bytes)} from an ``nvcc -Xptxas -v``
    log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = [None, 0, 0, 0, 0]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur][1:4] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur][0] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out[cur][4] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def short_names(names):
    """{mangled: a short readable name} (c++filt where there is one)."""
    names = list(names)
    plain = names
    tool = shutil.which("c++filt")
    if tool and names:
        res = subprocess.run([tool], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        if res.returncode == 0:
            plain = res.stdout.splitlines()
    short = {}
    for m, p in zip(names, plain):
        p = p.replace("(anonymous namespace)::", "")
        p = re.sub(r"^void ", "", p)
        short[m] = p.split("(", 1)[0] if "(" in p else p
    return short


def sass_counts(lib, ops):
    """{kernel: {opcode: count}} of the SASS in ``lib``, with the count of
    all its instructions under "all"."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        out[name] = {op: len(re.findall(rf"\b{op}\b", chunk)) for op in ops}
        out[name]["all"] = len(re.findall(r"/\*[0-9a-f]{4,}\*/", chunk))
    return out


def build_report(libs):
    """Print ptxas's report of every kernel and check the SASS of the
    flash library: each of WGMMA_KERNELS at each of its template
    arguments must hold wgmma (HGMMA) and TMA loads (UTMALDG) and spill
    nothing."""
    from repro_torch.kernels import _build
    reports = {n: ptxas_report(_build.build_log(n)) for n in libs}
    short = short_names(k for r in reports.values() for k in r)
    for n, rep in reports.items():
        if not rep:
            fail(f"build: no ptxas report for {n}.cu (is -Xptxas -v in "
                 f"its flags?)")
        phase("build", f"{n}.cu ptxas (registers / stack frame / spill "
              f"stores / spill loads / static smem bytes): " + "; ".join(
                  f"{short[k]} {r[0]}/{r[1]}/{r[2]}/{r[3]}/{r[4]}"
                  for k, r in rep.items()))
    sw = reports["lcdc_switch"]
    f64 = {k for k in sw if "<double" in short[k]}
    framed = {short[k]: r[1] for k, r in sw.items() if r[1] and k not in f64}
    if framed:
        fail(f"build: float32 lcdc_switch kernels with a stack frame "
             f"(bytes): {framed}; their rows must live in registers")
    if not f64:
        fail("build: no float64 lcdc_switch kernels in the ptxas report")
    framed64 = {short[k]: r[1] for k, r in sw.items() if r[1] and k in f64}
    phase("build", f"lcdc_switch.cu: all {len(sw) - len(f64)} float32 "
          f"kernels have a stack frame of 0 bytes; the {len(f64)} float64 "
          f"kernels: " + (f"stack frames (bytes) {framed64}" if framed64
                          else "all 0 bytes") + "; float64 registers max "
          f"{max(sw[k][0] for k in f64)}, spills (store/load bytes) max "
          f"{max(sw[k][2] for k in f64)}/{max(sw[k][3] for k in f64)}")
    ops = WGMMA_OPS + ASYNC_COPY_OPS
    counts = sass_counts(libs["flash_attention"], ops)
    names = short_names(counts)
    for k, c in counts.items():
        phase("build", f"flash_attention SASS {names[k]}: " + ", ".join(
            f"{op} {c[op]}" for op in ops))
    flash = reports["flash_attention"]
    for base, instances in WGMMA_KERNELS.items():
        for dims in instances:
            # the mangled name holds the template arguments as
            # I Li<a>E Li<b>E ... E
            tag = base + "I" + "".join(f"Li{d}E" for d in dims) + "E"
            name = f"{base}<{', '.join(map(str, dims))}>"
            found = [k for k in counts if tag in k]
            if len(found) != 1:
                fail(f"build: expected one {name} in the SASS, found "
                     f"{found}")
            c = counts[found[0]]
            if not all(c[op] for op in ops):
                fail(f"build: {name} lacks tensor-core ({WGMMA_OPS}) "
                     f"or TMA ({ASYNC_COPY_OPS}) instructions: {c}")
            rep = [r for k, r in flash.items() if tag in k]
            if len(rep) != 1 or rep[0][2] or rep[0][3]:
                fail(f"build: {name} must compile with 0 spill bytes; "
                     f"ptxas (registers / stack / spill stores / spill "
                     f"loads / smem): {rep}")
            phase("build", f"{name}: {rep[0][0]} registers, spill stores / "
                  f"loads {rep[0][2]} / {rep[0][3]} bytes; "
                  + ", ".join(f"{op} {c[op]}" for op in ops))
    # the wkv backward is bound by the instructions each SM dispatches:
    # its SASS (the 16 tokens of a chunk unrolled) a token, and the
    # convergence checks (WARPSYNC) a branch around its shuffles would add
    wkv = {k: c for k, c in sass_counts(libs["rwkv6_wkv"], (
        "SHFL", "WARPSYNC")).items() if "wkv_bwd_kernel" in k}
    wkv_names = short_names(wkv)
    for k, c in wkv.items():
        phase("build", f"rwkv6_wkv SASS {wkv_names[k]}: {c['all']} "
              f"instructions (~{c['all'] / 16:.0f} a token of a chunk of "
              f"16), SHFL {c['SHFL']}, WARPSYNC {c['WARPSYNC']}")
    # ptxas says when it must serialise wgmma (an accumulator touched
    # while a product is in flight): print each such warning
    for line in _build.build_log("flash_attention").splitlines():
        if "wgmma" in line.lower() and "warn" in line.lower():
            phase("build", f"flash_attention ptxas: {line.strip()}")


def attn_dims(cfg):
    """(H, dq, dv): the heads and the q/k and v head dims a prefill of
    ``cfg`` hands the attention kernel (MLA: nope + rope, and v)."""
    if cfg.attn_type == "mla":
        m = cfg.mla
        return (cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
                m.v_head_dim)
    return cfg.n_heads, cfg.d_head, cfg.d_head


def serve_phase(torch, arch, dev):
    """The serving path of ``arch`` at full width (at the depth
    SERVE_LAYERS gives it). Returns the kernel launches it made, by
    kernel and shape, and its numbers."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, ops, rwkv6_wkv
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import ContinuousBatcher, Request

    name = f"serve-{arch}"
    cfg = get_config(arch)
    depth = ""
    if arch in SERVE_LAYERS:
        depth = f" (of {cfg.n_layers})"
        cfg = dataclasses.replace(cfg, n_layers=SERVE_LAYERS[arch])
    L = cfg.n_layers
    kinds = M.layer_kinds(cfg)
    n_attn = sum(k == "attn" for k, _ in kinds)
    n_rwkv = sum(k == "rwkv" for k, _ in kinds)
    H, dq, dv = attn_dims(cfg)
    picked = flash_attention.variant(cfg.dtype, dq, dv)
    mix = ", ".join(f"{n} {k}" for k, n in sorted(
        collections.Counter(k for k, _ in kinds).items()))
    n_moe = sum(f == "moe" for k, f in kinds if k != "rwkv")
    t0 = time.perf_counter()
    params = M.init_params(cfg, SERVE_SEED, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in _leaves(params))
    phase(name, f"{L}{depth} layers ({mix}; {n_moe} MoE FFNs), d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}: {n_par / 1e9:.2f} B "
          f"parameters in {cfg.dtype} (seed {SERVE_SEED}) on cuda in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")

    def expect(what, prefills, decode_steps):
        """Fail unless flash launched once an attention layer a prefill,
        through the variant the prefill's head dims pick, and wkv once
        an rwkv layer a prefill and a decode step; returns the counts."""
        want = {"flash_attention": n_attn * prefills,
                "wkv": n_rwkv * (prefills + decode_steps)}
        got = {"flash_attention": flash_attention.LAUNCHES,
               "wkv": rwkv6_wkv.LAUNCHES}
        if got != want:
            fail(f"{name}: {what} launched {got}, expected {want} ({n_attn} "
                 f"attention and {n_rwkv} rwkv layers, {prefills} prefills, "
                 f"{decode_steps} decode steps)")
        check_variant(flash_attention, got["flash_attention"], picked, name)
        return got

    rng = np.random.default_rng(SERVE_SEED)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in SERVE_PROMPTS]
    toks = torch.tensor([prompts[-1]], device=dev)
    n32 = LOGIT_LAYERS[arch]
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype=torch.float32)
    params32 = _cast(dict(params, layers=params["layers"][:n32]),
                     torch.float32)
    kern, _ = M.prefill(cfg32, params32, {"tokens": toks},
                        kernel_fns=ops.model_kernel_fns())
    plain, _ = M.prefill(cfg32, params32, {"tokens": toks})
    torch.cuda.synchronize()
    gib32 = sum(t.numel() for t in _leaves(params32)) * 4 / 2**30
    del params32
    scale = float(plain.abs().max())
    diff = float((kern - plain).abs().max())
    if not (bool(torch.isfinite(kern).all()) and diff <= LOGIT_TOL * scale):
        fail(f"{name}: prefill logits through the kernels differ from the "
             f"plain path by {diff:.3g} (scale {scale:.3g}, tol "
             f"{LOGIT_TOL:g} of it)")
    phase(name, f"prefill of {toks.shape[1]} tokens through the first "
          f"{n32} layers in float32 ({gib32:.1f} GiB), kernels vs plain "
          f"versions on the same weights: logits max abs diff {diff:.3g} of "
          f"max |logit| {scale:.3g} (tol {LOGIT_TOL:g} of it)")
    share = sensitivity(torch, cfg, params, toks, dev)
    phase(name, f"the same request through all {L} layers in bf16: the "
          f"kernels move the plain path's logits by {share['kernels']:.3g}"
          f" of their scale, a relative noise of {NOISE:g} on the plain "
          f"path's own attention/wkv outputs by {share['noise']:.3g}")

    shapes = {"flash_attention": {}, "wkv": {}}

    def add(kernel, key, n):
        if n:
            shapes[kernel][key] = shapes[kernel].get(key, 0) + n

    b = ContinuousBatcher(cfg, params, n_slots=SERVE_SLOTS,
                          max_len=SERVE_MAX_LEN)
    reqs = [Request(rid=i, tokens=p, max_new=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    reset_counts(flash_attention, rwkv6_wkv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b.run(max_ticks=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counted = expect("the batcher", b.prefills, b.decode_steps)
    for r in reqs:
        if not (r.done and len(r.out) == SERVE_NEW and
                all(0 <= t < cfg.padded_vocab for t in r.out)):
            fail(f"{name}: request {r.rid} ended with {len(r.out)} tokens, "
                 f"done={r.done}")
    for n in SERVE_PROMPTS:
        add("flash_attention", (1, n, H, dq, dv), n_attn)
        add("wkv", (1, n), n_rwkv)
    add("wkv", (SERVE_SLOTS, 1), n_rwkv * b.decode_steps)
    generated = sum(len(r.out) for r in reqs)
    launched = "; ".join(f"{k} launches {n}" for k, n in counted.items()
                         if n)
    variants = f", all through the {picked} variant" if n_attn else ""
    phase(name, f"ContinuousBatcher {SERVE_SLOTS} slots, max_len "
          f"{SERVE_MAX_LEN}: {len(reqs)} requests (prompts {SERVE_PROMPTS},"
          f" {SERVE_NEW} new tokens each) in {b.ticks} ticks, {b.prefills} "
          f"prefills, {b.decode_steps} decode steps, {wall:.2f} s wall, "
          f"{generated / wall:.1f} generated tok/s, idle_fraction "
          f"{b.idle_fraction():.3f}; {launched}{variants}")
    del b, reqs

    prompts_b = torch.as_tensor(rng.integers(
        0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    fns = ops.model_kernel_fns()
    reset_counts(flash_attention, rwkv6_wkv)
    res = serve.generate(cfg, params, prompts_b, SERVE_GEN, kernel_fns=fns)
    got = expect("launch.serve", 1, SERVE_GEN - 1)
    for k, n in got.items():
        counted[k] += n
    tokens = res["tokens"]
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_GEN) or not bool(
            ((tokens >= 0) & (tokens < cfg.padded_vocab)).all()):
        fail(f"{name}: launch.serve gave tokens of shape "
             f"{tuple(tokens.shape)}")
    add("flash_attention", (SERVE_BATCH, SERVE_PROMPT, H, dq, dv), n_attn)
    add("wkv", (SERVE_BATCH, SERVE_PROMPT), n_rwkv)
    add("wkv", (SERVE_BATCH, 1), n_rwkv * (SERVE_GEN - 1))
    own = ("flash_wgmma_kernel" if picked == "wgmma" else "flash_fwd_kernel") \
        if n_attn else "wkv_kernel"
    wall, busy, n_launch, own_ms, top = profile_busy(
        torch, lambda: serve.generate(cfg, params, prompts_b, SERVE_GEN,
                                      kernel_fns=fns), own)
    own_ms = sum(own_ms.values())
    launched = "; ".join(f"{k} launches {n}" for k, n in got.items() if n)
    phase(name, f"launch.serve B={SERVE_BATCH} P={SERVE_PROMPT} gen "
          f"{SERVE_GEN}: prefill {res['prefill_tok_s']:.1f} tok/s "
          f"({res['prefill_s'] * 1e3:.1f} ms), decode "
          f"{res['decode_tok_s']:.1f} tok/s ({res['decode_s'] * 1e3:.1f} ms"
          f" for {SERVE_GEN - 1} steps); {launched}{variants}; under "
          f"torch.profiler: {wall * 1e3:.1f} ms wall, {busy * 1e3:.1f} ms "
          f"device busy, idle share {1 - busy / wall:.3f}, {n_launch} kernel"
          f" launches ({n_launch / SERVE_GEN:.0f} a step), {own} "
          f"{own_ms:.1f} ms of the device time; top kernels (name, calls, "
          f"ms): {top}")
    time_prefill(torch, name, cfg, params, prompts_b, fns, own)
    for k in counted:
        if sum(shapes[k].values()) != counted[k]:
            fail(f"{name}: {counted[k]} {k} launches, "
                 f"{sum(shapes[k].values())} by shape")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {k: {"launches": counted[k], "shapes": shapes[k]}
            for k in counted}


def time_prefill(torch, name, cfg, params, prompts, fns, own):
    """The batched prefill alone, warm: the wall time of PREFILL_REPS
    calls (median, min, max), then one call under torch.profiler (wall,
    device busy, idle share, the attention or wkv kernel's share). Its
    launches are not counted: the serve path's were read before it."""
    from repro_torch.models import model as M

    def prefill():
        M.prefill(cfg, params, {"tokens": prompts}, kernel_fns=fns)

    walls = []
    for _ in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall, busy, n_launch, own_ms, _ = profile_busy(torch, prefill, own)
    B, P = prompts.shape
    phase(name, f"prefill alone (B={B}, P={P}), warm: "
          f"{sorted(walls)[len(walls) // 2]:.1f} ms wall, median of "
          f"{len(walls)} ({min(walls):.1f}-{max(walls):.1f}); under "
          f"torch.profiler {wall * 1e3:.1f} ms wall, {busy * 1e3:.1f} ms "
          f"device busy, idle share {1 - busy / wall:.3f}, {n_launch} kernel"
          f" launches, {own} {sum(own_ms.values()):.1f} ms")


def reset_counts(flash_attention, rwkv6_wkv):
    """Every launch count of the serving kernels to 0."""
    flash_attention.LAUNCHES = rwkv6_wkv.LAUNCHES = 0
    for n in flash_attention.VARIANT_LAUNCHES:
        flash_attention.VARIANT_LAUNCHES[n] = 0


def check_variant(flash_attention, launches, picked, name,
                  counts="VARIANT_LAUNCHES"):
    """Fail unless the variant ``picked`` made all ``launches`` flash
    launches (of the forward, or with ``counts`` "BWD_VARIANT_LAUNCHES"
    the backward's calls) since the counts were reset, and the other
    none."""
    got = dict(getattr(flash_attention, counts))
    want = {n: launches if n == picked else 0 for n in got}
    if got != want:
        fail(f"{name}: flash {counts} {got}, expected all {launches} "
             f"through {picked}")


def sensitivity(torch, cfg, params, toks, dev):
    """Full-depth bf16 prefill logits: the kernels' difference from the
    plain path, and that of the plain path with a relative noise of
    NOISE on its attention/wkv outputs, as shares of the logits'
    largest magnitude."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(1)

    def noisy(x):
        n = torch.randn(x.shape, generator=g, device=dev)
        return (x.float() * (1 + NOISE * n)).to(x.dtype)

    noise_fns = {
        "attention": lambda *a, **kw: noisy(ref.attention_ref(*a, **kw)),
        "wkv": lambda *a: (lambda y, s: (noisy(y), s))(*ref.wkv_ref(*a)),
    }
    batch = {"tokens": toks}
    plain, _ = M.prefill(cfg, params, batch)
    kern, _ = M.prefill(cfg, params, batch, kernel_fns=ops.model_kernel_fns())
    noise, _ = M.prefill(cfg, params, batch, kernel_fns=noise_fns)
    scale = float(plain.abs().max())
    return {"kernels": float((kern - plain).abs().max()) / scale,
            "noise": float((noise - plain).abs().max()) / scale}


def _cast(tree, dtype):
    """A copy of a parameter tree with every tensor cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def turns(torch, fns):
    """Card ms per call of each of ``fns`` ({name: (fn, reps)}), timed in
    turns: in order, then in reverse order; the mean of the two."""
    first = {n: graph_ms(torch, f, r) for n, (f, r) in fns.items()}
    second = {n: graph_ms(torch, f, r)
              for n, (f, r) in reversed(list(fns.items()))}
    return {n: (first[n] + second[n]) / 2 for n in fns}


def time_attention_kernels(torch, dev, card, paths, worst, train=()):
    """Per-launch card time of flash_attention and wkv at each shape of
    their serve and train paths, beside their first designs on the same
    inputs; at the shapes in ``train`` also the training forward's
    (with the log-sum-exp or the saved states); returns their entries
    of the kernels line."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rwkv6_wkv
    entries = []
    rows = []
    for (B, T, H, dq, dv), n in sorted(
            paths["flash_attention"]["shapes"].items()):
        q, k, v = attn_inputs(torch, B, T, H, dq, dv, torch.bfloat16, dev,
                              500)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        row = {"shape": [B, T, H, dq, dv], "launches": n,
               "variant": fa.variant(q.dtype, dq, dv)}
        # fewer replays where a call is long (the training shape's
        # causal work is 64x that of (8, 256))
        reps = max(3, 200 * 8 * 256 * 256 // max(B * T * T, 1) // 1)
        reps = min(200, reps)
        fns = {
            "ms": (lambda: fa.flash_attention(q, k, v, causal=True), reps),
            "library_ms": (lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), reps),
        }
        plain = {}
        if T <= 1024:
            fns["plain_ms"] = (lambda: ref.attention_ref(q, k, v,
                                                         causal=True), 20)
        if row["variant"] != "cuda_core":
            fns["first_ms"] = (lambda: fa._flash_attention_variant(
                q, k, v, "cuda_core", causal=True), reps)
        if (B, T, H, dq, dv) in train:
            fns["lse_ms"] = (lambda: fa.flash_attention_lse(
                q, k, v, causal=True), reps)
        row.update(turns(torch, fns))
        if "plain_ms" not in row:
            row["plain_ms"] = event_ms(torch, lambda: plain.__setitem__(
                "out", ref.attention_ref(q, k, v, causal=True)), 2)
        held = ""
        if (B, T, H, dq, dv) in train:
            err = hold_train_forward(torch, fa, ref, q, k, v, plain)
            worst["flash_attention"] = max(worst["flash_attention"], err)
            held = (f"; the served and training forwards hold the plain "
                    f"version here (max abs {err:.3g}, tol "
                    f"{FLASH_TOL['bfloat16']:g}; lse tol {LSE_TOL:g})")
        first = "the first design itself"
        if "first_ms" not in row:             # the kernel is the first design
            row["first_ms"] = row["ms"]
        else:
            first = f"first design (cuda_core) {row['first_ms'] * 1e3:.1f} us"
        row["bound_ms"], row["bound_by"] = flash_bound(q, k, v, True, 0)
        rows.append(row)
        dims = f"{dq}" if dq == dv else f"q/k {dq}, v {dv}"
        lse = (f" (training's, with the log-sum-exp: "
               f"{row['lse_ms'] * 1e3:.1f} us)" if "lse_ms" in row else "")
        phase("time", f"flash_attention ({B}, {T}, {H}, {dims}) bf16 causal: "
              f"kernel ({row['variant']}) {row['ms'] * 1e3:.1f} us/launch{lse}, "
              f"{first}, plain version {row['plain_ms'] * 1e3:.1f} us, sdpa "
              f"{row['library_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}): kernel "
              f"{row['ms'] / row['library_ms']:.2f}x sdpa, "
              f"{row['ms'] / row['bound_ms']:.2f}x bound; {n} launches on "
              f"the path{held}; card {card}")
        plain.clear()
    entries.append(_entry("flash_attention", "flash_attention.cu",
                          "src/repro/kernels/flash_attention.py:83",
                          paths["flash_attention"]["launches"],
                          worst["flash_attention"], rows, library=True))
    rows = []
    for (B, T), n in sorted(paths["wkv"]["shapes"].items()):
        args = wkv_inputs(torch, B, T, 64, 64, torch.bfloat16, dev, 600)
        y, s_out = rwkv6_wkv.wkv(*args)
        layout = rwkv6_wkv.plan(B, T, 64)
        row = {"shape": [B, T, 64, 64], "launches": n,
               "groups_splits": list(layout)}
        reps = 200 if T <= 1024 else 20
        fns = {
            "ms": (lambda: rwkv6_wkv.wkv(*args), reps),
            "first_ms": (lambda: rwkv6_wkv._wkv_planned(*args, 1, 1), reps),
        }
        if T <= 1024:
            fns["plain_ms"] = (lambda: ref.wkv_ref(*args),
                               max(2, min(50, 400 // T)))
        if (B, T) in train:
            fns["ckpt_ms"] = (lambda: rwkv6_wkv.wkv_ckpt(*args), reps)
        row.update(turns(torch, fns))
        plain = {}
        if "plain_ms" not in row:
            row["plain_ms"] = event_ms(torch, lambda: plain.__setitem__(
                "out", ref.wkv_ref(*args)), 1)
        held = ""
        if (B, T) in train:
            err = hold_train_wkv(torch, rwkv6_wkv, ref, args, y, s_out,
                                 plain)
            worst["wkv"] = max(worst["wkv"], err)
            held = (f"; the served and training forwards hold the plain "
                    f"version here (y max abs {err:.3g}, tol "
                    f"{WKV_Y_TOL['bfloat16']:g}; the final state "
                    f"bit-identical)")
        del plain
        row["bound_ms"], row["bound_by"] = wkv_bound(args, y, s_out)
        rows.append(row)
        ck = (f" (training's, saving the states: "
              f"{row['ckpt_ms'] * 1e3:.1f} us)" if "ckpt_ms" in row else "")
        phase("time", f"wkv ({B}, {T}, 64, 64) bf16: kernel (groups, "
              f"splits {layout}) {row['ms'] * 1e3:.1f} us/launch{ck}, "
              f"one thread a column {row['first_ms'] * 1e3:.1f} us, plain "
              f"version {row['plain_ms'] * 1e3:.1f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}): kernel "
              f"{row['ms'] / row['bound_ms']:.2f}x bound; {n} launches on "
              f"the path{held}; card {card}")
    entries.append(_entry("wkv", "rwkv6_wkv.cu",
                          "src/repro/kernels/rwkv6_wkv.py:78",
                          paths["wkv"]["launches"], worst["wkv"], rows,
                          library=False))
    return entries


def _entry(name, source, replaces, launches, max_abs_err, rows, library):
    """A kernels-line entry: times, bound and library time as the mean
    per launch on the path (weighted by each shape's launches), with
    the per-shape rows beside them; ``first_ms`` is the first design's
    time on the same inputs, where every row has one."""
    share = {}
    for r in rows:
        share[r["bound_by"]] = share.get(r["bound_by"], 0.0) \
            + r["bound_ms"] * r["launches"]
    entry = {
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": weighted(rows, "ms"),
        "plain_ms": weighted(rows, "plain_ms"),
        "bound_ms": weighted(rows, "bound_ms"),
        "bound_by": max(share, key=share.get),
        "library_ms": weighted(rows, "library_ms") if library else None,
    }
    if all("first_ms" in r for r in rows):
        entry["first_ms"] = weighted(rows, "first_ms")
    entry["shapes"] = rows
    return entry


def golden_phase(torch, S, dev, name, batch, rows, cfg, x64):
    """The golden batch on the card in one mode: a run replayed from a
    CUDA graph, with a checkpoint at every chunk boundary, then its last
    chunk again with eager ticks, resumed from the graph run's last
    checkpoint (an eager tick costs ~4 ms in x32 and ~30 ms in x64, so
    the eager leg runs one chunk, not the whole run). Both end at the
    golden's full length: each within PARITY_TOL of ``rows``, and the two
    equal, results and final state, bit for bit."""
    import tempfile
    from repro_torch.core import checkpoint as CK
    from repro_torch.kernels import lcdc_switch
    keys = [k for k in S.PARITY_KEYS if k in rows[0]]
    n, chunk = cfg["ticks"], cfg["chunk_ticks"]
    last = n // chunk - 1          # the last boundary a run snapshots
    out = {}
    with tempfile.TemporaryDirectory() as d:
        spec = CK.CheckpointSpec(directory=d, every_chunks=1, keep=last,
                                 tag="golden")
        for graph in (True, False):
            mode = "CUDA graph" if graph else "eager"
            S.CAPTURE_COUNT = 0
            lcdc_switch.LAUNCHES = lcdc_switch.LAUNCHES_F64 = 0
            t0 = time.perf_counter()
            if graph:
                ticks, what = n, f"{n} ticks"
                res, state = S.run_sweep(
                    batch, n, chunk_ticks=chunk, device=dev,
                    threefry_partitionable=False, graph=True, x64=x64,
                    checkpoint=spec, return_state=True)
            else:
                files = CK.list_checkpoints(d, "golden")
                if [i for i, _ in files] != list(range(1, last + 1)):
                    fail(f"{name}: boundary files {[i for i, _ in files]}")
                ticks = n - last * chunk
                what = (f"the last {ticks} of {n} ticks, resumed from the "
                        f"graph run's boundary {last}")
                res, state = S.resume_sweep(files[-1][1], device=dev,
                                            graph=False, x64=x64,
                                            return_state=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (S.CAPTURE_COUNT, lcdc_switch.LAUNCHES,
                   lcdc_switch.LAUNCHES_F64)
            if got != (int(graph), ticks, ticks if x64 else 0):
                fail(f"{name} ({mode}): captures, switch_tiers launches, "
                     f"float64 ones {got}")
            diff, where = S.worst_parity(rows, res, keys)
            if not diff <= PARITY_TOL:
                fail(f"{name} ({mode}): parity {diff:.3g} at {where} > "
                     f"{PARITY_TOL}")
            out[graph] = res, state
            phase(name, f"{mode}: {len(batch)} runs, {what} on cuda in "
                  f"{wall:.1f} s: worst_parity {diff:.3g} ({where}) <= "
                  f"{PARITY_TOL} over {len(keys)} keys; injected "
                  f"{res[0]['injected_pkts']:.0f} ({res[0]['label']}); "
                  f"captures {got[0]}, switch_tiers launches {got[1]} "
                  f"(float64 {got[2]})")
    (res_g, st_g), (res_e, st_e) = out[True], out[False]
    if res_g != res_e or not all(torch.equal(a, b) for a, b in
                                 S._leaf_pairs(st_g, st_e)):
        diff, where = S.worst_parity(res_e, res_g)
        fail(f"{name}: the CUDA-graph run differs from the eager one "
             f"(worst_parity {diff:.3g} at {where}); they must be equal")
    phase(name, "the CUDA-graph and eager runs end in equal results and "
          "equal state, leaf for leaf")



# training -----------------------------------------------------------------
# the full-width models trained on the card: qwen3-8b (flash) and
# rwkv6-7b (wkv), bf16, random weights from TRAIN_SEED, remat on (the
# full configs'), AdamW through Trainer.run on batch_at's tokens, no
# checkpoint. Cut in depth and batch: the whole of qwen3-8b with AdamW's
# float32 moments is ~98 GB; 8 of its 36 layers are ~2.79 B parameters,
# ~33.5 GB of weights, gradients and moments, 8 of rwkv6-7b's 32 ~2.28 B,
# ~27 GB; B = 2 sequences of the reference launcher's 4,096 tokens
# (8,192 tokens a step, against its global batch of 256).
TRAIN_ARCHS = ("qwen3-8b", "rwkv6-7b")
TRAIN_LAYERS = 8
# steps: the first (the kernels' first launches) apart, a timed window
# of TRAIN_WINDOW, then one under torch.profiler
TRAIN_BATCH, TRAIN_SEQ, TRAIN_WINDOW = 2, 4096, 3
TRAIN_STEPS = TRAIN_WINDOW + 2
TRAIN_SEED = 0
# the gradient check: the float32 kernels (forward and backward) against
# the float32 plain versions (differentiated by autograd) on the card,
# over the first GRAD_LAYERS layers (and the embedding, norm and head)
# at B = 1, T = GRAD_SEQ; every gradient leaf within GRAD_TOL of its
# largest magnitude (serving's LOGIT_TOL). The model around the kernels
# runs on float64 copies of the weights, the kernels' inputs cast to
# float32 and their outputs back: in a float32 model rwkv6-7b's
# gradients are themselves ~4e-4 of their scale from float64 (on an
# H100, PERF.md), so two float32 models that differ in one op differ by
# that much in every leaf however right the op is; in float64 the
# comparison sees the kernels alone (1.4e-5 for wkv, 1.8e-6 for flash
# there).
GRAD_LAYERS, GRAD_SEQ = 2, 1024
GRAD_TOL = LOGIT_TOL
# the backward kernels against their plain versions on the same inputs
# (ref.attention_bwd_ref, ref.wkv_bwd_ref: float32 step by step), each
# gradient within a share of its largest magnitude: float32 sums in
# another order (1e-3; they read ~1e-6), and in bf16 the gradients' own
# rounding (2^-9 of the value) grown by the sums over the sequence, as
# FLASH_TOL and WKV_Y_TOL hold the forwards' bf16 outputs (2e-2)
FLASH_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
WKV_BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
# the forwards' rows' log-sum-exp against the plain logsumexp of the
# scaled scores (abs and rel): float32 sums in another order
LSE_TOL = 1e-4
# (label, B, T, S, H, dq, dv, causal, window, dtype): the wgmma
# backward's edges (d 64, a ragged T, T != S without the causal mask, a
# window), then the CUDA-core variant's float32 and MLA cases (MLA's L
# from the wgmma forward)
FLASH_BWD_CASES = [
    ("batched prefill", 8, 256, 256, 32, 128, 128, True, 0, "bfloat16"),
    ("head dim 64", 2, 256, 256, 40, 64, 64, True, 0, "bfloat16"),
    ("ragged T", 1, 200, 200, 32, 128, 128, True, 0, "bfloat16"),
    ("non-causal, T != S", 2, 100, 160, 32, 128, 128, False, 0,
     "bfloat16"),
    ("sliding window 128", 1, 384, 384, 32, 128, 128, True, 128,
     "bfloat16"),
    ("float32", 1, 384, 384, 32, 128, 128, True, 0, "float32"),
    ("MLA", 2, 256, 256, 40, 96, 64, True, 0, "bfloat16"),
]
# (B, T, dtype, with a final-state gradient); H 64, dh 64
WKV_BWD_CASES = [(1, 256, "bfloat16", False), (1, 256, "float32", True),
                 (2, 77, "bfloat16", True),
                 (2, 1024, "bfloat16", True), (2, 1024, "float32", False)]
# train-reduced: tests/test_system.py's run (reduced qwen3-0.6b, vocab
# 256, 30 steps of B = 8 x 32 tokens at peak lr 3e-3; the loss must fall
# by 0.5) and tests/test_checkpoint_trainer.py's failure and resume
# (vocab 512, 12 steps of 4 x 16, checkpoints every 4, killed at 8)
REDUCED_STEPS, REDUCED_FALL = 30, 0.5


def rel_errs(torch, got, want):
    """max |got - want| and that over max |want|, per pair."""
    out = []
    for g, w in zip(got, want):
        d = float((g.double() - w.double()).abs().max())
        out.append((d, d / max(float(w.double().abs().max()), 1e-30)))
    return out


def check_backward_kernels(torch, dev):
    """The forwards' log-sum-exp and both backward kernels against
    their plain versions on the card; returns the backward kernels'
    largest abs errors."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rwkv6_wkv
    worst = {"flash_attention_bwd": 0.0, "wkv_bwd": 0.0}
    for i, (want_variant, B, T, H, d, dv, dt) in enumerate(
            (("wgmma", 8, 256, 32, 128, 128, "bfloat16"),
             ("wgmma", 2, 256, 40, 96, 64, "bfloat16"),     # MLA
             ("cuda_core", 1, 384, 32, 128, 128, "float32"))):
        q, k, v = attn_inputs(torch, B, T, H, d, dv, getattr(torch, dt),
                              dev, 700 + i)
        if fa.variant(q.dtype, d, dv) != want_variant:
            fail(f"flash_attention_lse: ({B}, {T}, {H}, {d}, {dv}) {dt} "
                 f"picks {fa.variant(q.dtype, d, dv)}, expected "
                 f"{want_variant}")
        out, lse = fa.flash_attention_lse(q, k, v, causal=True)
        served = fa.flash_attention(q, k, v, causal=True)
        try:
            err = allclose_err(torch, lse, ref.attention_lse_ref(q, k),
                               LSE_TOL, LSE_TOL)
        except AssertionError as e:
            fail(f"flash_attention_lse {want_variant} {(d, dv)}: {e}")
        if not torch.equal(out, served):
            fail(f"flash_attention_lse {want_variant} {(d, dv)}: the "
                 f"output differs from serving's launch")
        phase("kernel", f"flash_attention forward with log-sum-exp, "
              f"{want_variant} variant ({B}, {T}, {H}, {d}, {dv}) {dt}: lse "
              f"max abs {err:.3g} (tol {LSE_TOL:g} abs + rel); the output "
              f"equals serving's bit for bit")
    for i, (label, B, T, S, H, dq, dv, causal, win, dt) in enumerate(
            FLASH_BWD_CASES):
        g = torch.Generator(device=dev).manual_seed(720 + i)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                       .to(getattr(torch, dt)) for shape in (
                           (B, T, H, dq), (B, S, H, dq), (B, S, H, dv),
                           (B, T, H, dv)))
        fwd = fa.variant(q.dtype, dq, dv)
        fwd_before = dict(fa.VARIANT_LAUNCHES)
        out, lse = fa.flash_attention_lse(q, k, v, causal=causal,
                                          swa_window=win)
        moved = {n: fa.VARIANT_LAUNCHES[n] - fwd_before[n]
                 for n in fwd_before}
        if moved != {n: int(n == fwd) for n in fwd_before}:
            fail(f"flash_attention_lse {label}: picked {fwd}, but the "
                 f"variant counters moved {moved}")
        picked = fa.bwd_variant(q.dtype, dq, dv)
        before = dict(fa.BWD_VARIANT_LAUNCHES)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                     swa_window=win)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       swa_window=win)
        moved = {n: fa.BWD_VARIANT_LAUNCHES[n] - before[n] for n in before}
        if moved != {n: 2 * int(n == picked) for n in before}:
            fail(f"flash_attention_bwd {label}: picked {picked}, but the "
                 f"variant counters moved {moved}")
        want = ref.attention_bwd_ref(
            q, k, v, out, ref.attention_lse_ref(q, k, causal=causal,
                                                swa_window=win), do,
            causal=causal, swa_window=win)
        tol = FLASH_BWD_TOL[dt]
        designs = {picked: (got, again)}
        if picked != "cuda_core":          # the first design, same inputs
            designs["cuda_core"] = tuple(
                fa._flash_attention_bwd_variant(
                    q, k, v, out, lse, do, "cuda_core", causal=causal,
                    swa_window=win) for _ in range(2))
        torch.cuda.synchronize()
        read = {}
        for name, (a, b) in designs.items():
            errs = rel_errs(torch, a, want)
            if not all(bool(torch.isfinite(x).all()) for x in a) or any(
                    r > tol for _, r in errs):
                fail(f"flash_attention_bwd {label} {(B, T, S, H, dq, dv)} "
                     f"{dt}, {name} variant: (dq, dk, dv) errors {errs} "
                     f"(tol {tol:g} of max |plain|)")
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                fail(f"flash_attention_bwd {label}, {name} variant: two "
                     f"runs differ")
            read[name] = errs
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                           max(a for a, _ in read[picked]))
        phase("kernel", f"flash_attention backward {label} ({B}, {T}, {S}, "
              f"{H}, {dq}, {dv}) {dt} causal={causal} window={win}, L from "
              f"the {fwd} forward: "
              + "; ".join(f"{name} variant dq, dk, dv max abs " + ", ".join(
                  f"{a:.3g} ({r:.2g} of scale)" for a, r in errs)
                  for name, errs in read.items())
              + f" (tol {tol:g} of scale); each two runs equal bit for bit")
        del q, k, v, do, out, lse, got, again, want, designs
    for i, (B, T, dt, final) in enumerate(WKV_BWD_CASES):
        args = wkv_inputs(torch, B, T, 64, 64, getattr(torch, dt), dev,
                          760 + i)
        g = torch.Generator(device=dev).manual_seed(780 + i)
        dy = torch.randn(args[0].shape, generator=g, device=dev) \
            .to(args[0].dtype)
        ds = torch.randn(args[5].shape, generator=g, device=dev) \
            if final else None
        y, s, ckpt = rwkv6_wkv.wkv_ckpt(*args)
        y0, s0 = rwkv6_wkv.wkv(*args)
        if not (torch.equal(y, y0) and torch.equal(s, s0)):
            fail(f"wkv_ckpt ({B}, {T}) {dt}: differs from serving's launch")
        want = ref.wkv_bwd_ref(*args, dy, ds)
        tol = WKV_BWD_TOL[dt]
        got = rwkv6_wkv.wkv_bwd(*args[:5], ckpt, dy, ds)
        again = rwkv6_wkv.wkv_bwd(*args[:5], ckpt, dy, ds)
        torch.cuda.synchronize()
        errs = rel_errs(torch, got, want)
        if not all(bool(torch.isfinite(x).all()) for x in got) or any(
                r > tol for _, r in errs):
            fail(f"wkv_bwd ({B}, {T}, 64, 64) {dt}: (dr, dk, dv, dw, du, "
                 f"ds0) errors {errs} (tol {tol:g} of max |plain|)")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"wkv_bwd ({B}, {T}) {dt}: two runs differ")
        worst["wkv_bwd"] = max(worst["wkv_bwd"], max(a for a, _ in errs))
        phase("kernel", f"wkv backward ({B}, {T}, 64, 64) {dt}, final-state"
              f" gradient {'given' if final else 'None'}: dr, dk, dv, dw, "
              f"du, ds0 within " + ", ".join(f"{r:.2g}" for _, r in errs)
              + f" of their scales (tol {tol:g}); scratch "
              f"{ckpt.numel() * 4 / 2**20:.1f} MiB; two runs equal bit for "
              f"bit")
        del ckpt, want, got, again
    torch.cuda.empty_cache()
    return worst


def reset_train_counts(flash_attention, rwkv6_wkv):
    reset_counts(flash_attention, rwkv6_wkv)
    flash_attention.BWD_LAUNCHES = rwkv6_wkv.BWD_LAUNCHES = 0
    for n in flash_attention.BWD_VARIANT_LAUNCHES:
        flash_attention.BWD_VARIANT_LAUNCHES[n] = 0


def model_flops(cfg, params, B, T, kinds):
    """Model FLOPs of one training step (forward and backward, remat's
    recompute not counted): 6 x the tokens x the weights of every matrix
    product (the layers' matrices and the head; the embedding is a
    lookup), plus causal attention's 6 B H T^2 dh (QK^T and PV, half
    the pairs, three passes) or wkv's 3 x 4 B T H dh^2."""
    from repro_torch.core.tree import paths
    mats = sum(t.numel() for p, t in paths(params["layers"])
               if t.dim() >= 2 and p[-1] not in ("maa_wkvrg", "u"))
    head = params["embed" if cfg.tie_embeddings else "head"].numel()
    flops = 6 * B * T * (mats + head)
    for kind, _ in kinds:
        if kind == "attn":
            flops += 6 * B * cfg.n_heads * T * T * cfg.d_head
        elif kind == "rwkv":
            dh = cfg.rwkv_head_dim
            flops += 12 * B * T * (cfg.d_model // dh) * dh * dh
    return flops


def f32_kernel_fns():
    """``ops.model_kernel_fns()`` for a float64 model: the kernels run
    in float32 (inputs cast, outputs cast back), as the plain versions
    compute in float32 whatever they are given."""
    from repro_torch.kernels import ops

    def attention(q, k, v, **kw):
        return ops.attention(q.float(), k.float(), v.float(), **kw) \
            .to(q.dtype)

    def wkv(r, k, v, w, u, state):
        y, s = ops.wkv(*(x.float() for x in (r, k, v, w, u, state)))
        return y.to(r.dtype), s
    return {"attention": attention, "wkv": wkv}


def grad_check(torch, cfg, params, dev, name):
    """The gradient check: the kernel path against the plain path over
    the first GRAD_LAYERS layers at (1, GRAD_SEQ), in a float64 model.
    Returns (worst share, its leaf, leaves)."""
    from repro_torch.core.tree import leaves, paths, unflatten
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (1, GRAD_SEQ), generator=g,
                              device=dev) for k in ("tokens", "targets")}
    head = dict(params, layers=params["layers"][:GRAD_LAYERS])
    names = [".".join(map(str, p)) for p, _ in paths(head)]
    cfgx = dataclasses.replace(cfg, n_layers=GRAD_LAYERS,
                               dtype=torch.float64)
    px = _cast(head, torch.float64)
    out = {}
    for label, kf in (("kernels", f32_kernel_fns()), ("plain", None)):
        live = [t.detach().requires_grad_() for t in leaves(px)]
        loss, _ = M.train_loss(cfgx, unflatten(px, live), batch,
                               kernel_fns=kf)
        out[label] = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    errs = [r for (_, r) in rel_errs(torch, out["kernels"], out["plain"])]
    if not all(bool(torch.isfinite(a).all()) for a in out["kernels"]):
        fail(f"{name}: non-finite gradients through the kernels")
    r, leaf = max(zip(errs, names))
    del px, out
    gc.collect()
    torch.cuda.empty_cache()
    if r > GRAD_TOL:
        fail(f"{name}: gradient leaf {leaf} through the float32 kernels "
             f"differs from the plain versions' by {r:.3g} of its scale "
             f"(tol {GRAD_TOL:g})")
    return r, leaf, len(names)


def cuda_core_bwd_fns(torch):
    """``ops.model_kernel_fns()`` with the flash backward through the
    CUDA-core design whatever the inputs would pick: the forward kernel
    with its log-sum-exp, then ``_flash_attention_bwd_variant(...,
    "cuda_core")``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    class Attention(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, swa_window):
            out, lse = fa.flash_attention_lse(q, k, v, causal=causal,
                                              swa_window=swa_window)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.mask = (causal, swa_window)
            return out

        @staticmethod
        def backward(ctx, dout):
            causal, swa_window = ctx.mask
            dq, dk, dv = fa._flash_attention_bwd_variant(
                *ctx.saved_tensors, dout.contiguous(), "cuda_core",
                causal=causal, swa_window=swa_window)
            return dq, dk, dv, None, None

    def attention(q, k, v, *, causal=True, swa_window=0):
        return Attention.apply(q, k, v, causal, swa_window)
    return dict(ops.model_kernel_fns(), attention=attention)


def bwd_designs_reading(torch, cfg, params, dev):
    """The gradients of the first GRAD_LAYERS layers (and the embedding,
    norm and head) of the bf16 model at (1, GRAD_SEQ), once through the
    flash backward ``bwd_variant`` picks and once through the CUDA-core
    design: each leaf's max difference as a share of the CUDA-core
    gradient's largest magnitude. Returns (worst share, its leaf, the
    median share, leaves, the wgmma backward calls)."""
    from repro_torch.core.tree import leaves, paths, unflatten
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab, (1, GRAD_SEQ), generator=g,
                              device=dev) for k in ("tokens", "targets")}
    head = dict(params, layers=params["layers"][:GRAD_LAYERS])
    names = [".".join(map(str, p)) for p, _ in paths(head)]
    cfg2 = dataclasses.replace(cfg, n_layers=GRAD_LAYERS)
    out = {}
    before = fa.BWD_VARIANT_LAUNCHES["wgmma"]
    for label, kf in (("picked", ops.model_kernel_fns()),
                      ("cuda_core", cuda_core_bwd_fns(torch))):
        live = [t.detach().requires_grad_() for t in leaves(head)]
        loss, _ = M.train_loss(cfg2, unflatten(head, live), batch,
                               kernel_fns=kf)
        out[label] = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    calls = fa.BWD_VARIANT_LAUNCHES["wgmma"] - before
    shares = [r for _, r in rel_errs(torch, out["picked"], out["cuda_core"])]
    del out
    gc.collect()
    torch.cuda.empty_cache()
    worst, leaf = max(zip(shares, names))
    return worst, leaf, sorted(shares)[len(shares) // 2], len(names), calls


def train_phase(torch, arch, dev, card, tmp):
    """The training path of ``arch`` at full width, TRAIN_LAYERS deep:
    the float32 gradient check, then TRAIN_STEPS AdamW steps through
    Trainer.run (a warm-up step, a timed window of TRAIN_WINDOW, one
    under torch.profiler). Returns the kernel launches it made, by
    kernel and shape."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_wkv
    from repro_torch.models import model as M
    from repro_torch.optim import make_optimizer
    from repro_torch.train.trainer import Trainer, TrainerConfig

    name = f"train-{arch}"
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    kinds = M.layer_kinds(cfg)
    n_attn = sum(k == "attn" for k, _ in kinds)
    n_rwkv = sum(k == "rwkv" for k, _ in kinds)
    t0 = time.perf_counter()
    params = M.init_params(cfg, TRAIN_SEED, device=dev)
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in leaves(params))
    phase(name, f"{TRAIN_LAYERS} of {full.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}: {n_par / 1e9:.2f} B parameters "
          f"in {cfg.dtype} (seed {TRAIN_SEED}), remat {cfg.remat}, "
          f"optimizer {cfg.optimizer}, in {time.perf_counter() - t0:.1f} s")
    worst, at, n_leaves = grad_check(torch, cfg, params, dev, name)
    phase(name, f"gradients over the first {GRAD_LAYERS} layers at (1, "
          f"{GRAD_SEQ}), the float32 kernels (forward and backward) vs the "
          f"float32 plain versions (autograd) in a float64 model: all "
          f"{n_leaves} leaves within {worst:.3g} of their scale (worst "
          f"{at}; tol {GRAD_TOL:g})")
    if n_attn and fa.bwd_variant(cfg.dtype, cfg.d_head,
                                 cfg.d_head) != "cuda_core":
        worst, at, median, n_leaves, calls = bwd_designs_reading(
            torch, cfg, params, dev)
        phase(name, f"bf16 gradients over the first {GRAD_LAYERS} layers at "
              f"(1, {GRAD_SEQ}) through the wgmma flash backward ({calls} "
              f"calls) vs the CUDA-core one: the {n_leaves} leaves differ by "
              f"a median {median:.3g} and at most {worst:.3g} of their scale "
              f"({at}); a reading, not a gate")

    data = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tcfg = TrainerConfig(ckpt_dir=str(tmp / name), total_steps=1,
                         ckpt_every=0, seed=TRAIN_SEED)
    trainer = Trainer(cfg=cfg, tcfg=tcfg, data=data, device=dev)
    opt_init, _ = make_optimizer(cfg)
    state = {"params": params, "opt": opt_init(params)}
    del params
    flops = model_flops(cfg, state["params"], TRAIN_BATCH, TRAIN_SEQ, kinds)
    reset_train_counts(fa, rwkv6_wkv)
    torch.cuda.reset_peak_memory_stats()
    state = trainer.run(state, 0)
    trainer.tcfg.total_steps = 1 + TRAIN_WINDOW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = trainer.run(state, 1)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_WINDOW
    trainer.tcfg.total_steps = TRAIN_STEPS
    box = []
    own = "flash_bwd" if n_attn else "wkv_bwd_kernel"
    wall, busy, n_launch, own_ms, top = profile_busy(
        torch, lambda: box.append(trainer.run(state, TRAIN_STEPS - 1)), own)
    peak = torch.cuda.max_memory_allocated() / 2**30
    passes = 2 if cfg.remat else 1
    want = {"flash_attention": passes * n_attn * TRAIN_STEPS,
            "flash_attention_bwd": n_attn * TRAIN_STEPS,
            "wkv": passes * n_rwkv * TRAIN_STEPS,
            "wkv_bwd": n_rwkv * TRAIN_STEPS}
    got = {"flash_attention": fa.LAUNCHES,
           "flash_attention_bwd": fa.BWD_LAUNCHES,
           "wkv": rwkv6_wkv.LAUNCHES, "wkv_bwd": rwkv6_wkv.BWD_LAUNCHES}
    if got != want:
        fail(f"{name}: launches {got}, expected {want} ({n_attn} attention "
             f"and {n_rwkv} rwkv layers x {TRAIN_STEPS} steps, forward "
             f"{passes}x with remat)")
    if n_attn:
        check_variant(fa, got["flash_attention"], fa.variant(
            cfg.dtype, cfg.d_head, cfg.d_head), name)
        check_variant(fa, got["flash_attention_bwd"], fa.bwd_variant(
            cfg.dtype, cfg.d_head, cfg.d_head), name,
            "BWD_VARIANT_LAUNCHES")
    log = trainer.metrics_log
    for m in log:
        if not all(math.isfinite(m[k]) for k in ("loss", "grad_norm")):
            fail(f"{name}: step {m['step']} loss {m['loss']} grad_norm "
                 f"{m['grad_norm']}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    phase(name, "steps (loss, grad_norm, ms): " + "; ".join(
        f"{m['step']}: {m['loss']:.4f}, {m['grad_norm']:.4g}, "
        f"{m['step_time_s'] * 1e3:.1f}" for m in log)
        + " (the first with the kernels' first launches, the last under "
        "torch.profiler)")
    phase(name, f"B={TRAIN_BATCH} T={TRAIN_SEQ} ({tokens} tokens a step): "
          f"{step_s * 1e3:.1f} ms a step (the wall time of steps 1-"
          f"{TRAIN_WINDOW} over {TRAIN_WINDOW}), {tokens / step_s:.0f}"
          f" tokens/s; model FLOPs {flops / 1e12:.1f} T a step, "
          f"{flops / step_s / 1e12:.1f} TFLOP/s = "
          f"{flops / step_s / BF16_OPS_PER_S:.3f} of 989 TFLOP/s; peak "
          f"memory {peak:.1f} GiB; launches {got}, the backward's by "
          f"variant {dict(fa.BWD_VARIANT_LAUNCHES)}; the last step under "
          f"torch.profiler: {wall * 1e3:.1f} ms wall, {busy * 1e3:.1f} ms "
          f"device busy, idle share {1 - busy / wall:.3f}, {n_launch} kernel"
          f" launches, {own} {sum(own_ms.values()):.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in own_ms.items())
          + "); top kernels (name, calls, ms):"
          f" {top}; card {card}")
    del state, box, trainer
    gc.collect()
    torch.cuda.empty_cache()
    H = cfg.n_heads if n_attn else cfg.d_model // cfg.rwkv_head_dim
    dh = cfg.d_head if n_attn else cfg.rwkv_head_dim
    shape = (TRAIN_BATCH, TRAIN_SEQ, H, dh, dh) if n_attn else \
        (TRAIN_BATCH, TRAIN_SEQ)
    return {k: {"launches": n, "shapes": {shape: n} if n else {}}
            for k, n in got.items()}


def train_reduced_phase(torch, dev, card, tmp):
    """tests/test_system.py's training run and
    tests/test_checkpoint_trainer.py's failure and resume on the card,
    through the kernels."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_wkv
    from repro_torch.train.trainer import (SimulatedFailure, Trainer,
                                           TrainerConfig)
    name = "train-reduced"
    base = reduced(get_config("qwen3-0.6b"))
    cfg = dataclasses.replace(base, vocab=256)
    trainer = Trainer(cfg=cfg, tcfg=TrainerConfig(
        ckpt_dir=str(tmp / "reduced"), total_steps=REDUCED_STEPS,
        ckpt_every=0, peak_lr=3e-3), data=DataConfig(
            vocab=256, seq_len=32, global_batch=8), device=dev)
    reset_train_counts(fa, rwkv6_wkv)
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    losses = trainer.losses()
    want = REDUCED_STEPS * cfg.n_layers
    if (fa.LAUNCHES, fa.BWD_LAUNCHES) != (want, want):
        fail(f"{name}: flash launches {fa.LAUNCHES}, backward "
             f"{fa.BWD_LAUNCHES}, expected {want} each")
    if not losses[-1] < losses[0] - REDUCED_FALL:
        fail(f"{name}: the loss went from {losses[0]:.4f} to "
             f"{losses[-1]:.4f} in {REDUCED_STEPS} steps (must fall by "
             f"{REDUCED_FALL})")
    phase(name, f"reduced qwen3-0.6b (vocab 256) {REDUCED_STEPS} steps of "
          f"8 x 32 tokens through the flash kernels (forward and backward "
          f"{want} launches each) in {wall:.2f} s: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (must fall by {REDUCED_FALL})")

    cfg = dataclasses.replace(base, vocab=512)
    data = DataConfig(vocab=512, seq_len=16, global_batch=4)

    def make(path, fail_at=None):
        return Trainer(cfg=cfg, tcfg=TrainerConfig(
            ckpt_dir=str(tmp / path), total_steps=12, ckpt_every=4,
            fail_at_step=fail_at), data=data, device=dev)
    ref = make("uninterrupted")
    ref.run()
    killed = make("resumed", fail_at=8)
    try:
        killed.run()
        fail(f"{name}: fail_at_step=8 did not raise")
    except SimulatedFailure:
        pass
    resumed = make("resumed")
    resumed.run()
    a, b = resumed.losses(), ref.losses()[8:]
    diff = max(abs(x - y) for x, y in zip(a, b))
    exact = a == b
    phase(name, f"killed after step 8 (checkpoints every 4), resumed from "
          f"its checkpoint: steps 8-11 losses {a} against the uninterrupted"
          f" run's {b}: " + ("equal bit for bit" if exact else
                             f"NOT bit-exact, max diff {diff:.3g}"))
    return exact, diff


def hold_grads(torch, label, got, want, tol):
    """A backward kernel's gradients against the plain version's: each
    finite and within ``tol`` of the plain one's largest magnitude;
    returns (max abs, share of scale) per gradient."""
    torch.cuda.synchronize()
    errs = rel_errs(torch, got, want)
    if not all(bool(torch.isfinite(g).all()) for g in got) or any(
            r > tol for _, r in errs):
        fail(f"{label}: gradient errors {errs} (tol {tol:g} of max "
             f"|plain|)")
    return errs


def hold_train_forward(torch, fa, ref, q, k, v, plain):
    """At a training shape: the served forward and the training one
    (with the log-sum-exp) against ``plain["out"]``, the plain output the
    timing computed (else computed here), under FLASH_TOL and LSE_TOL;
    returns the max abs."""
    if "out" not in plain:
        plain["out"] = ref.attention_ref(q, k, v, causal=True)
    want = plain["out"]
    out, lse = fa.flash_attention_lse(q, k, v, causal=True)
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    err = 0.0
    try:
        for got in (fa.flash_attention(q, k, v, causal=True), out):
            err = max(err, allclose_err(torch, got, want, tol, tol))
        allclose_err(torch, lse, ref.attention_lse_ref(q, k), LSE_TOL,
                     LSE_TOL)
    except AssertionError as e:
        fail(f"flash_attention {tuple(q.shape)} training shape: {e}")
    return err


def hold_train_wkv(torch, rwkv6_wkv, ref, args, y, s_out, plain):
    """At a training shape: the served wkv (``y``, ``s_out``) and the
    training one (saving the states) against ``plain["out"]``, the plain
    version's output the timing computed (else computed here), y under
    WKV_Y_TOL and the final state bit-identical, as in phase ``kernel``;
    returns the max abs of y."""
    if "out" not in plain:
        plain["out"] = ref.wkv_ref(*args)
    want_y, want_s = plain["out"]
    yc, sc, _ = rwkv6_wkv.wkv_ckpt(*args)
    tol = WKV_Y_TOL[str(y.dtype).split(".")[-1]]
    err = 0.0
    try:
        for got_y, got_s in ((y, s_out), (yc, sc)):
            err = max(err, allclose_err(torch, got_y, want_y, tol, tol))
            if not torch.equal(got_s, want_s):
                raise AssertionError("the final state differs from the "
                                     "plain version's (must be "
                                     "bit-identical)")
    except AssertionError as e:
        fail(f"wkv {tuple(y.shape)} training shape: {e}")
    return err


def event_turns(torch, fns):
    """``turns`` with ``event_ms`` in place of CUDA-graph replay."""
    first = {n: event_ms(torch, f, r) for n, (f, r) in fns.items()}
    second = {n: event_ms(torch, f, r)
              for n, (f, r) in reversed(list(fns.items()))}
    return {n: (first[n] + second[n]) / 2 for n in fns}


def event_ms(torch, fn, reps):
    """Mean milliseconds per call between CUDA events around ``reps``
    eager calls after one warm-up (the plain versions, whose Python
    loops a CUDA graph would capture as tens of thousands of nodes)."""
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


def flash_bwd_bound(q, v, causal, window):
    """q, k, v, o, dout and the log-sum-exp read once, dq, dk, dv
    written once; 6 dq + 4 dv operations a visible pair (S, dP, dV, dK,
    dQ), at the bf16 tensor rate."""
    B, T, H, dq = q.shape
    dv = v.shape[-1]
    nbytes = (2 * 2 * B * T * H * dq + 3 * B * T * H * dv) * q.element_size() \
        + B * H * T * 4
    return bound(nbytes, (6 * dq + 4 * dv) * B * H * visible_pairs(
        T, T, causal, window), BF16_OPS_PER_S)


def wkv_bwd_bound(args, ckpt):
    """r, k, v, w, u, dy and the saved states read once, the gradients
    written once; 10 dh^2 float32 operations a token and head (dr, dk,
    dv, dw and the state gradient's update), at the float32 rate."""
    B, T, H, dh = args[0].shape
    el = args[0].element_size()
    nbytes = (5 * 2 * B * T * H * dh + 2 * H * dh) * el \
        + ckpt.numel() * 4 + 2 * B * H * dh * dh * 4
    return bound(nbytes, 10 * B * T * H * dh * dh, FP32_OPS_PER_S)


def time_backward_kernels(torch, dev, card, paths, worst):
    """Per-call card time of the two backward kernels at the training
    shapes beside their bounds, plain versions and (flash) SDPA's
    backward on the same tensors; returns their entries of the kernels
    line."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, rwkv6_wkv
    entries = []
    rows = []
    for (B, T, H, dq, dv), n in sorted(
            paths["flash_attention_bwd"]["shapes"].items()):
        q, k, v = attn_inputs(torch, B, T, H, dq, dv, torch.bfloat16, dev,
                              800)
        do = attn_inputs(torch, B, T, H, dv, dv, torch.bfloat16, dev, 801)[0]
        out, lse = fa.flash_attention_lse(q, k, v, causal=True)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        dot = do.transpose(1, 2)
        row = {"shape": [B, T, H, dq, dv], "launches": n}
        picked = fa.bwd_variant(q.dtype, dq, dv)
        # the picked design, the CUDA-core first design and SDPA's
        # backward on the same tensors, in turns
        row.update(event_turns(torch, {
            "ms": (lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                  causal=True), 5),
            "first_ms": (lambda: fa._flash_attention_bwd_variant(
                q, k, v, out, lse, do, "cuda_core", causal=True), 2),
            "library_ms": (lambda: torch.autograd.grad(
                sdpa, (qt, kt, vt), dot, retain_graph=True), 10),
        }))
        plain = {}
        row["plain_ms"] = event_ms(torch, lambda: plain.__setitem__(
            "grads", ref.attention_bwd_ref(q, k, v, out, lse, do,
                                           causal=True)), 1)
        want = plain.pop("grads")
        label = f"flash_attention_bwd ({B}, {T}, {H}, {dq}, {dv}) bf16"
        got = [fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
               for _ in range(2)]
        errs = hold_grads(torch, f"{label}, {picked} variant", got[0], want,
                          FLASH_BWD_TOL["bfloat16"])
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            fail(f"{label}, {picked} variant: two runs differ")
        del got
        first = hold_grads(torch, f"{label}, cuda_core variant",
                           fa._flash_attention_bwd_variant(
                               q, k, v, out, lse, do, "cuda_core",
                               causal=True), want,
                           FLASH_BWD_TOL["bfloat16"])
        worst["flash_attention_bwd"] = max(worst["flash_attention_bwd"],
                                           max(a for a, _ in errs))
        del want
        row["bound_ms"], row["bound_by"] = flash_bwd_bound(q, v, True, 0)
        rows.append(row)
        phase("time", f"flash_attention backward ({B}, {T}, {H}, {dq}) bf16 "
              f"causal: {picked} variant {row['ms']:.3f} ms/call (three "
              f"launches), the CUDA-core first design {row['first_ms']:.3f} "
              f"ms ({row['first_ms'] / row['ms']:.1f}x the {picked}), plain "
              f"version {row['plain_ms']:.1f} ms, SDPA's backward "
              f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}): kernel {row['ms'] / row['library_ms']:.2f}"
              f"x SDPA's, {row['ms'] / row['bound_ms']:.1f}x bound; {n} "
              f"calls on the path; dq, dk, dv within "
              + ", ".join(f"{r:.2g}" for _, r in errs)
              + " of the plain version's scales, two runs equal bit for bit"
              " (the CUDA-core design "
              + ", ".join(f"{r:.2g}" for _, r in first)
              + f"; tol {FLASH_BWD_TOL['bfloat16']:g}); card {card}")
        del q, k, v, do, out, lse, qt, kt, vt, sdpa, dot
    e = _entry("flash_attention_bwd", "flash_attention.cu",
               "src/repro/kernels/flash_attention.py:83",
               paths["flash_attention_bwd"]["launches"],
               worst["flash_attention_bwd"], rows, library=True)
    e["note"] = ("port-side backward, no Pallas counterpart: pallas_call "
                 "has no usable JVP in jax 0.9")
    entries.append(e)
    rows = []
    for (B, T), n in sorted(paths["wkv_bwd"]["shapes"].items()):
        args = wkv_inputs(torch, B, T, 64, 64, torch.bfloat16, dev, 820)
        dy = wkv_inputs(torch, B, T, 64, 64, torch.bfloat16, dev, 821)[0]
        _, _, ckpt = rwkv6_wkv.wkv_ckpt(*args)
        row = {"shape": [B, T, 64, 64], "launches": n,
               "ms": event_ms(torch, lambda: rwkv6_wkv.wkv_bwd(
                   *args[:5], ckpt, dy), 10)}
        plain = {}
        row["plain_ms"] = event_ms(torch, lambda: plain.__setitem__(
            "grads", ref.wkv_bwd_ref(*args, dy)), 1)
        want = plain.pop("grads")
        got = [rwkv6_wkv.wkv_bwd(*args[:5], ckpt, dy) for _ in range(2)]
        errs = hold_grads(torch, f"wkv_bwd ({B}, {T}, 64, 64) bf16", got[0],
                          want, WKV_BWD_TOL["bfloat16"])
        if not all(torch.equal(a, b) for a, b in zip(*got)):
            fail(f"wkv_bwd ({B}, {T}, 64, 64) bf16: two runs differ")
        del got
        worst["wkv_bwd"] = max(worst["wkv_bwd"], max(a for a, _ in errs))
        del want
        row["bound_ms"], row["bound_by"] = wkv_bwd_bound(args, ckpt)
        rows.append(row)
        phase("time", f"wkv backward ({B}, {T}, 64, 64) bf16: kernel "
              f"{row['ms']:.3f} ms/launch, plain version "
              f"{row['plain_ms']:.1f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}): kernel {row['ms'] / row['bound_ms']:.2f}"
              f"x bound; scratch {ckpt.numel() * 4 / 2**20:.0f} MiB a layer;"
              f" {n} launches on the path; dr, dk, dv, dw, du, ds0 within "
              + ", ".join(f"{r:.2g}" for _, r in errs)
              + " of the plain version's scales, two runs equal bit for bit"
              f" (tol {WKV_BWD_TOL['bfloat16']:g}); card {card}")
        del args, dy, ckpt
    e = _entry("wkv_bwd", "rwkv6_wkv.cu", "src/repro/kernels/rwkv6_wkv.py:78",
               paths["wkv_bwd"]["launches"], worst["wkv_bwd"], rows,
               library=False)
    e["note"] = ("port-side backward, no Pallas counterpart: pallas_call "
                 "has no usable JVP in jax 0.9")
    entries.append(e)
    torch.cuda.empty_cache()
    return entries


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Drive the port's main paths on one GPU and check them; "
        "with --serve, only the build and the named serve phases (to time "
        "one tree's serving path against another's, in turns).")
    ap.add_argument("--serve", action="append", choices=SERVE_ARCHS,
                    metavar="ARCH", help="run only phase serve-ARCH "
                    "(repeatable); prints no kernels or device line")
    serve_only = ap.parse_args().serve
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
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 compares
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = _LAST_LINE[0] = time.perf_counter()
    card = card_line()
    print(card, flush=True)

    # 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    phase("build", f"{len(libs)} CUDA source(s) built with nvcc for sm_90a "
          f"in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs.values()))
    if serve_only:
        for arch in serve_only:
            serve_phase(torch, arch, dev)
        phase("done", f"serve phases {', '.join(serve_only)} passed in "
              f"{time.perf_counter() - t_start:.0f} s; card {card}")
        return
    build_report(libs)

    # 2. kernel vs plain version ----------------------------------------
    cases = [("rsw tier", 1280, 4, 2, 1.0), ("csw tier", 160, 4, 1, 4.0),
             ("odd S", 16, 16, 2, 1.0), ("odd S", 100, 16, 1, 4.0),
             ("odd S", 100, 3, 2, 2.0)]
    worst_step = 0.0
    for i, (name, n, L, K, rate) in enumerate(cases):
        args, kw = switch_inputs(torch, n, L, K, dev, seed=100 + i)
        got = lcdc_switch.switch_step(*args, serve_rate=rate, **kw)
        want = ref.switch_step_ref(*args, serve_rate=rate, **kw)
        torch.cuda.synchronize()
        try:
            mabs, mrel = compare(torch, got, want)
        except AssertionError as e:
            fail(f"switch_step {name} ({n}, {L}, {K}) serve {rate}: {e}")
        worst_step = max(worst_step, mrel)
        phase("kernel", f"switch_step {name} ({n}, {L}, {K}) serve {rate:g}:"
              f" ints exact, floats max abs {mabs:.3g} max rel {mrel:.3g}"
              f" (tol {FLOAT_RTOL:.3g} rel)")
    worst_step64 = 0.0
    for i, (name, n, L, K, rate) in enumerate(cases):
        args, kw = switch_inputs(torch, n, L, K, dev, seed=150 + i,
                                 dtype=torch.float64)
        got = lcdc_switch.switch_step(*args, serve_rate=rate, **kw)
        want = ref.switch_step_ref(*args, serve_rate=rate, **kw)
        torch.cuda.synchronize()
        try:
            mabs, mrel = compare(torch, got, want, 4 * ULP64)
        except AssertionError as e:
            fail(f"switch_step float64 {name} ({n}, {L}, {K}) serve "
                 f"{rate}: {e}")
        worst_step64 = max(worst_step64, mrel)
    phase("kernel", f"switch_step float64, the same {len(cases)} cases: ints "
          f"exact, floats max rel {worst_step64:.3g} (tol "
          f"{4 * ULP64:.3g} rel)")

    grid = S.sweep_grid()
    padded = S.make_multi_site_batch(
        S.grid_runs(traces=("fb_web", "fb_hadoop"))
        + S.grid_runs(traces=("fb_web",), site=FBSite(
            n_clusters=2, racks_per_cluster=40, csw_per_cluster=5,
            n_fc=3)))
    tiers_err = 0.0
    for i, (label, b, share) in enumerate([
            ("main grid", grid, 0.0), ("faults striking links", grid, 0.15),
            ("padded multi-site hull", padded, 0.1)]):
        args = tiers_inputs(torch, S, b, 700 + i, share, dev)
        got = lcdc_switch.switch_tiers(*args)
        want = ref.switch_tiers_ref(*args)
        torch.cuda.synchronize()
        try:
            err = compare_tiers(torch, got, want, args)
        except AssertionError as e:
            fail(f"switch_tiers {label}: {e}")
        tiers_err = max(tiers_err, err)
        B, R, P, _ = args[0].shape
        NC, CUP = args[6].shape[1:]
        phase("kernel", f"switch_tiers {label}, B={B} on hull (R, P, NC, "
              f"CUP) = ({R}, {P}, {NC}, {CUP}), {share:.0%} of links "
              f"faulted: queues and waits within {FLOAT_RTOL:.3g} rel, "
              f"to_csw within {sum_rtol(R // (NC // P)):.3g}, fc_in "
              f"{sum_rtol(NC):.3g}, accumulators "
              f"{sum_rtol(2 * R * P * 2 + 2):.3g}; max abs {err:.3g}")

    tiers_err64 = 0.0
    for i, (label, b, share) in enumerate([
            ("main grid", grid, 0.0), ("faults striking links", grid, 0.15),
            ("padded multi-site hull", padded, 0.1)]):
        args = x64_tiers_args(tiers_inputs(torch, S, b, 750 + i, share, dev))
        before = lcdc_switch.LAUNCHES_F64
        got = lcdc_switch.switch_tiers(*args)
        if lcdc_switch.LAUNCHES_F64 != before + 1:
            fail(f"switch_tiers float64 {label}: the float64 count did not "
                 f"move")
        want = ref.switch_tiers_ref(*args)
        torch.cuda.synchronize()
        try:
            err = compare_tiers(torch, got, want, args, ULP64)
        except AssertionError as e:
            fail(f"switch_tiers float64 {label}: {e}")
        tiers_err64 = max(tiers_err64, err)
        B, R, P, _ = args[0].shape
        NC, CUP = args[6].shape[1:]
        phase("kernel", f"switch_tiers float64 {label}, B={B} on hull (R, "
              f"P, NC, CUP) = ({R}, {P}, {NC}, {CUP}), {share:.0%} of links "
              f"faulted: queues and waits within {4 * ULP64:.3g} rel, sums "
              f"as float32's in float64 ulp; max abs {err:.3g}")

    worst = check_attention_kernels(torch, dev)
    worst_bwd = check_backward_kernels(torch, dev)
    phase("kernel", f"every kernel holds its plain version: switch_step "
          f"max rel {worst_step:.3g} (tol {FLOAT_RTOL:.3g}), switch_tiers "
          f"max abs {tiers_err:.3g}, float64 switch_step max rel "
          f"{worst_step64:.3g}, float64 switch_tiers max abs "
          f"{tiers_err64:.3g}, flash_attention max abs "
          f"{worst['flash_attention']:.3g}, wkv max abs {worst['wkv']:.3g}, "
          f"flash_attention backward max abs "
          f"{worst_bwd['flash_attention_bwd']:.3g}, wkv backward max abs "
          f"{worst_bwd['wkv_bwd']:.3g}")

    # 3. golden on the card, the tick from a CUDA graph and eagerly ------
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
    golden_phase(torch, S, dev, "golden", batch, rows, cfg, x64=False)

    # 3b. the golden in the x64 mode, against results_x64 ---------------
    golden_phase(torch, S, dev, "golden-x64", batch, golden["results_x64"],
                 cfg, x64=True)

    # 4. the full-size main path: three runs replayed from a CUDA graph;
    # then the eager leg, cut to MAIN_EAGER_TICKS (an eager tick of the
    # grid costs 20-26 ms): an eager run and a graph run of that length,
    # which must be equal --------------------------------------------
    batch = grid
    hull = batch.hull
    rates, main = [], {}
    legs = (3 * [(True, MAIN_TICKS, MAIN_CHUNK)]
            + [(False, MAIN_EAGER_TICKS, MAIN_EAGER_CHUNK),
               (True, MAIN_EAGER_TICKS, MAIN_EAGER_CHUNK)])
    for run, (graph, n, chunk) in enumerate(legs):
        lcdc_switch.LAUNCHES = 0
        S.HOST_TRANSFER_COUNT = 0
        S.CAPTURE_COUNT = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = S.run_sweep(batch, n, chunk_ticks=chunk,
                                 return_state=True, device=dev, graph=graph)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = lcdc_switch.LAUNCHES
        counts = (launches, S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT)
        if counts != (n, int(graph), 1):
            fail(f"main: switch_tiers launches, captures, fold fetches "
                 f"{counts}; expected ({n}, {int(graph)}, 1)")
        check_run(S, res, state)
        rate = len(batch) * n / wall
        if run < 3:
            rates.append(rate)
            main.setdefault("launches", launches)
            main.setdefault("graph", res)
            main.setdefault("state", state)
        elif not graph:
            main["eager"] = rate
            eager = res, state
        else:
            main["short"] = res, state
            diff, where = S.worst_parity(eager[0], res)
            if res != eager[0] or not all(torch.equal(a, b) for a, b in
                                          S._leaf_pairs(state, eager[1])):
                fail(f"main: the CUDA-graph run of {n} ticks differs from "
                     f"the eager one (worst_parity {diff:.3g} at {where})")
        phase("main", f"FBSite() {hull.n_servers} servers, {len(batch)} "
              f"scenarios x {n} ticks (chunk {chunk}) on "
              f"cuda, {'CUDA graph' if graph else 'eager'}: {wall:.2f} s "
              f"wall, {rate:.1f} scenario-ticks/s; switch_tiers launches "
              f"{launches} (= ticks), captures {S.CAPTURE_COUNT}, fold "
              f"fetches {S.HOST_TRANSFER_COUNT}; conservation holds")
    lc = [r for r in main["graph"] if r["gating"]]
    savings = min(r["switch_energy_savings_frac"] for r in lc)
    phase("main", f"CUDA graph over 3 runs: {min(rates):.1f}-"
          f"{max(rates):.1f} scenario-ticks/s (mean "
          f"{sum(rates) / 3:.1f}); eager {main['eager']:.1f} (the graph "
          f"{sum(rates) / 3 / main['eager']:.2f}x that); graph and eager "
          f"runs of {MAIN_EAGER_TICKS} ticks equal in results and state; "
          f"min LC/DC switch savings {savings:.3f}; card {card}")

    kernels = [time_switch(torch, dev, card, S, batch, main["state"],
                           main["launches"], tiers_err)]

    # 4b. the main grid in the x64 mode: three runs from a CUDA graph ----
    rates64, main64 = [], {}
    for run in range(3):
        lcdc_switch.LAUNCHES = lcdc_switch.LAUNCHES_F64 = 0
        S.HOST_TRANSFER_COUNT = 0
        S.CAPTURE_COUNT = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, state = S.run_sweep(batch, MAIN_TICKS, chunk_ticks=MAIN_CHUNK,
                                 return_state=True, device=dev, x64=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = (lcdc_switch.LAUNCHES_F64, lcdc_switch.LAUNCHES,
               S.CAPTURE_COUNT, S.HOST_TRANSFER_COUNT)
        if got != (MAIN_TICKS, MAIN_TICKS, 1, 1):
            fail(f"main-x64: float64 switch_tiers launches, all launches, "
                 f"captures, fold fetches {got}; expected ({MAIN_TICKS}, "
                 f"{MAIN_TICKS}, 1, 1)")
        if state.rsw_q.dtype != torch.float64:
            fail(f"main-x64: the state's queues are {state.rsw_q.dtype}")
        check_run(S, res, state)
        rates64.append(len(batch) * MAIN_TICKS / wall)
        main64.setdefault("launches", lcdc_switch.LAUNCHES_F64)
        main64.setdefault("state", state)
        phase("main-x64", f"FBSite() {len(batch)} scenarios x {MAIN_TICKS} "
              f"ticks (chunk {MAIN_CHUNK}) on cuda in x64, CUDA graph: "
              f"{wall:.2f} s wall, {rates64[-1]:.1f} scenario-ticks/s; "
              f"float64 switch_tiers launches {lcdc_switch.LAUNCHES_F64} "
              f"(= ticks), captures {S.CAPTURE_COUNT}, fold fetches "
              f"{S.HOST_TRANSFER_COUNT}; conservation holds")
    phase("main-x64", f"x64 over 3 runs: {min(rates64):.1f}-"
          f"{max(rates64):.1f} scenario-ticks/s (mean "
          f"{sum(rates64) / 3:.1f}) beside x32 {min(rates):.1f}-"
          f"{max(rates):.1f} (mean {sum(rates) / 3:.1f}) in this "
          f"invocation: x64 at {sum(rates64) / sum(rates):.3f}x the x32 "
          f"rate; card {card}")
    kernels.append(time_switch_f64(torch, dev, card, S, batch,
                                   main64["state"], main64["launches"],
                                   tiers_err64))

    # 4c-4d. the paper's analytic models on main's rows; the main grid
    # over views of the card -------------------------------------------
    fabric_phase(torch, dev, card, lc)
    sharded_phase(torch, S, dev, card, batch, main["short"],
                  MAIN_EAGER_TICKS, MAIN_EAGER_CHUNK)

    # 5-7. the planner's, the durable and the isolating paths ----------
    planned_phase(torch, S, dev, card)
    durable_phase(torch, S, dev, card)
    bucket_fault_phase(torch, S, dev)

    # 8-9b. the serving paths at full width, one model at a time -------
    paths = {"flash_attention": {"launches": 0, "shapes": {}},
             "wkv": {"launches": 0, "shapes": {}}}
    for arch in SERVE_ARCHS:
        for k, got in serve_phase(torch, arch, dev).items():
            paths[k]["launches"] += got["launches"]
            for key, n in got["shapes"].items():
                paths[k]["shapes"][key] = paths[k]["shapes"].get(key, 0) + n

    # 9c-9e. the training paths: full width at a depth cut, then the
    # reduced run and the failure/resume round trip ------------------
    for k in ("flash_attention_bwd", "wkv_bwd"):
        paths[k] = {"launches": 0, "shapes": {}}
    tmp = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(tmp, ignore_errors=True)
    train_shapes = set()
    for arch in TRAIN_ARCHS:
        for k, got in train_phase(torch, arch, dev, card, tmp).items():
            paths[k]["launches"] += got["launches"]
            for key, n in got["shapes"].items():
                paths[k]["shapes"][key] = paths[k]["shapes"].get(key, 0) + n
                train_shapes.add(key)
    train_reduced_phase(torch, dev, card, tmp)
    shutil.rmtree(tmp, ignore_errors=True)

    # 10. per-launch times of the serving and training kernels ----------
    kernels += time_attention_kernels(torch, dev, card, paths, worst,
                                      train_shapes)
    kernels += time_backward_kernels(torch, dev, card, paths, worst_bwd)
    phase("done", f"every phase passed in {time.perf_counter() - t_start:.0f} s "
          f"(the build included); seconds by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
