"""Where a sweep on the card waits for the host: every sync that
``torch.cuda.set_sync_debug_mode("warn")`` flags, by call site.

Run from a checkout's root on a machine with a CUDA device:

    python3 tools/sync_probe.py

It prints which primitive operations the mode flags on this PyTorch
(``torch.cuda.synchronize()``, ``Stream.synchronize``, ``.item()``, a
copy from pageable or pinned memory, ...), then runs small sweeps of
the golden site under the mode (a graph run with ``validate=True``,
the same run eagerly, one checkpointing every chunk, a two-bucket
pipelined ``run_sweep_planned``, ``run_sim`` and an x64 run) and prints
each run's flagged syncs, grouped by the last frames of the port's own
code that made them. A sync inside a blessed fetch point
(``repro_torch.device.fetch_point``, where the tree has it) is not
flagged. It uses only entry points every tree of the port has, so it
runs in an earlier commit's checkout too.
"""
from __future__ import annotations

import collections
import sys
import tempfile
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SITES: collections.Counter = collections.Counter()


def _record(message, category, filename, lineno, file=None, line=None):
    if "synchroniz" not in str(message):
        return
    frames = [f for f in traceback.extract_stack()[:-1]
              if "repro_torch" in f.filename]
    SITES[" <- ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                      for f in reversed(frames[-3:]))] += 1


def flagged(fn) -> collections.Counter:
    """The syncs ``fn()`` makes that the warn mode flags, by site."""
    SITES.clear()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = _record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return collections.Counter(SITES)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    x, h = torch.ones(4, device=dev), torch.ones(4)
    flagged(lambda: torch.cuda.synchronize())     # the mode's first notice

    def event():
        e = torch.cuda.Event()
        e.record()
        e.synchronize()

    for name, fn in (
            ("torch.cuda.synchronize()", torch.cuda.synchronize),
            ("Stream.synchronize()",
             lambda: torch.cuda.current_stream().synchronize()),
            ("Event.synchronize()", event),
            (".item()", lambda: x.sum().item()),
            (".cpu()", lambda: x.cpu()),
            ("torch.tensor(1.0, device=cuda)",
             lambda: torch.tensor(1.0, device=dev)),
            ("pageable .to(cuda)", lambda: h.to(dev)),
            ("pageable .to(cuda, non_blocking=True)",
             lambda: h.to(dev, non_blocking=True)),
            ("pinned .to(cuda, non_blocking=True)",
             lambda: h.pin_memory().to(dev, non_blocking=True))):
        n = sum(flagged(fn).values())
        print(f"[primitive] {name}: {'flagged' if n else 'not flagged'}",
              flush=True)

    from repro_torch.core import simulator as S
    from repro_torch.core.checkpoint import CheckpointSpec
    from repro_torch.core.topology import FBSite
    from repro_torch.core.traffic import TRAFFIC_SPECS
    site = FBSite(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
                  csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                  fc_ring_links=8)
    spec = TRAFFIC_SPECS["fb_hadoop"]
    runs = [(S.SimParams(spec=spec, site=site, rate_scale=1.6), 8),
            (S.SimParams(spec=spec, site=site, gating_enabled=False,
                         rate_scale=1.6), 9),
            (S.SimParams(spec=TRAFFIC_SPECS["fb_web"], site=site), 3)]
    other = FBSite(n_clusters=2, racks_per_cluster=4, servers_per_rack=8,
                   csw_per_cluster=2, n_fc=2, csw_ring_links=4,
                   fc_ring_links=8)
    mixed = runs[:2] + [(S.SimParams(spec=spec, site=other), 1)]
    batch = S.make_batch(runs)
    S.run_sweep(batch, 8, chunk_ticks=4, device=dev)      # loads the kernel
    with tempfile.TemporaryDirectory() as d:
        for name, fn in (
                ("graph, validate=True", lambda: S.run_sweep(
                    batch, 64, chunk_ticks=16, device=dev, validate=True)),
                ("eager", lambda: S.run_sweep(batch, 64, chunk_ticks=16,
                                              device=dev, graph=False)),
                ("checkpoint every chunk", lambda: S.run_sweep(
                    batch, 64, chunk_ticks=16, device=dev,
                    checkpoint=CheckpointSpec(directory=d, tag="probe"))),
                ("planned, 2 buckets", lambda: S.run_sweep_planned(
                    mixed, 64, chunk_ticks=16, max_compiles=2, device=dev)),
                ("run_sim", lambda: S.run_sim(runs[0][0], 32, device=dev)),
                ("x64", lambda: S.run_sweep(batch, 32, chunk_ticks=16,
                                            device=dev, x64=True))):
            sites = flagged(fn)
            print(f"[sweep] {name}: {sum(sites.values())} flagged syncs",
                  flush=True)
            for where, n in sites.most_common():
                print(f"    {n:4d}  {where}", flush=True)


if __name__ == "__main__":
    main()
