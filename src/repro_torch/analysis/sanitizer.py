"""Runtime sanitizers: the dynamic half of the port's contract linter.

The static rules (RL001-RL006) prove properties of the source; these
context managers watch the same contracts while a sweep runs, so the
two cross-validate:

* :func:`sync_sanitizer` - arms ``torch.cuda.set_sync_debug_mode
  ("error")``: an implicit host sync (``.item()``, ``.cpu()``, a
  blocking copy from pageable memory, ``nonzero``,
  ``Stream.synchronize``) raises, while the blessed fetch points keep
  working: the simulator runs each RL003-blessed fetch and wait inside
  ``repro_torch.device.fetch_point()``, which lifts the mode and
  restores it (exactly the RL003 split). ``torch.cuda.synchronize()``
  is not flagged by the mode (an H100 run shows it; a graph capture's
  own device synchronize passes). Caveat: on the CPU the mode does
  nothing, so the sanitizer arms nothing there; the teeth are then the
  ``HOST_TRANSFER_COUNT`` pin and the ledgers below, and on a CUDA
  device the mode bites for real.

* :class:`CaptureWatcher` - counts tick programs by the function that
  builds them: every ``simulator.make_sim_step`` (the step a run steps
  eagerly, or captures) and every finished CUDA-graph capture, named
  by the function whose ``with torch.cuda.graph(...)`` it closes
  (``_TickGraph.run``, ``ici_gating._replay``).

* :class:`CaptureLedger` - hooks ``simulator.CAPTURE_HOOK`` to record
  the static ``site`` hull of every tick program a run builds (the
  capture on the card, the eager step on the CPU or with
  ``graph=False``, so the ledger means the same on both devices).
  :meth:`SanitizerSession.assert_one_capture_per_bucket` turns that into
  the planner pipeline's contract: each plan bucket builds exactly one
  tick program, and a violation fails with the offending bucket's hull
  tag (not just a drifted total). Its messages keep the reference's
  words: a tick program is the port's trace.

``tests/test_torch_sanitizer.py`` holds its own ``sweep_sanitizer``
fixture; ``chip_smoke.py`` phase ``analysis`` arms it on the card.
"""
from __future__ import annotations

import contextlib
import sys
import warnings
from collections import Counter
from dataclasses import dataclass

import torch

from repro_torch.core import simulator
from repro_torch.core.topology import full_site_tag


@contextlib.contextmanager
def sync_sanitizer():
    """Raise on every implicit host sync while active; the blessed fetch
    points stay legal. Arms nothing without a CUDA device (see the
    module's caveat)."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        # the mode's one-time notice that it is a prototype
        warnings.filterwarnings("ignore", message=".*prototype feature")
        torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CaptureWatcher:
    """Counts tick programs by the function that builds them, while
    active (``events``: one builder name each)."""

    def __init__(self):
        self.events: list = []

    def programs_of(self, name: str) -> int:
        return sum(1 for e in self.events if e == name)

    def __enter__(self):
        self._make = simulator.make_sim_step
        self._end = torch.cuda.CUDAGraph.capture_end
        make, end, events = self._make, self._end, self.events

        def make_sim_step(*args, **kwargs):
            events.append("make_sim_step")
            return make(*args, **kwargs)

        def capture_end(graph):
            # caller 1: torch.cuda.graph.__exit__; 2: the with block's
            events.append(sys._getframe(2).f_code.co_qualname)
            return end(graph)

        simulator.make_sim_step = make_sim_step
        torch.cuda.CUDAGraph.capture_end = capture_end
        return self

    def __exit__(self, *exc):
        simulator.make_sim_step = self._make
        torch.cuda.CUDAGraph.capture_end = self._end
        return False


class CaptureLedger:
    """Records the static site hull of every tick program a run
    builds (``simulator.CAPTURE_HOOK``), chaining any hook already set
    and restoring it on exit."""

    def __init__(self):
        self.sites: list = []
        self._count0 = 0
        self._prev = None

    @property
    def tags(self) -> list:
        return [full_site_tag(s) for s in self.sites]

    def new_captures(self) -> int:
        """CUDA-graph captures since the ledger was armed (0 on the
        CPU, where the ledger still records each eager step)."""
        return simulator.CAPTURE_COUNT - self._count0

    def _record(self, site):
        self.sites.append(site)
        if self._prev is not None:
            self._prev(site)

    def __enter__(self):
        self._prev = simulator.CAPTURE_HOOK
        self._count0 = simulator.CAPTURE_COUNT
        simulator.CAPTURE_HOOK = self._record
        return self

    def __exit__(self, *exc):
        simulator.CAPTURE_HOOK = self._prev
        return False


@dataclass
class SanitizerSession:
    watcher: CaptureWatcher
    ledger: CaptureLedger

    def assert_one_capture_per_bucket(self, plan):
        """The planner pipeline's per-bucket contract.

        Every bucket of ``plan`` (a ``planner.SweepPlan`` or the
        ``run_sweep_planned`` report) must have built exactly one tick
        program: no bucket re-captured (shape drift inside a bucket)
        and no program for a hull the plan never declared. Failure names
        the offending hull tag so the guilty bucket is identifiable
        without bisecting.
        """
        counts = Counter(self.ledger.tags)
        if hasattr(plan, "buckets"):          # planner.SweepPlan
            planned = [full_site_tag(b.hull) for b in plan.buckets]
        else:                                 # run_sweep_planned report
            planned = [b["hull"] for b in plan["buckets"]]
        for tag in planned:
            n = counts.get(tag, 0)
            if n > 1:
                raise AssertionError(
                    f"bucket hull {tag} was traced {n}x (expected "
                    "exactly 1 capture): the pipeline retraced a bucket "
                    "(batch-shape drift inside the bucket)")
            if n == 0:
                raise AssertionError(
                    f"bucket hull {tag} was never traced: the ledger "
                    "missed a bucket (was it armed before the run?)")
        stray = set(counts) - set(planned)
        if stray:
            raise AssertionError(
                f"captures for undeclared hull(s) {sorted(stray)}: the "
                "pipeline built a tick program outside the plan's "
                "buckets")


@contextlib.contextmanager
def sweep_sanitizer():
    """sync sanitizer + capture watcher + capture ledger, as one
    session."""
    with sync_sanitizer(), CaptureWatcher() as cw, CaptureLedger() as cl:
        yield SanitizerSession(watcher=cw, ledger=cl)
