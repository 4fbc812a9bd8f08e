"""Contract-aware static analysis and runtime sanitizers for the port
(the counterpart of the reference's ``repro/analysis``).

The contracts the port keeps (one capture per bucket, exactly one host
fetch per ``run_sweep``, no host sync in the captured tick, Scenario
knobs in the registry, PRNG ``fold_in`` discipline, x32 results free of
float64) are machine-checked here, per file, with named rules (mirrored
in ROADMAP.md "Static contracts of the port"):

* **RL001 traced-control-flow** - no Python ``if``/``while``/``assert``
  or ``float()/int()/bool()/.item()/.tolist()`` on tensor values inside
  any function the tick graph captures or the tick reaches (taint.py:
  interprocedural taint from the capture and the registry's
  ``[[traced_root]]``). On the card such a line is exactly the host
  sync a CUDA-graph capture refuses; the rule finds it on the CPU.
* **RL002 compile-site-registry** - every CUDA-graph capture
  (``cuda_graph``), kernel library binding (``kernel_load``) and
  ``torch.library`` operator definition (``operator``) is declared in
  ``compile_sites.toml`` with its multiplicity; drift against the code
  or the ``CAPTURE_COUNT`` probe is a finding (registry.py).
* **RL003 host-transfer-smell** - ``.item()/.cpu()/.tolist()/.numpy()
  /.to("cpu")/synchronize()`` in hot-loop modules outside the blessed
  fetch points (``[[blessed_transfer]]``), plus ``np.asarray`` and host
  copies of tensor values inside traced functions.
* **RL004 scenario-leaf-sync** - Scenario/SimParams fields match the
  registry inventory (the reference's own: ``FAULT_KNOBS``,
  ``FLOW_KNOBS``, ``SIM_SCHEMA_VERSION = 8``), every param validated in
  ``__post_init__`` or exempted with a reason.
* **RL005 prng-discipline** - a ``core.prng`` key feeding two sampling
  calls without an intervening ``split``/``fold_in`` (checkers.py); the
  port keeps JAX's explicit keys, so reuse means what it means there.
* **RL006 dtype-discipline** - float64 in the bit-exact modules
  (kernels, ref, gating) outside the registry's per-function x64
  exemptions.

The artifact layer (artifact.py) audits what the engine runs: one
tick, counted op by op by ``launch.hlo_analysis.CostCounter`` and, on
the card, captured as a CUDA graph, against ``artifact_contracts.toml``:

* **RL007 artifact-contract-drift** - fold dtype by mode, FLOPs and
  bytes per tick and per chunk boundary in blessed bands, no op without
  a cost rule, the tick's peak live bytes within budget on the card,
  registry coverage and planner calibration (the same table backs
  ``planner.plan_sites(cost_model="hlo")``).
* **RL008 artifact-collective-callback** - no collective, host read or
  copy between devices in the tick; no host node or device-to-host copy
  in its captured graph.
* **RL009 donation-aliasing-loss** - ``step_into`` writes every
  ``SimState`` leaf in place, after a tick and after replays.

Workflow: ``python -m repro_torch.analysis --check`` (lint, then the
audit on ``--device``, ``cuda`` by default; ``--device cpu`` on a
machine without a card); ``--json``/``--dead-code`` write reports under
``results/analysis_torch/``. To bless a lint violation, register it
(compile site, blessed transfer, dtype exemption, validation exemption:
reviewed registry edits) or annotate the line with ``#
repro-torch-lint: disable=RULE(reason)``; reasons are mandatory and
the suppression count is baselined by ``max_suppressions``.

Runtime cross-validation lives in sanitizer.py: ``sync_sanitizer``
(``torch.cuda.set_sync_debug_mode("error")``), the ``CaptureWatcher``
and the per-hull ``CaptureLedger`` (the ``CAPTURE_HOOK`` seam in
core/simulator.py).
"""
from .artifact import ARTIFACT_RELPATH, run_audit  # noqa: F401
from .engine import LintReport, run_lint          # noqa: F401
from .findings import RULES, Finding              # noqa: F401
from .registry import load_config                 # noqa: F401
