"""The port's x64 mode against the reference run under JAX_ENABLE_X64=1.

JAX's x64 mode is process-wide, so the reference runs in ONE subprocess
(``_REF_SCRIPT``, started with this module's first test and running
while the port-only tests do; they come first): it compiles once and
hands back every result the cases below compare with. The port's mode
is the ``x64=True`` argument of its entry points.

* ``fma64`` (kernels/ref.py) is exact: on 20,000 random triples (with
  cancellation cases) and on signed zeros, subnormals and exact
  cancellations it equals a*b + c rounded once, as ``fractions.Fraction``
  computes it.
* PRNG: x64 keys keep the high word of int64 seeds (seeds >= 2**32 and
  negative ones); 64-bit words and float64 uniforms match
  ``jax.random.bits``/``uniform`` bit for bit in both threefry schemes at
  every draw width of the step. float64 normals (the erfinv and log1p
  XLA compiles, in core/prng.py) are held to 4 ulp with at least 99%
  bit-exact: measured over 512,000 normals in each scheme, 99.995% and
  99.996% bit-exact, max 2 ulp (the rest is ``log``'s last bit).
* Types: the x64 ``SimState`` and fold buffers have the reference's
  types leaf for leaf (49 float64, 2 float32, 18 int32, 6 bool, the
  key; 88 float64 fold leaves).
* One x64 tick from a shared state (carried across with
  core/convert.py) in test_torch_step.py's ``rate``, ``flows`` and
  ``harsh_faults`` cases: integer and bool leaves exact, float32 leaves
  within 1e-6 and float64 leaves within 1e-12 (``assert_allclose``
  rtol = atol, as the x32 tier's 1e-6). Reached: 0.0 on every leaf of
  ``rate`` and ``harsh_faults``; in ``flows`` 3.7e-15 relative at most
  on the float64 leaves and 0.0 on the float32 ones, but for the
  accumulators of ``F32_RACK_SUMS``: float32 sums over racks of the
  flow engine's fractional emissions, which the reference's compiled
  tick sums with reassociating vector reductions
  (``llvm.vector.reduce.fadd`` with ``reassoc`` in its LLVM IR) in an
  order that depends on the shapes. They reach 4.9e-9 (``delay_hist``),
  2.6e-9 (``injected``) and 1.7e-9 (``delay_wt_inter``) in
  ``assert_allclose``'s measure and are held to ``RTOL_RACK`` = 2e-8.
  The tick's other float32 sums over racks (``intra_rack``,
  ``delay_wt``, the stall counts) match to the bit here and are held to
  1e-12 with the rest.
* Runs on the CPU, all in the reference's original threefry scheme:
  the golden batch (2,000 ticks, chunks of 500) against
  ``preflow_golden.json["results_x64"]`` within 1e-3 under
  ``worst_parity`` (reached: 0.0), injecting the x64 draws' 2,216
  packets for fb_hadoop|lcdc|x1.6|s8 (10,362 under x32); and
  test_torch_step.py's ``HARSH`` and ``FLOWS`` knobs on fb_hadoop lcdc
  x1.6 s8, fb_web base s3 and university lcdc x1.5 s0 against the
  reference's x64 run within 1e-3 (reached: 1.5e-8, every scalar
  metric). Both batches run as one port sweep of six scenarios.
* Contracts in x64: one host transfer a run, 1 + n checkpoints with
  checkpointing, the validate guard riding it; a resume is
  bit-identical; resuming across modes is rejected as "x64_mode" both
  ways; ``fold="host"`` within 1e-6 of the device fold;
  ``run_sweep_planned(x64=True)`` equals the plain runs of its buckets
  within 1e-3; ``run_sim`` and ``compare_traces`` take the mode.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from collections import Counter
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import convert, prng
from repro_torch.core import simulator as TS
from repro_torch.core.checkpoint import CheckpointError, CheckpointSpec
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS
from repro_torch.kernels import lcdc_switch, ops
from repro_torch.kernels.ref import fma64

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
GOLDEN = TESTS / "data" / "preflow_golden.json"
PARITY_TOL = 1e-3
HOST_FOLD_TOL = 1e-6
RTOL64 = ATOL64 = 1e-12
RTOL32 = ATOL32 = 1e-6
#: the reassociated float32 sums' band: 4x the largest reading, 4.9e-9
RTOL_RACK = ATOL_RACK = 2e-8
TICKS, CHUNK = 2000, 500          # the golden capture's geometry
#: test_torch_step.py's site and knobs (tests/test_faults.py's values)
SITE = dict(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
            csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)
SMALL = dict(n_clusters=1, racks_per_cluster=5, servers_per_rack=6,
             csw_per_cluster=3, n_fc=1, csw_ring_links=2, fc_ring_links=4)
HARSH = dict(wake_fail_prob=0.30, wake_jitter_frac=0.50,
             link_mtbf_ticks=500.0, repair_ticks=40, plane_fail_prob=0.01)
FLOWS = dict(flow_mode=1, flow_arrival_rate=0.3, flow_size_dist="datamining",
             incast_degree=4, flow_table_cap=12)
#: every fixed draw width of the step (tests/test_torch_prng.py's)
WIDTHS = [5 + TS.F_SLOTS, 2, 2 + TS.MAX_FAULT_LINKS, TS.MAX_FAULT_LINKS,
          8, 3, 1]
SEEDS = [0, 3, 8, 12345, -1, -7, 2**32 + 5, 2**40 + 3, -(2**35) - 11]
TICK_CASES = ("rate", "flows", "harsh_faults")
K_TICKS = 40
#: accumulators whose float32 sums over racks the reference's flows
#: tick reassociates (see the module docstring)
F32_RACK_SUMS = ("acc.delay_hist", "acc.delay_wt_inter", "acc.injected")

# The reference's side, run under JAX_ENABLE_X64=1 in a subprocess. It
# writes one pickle of numpy arrays and result dicts (argv[1]).
_REF_SCRIPT = r'''
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import simulator as JS
from repro.core.topology import FBSite
from repro.core.traffic import TRAFFIC_SPECS
assert jax.config.jax_enable_x64
spec = pickle.loads(bytes.fromhex(sys.argv[2]))
out = {"prng": {}, "tick": {}}

for part in (True, False):
    with jax.threefry_partitionable(part):
        keys = {s: np.asarray(jax.random.PRNGKey(s)) for s in spec["seeds"]}
        ks = jnp.stack([jax.random.PRNGKey(s) for s in spec["seeds"]])
        ks = jnp.concatenate([ks, jax.random.split(jax.random.PRNGKey(7),
                                                   64)])
        draws = {}
        for n in spec["widths"]:
            draws[n] = (np.asarray(jax.vmap(lambda k: jax.random.bits(
                            k, (n,), jnp.uint64))(ks)),
                        np.asarray(jax.vmap(lambda k: jax.random.uniform(
                            k, (n,)))(ks)))
        nk = jax.random.split(jax.random.PRNGKey(11), 2000)
        u = jax.vmap(lambda k: jax.random.uniform(k, (256,)))(nk)
        z = jax.vmap(lambda k: jax.random.normal(k, (256,)))(nk)
        out["prng"][part] = dict(keys=keys, batch=np.asarray(ks),
                                 draws=draws, u=np.asarray(u),
                                 z=np.asarray(z))

def runs(rows, site):
    return [(JS.SimParams(spec=TRAFFIC_SPECS[t], site=site,
                          gating_enabled=g, rate_scale=r, **kn), s)
            for t, g, r, s, kn in rows]

site = FBSite(**spec["site"])
jstep = jax.jit(jax.vmap(JS.make_sim_step(site)))
for case, rows in spec["tick"].items():
    jb = JS.make_batch(runs(rows, site))
    scen, state, fold, _, _ = JS._prepare_sweep_args(jb, fold="device")
    init = jax.device_get((state, fold))
    for _ in range(spec["k_ticks"]):
        state = jstep(scen, state)
    shared = jax.device_get(state)
    out["tick"][case] = (jax.device_get(scen), shared,
                         jax.device_get(jstep(scen, state)), init)

jax.config.update("jax_threefry_partitionable", False)
jb = JS.make_batch(runs(spec["faults_flows"], site))
out["faults_flows"] = JS.run_sweep(jb, spec["ticks"],
                                   chunk_ticks=spec["chunk"])
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def _rows(case):
    """(trace, gating, rate_scale, seed, knobs) rows of a tick case:
    test_torch_step.py's single-site batches."""
    knobs = {"rate": {}, "flows": FLOWS, "harsh_faults": HARSH}[case]
    return [("fb_hadoop", True, 1.6, 8, knobs), ("fb_web", False, 1.0, 3,
                                                 knobs)]


#: the faults-and-flows rows (ROADMAP Queue 3's coverage gap)
FAULTS_FLOWS = [("fb_hadoop", True, 1.6, 8, dict(HARSH, **FLOWS)),
                ("fb_web", False, 1.0, 3, dict(HARSH, **FLOWS)),
                ("university", True, 1.5, 0, dict(HARSH, **FLOWS))]
#: the golden capture's rows (tests/test_flows.py:_golden_runs)
GOLDEN_ROWS = [("fb_hadoop", True, 1.6, 8, {}), ("fb_hadoop", False, 1.6, 9,
                                                 {}),
               ("fb_web", True, 1.0, 3, {})]


def _port_runs(rows, site=SITE):
    s = FBSite(**site)
    return [(TS.SimParams(spec=TRAFFIC_SPECS[t], site=s, gating_enabled=g,
                          rate_scale=r, **kn), seed)
            for t, g, r, seed, kn in rows]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend (with each other, the reference's subprocess
    and the other test workers), so this module runs them on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Reference:
    """The reference's subprocess, started once; ``get()`` waits for it
    and loads what it wrote."""

    def __init__(self, path):
        self.path = path
        spec = dict(seeds=SEEDS, widths=WIDTHS, site=SITE, k_ticks=K_TICKS,
                    tick={c: _rows(c) for c in TICK_CASES},
                    faults_flows=FAULTS_FLOWS, ticks=TICKS, chunk=CHUNK)
        env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(SRC) + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, str(path),
             pickle.dumps(spec).hex()], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.data = None

    def get(self):
        if self.data is None:
            log, _ = self.proc.communicate(timeout=900)
            assert self.proc.returncode == 0, f"reference failed:\n{log}"
            with open(self.path, "rb") as f:
                self.data = pickle.load(f)
        return self.data


@pytest.fixture(autouse=True, scope="module")
def reference(tmp_path_factory):
    """The reference's subprocess, started with the module's first test
    so that it runs while the port-only tests do."""
    ref = _Reference(tmp_path_factory.mktemp("x64ref") / "ref.pkl")
    yield ref
    if ref.proc.poll() is None:
        ref.proc.kill()
        ref.proc.wait()


# ---- fma64 ---------------------------------------------------------------

def _fma_exact(a, b, c):
    """a*b + c rounded once to float64 (round to nearest even), with
    IEEE's sign of an exact zero."""
    x = Fraction(a) * Fraction(b) + Fraction(c)
    if x == 0:
        return (a * b) + c if (a * b == 0 and c == 0) else 0.0
    return float(x)


def test_fma64_exact_against_rationals():
    rng = np.random.default_rng(0)
    n = 20_000
    a = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    b = rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)
    c = rng.standard_normal(n) * 2.0 ** rng.integers(-120, 120, n)
    k = n // 4                       # cancellation: c next to -a*b
    c[:k] = -(a[:k] * b[:k]) * (1 + rng.integers(-4, 5, k) * 2.0 ** -52)
    sub = 5e-324
    edge = [(0.0, 1.0, -0.0), (-0.0, 1.0, -0.0), (0.0, -1.0, -0.0),
            (-0.0, -0.0, -0.0), (0.0, 5.0, -0.0), (1.0, 1.0, -1.0),
            (3.0, sub, 0.0), (sub * 7, 2.0 ** 60, 1.0),
            (2.0 ** -520, 2.0 ** -520, 3 * sub), (1e-160, 1e-150, -1e-310),
            (1.5, 2.0 ** -1022, -2.0 ** -1022),
            (1.0 + 2 ** -52, 1.0 - 2 ** -53, -1.0),
            (2.0 ** -537, 2.0 ** -537, sub), (1e300, 1e-300, -1.0),
            (2.0 ** -500, 2.0 ** -500, -(2.0 ** -1000)),
            (1.0 + 2 ** -30, 1.0 + 2 ** -30, -(1.0 + 2 ** -29))]
    a = np.concatenate([a, [e[0] for e in edge]])
    b = np.concatenate([b, [e[1] for e in edge]])
    c = np.concatenate([c, [e[2] for e in edge]])
    got = fma64(*(torch.as_tensor(x) for x in (a, b, c))).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)])
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


# ---- runs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def x64_run(tmp_path_factory):
    """ONE port sweep of the golden rows and the faults-and-flows rows
    (six scenarios on the golden site, independent lanes), in x64 under
    the original threefry scheme, with the validate guards and a
    checkpoint every chunk."""
    spec = CheckpointSpec(directory=str(tmp_path_factory.mktemp("ck")),
                          every_chunks=1, keep=8, tag="x64")
    batch = TS.make_batch(_port_runs(GOLDEN_ROWS + FAULTS_FLOWS))
    before = TS.HOST_TRANSFER_COUNT
    res = TS.run_sweep(batch, TICKS, chunk_ticks=CHUNK, device="cpu",
                       threefry_partitionable=False, x64=True,
                       validate=True, checkpoint=spec)
    return batch, res, TS.HOST_TRANSFER_COUNT - before, spec


def test_golden_results_x64(x64_run):
    _, res, _, _ = x64_run
    rows = json.loads(GOLDEN.read_text())["results_x64"]
    got = res[:3]
    assert [r["label"] for r in rows] == [r["label"] for r in got]
    keys = [k for k in TS.PARITY_KEYS if k in rows[0]]
    diff, where = TS.worst_parity(rows, got, keys)
    assert diff <= PARITY_TOL, (diff, where)
    # the x64 draws are other numbers, not just wider ones
    assert got[0]["label"] == "fb_hadoop|lcdc|x1.6|s8"
    assert round(got[0]["injected_pkts"]) == 2216


def test_x64_checkpointed_run_transfers_and_resumes(x64_run):
    """1 + 3 transfers (the fold with the guard riding it, and one a
    checkpoint at boundaries 1-3); a resume from boundary 3 is
    bit-identical and takes one transfer."""
    batch, res, transfers, spec = x64_run
    assert transfers == 1 + 3
    files = sorted(Path(spec.directory).glob("x64*"))
    assert len(files) == 3
    last = max(files, key=lambda p: p.name)
    before = TS.HOST_TRANSFER_COUNT
    again = TS.resume_sweep(last, device="cpu", x64=True)
    assert TS.HOST_TRANSFER_COUNT - before == 1
    assert again == res
    with pytest.raises(CheckpointError) as ei:
        TS.resume_sweep(last, device="cpu")
    assert ei.value.reason == "x64_mode"


def test_x32_checkpoint_rejected_in_x64(tmp_path):
    spec = CheckpointSpec(directory=str(tmp_path), every_chunks=1, tag="x32")
    batch = TS.make_batch(_port_runs(GOLDEN_ROWS[:1]))
    TS.run_sweep(batch, 6, chunk_ticks=2, device="cpu", checkpoint=spec)
    path = sorted(tmp_path.glob("x32*"))[0]
    with pytest.raises(CheckpointError) as ei:
        TS.resume_sweep(path, device="cpu", x64=True)
    assert ei.value.reason == "x64_mode"
    assert TS.resume_sweep(path, device="cpu")[0]["ticks"] == 6


def test_host_fold_within_1e6_of_device_fold_x64():
    """The host fold makes one transfer a chunk (the guard riding it)."""
    batch = TS.make_batch(_port_runs(FAULTS_FLOWS))
    kw = dict(chunk_ticks=100, device="cpu", x64=True, validate=True)
    before = TS.HOST_TRANSFER_COUNT
    dev = TS.run_sweep(batch, 300, **kw)
    mid = TS.HOST_TRANSFER_COUNT
    host = TS.run_sweep(batch, 300, fold="host", **kw)
    assert (mid - before, TS.HOST_TRANSFER_COUNT - mid) == (1, 3)
    diff, where = TS.worst_parity(dev, host)
    assert diff <= HOST_FOLD_TOL, (diff, where)


def test_validate_guard_rides_the_x64_fetch():
    """A tripped guard comes back through the float64 fold's column
    exactly: chunk 0 for every label (``validate_tol=-1`` fails the
    device fold's conservation check at once)."""
    batch = TS.make_batch(_port_runs(GOLDEN_ROWS))
    with pytest.raises(TS.SweepValidationError) as ei:
        TS.run_sweep(batch, 40, chunk_ticks=20, device="cpu", x64=True,
                     validate=True, validate_tol=-1.0)
    assert ei.value.first_bad_chunk == 0
    assert list(ei.value.labels) == list(batch.labels)


def test_planned_x64_equals_plain_bucket_runs():
    runs = _port_runs(GOLDEN_ROWS[:2]) + _port_runs(FAULTS_FLOWS[:1], SMALL)
    res, plan = TS.run_sweep_planned(runs, 200, max_compiles=2,
                                     chunk_ticks=100, device="cpu",
                                     x64=True, return_plan=True)
    assert len(plan["buckets"]) == 2
    for bucket in plan["buckets"]:
        idx = bucket["indices"]
        plain = TS.run_sweep(TS.make_multi_site_batch([runs[i] for i in idx]),
                             200, chunk_ticks=100, device="cpu", x64=True)
        diff, where = TS.worst_parity(plain, [res[i] for i in idx])
        assert diff <= PARITY_TOL, (diff, where)


def test_run_sim_and_compare_traces_take_the_mode():
    p = _port_runs(GOLDEN_ROWS[:1])[0][0]
    one = TS.run_sim(p, 60, seed=8, device="cpu", x64=True)
    sweep = TS.run_sweep(TS.make_batch([(p, 8)]), 60, chunk_ticks=60,
                         device="cpu", x64=True)[0]
    assert one == sweep
    assert one != TS.run_sim(p, 60, seed=8, device="cpu")
    out = TS.compare_traces(n_ticks=30, traces=("fb_web",), device="cpu",
                            x64=True)
    assert out["fb_web"]["lcdc"]["ticks"] == 30


def test_switch_dispatch_by_type_and_device():
    """float64 CPU tensors take the plain version (no launch); the
    kernel wrappers take CUDA tensors only, and float32 or float64
    queues only."""
    q = torch.rand(6, 4, 2, dtype=torch.float64)
    args = (q, torch.full((6,), 2, dtype=torch.int32),
            torch.rand(6, 2, dtype=torch.float64))
    before = lcdc_switch.LAUNCHES
    out = ops.switch_step(*args)
    assert lcdc_switch.LAUNCHES == before
    assert all(o.dtype == torch.float64 for i, o in enumerate(out)
               if i not in (2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        lcdc_switch.switch_step(*args)
    with pytest.raises(TypeError, match="float32 or float64"):
        lcdc_switch._float_type("switch_step", q.half())


def test_faults_and_flows_run_parity_x64(reference, x64_run):
    _, res, _, _ = x64_run
    want = reference.get()["faults_flows"]
    got = res[3:]
    assert [r["label"] for r in want] == [r["label"] for r in got]
    assert all(r["flows_started"] > 0 for r in got)
    assert any(r["fault_dropped_pkts"] > 0 for r in got)
    diff, where = TS.worst_parity(want, got)
    assert diff <= PARITY_TOL, (diff, where)


# ---- PRNG ----------------------------------------------------------------

def test_x64_keys_keep_the_high_word(reference):
    keys = reference.get()["prng"][True]["keys"]
    for seed, want in keys.items():
        got = prng.key(seed, x64=True).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64),
                                      err_msg=str(seed))
    batch = prng.key(SEEDS, x64=True).numpy()
    np.testing.assert_array_equal(
        batch, np.stack([keys[s] for s in SEEDS]).astype(np.int64))
    # the x32 default keeps truncating
    assert prng.key(2**32 + 5).tolist() == [0, 5]


@pytest.mark.parametrize("partitionable", [True, False])
def test_64bit_words_and_uniforms_exact(reference, partitionable):
    ref = reference.get()["prng"][partitionable]
    ks = torch.as_tensor(ref["batch"].astype(np.int64))
    for n, (bits, uni) in ref["draws"].items():
        got = prng.random_bits(ks, n, partitionable, bits=64).numpy()
        np.testing.assert_array_equal(got, bits.view(np.int64),
                                      err_msg=f"bits n={n}")
        u = prng.uniform(ks, n, partitionable, dtype=torch.float64).numpy()
        assert u.dtype == np.float64
        np.testing.assert_array_equal(u.view(np.int64),
                                      uni.view(np.int64),
                                      err_msg=f"uniform n={n}")


def test_float64_normals_within_4_ulp(reference):
    ref = reference.get()["prng"][False]
    z = prng.unit_to_normal(torch.as_tensor(ref["u"])).numpy()
    assert z.dtype == np.float64
    ulp = np.abs(z.view(np.int64) - ref["z"].view(np.int64))
    assert int(ulp.max()) <= 4, int(ulp.max())
    assert (ulp == 0).mean() >= 0.99, (ulp == 0).mean()


# ---- types and one tick --------------------------------------------------

def _dtype_census(leaves):
    return Counter(str(np.asarray(v).dtype) for v in leaves)


def test_state_and_fold_types_match_the_reference(reference):
    _, _, _, (jstate, jfold) = reference.get()["tick"]["rate"]
    batch = TS.make_batch(_port_runs(_rows("rate")))
    _, state, fold, _, _ = TS._prepare_sweep_args(
        batch, torch.device("cpu"), x64=True)
    got = convert.state_to_numpy(state)
    want = convert.state_to_numpy(convert.state_from_numpy(jstate))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype,
                                               want[k].dtype)
    census = _dtype_census(got.values())
    assert census == Counter(float64=49, float32=2, int32=18, bool=6,
                             uint32=1), census
    jflat = convert.fold_from_numpy(jfold)
    assert [f.dtype for f in fold] == [f.dtype for f in jflat] \
        == [torch.float64] * 2
    n_leaves = sum(len(part) for part in jfold)
    assert n_leaves == 88 and fold[0].shape == jflat[0].shape


@pytest.mark.parametrize("case", TICK_CASES)
def test_one_x64_tick_from_shared_state(reference, case):
    scen, shared, nxt, _ = reference.get()["tick"][case]
    want = convert.state_to_numpy(convert.state_from_numpy(nxt))
    batch = TS.make_batch(_port_runs(_rows(case)))
    step = TS.make_sim_step(batch.hull, convert.scenario_from_numpy(scen),
                            x64=True)
    got = convert.state_to_numpy(step(convert.state_from_numpy(shared)))
    if case == "flows":
        assert np.asarray(shared.ft_rem).any(), "flow table never filled"
    if case == "harsh_faults":
        assert np.asarray(shared.rsw_fault.timer).any(), "no fault struck"
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        b = got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == np.float64 and case == "flows" \
                and k in F32_RACK_SUMS:
            np.testing.assert_allclose(b, a, rtol=RTOL_RACK, atol=ATOL_RACK,
                                       err_msg=k)
        elif a.dtype == np.float64:
            np.testing.assert_allclose(b, a, rtol=RTOL64, atol=ATOL64,
                                       err_msg=k)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL32, atol=ATOL32,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)
