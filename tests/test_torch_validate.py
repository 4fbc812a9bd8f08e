"""The port's validate guards and host fold.

* The three validate cases of tests/test_faults.py, on its small site:
  a clean pass changes no result (bit for bit) and adds no transfer; an
  impossible tolerance trips the conservation guard at chunk 0, naming
  every scenario; the host fold's finite-value guard passes.
* A guard that sees a non-finite queue names the first chunk it saw it
  in, on both folds.
* ``fold="host"`` is within 1e-6 of the device fold, with one transfer a
  chunk (the guard riding it), and an unknown fold is refused.
"""
import math

import pytest
import torch

from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite

HOST_FOLD_TOL = 1e-6
#: tests/test_faults.py's small-but-real site
SITE = FBSite(n_clusters=2, racks_per_cluster=8, servers_per_rack=8,
              csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)
TICKS, CHUNK = 400, 150         # two full chunks and a remainder of 100


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs tiny tensors on the CPU here: PyTorch's intra-op
    threads only contend, so this module runs them on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(**kw):
    kw.setdefault("rate_scales", (1.5,))
    return S.sweep_grid(traces=("university",), site=SITE, **kw)


def _run(batch, **kw):
    return S.run_sweep(batch, TICKS, chunk_ticks=CHUNK, device="cpu", **kw)


@pytest.fixture(scope="module")
def plain():
    return _run(_grid())


def test_validate_clean_pass_is_inert(plain):
    """validate=True never changes the dynamics: every result is
    bit-identical with the guards on, still one host transfer."""
    h0 = S.HOST_TRANSFER_COUNT
    checked = _run(_grid(), validate=True)
    assert S.HOST_TRANSFER_COUNT - h0 == 1
    assert checked == plain


def test_validate_trips_and_localizes():
    """An impossible tolerance trips the conservation guard on the very
    first chunk, naming every failing scenario label."""
    batch = _grid(gating=(True, False))
    with pytest.raises(S.SweepValidationError) as ei:
        _run(batch, validate=True, validate_tol=-1.0)
    assert ei.value.first_bad_chunk == 0
    assert set(ei.value.labels) == set(batch.labels)


def test_validate_host_fold_path(plain):
    """The host fold supports the finite-value guard too (its per-chunk
    accumulators are checked instead of the fold): a clean run passes,
    one transfer a chunk, the guard riding along."""
    h0 = S.HOST_TRANSFER_COUNT
    res = _run(_grid(), fold="host", validate=True)
    assert S.HOST_TRANSFER_COUNT - h0 == math.ceil(TICKS / CHUNK)
    assert res[0]["injected_pkts"] > 0
    diff, key = S.worst_parity(plain, res)
    assert diff <= HOST_FOLD_TOL, (diff, key)


@pytest.mark.parametrize("fold", ["device", "host"])
def test_guard_names_the_first_non_finite_chunk(monkeypatch, fold):
    """A NaN planted in one scenario's RSW queue in the first tick of
    chunk 1 trips the finite-value guard for that scenario alone, at
    chunk 1."""
    batch = _grid(gating=(True, False))
    real = S.make_sim_step

    def poisoned(*args, **kw):
        step = real(*args, **kw)
        ticks = [0]

        def tick(state):
            state = step(state)
            ticks[0] += 1
            if ticks[0] == CHUNK + 1:
                q = state.rsw_q.clone()
                q[1, 0, 0, 0] = float("nan")
                state = state._replace(rsw_q=q)
            return state
        return tick

    monkeypatch.setattr(S, "make_sim_step", poisoned)
    with pytest.raises(S.SweepValidationError) as ei:
        _run(batch, fold=fold, validate=True)
    assert ei.value.first_bad_chunk == 1
    assert ei.value.labels == (batch.labels[1],)


def test_host_fold_matches_device_fold(plain):
    """The float64 host fold against the float32 Kahan device fold:
    within 1e-6, one transfer a chunk."""
    h0 = S.HOST_TRANSFER_COUNT
    res = _run(_grid(), fold="host")
    assert S.HOST_TRANSFER_COUNT - h0 == math.ceil(TICKS / CHUNK)
    diff, key = S.worst_parity(plain, res)
    assert diff <= HOST_FOLD_TOL, (diff, key)
    for a, b in zip(plain, res):
        for k in ("injected_pkts", "delivered_pkts", "flows_started"):
            assert a[k] == b[k], k


def test_unknown_fold_rejected():
    with pytest.raises(ValueError, match="fold"):
        _run(_grid(), fold="disk")
