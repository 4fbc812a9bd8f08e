"""Scenario sharding in the port: tests/test_sharding.py's contracts with
``simulator._local_devices`` replaced by four CPU devices (the port's
counterpart of ``--xla_force_host_platform_device_count=4``).

* B=6 padded to 8 over four devices equals the one-device run (the
  reference's bound, <= 1e-6; on the CPU the results and the final state
  are bit-identical, which the test also asserts), results in caller
  order;
* B=8 over four devices (no pad rows) equals the one-device run;
* a sharded run makes ONE host transfer and, with ``return_state``,
  returns the 6 real rows;
* the planned path sharded: 2 buckets, 2 fold fetches, equal to the
  unsharded planned run;
* ``execution_mode`` and ``_should_shard`` follow the reference's
  predicate; ``shard=True`` on one device, or a batch of one scenario,
  does not shard.

Ticks are cut from the reference's 700 to keep the file quick: each
device's block runs every op of the tick, so four blocks cost four
one-device runs on the CPU.
"""
import pytest
import torch

from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS

N_DEV = 4
TICKS, CHUNK = 200, 80          # a remainder chunk of 40
SMALL = FBSite(n_clusters=2, racks_per_cluster=4, servers_per_rack=8,
               csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)
PARITY = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def four_devices(monkeypatch):
    monkeypatch.setattr(S, "_local_devices", lambda dev: [dev] * N_DEV)


def _runs(seeds=(0, 1, 2)):
    spec = TRAFFIC_SPECS["fb_hadoop"]
    return [(S.SimParams(spec=spec, site=SMALL, gating_enabled=g), s)
            for g in (True, False) for s in seeds]


def _sweep(batch, **kw):
    return S.run_sweep(batch, TICKS, chunk_ticks=CHUNK, device="cpu", **kw)


@pytest.fixture(scope="module")
def padded():
    """B=6 sharded over four devices (two pad rows) beside the same run
    on one device; the transfer count of the sharded run."""
    batch = S.make_batch(_runs())
    one = _sweep(batch, return_state=True, validate=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(S, "_local_devices", lambda dev: [dev] * N_DEV)
        h0 = S.HOST_TRANSFER_COUNT
        four = _sweep(batch, return_state=True, validate=True)
        transfers = S.HOST_TRANSFER_COUNT - h0
    return batch, one, four, transfers


def test_sharded_matches_unsharded_with_padding(padded):
    batch, (one, st1), (four, st4), _ = padded
    assert S.worst_parity(one, four)[0] <= PARITY
    assert [r["label"] for r in four] == list(batch.labels)
    assert len(four) == 6
    # bitwise on the CPU: every block runs the tick's ops on its own rows
    assert four == one
    assert all(torch.equal(a, b) for a, b in S._leaf_pairs(st1, st4))


def test_sharded_run_is_one_host_transfer(padded):
    assert padded[3] == 1


def test_sharded_return_state_drops_pad_rows(padded):
    _, _, (_, st4), _ = padded
    assert st4.rsw_q.shape[0] == 6 and st4.key.shape == (6, 2)
    assert st4.acc["injected"].shape == (6,)


def test_sharded_matches_unsharded_divisible(four_devices):
    batch = S.make_batch(_runs((0, 1, 2, 7)))
    n_pad = S._layout(len(batch), None, torch.device("cpu"))[1]
    assert n_pad == 8
    sharded = S.run_sweep(batch, 120, chunk_ticks=60, device="cpu")
    one = S.run_sweep(batch, 120, chunk_ticks=60, device="cpu",
                      shard=False)
    assert S.worst_parity(one, sharded)[0] <= PARITY
    assert sharded == one


def test_sharded_planned_contracts(four_devices):
    """The planner under sharding: one fold fetch per hull bucket, the
    metrics of the unsharded planned run, caller order."""
    mixed = [(S.SimParams(spec=TRAFFIC_SPECS["fb_hadoop"], site=SMALL,
                          gating_enabled=g), s)
             for g in (True, False) for s in (0, 1)] + \
        [(S.SimParams(spec=TRAFFIC_SPECS["university"], site=FBSite(
            n_clusters=3, racks_per_cluster=2, servers_per_rack=4,
            csw_per_cluster=3, n_fc=2, csw_ring_links=2,
            fc_ring_links=4)), s) for s in (0, 1)]
    h0 = S.HOST_TRANSFER_COUNT
    planned, plan = S.run_sweep_planned(mixed, 120, chunk_ticks=50,
                                        max_compiles=2, return_plan=True,
                                        device="cpu")
    assert S.HOST_TRANSFER_COUNT - h0 == plan["n_buckets"] == 2
    one = S.run_sweep_planned(mixed, 120, chunk_ticks=50, max_compiles=2,
                              shard=False, device="cpu")
    assert S.worst_parity(one, planned)[0] <= PARITY
    assert [r["label"] for r in planned] == [r["label"] for r in one]
    assert [r["plan_bucket"] for r in planned] \
        == [r["plan_bucket"] for r in one]


def test_execution_mode_and_predicate(monkeypatch):
    cpu = torch.device("cpu")
    assert S._local_devices(cpu) == [cpu]
    assert S.execution_mode(device="cpu") == {
        "fold": "device", "fold_dtype": "float32", "devices": 1}
    assert not S._should_shard(8, True, cpu)     # one device: no layout
    monkeypatch.setattr(S, "_local_devices", lambda dev: [dev] * N_DEV)
    assert S.execution_mode(device="cpu", n_scenarios=6)["devices"] == 4
    assert S.execution_mode(device="cpu", fold="host", x64=True) == {
        "fold": "host", "fold_dtype": "float64", "devices": 4}
    assert S.execution_mode(device="cpu", shard=False)["devices"] == 1
    assert S.execution_mode(device="cpu", n_scenarios=1)["devices"] == 1
    assert S._should_shard(2, None, cpu) and not S._should_shard(1, True,
                                                                 cpu)
    assert S._layout(6, None, cpu) == ([cpu] * 4, 8)
    assert S._layout(6, False, cpu) == ([cpu], 6)


def test_sharded_run_needs_a_device():
    """No CUDA device and no ``device="cpu"``: a sharded run raises, as
    every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.run_sweep(S.make_batch(_runs()), 10, shard=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.execution_mode(shard=True)


def test_pad_rows_copy_row_zero():
    x = torch.arange(6.0).reshape(3, 2)
    got = S._pad_rows((x, {"a": x[:, 0]}), 5)
    assert torch.equal(got[0][3:], x[:1].expand(2, 2))
    assert got[1]["a"].tolist() == [0.0, 2.0, 4.0, 0.0, 0.0]
    assert S._pad_rows(x, 3) is x and S._pad_rows(None, 4) is None
