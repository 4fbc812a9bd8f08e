"""``repro_torch.trace_sweep --shard-views``'s comparison
(``first_divergence``) on the CPU: a small grid laid over K views of one
device, stepped eagerly beside the one-device run. The rows never mix,
so every carry leaf stays equal to the one-device run's (the card's
graph replays are held by the script itself)."""
import pytest
import torch

from repro_torch.core import simulator as S
from repro_torch.core.topology import FBSite
from repro_torch.core.traffic import TRAFFIC_SPECS
from repro_torch.trace_sweep import first_divergence

TICKS = 4
SITE = FBSite(n_clusters=2, racks_per_cluster=4, servers_per_rack=4,
              csw_per_cluster=2, n_fc=2, csw_ring_links=4, fc_ring_links=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("views", [2, 3])
def test_first_divergence_steps_views_on_cpu(views):
    spec = TRAFFIC_SPECS["fb_hadoop"]
    batch = S.make_batch([
        (S.SimParams(spec=spec, site=SITE), 0),
        (S.SimParams(spec=spec, site=SITE, gating_enabled=False), 1),
        (S.SimParams(spec=spec, site=SITE, rate_scale=1.5,
                     flow_mode=1), 2),
        (S.SimParams(spec=spec, site=SITE, link_mtbf_ticks=300.0,
                     repair_ticks=20, plane_fail_prob=0.01), 3)])
    assert batch.flows
    out = first_divergence(torch.device("cpu"), batch, views, TICKS,
                           x64=False)
    assert out["ticks_compared"] == TICKS
    assert "first_outside_accumulators" not in out, out
