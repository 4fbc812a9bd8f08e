"""Data-center network topology of the simulated site.

`FBSite` is the simulated Clos site of Fig 2 (the LC/DC evaluation
network): 4 clusters x 32 racks x 48 servers, RSW->4 CSWs (10G),
CSW->4 FCs (40G), plus the CSW/FC load-balancing rings. Counterpart of
``repro/core/topology.py`` (the Fig 1 ``NetworkDesign`` builders are
not ported yet).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core import constants as C


@dataclass(frozen=True)
class FBSite:
    """A (generalized) Fig 2 Clos site.

    The wiring fixes two invariants: every RSW has exactly one uplink
    per CSW of its cluster (``rsw_uplinks == csw_per_cluster`` — uplink
    c IS the link to cluster-CSW c, the stage-c "plane"), and every CSW
    has exactly one uplink per fabric core switch (``csw_uplinks ==
    n_fc`` — uplink f IS the link to FC f). The uplink fields therefore
    default to None and are derived; passing them explicitly is allowed
    only when consistent (anything else would silently mis-route the
    down-plane math, so ``__post_init__`` rejects it).
    """
    n_clusters: int = 4
    racks_per_cluster: int = 32
    servers_per_rack: int = 48
    csw_per_cluster: int = 4
    n_fc: int = 4
    rsw_uplinks: int | None = None  # derived: = csw_per_cluster
    csw_uplinks: int | None = None  # derived: = n_fc
    csw_ring_links: int = 8         # 10G per cluster ring
    fc_ring_links: int = 16         # 10G FC ring

    def __post_init__(self):
        if self.rsw_uplinks is None:
            object.__setattr__(self, "rsw_uplinks", self.csw_per_cluster)
        if self.csw_uplinks is None:
            object.__setattr__(self, "csw_uplinks", self.n_fc)
        for name in ("n_clusters", "racks_per_cluster", "servers_per_rack",
                     "csw_per_cluster", "n_fc", "rsw_uplinks",
                     "csw_uplinks"):
            if int(getattr(self, name)) < 1:
                raise ValueError(f"FBSite.{name} must be >= 1, got "
                                 f"{getattr(self, name)}")
        if self.rsw_uplinks != self.csw_per_cluster:
            raise ValueError(
                f"inconsistent FBSite: rsw_uplinks={self.rsw_uplinks} but "
                f"csw_per_cluster={self.csw_per_cluster}; each RSW has one "
                "uplink per cluster CSW (uplink c is the stage-c plane), "
                "so the two must match — omit rsw_uplinks to derive it")
        if self.csw_uplinks != self.n_fc:
            raise ValueError(
                f"inconsistent FBSite: csw_uplinks={self.csw_uplinks} but "
                f"n_fc={self.n_fc}; each CSW has one uplink per fabric "
                "core switch (uplink f lands on FC f), so the two must "
                "match — omit csw_uplinks to derive it")

    @property
    def n_racks(self) -> int:
        return self.n_clusters * self.racks_per_cluster

    @property
    def n_servers(self) -> int:
        return self.n_racks * self.servers_per_rack

    @property
    def n_csw(self) -> int:
        return self.n_clusters * self.csw_per_cluster

    # --- link populations (each link has a transceiver at BOTH ends) ----
    @property
    def n_server_links(self) -> int:
        return self.n_servers

    @property
    def n_rsw_csw_links(self) -> int:
        return self.n_racks * self.rsw_uplinks          # 512

    @property
    def n_csw_fc_links(self) -> int:
        return self.n_csw * self.csw_uplinks            # 64 (40G)

    @property
    def n_ring_links(self) -> int:
        return self.n_clusters * self.csw_ring_links + self.fc_ring_links

    def transceiver_power_w(self) -> dict:
        """Peak (always-on) optical transceiver power by population."""
        return {
            "server": self.n_server_links * 2 * C.P_SFP10_W,
            "rsw_csw": self.n_rsw_csw_links * 2 * C.P_SFP10_W,
            "csw_fc": self.n_csw_fc_links * 2 * C.P_QSFP40_W,
            "ring": self.n_ring_links * 2 * C.P_SFP10_W,
        }

    def total_transceiver_power_w(self) -> float:
        return sum(self.transceiver_power_w().values())


def site_tag(site: FBSite) -> str:
    """Compact ``<ncl>x<rpc>c<cpc>f<nfc>`` tag of the four hull-defining
    axes; used in scenario labels, cache keys and planner reports."""
    return (f"{site.n_clusters}x{site.racks_per_cluster}"
            f"c{site.csw_per_cluster}f{site.n_fc}")


def full_site_tag(site: FBSite) -> str:
    """``site_tag`` extended with servers-per-rack and ring-link counts —
    covers EVERY FBSite field, so two distinct sites never collide."""
    return (f"{site_tag(site)}s{site.servers_per_rack}"
            f"r{site.csw_ring_links}-{site.fc_ring_links}")


def pad_hull(sites: Sequence[FBSite]) -> FBSite:
    """The smallest FBSite every site in ``sites`` fits inside (per-axis
    max). This is the static shape a multi-site batch compiles against;
    the planner (core/planner.py) buckets scenarios to keep these hulls
    tight."""
    return FBSite(
        n_clusters=max(s.n_clusters for s in sites),
        racks_per_cluster=max(s.racks_per_cluster for s in sites),
        servers_per_rack=max(s.servers_per_rack for s in sites),
        csw_per_cluster=max(s.csw_per_cluster for s in sites),
        n_fc=max(s.n_fc for s in sites),
        csw_ring_links=max(s.csw_ring_links for s in sites),
        fc_ring_links=max(s.fc_ring_links for s in sites))
