"""Data-center network topology of the simulated site.

`FBSite` is the simulated Clos site of Fig 2 (the LC/DC evaluation
network): 4 clusters x 32 racks x 48 servers, RSW->4 CSWs (10G),
CSW->4 FCs (40G), plus the CSW/FC load-balancing rings. Counterpart of
``repro/core/topology.py``, with the component counts of the five
network designs Fig 1 and Fig 11 compare (``NetworkDesign``,
``all_designs``).
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


@dataclass(frozen=True)
class NetworkDesign:
    """Component counts for the Fig 1 power-breakdown study."""
    name: str
    n_servers: int
    n_switches: int
    n_10g_ports: int          # optical 10G ports (transceiver each)
    n_40g_ports: int
    notes: str = ""

    def network_power_w(self) -> dict:
        return {
            "switch_asic": self.n_switches * C.P_SWITCH_ASIC_W,
            "nic": self.n_servers * C.P_NIC_W,
            "phy": (self.n_10g_ports + self.n_40g_ports) * C.P_PHY_W,
            "transceivers": (self.n_10g_ports * C.P_SFP10_W
                             + self.n_40g_ports * C.P_QSFP40_W),
        }


def fb_site_design() -> NetworkDesign:
    s = FBSite()
    n10 = (s.n_server_links * 2 + s.n_rsw_csw_links * 2
           + s.n_ring_links * 2)
    n40 = s.n_csw_fc_links * 2
    n_switches = s.n_racks + s.n_csw + s.n_fc
    return NetworkDesign("fb_clos", s.n_servers, n_switches, n10, n40,
                         "Facebook site, Fig 2 [48]")


def flattened_butterfly_design(n_servers: int = 6144) -> NetworkDesign:
    # Abts et al. [1]: FBFLY k=32 c=4; ~each switch 4 servers + ~19
    # inter-switch 40G ports.
    n_sw = n_servers // 4
    n40 = n_sw * 19
    return NetworkDesign("flattened_butterfly", n_servers, n_sw,
                         n_servers * 2, n40, "Google FBFLY [1]")


def fat_tree_designs(n_servers: int = 6144) -> list[NetworkDesign]:
    # Farrington et al. [28]: k=48 3-tier FULLY-PROVISIONED fat trees
    # (1:1 oversubscription): every server has an optical edge link plus
    # edge-agg and agg-core fabric links (2 transceivers each) -> ~6 10G
    # transceivers per server, with a 40G share for the engineered
    # variants. The board/chassis (ft2) and custom-ASIC (ft3) builds fold
    # tiers onto backplanes, cutting optical port counts.
    designs = []
    for i, (sw_scale, p10, p40) in enumerate(
            [(1.0, 6.0, 0.5), (0.7, 5.0, 0.4), (0.5, 4.0, 0.3)], start=1):
        n_sw = int(5 * n_servers / 48 * sw_scale)
        n10 = int(n_servers * p10)
        n40 = int(n_servers * p40)
        designs.append(NetworkDesign(
            f"fat_tree_{i}", n_servers, n_sw, n10, n40,
            "off-the-shelf" if i == 1 else
            ("board/chassis engineered" if i == 2 else "custom ASIC")))
    return designs


def all_designs() -> list[NetworkDesign]:
    return [fb_site_design(), flattened_butterfly_design(),
            *fat_tree_designs()]
