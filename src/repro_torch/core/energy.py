"""Data-center power models: Fig 1 (breakdown vs server optimizations),
Fig 9 inputs, and Fig 11 (whole-DC savings of LC/DC).

The server power model follows Fan et al. [26] (component split), SPECpower
SR665 [53] (best-in-class energy proportionality), IRDS CMOS scaling [10,34]
and the memory/storage/specialization optimizations of Sec II. Each
optimization multiplies the affected component's power; the sequence of
bars in Fig 1 is reproduced by ``power_breakdown_series``.

Counterpart of ``repro/core/energy.py``: plain float64 Python, a copy of
the reference's arithmetic (tests/test_torch_energy.py holds it equal).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.topology import NetworkDesign, all_designs

SERVER_PEAK_W = 300.0
# peak-power split of a data-center-class server [26]
SERVER_SPLIT = {"cpu": 0.40, "dram": 0.25, "disk": 0.10, "other": 0.25}

# utilization -> power fraction curves (calibrated to the paper's stated
# anchor points: 70% / 58% / 40% of peak at 30% utilization)
UTIL_CURVES = {
    "server_2013": lambda u: 0.50 + 0.6667 * u,      # [6]  70% @30%
    "sr665": lambda u: 0.40 + 0.60 * u,              # [53] 58% @30%
    "proportional": lambda u: 0.10 + 1.00 * u,       # [6,7] 40% @30%
}

# component multipliers per optimization step (applied cumulatively),
# following the Sec II citations: IRDS 7->1.5 nm silicon [10,34], HMC
# [16,46], 16-die 3D NAND [3,55], Catapult-style offload [47], refresh
# reduction [39] + DIMMer idle-off [56], disaggregation [44] + NMP [38].
OPT_STEPS = [
    ("full util (100%)", {}),
    ("2013 server @util", {}),
    ("SR665 @util", {}),
    ("energy-proportional", {}),
    ("CMOS 7->1.5nm", {"cpu": 0.25, "switch_asic": 0.25, "nic": 0.25,
                       "phy": 0.25, "other": 0.5}),
    ("HMC memory", {"dram": 0.4}),
    ("3D-NAND SSD", {"disk": 0.35}),
    ("specialized compute", {"cpu": 0.5}),
    ("DRAM refresh/idle-off", {"dram": 0.5}),
    ("disaggregation+NMP", {"dram": 0.6, "other": 0.6}),
]


def _server_power(util: float, curve: str, mults: dict) -> float:
    base = {k: SERVER_PEAK_W * v for k, v in SERVER_SPLIT.items()}
    for k, m in mults.items():
        if k in base:
            base[k] *= m
    peak = sum(base.values())
    return peak * UTIL_CURVES[curve](util)


def power_breakdown_series(design: NetworkDesign, util: float = 0.30):
    """Fig 1: list of (step_name, breakdown dict in W) for one network."""
    net = design.network_power_w()
    out = []
    cum: dict[str, float] = {}
    for i, (name, mults) in enumerate(OPT_STEPS):
        for k, m in mults.items():
            cum[k] = cum.get(k, 1.0) * m
        if i == 0:
            srv = SERVER_PEAK_W * design.n_servers
        elif i == 1:
            srv = _server_power(util, "server_2013", cum) * design.n_servers
        elif i == 2:
            srv = _server_power(util, "sr665", cum) * design.n_servers
        else:
            srv = _server_power(util, "proportional", cum) * design.n_servers
        netw = dict(net)
        for k in ("switch_asic", "nic", "phy"):
            netw[k] = net[k] * cum.get(k, 1.0)
        row = {"servers": srv, **netw}
        total = sum(row.values())
        out.append((name, row, {k: v / total for k, v in row.items()}))
    return out


def final_network_fractions(util: float = 0.30) -> dict:
    """After all optimizations: transceiver / PHY+NIC+transceiver fraction
    of DC power, per design (the paper projects ~20% / up to 46%)."""
    res = {}
    for d in all_designs():
        series = power_breakdown_series(d, util)
        _, row, frac = series[-1]
        res[d.name] = {
            "transceivers": frac["transceivers"],
            "phy_nic_transceivers": frac["transceivers"] + frac["phy"]
            + frac["nic"],
        }
    return res


@dataclass(frozen=True)
class DCEnergyResult:
    util: float
    transceiver_frac: float            # of total DC power
    savings_links_only: float          # LC/DC gating transceivers
    savings_with_phy_nic: float        # + PHY/NIC electronics sleep


def dc_savings(transceiver_on_frac: float, util: float = 0.30) -> dict:
    """Fig 11: whole-DC savings when LC/DC leaves `transceiver_on_frac`
    of transceiver power on, at the given server utilization, averaged
    over the five network designs (servers fully optimized)."""
    out = {}
    for d in all_designs():
        series = power_breakdown_series(d, util)
        _, row, frac = series[-1]
        total = sum(row.values())
        tx_save = row["transceivers"] * (1 - transceiver_on_frac)
        # extension: PHY + NIC electronics sleep with the link
        ext_save = tx_save + (row["phy"] + row["nic"]) * \
            (1 - transceiver_on_frac)
        out[d.name] = DCEnergyResult(
            util=util,
            transceiver_frac=frac["transceivers"],
            savings_links_only=tx_save / total,
            savings_with_phy_nic=ext_save / total,
        )
    avg_links = sum(r.savings_links_only for r in out.values()) / len(out)
    avg_ext = sum(r.savings_with_phy_nic for r in out.values()) / len(out)
    # the "average" row must carry the real mean transceiver fraction —
    # a 0.0 placeholder silently poisons consumers that average it
    avg_frac = sum(r.transceiver_frac for r in out.values()) / len(out)
    out["average"] = DCEnergyResult(util, avg_frac, avg_links, avg_ext)
    return out
