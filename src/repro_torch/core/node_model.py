"""Node-level LC/DC model (Sec III-C / IV-C).

The kernel interposes ``sendmsg()``: the laser turn-on command is issued
at socket-write time and the payload then spends the TCP/IP + driver +
NIC-DMA pipeline (3.75 us budget, measured 3.2 us mean) before bits hit
the fiber. The laser (1 us) and CDR (625 ps) finish well inside that
window, so the egress link can sit dark between sends at ZERO added
latency. This module reproduces that latency budget and the hiding
condition as executable checks (the kernel module itself is obviously
out of scope for this repository; the 200-LoC driver change is described
in the paper).

Counterpart of ``repro/core/node_model.py`` (a copy; plain Python).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import constants as C

STACK_STAGES = (
    ("socket write -> TCP entry", 950),
    ("TCP segment + copy to kernel queue", 260),
    ("IP routing / header / driver call", 550),
    ("driver queues descriptor, doorbell", 430),
    ("NIC fetches descriptor (DMA)", 400),
    ("NIC parses descriptor, starts data DMA", 760),
    ("payload cache-line DMA to NIC", 400),
)


@dataclass(frozen=True)
class NodeTiming:
    stack_ns: int
    laser_on_ns: int
    cdr_ns: float

    @property
    def slack_ns(self) -> float:
        return self.stack_ns - (self.laser_on_ns + self.cdr_ns)

    @property
    def hidden(self) -> bool:
        return self.slack_ns >= 0.0

    @property
    def added_latency_ns(self) -> float:
        return max(0.0, -self.slack_ns)


def default_timing() -> NodeTiming:
    return NodeTiming(
        stack_ns=sum(ns for _, ns in STACK_STAGES),
        laser_on_ns=int(C.LASER_ON_US * 1000),
        cdr_ns=C.CDR_LOCK_US * 1000,
    )


def hiding_condition(laser_on_us: float,
                     stack_us: float = C.SENDMSG_TO_TX_US) -> bool:
    """True iff a laser that takes `laser_on_us` is fully hidden behind
    the measured sendmsg->transmit latency."""
    return laser_on_us + C.CDR_LOCK_US <= stack_us


def max_hideable_laser_on_us(stack_us: float = C.SENDMSG_TO_TX_US) -> float:
    return stack_us - C.CDR_LOCK_US
