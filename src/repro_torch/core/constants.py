"""Timing / power constants from the paper (LC/DC, cs.NI 2021).

Sim tick = 1 us. One 1500 B MTU packet on a 10G link ~= 1.2 us, so a 10G
link serves ~1 pkt/tick and a 40G link 4 pkt/tick.
"""

TICK_US = 1.0

# --- transceiver timing (Sec IV, conservative MRV SFPFC401 [43]) ---------
LASER_ON_US = 1.0          # turn-on
LASER_OFF_US = 10.0        # turn-off (charged at full power: conservative)
CDR_LOCK_US = 0.000625     # clock-phase caching, 625 ps [5,14,15]
SWITCH_STAGE_TRIGGER_NS = 5.8   # FPGA: same-cycle trigger (Sec IV-B)
SWITCH_CTRL_PARSE_NS = 12.8     # 2 cycles @169.32 MHz
SWITCH_PIPELINE_CYCLES = 7
FPGA_CLOCK_MHZ = 169.32

# control-message hop + ack + laser + CDR, rounded up to whole ticks.
# Feasibility (Sec IV): trigger <5.8 ns, ctrl parse 12.8 ns, laser 1 us,
# clock-phase-caching CDR 625 ps, intra-pod fiber ~0.3 us -> ~2 us.
STAGE_UP_DELAY_TICKS = 2
STAGE_OFF_DELAY_TICKS = 10  # 10 us laser-off transition, still charged

# --- node level (Sec IV-C) ------------------------------------------------
TCP_STACK_NS = (950, 260, 550, 430, 400, 760, 400)   # = 3750 ns total
SENDMSG_TO_TX_US = 3.2     # measured mean (100k samples, Sec IV-C)

# --- power (Sec II) -------------------------------------------------------
P_SFP10_W = 1.0            # 10G SFP+ per transceiver
P_QSFP40_W = 2.4           # 40G QSFP per transceiver
P_PHY_W = 0.8              # switch PHY per port
P_NIC_W = 10.0             # server NIC electronics
P_SWITCH_ASIC_W = 28.0     # switch ASIC + CPU chips

# --- in-scan packet-delay histogram (bounded-memory distributions) --------
# Per-tick delay samples are binned into a fixed log-spaced histogram so a
# chunked scan can emit full latency distributions (p50/p95/p99, Fig 10
# tails) without unbounding memory. Bin 0 is [0, MIN); bin i >= 1 covers
# [MIN * 2**((i-1)/BPO), MIN * 2**(i/BPO)); the last bin absorbs overflow.
DELAY_HIST_BINS = 48
DELAY_HIST_MIN_US = 4.0          # just under the 5.75 us stack+wire floor
DELAY_HIST_BINS_PER_OCTAVE = 6   # ~12% resolution per bin, range ~900 us

# --- flow-level workload engine (flow_mode=1, core/workloads.py) ----------
# Fixed per-rack flow-table width: the static slot axis the jitted step
# compiles against. The *usable* prefix is the traced flow_table_cap
# knob (<= this), so table pressure is sweepable with zero recompiles.
FLOW_TABLE_SLOTS = 64
# fixed per-arrival-event size-draw width (the incast fan-in ceiling):
# like MAX_FAULT_LINKS, a fixed draw shape keeps every random stream
# padding- and knob-invariant
MAX_INCAST_DEGREE = 8
# per-flow emission ceiling: 10G NIC ~= 1 pkt/tick — also the line rate
# of the ideal-FCT baseline (workloads.ideal_fct_us)
FLOW_LINE_RATE_PPT = 1.0
# AIMD congestion window (pkts/tick): slow trickle start, additive
# increase toward line rate, halve on the rack's hi-watermark signal
FLOW_CWND_INIT_PPT = 0.25
FLOW_CWND_MIN_PPT = 0.0625
FLOW_AIMD_INCREASE_PPT = 0.02
FLOW_AIMD_DECREASE = 0.5
# FCT histogram: flows live 1e1..1e7 us, so 2 bins/octave spans
# ~8 us * 2**23.5 ~= 9e7 us in the same 48-bin frame the delay
# histogram machinery uses
FCT_HIST_BINS = 48
FCT_HIST_MIN_US = 8.0
FCT_HIST_BINS_PER_OCTAVE = 2
# FCT slowdown histogram (dimensionless, >= 1 by construction):
# 4 bins/octave spans 1x..~3400x
FCT_SLOWDOWN_HIST_BINS = 48
FCT_SLOWDOWN_HIST_MIN = 1.0
FCT_SLOWDOWN_HIST_BINS_PER_OCTAVE = 4

# --- optical fault model (beyond-paper robustness axis) -------------------
# Real optical DCN components are not the paper's perfect plane: wakes
# jitter and transiently fail (PULSE-class timing margins; the Xue et al.
# 2023 optical-switching survey catalogs transceiver reliability). A
# failed stage-up retries after a bounded backoff on top of the re-drawn
# turn-on delay, so a flapping laser cannot hot-loop the controller.
WAKE_RETRY_BACKOFF_TICKS = 4
# conservation tolerance of the opt-in in-program validate guard
# (relative |injected - (delivered + in-flight + drops + fault-drops)|);
# matches the cross-path parity tolerance the test suite pins
VALIDATE_CONS_REL_TOL = 1e-3

# --- watermarks (Sec V) ---------------------------------------------------
QUEUE_CAP_PKTS = 20        # output queue capacity (pkts)
HI_WATERMARK = 0.75        # stage-up threshold (75% buffer utilization)
LO_WATERMARK = 0.22        # stage-down threshold (22%)
# anti-flap dwell: a freshly activated stage stays up for at least this
# long before the low watermark may drain it (keeps an elephant from
# flapping the stage and re-paying the turn-on queueing repeatedly)
STAGE_DWELL_TICKS = 1024

# --- the modelled TPU v5e pod of the beyond-paper ICI study ---------------
# Inputs of core/ici_gating.py: the chip and link parameters of the TPU
# pod whose ICI fabric that analysis models (per chip, per link). They
# describe the modelled pod, not the hardware this port runs on.
TPU_PEAK_BF16_FLOPS = 197e12     # per chip
TPU_HBM_BW = 819e9               # bytes/s per chip
TPU_ICI_LINK_BW = 50e9           # bytes/s per link (~ one direction)
TPU_ICI_LINKS_PER_CHIP = 4       # 2D torus (v5e); 3D torus has 6
ICI_XCVR_W = 2.5                 # modeled per-link optical transceiver power
