"""DRAM random-access bandwidth model — paper Sec. IV-D-2 / Fig. 6.

Embedding lookups are scattered 64-256 B reads with poor page locality
(paper Sec. IV-D-2), so the achievable rate is NOT the streaming bandwidth.
With closed-page (autoprecharge) policy each access costs one ACTIVATE; the
per-channel access rate is bounded by three independent limits:

  1. activate-rate  : tFAW allows 4 ACTs per rolling window (and tRRD between
                      consecutive ACTs) -> max(4/tFAW, 1/tRRD) ACT/s;
  2. bank-cycle     : a bank is busy tRC per access -> n_banks / tRC ACT/s;
  3. data-bus       : an access of `access_bytes` occupies the bus for
                      access_bytes / channel_bw seconds -> channel_bw /
                      access_bytes accesses/s (derated for refresh + bus
                      turnaround).

Effective random-access bandwidth = access_bytes x min(limits) x n_channels.

This reproduces the paper's Fig. 6 shape: DDR4 server memory is ACT-limited
(tFAW) to a small fraction of its streaming bandwidth for 64 B embeddings,
while HBM's many independent (pseudo-)channels keep random access within
~2x of streaming; GDDR6 sits between.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# Derate on data-bus-bound transfers: refresh (~5%) + read/write turnaround.
BUS_DERATE = 0.90


@dataclass(frozen=True)
class MemoryDevice:
    """One DRAM channel's timing + geometry (datasheet parameters).

    channel_bytes_per_s : peak data rate of one channel (pins x rate / 8)
    burst_bytes         : bytes delivered per burst (bus width x burst length)
    n_banks             : banks addressable in parallel per channel
    t_rc_s              : row cycle time (ACT -> ACT same bank)
    t_faw_s             : four-activate window
    t_rrd_s             : ACT -> ACT different bank (same group; we use the
                          conservative long variant)
    """

    name: str
    channel_bytes_per_s: float
    burst_bytes: int
    n_banks: int
    t_rc_s: float
    t_faw_s: float
    t_rrd_s: float


# --- datasheet-derived devices (paper Table VIII memory systems) -----------
# DDR4-3200: 64-bit channel, BL8 -> 64 B bursts, 16 banks, tRC 45.8 ns,
# tFAW ~30 ns (2KB pages), tRRD_L 7.5 ns  [Micron MT40A2G4; systemverilog.io]
DDR4_3200 = MemoryDevice(
    name="DDR4-3200", channel_bytes_per_s=25.6e9, burst_bytes=64,
    n_banks=16, t_rc_s=45.8e-9, t_faw_s=30e-9, t_rrd_s=7.5e-9)

# HBM2 (V100-era, ~1.75-2.0 Gb/s/pin): stack = 8 channels x 128-bit, BL4 ->
# 64 B bursts. Per channel 16 banks. tRC ~45 ns, tFAW ~21.4 ns.
HBM2_2000 = MemoryDevice(
    name="HBM2-2000", channel_bytes_per_s=32.0e9, burst_bytes=64,
    n_banks=16, t_rc_s=45e-9, t_faw_s=21.4e-9, t_rrd_s=4e-9)

# HBM2E (A100/RecSpeed-era, 2.4-3.0 Gb/s/pin): stack = 16 pseudo-channels x
# 64-bit, BL4 -> 32 B bursts, 16 banks/pc.
HBM2E_2400 = MemoryDevice(
    name="HBM2E-2400", channel_bytes_per_s=19.2e9, burst_bytes=32,
    n_banks=16, t_rc_s=45e-9, t_faw_s=21.4e-9, t_rrd_s=4e-9)
HBM2E_3000 = MemoryDevice(
    name="HBM2E-3000", channel_bytes_per_s=24.0e9, burst_bytes=32,
    n_banks=16, t_rc_s=45e-9, t_faw_s=21.4e-9, t_rrd_s=4e-9)

# GDDR6 (TU102-era, 14 Gb/s/pin): device = 2 channels x 16-bit, BL16 ->
# 32 B bursts, 16 banks, tRC ~45 ns, tFAW ~24 ns.
GDDR6_14000 = MemoryDevice(
    name="GDDR6-14000", channel_bytes_per_s=28.0e9, burst_bytes=32,
    n_banks=16, t_rc_s=45e-9, t_faw_s=24e-9, t_rrd_s=6e-9)

DEVICES: Dict[str, MemoryDevice] = {
    d.name: d for d in (DDR4_3200, HBM2_2000, HBM2E_2400, HBM2E_3000, GDDR6_14000)
}


@dataclass(frozen=True)
class MemorySystem:
    """A processor's attached memory: `n_channels` of `device`.

    For HBM, n_channels = stacks x (pseudo-)channels per stack.
    """

    device: MemoryDevice
    n_channels: int
    capacity_bytes: float = 0.0

    @property
    def peak_stream_bytes_per_s(self) -> float:
        return self.device.channel_bytes_per_s * self.n_channels

    def random_access_rate_per_channel(self, access_bytes: int) -> float:
        """Accesses/s one channel sustains for random `access_bytes` reads."""
        d = self.device
        act_limit = min(4.0 / d.t_faw_s, 1.0 / d.t_rrd_s)
        bank_limit = d.n_banks / d.t_rc_s
        # an access may span multiple bursts (e.g. 256 B on a 32 B-burst HBM pc)
        data_limit = BUS_DERATE * d.channel_bytes_per_s / max(access_bytes, d.burst_bytes)
        return min(act_limit, bank_limit, data_limit)

    def random_access_bytes_per_s(self, access_bytes: int) -> float:
        """Paper Fig. 6: effective bandwidth for random embedding reads."""
        per_ch = self.random_access_rate_per_channel(access_bytes)
        # each access still moves max(access, burst) granularity on the wire,
        # but only access_bytes are useful
        return per_ch * access_bytes * self.n_channels

    def random_write_bytes_per_s(self, access_bytes: int) -> float:
        """Sparse embedding updates (paper Sec. V-B: buffered rows -> write
        only). Writes obey the same ACT/bank limits; same model."""
        return self.random_access_bytes_per_s(access_bytes)


# --- the concrete systems compared in the paper ----------------------------
def xeon_ddr4_6ch(capacity: float = 768e9) -> MemorySystem:
    """Server CPU: 6 channels DDR4-3200 (paper Table I / VIII)."""
    return MemorySystem(DDR4_3200, 6, capacity)


def v100_hbm2() -> MemorySystem:
    """DGX-2 V100: 4 stacks HBM2, 8 channels each, 32 GB (paper Table XV)."""
    return MemorySystem(HBM2_2000, 4 * 8, 32e9)


def a100_hbm2e() -> MemorySystem:
    """A100: 5 stacks HBM2E @ 2430, 16 pc each, 40 GB (paper Table II)."""
    return MemorySystem(HBM2E_2400, 5 * 16, 40e9)


def recspeed_hbm2e(stacks: int = 6) -> MemorySystem:
    """RecSpeed: 6 stacks HBM2E @ 3000 MHz, 96 GB (paper Table XIV)."""
    return MemorySystem(HBM2E_3000, stacks * 16, 96e9)


def recspeed_sweep_hbm2e(stacks: int = 6) -> MemorySystem:
    """Parameter-sweep system: 6 stacks HBM2E @ 2400 (paper Table XIII)."""
    return MemorySystem(HBM2E_2400, stacks * 16, 64e9)


def gddr6_tu102() -> MemorySystem:
    """RTX 2080 Ti: 11 GDDR6 devices x 2 channels (paper Table VIII)."""
    return MemorySystem(GDDR6_14000, 22, 11e9)

