"""ZigZag-IMC-style EDP cost model (paper §4, Table 1).

    EDP_total = EDP_{MAC, Act.mem} + EDP_{Weight loading}       (paper eq. 1)

Per-layer accounting, driven by the final tile shapes of a mapping:

  cycles        = OX * OY * T_m                       (D_m slots revisited per
                                                       output position)
  MAC energy    = per-cycle macro energy * active macros   (digital: gate
                  switching ~ active MACs; analog: ADC/DAC conversions)
  input reads   = OX*OY * T_m_red * T_h_red * T_o * act_bits   from the SRAM
                  activation buffer (K-multiplexed D_m slots and K-split macro
                  copies reuse/multicast the same inputs)
  psum traffic  = outputs * (T_m_red - 1 + T_h_red - 1) * 2 accesses at
                  accumulator precision (reduction split in time or across
                  macros forces read-modify-write / gather-add)
  output writes = K * OX * OY * out_bits
  weight reload = per-inference DRAM fetch of every *streamed* layer
                  (energy: pj/bit; latency: bits / DRAM bandwidth, serial
                  with compute — §2.2: loading and computing cannot overlap)

Weights that fit on-chip are loaded once at boot and are free in steady-state
inference — the paper's central premise ("maximize stationarity").
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping, Sequence

from .imc_arch import IMCArchitecture
from .loops import LayerSpec, Workload
from .packer import PackingPlan
from .tiles import Tile


ACC_BITS = 16  # partial-sum precision for 4b x 4b MACs over <=4k reductions


@dataclasses.dataclass(frozen=True)
class LayerCost:
    name: str
    cycles: int
    stall_cycles: float          # DRAM weight-load stalls (latency only)
    e_mac_pj: float
    e_act_pj: float              # SRAM buffer: inputs + psums + outputs
    e_weight_pj: float           # DRAM weight fetching (per-inference)
    streamed: bool

    @property
    def e_total_pj(self) -> float:
        return self.e_mac_pj + self.e_act_pj + self.e_weight_pj

    @property
    def total_cycles(self) -> float:
        return self.cycles + self.stall_cycles


@dataclasses.dataclass(frozen=True)
class CostReport:
    workload: str
    method: str
    arch: IMCArchitecture
    layers: tuple[LayerCost, ...]
    min_D_m: int

    # -- energy (pJ) ---------------------------------------------------------
    @property
    def e_mac_pj(self) -> float:
        return sum(l.e_mac_pj for l in self.layers)

    @property
    def e_act_pj(self) -> float:
        return sum(l.e_act_pj for l in self.layers)

    @property
    def e_weight_pj(self) -> float:
        return sum(l.e_weight_pj for l in self.layers)

    @property
    def energy_pj(self) -> float:
        return self.e_mac_pj + self.e_act_pj + self.e_weight_pj

    # -- latency (ns) ----------------------------------------------------------
    @property
    def compute_ns(self) -> float:
        return sum(l.cycles for l in self.layers) * self.arch.macro.cycle_ns()

    @property
    def stall_ns(self) -> float:
        return sum(l.stall_cycles for l in self.layers) \
            * self.arch.macro.cycle_ns()

    @property
    def latency_ns(self) -> float:
        return self.compute_ns + self.stall_ns

    @property
    def edp_pj_s(self) -> float:
        """EDP in pJ*s."""
        return self.energy_pj * self.latency_ns * 1e-9

    @property
    def area_mm2(self) -> float:
        return self.arch.total_area_mm2()

    def row(self) -> dict:
        return {
            "workload": self.workload, "method": self.method,
            "D_h": self.arch.D_h, "D_m": self.arch.D_m,
            "min_D_m": self.min_D_m,
            "E_mac_uJ": self.e_mac_pj * 1e-6,
            "E_act_uJ": self.e_act_pj * 1e-6,
            "E_wload_uJ": self.e_weight_pj * 1e-6,
            "E_total_uJ": self.energy_pj * 1e-6,
            "lat_compute_us": self.compute_ns * 1e-3,
            "lat_stall_us": self.stall_ns * 1e-3,
            "lat_total_us": self.latency_ns * 1e-3,
            "EDP_pJs": self.edp_pj_s,
            "area_mm2": self.area_mm2,
        }


def _layer_cost(layer: LayerSpec, tile: Tile, arch: IMCArchitecture, *,
                n_macros: int, streamed: bool) -> LayerCost:
    """Cost of executing one layer with the given (final) tile shape."""
    m = arch.macro
    act_bits = m.act_bits
    out_bits = 2 * m.act_bits
    cycles = tile.compute_cycles()
    outputs = layer.K * layer.OX * layer.OY

    # --- MAC / array energy --------------------------------------------------
    if m.kind == "digital":
        # Gate switching scales with *true* MACs (idle cells clock-gate);
        # peripheral energy is per cycle per active macro — its amortization
        # is what rewards high spatial utilization (§2.2).
        e_per_mac = (m.nd2_per_mac * m.nd2_cap_ff * 1e-15
                     * m.vdd ** 2 * 0.5) * 1e12  # pJ/MAC
        e_mac = e_per_mac * layer.macs \
            + m.periph_pj_per_cycle * cycles * n_macros
    else:
        # Analog: ADCs convert every active row each cycle regardless of
        # element-level activity; DACs drive active columns.
        e_cycle = (m.adc_fj_per_conv * 1e-3 * tile.T_i
                   + m.dac_fj_per_input * 1e-3 * tile.T_o
                   + m.periph_pj_per_cycle)
        e_mac = e_cycle * cycles * n_macros

    # --- activation buffer traffic -------------------------------------------
    input_reads_bits = (layer.OX * layer.OY * tile.T_m_red * tile.T_h_red
                        * tile.T_o * act_bits)
    psum_steps = (tile.T_m_red - 1) + (tile.T_h_red - 1)
    psum_bits = outputs * psum_steps * 2 * ACC_BITS
    output_bits = outputs * out_bits
    e_act = (input_reads_bits + psum_bits + output_bits) \
        * arch.mem.sram_energy_pj_per_bit

    # --- weight loading --------------------------------------------------------
    e_weight = 0.0
    stall = 0.0
    if streamed:
        wbits = layer.weight_volume * m.weight_bits
        e_weight = wbits * arch.mem.dram_energy_pj_per_bit \
            + wbits * arch.mem.sram_energy_pj_per_bit  # array write
        # DRAM bandwidth-limited, serial with compute in the same macro.
        load_ns = wbits / arch.mem.dram_bandwidth_gbit_s  # Gb/s == bits/ns
        stall = load_ns / m.cycle_ns()

    return LayerCost(name=layer.name, cycles=cycles, stall_cycles=stall,
                     e_mac_pj=e_mac, e_act_pj=e_act, e_weight_pj=e_weight,
                     streamed=streamed)


def plan_cost(plan: PackingPlan) -> CostReport:
    """Cost a §3 packing plan (or a baseline expressed as a plan)."""
    costs = []
    for layer in plan.workload.layers:
        tile = plan.tiles[layer.name]
        streamed = layer.name in plan.streamed_layers
        n_macros = plan.macros_holding(layer.name) if not streamed else \
            min(tile.T_h, plan.arch.D_h)
        costs.append(_layer_cost(layer, tile, plan.arch,
                                 n_macros=n_macros, streamed=streamed))
    return CostReport(workload=plan.workload.name, method=plan.method,
                      arch=plan.arch, layers=tuple(costs),
                      min_D_m=plan.min_D_m)
