"""IMC architecture description + the two silicon baselines of the paper.

The 4-D design space (paper Fig. 2a):
  D_i  input-reuse rows per macro       (K unrolled)
  D_o  output-reuse columns per macro   (C/FX/FY unrolled, in-array accumulation)
  D_h  number of macros
  D_m  memory cells per multiplier      (time-multiplex depth)

Unit energy/latency costs follow paper Table 1 (D-IMC = 22nm all-digital
ISSCC'21 [5]; A-IMC = 28nm charge-domain TCAS-I'23 [4]; LPDDR4 DRAM [13];
256 kB SRAM activation buffer from CACTI [1]).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MemoryCosts:
    """System memories feeding the IMC fabric."""

    dram_energy_pj_per_bit: float = 4.0       # LPDDR4 R/W [13]
    dram_bandwidth_gbit_s: float = 12.8       # LPDDR4 [13]
    sram_energy_pj_per_bit: float = 0.009     # 256 kB buffer [1]
    sram_bytes: int = 256 * 1024


@dataclasses.dataclass(frozen=True)
class IMCMacro:
    """A single IMC macro and its unit costs."""

    name: str
    D_i: int                 # input-reuse rows (K)
    D_o: int                 # output-reuse cols (C*FX*FY)
    kind: str = "digital"    # "digital" | "analog"
    weight_bits: int = 4
    act_bits: int = 4
    freq_mhz: float = 200.0
    vdd: float = 0.9

    # --- energy model knobs -------------------------------------------------
    # Digital macro: per-MAC switching modeled as an ND2-equivalent gate count
    # times ND2 cap (paper Table 1: 0.3 fF). ZigZag-IMC models the adder tree +
    # multiplier as ~ (w_bits * a_bits + adder tree) ND2 equivalents per MAC.
    nd2_cap_ff: float = 0.3
    # ND2-equivalents per 4b x 4b MAC (multiplier + adder-tree share), set so
    # that a fully-utilized 16x256 macro lands on the 89 TOPS/W @ 4b reported
    # by the silicon baseline [5]: 2*4096 ops / (180*0.3fF*0.81V^2*0.5*4096
    # + periph) = ~89e12 ops/J.
    nd2_per_mac: float = 180.0
    # Analog macro: ADC conversion dominates; one conversion per active
    # D_i row (output) per cycle (paper Table 1: 190 fJ/conv) + DAC and row drive.
    adc_fj_per_conv: float = 190.0
    dac_fj_per_input: float = 12.0
    # Peripheral energy per *cycle* per macro (decoders, clocking, control);
    # amortized over the spatially-active MACs — §2.2's amortization argument.
    periph_pj_per_cycle: float = 2.0

    # --- area model (paper Fig. 3 / Table 1) --------------------------------
    cell_area_um2: float = 0.379      # D-IMC 22nm SRAM-cell area
    periph_area_um2: float = 44290.0  # per-macro peripheral area
    mult_area_um2: float = 2.0        # one multiplier unit (amortized by D_m)

    @property
    def plane(self) -> int:
        """Multiplier positions per macro (the 2-D packing plane)."""
        return self.D_i * self.D_o

    def cycle_ns(self) -> float:
        return 1e3 / self.freq_mhz

    def mac_energy_pj(self, active_macs: int, active_rows: int,
                      active_cols: int) -> float:
        """Energy of one compute cycle with the given activity (one macro).

        active_macs = active multiplier positions (<= plane),
        active_rows = active D_i rows, active_cols = active D_o columns.
        """
        if self.kind == "digital":
            # gate switching scales with active MACs; 0.5 activity factor.
            e_mac = (self.nd2_per_mac * self.nd2_cap_ff * 1e-15
                     * self.vdd ** 2 * 0.5) * 1e12  # -> pJ per MAC
            return e_mac * active_macs + self.periph_pj_per_cycle
        # analog: ADC per active row conversion + DAC per active column input.
        return (self.adc_fj_per_conv * 1e-3 * active_rows
                + self.dac_fj_per_input * 1e-3 * active_cols
                + self.periph_pj_per_cycle)

    def macro_area_mm2(self, d_m: int) -> float:
        """Macro area as cells/multipliers/peripherals (paper Fig. 3 model)."""
        cells = self.plane * d_m * self.cell_area_um2 * self.weight_bits
        mults = self.plane * self.mult_area_um2
        return (cells + mults + self.periph_area_um2) * 1e-6


@dataclasses.dataclass(frozen=True)
class IMCArchitecture:
    """A full accelerator: D_h macros of depth D_m + system memories."""

    macro: IMCMacro
    D_h: int = 1
    D_m: int = 1
    mem: MemoryCosts = dataclasses.field(default_factory=MemoryCosts)

    @property
    def weight_capacity(self) -> int:
        """Total weight elements storable on-chip."""
        return self.macro.plane * self.D_h * self.D_m

    def total_area_mm2(self) -> float:
        return self.D_h * self.macro.macro_area_mm2(self.D_m)

    def with_dims(self, *, D_h: int | None = None,
                  D_m: int | None = None) -> "IMCArchitecture":
        return dataclasses.replace(self, D_h=D_h or self.D_h, D_m=D_m or self.D_m)


# --- Silicon baselines (paper Table 1) ---------------------------------------

def d_imc_macro() -> IMCMacro:
    """22nm all-digital SRAM IMC, ISSCC'21 [5]: D_o x D_i = 256 x 16."""
    return IMCMacro(name="D-IMC-22nm", D_i=16, D_o=256, kind="digital",
                    weight_bits=4, act_bits=4, freq_mhz=200.0, vdd=0.9,
                    nd2_cap_ff=0.3, cell_area_um2=0.379,
                    periph_area_um2=44290.0)


def a_imc_macro() -> IMCMacro:
    """28nm charge-domain 10T SRAM IMC, TCAS-I'23 [4]: D_o x D_i = 256 x 16."""
    return IMCMacro(name="A-IMC-28nm", D_i=16, D_o=256, kind="analog",
                    weight_bits=4, act_bits=4, freq_mhz=200.0, vdd=0.9,
                    adc_fj_per_conv=190.0, cell_area_um2=1.2,
                    periph_area_um2=15400.0)


def d_imc(D_h: int = 1, D_m: int = 1) -> IMCArchitecture:
    return IMCArchitecture(macro=d_imc_macro(), D_h=D_h, D_m=D_m)


def a_imc(D_h: int = 1, D_m: int = 1) -> IMCArchitecture:
    return IMCArchitecture(macro=a_imc_macro(), D_h=D_h, D_m=D_m)
