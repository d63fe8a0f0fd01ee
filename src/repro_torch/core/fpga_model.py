"""The paper's analytic FPGA model (Eq. 1-2, Tables 1-2, Fig. 1), port of
``repro.core.fpga_model``.

These are analytic numbers for an AMD Xilinx Alveo U280 FPGA at the
paper's clock, from its resource counts: the DSP-based and LUT-based peak
rates (Eq. 1 and the LUTMUL count of Eq. 3), the memory roofline (Eq. 2)
and the MobileNetV2 dataflow throughput model whose folding factors
predict the paper's 1627 FPS operating point.  They are not measurements
of any chip, and nothing here runs on a device.  Plain Python floats,
computed in the reference's order, so both packages give the same bits.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.lut import luts_per_multiply


@dataclasses.dataclass(frozen=True)
class FPGASpec:
    name: str
    luts: int
    dsps: int
    bram36: int
    freq_hz: float
    hbm_bw: float           # bytes/s
    ddr_bw: float = 0.0
    power_w: float = 0.0


# AMD Xilinx Alveo U280 (paper Table 1)
U280 = FPGASpec(name="Alveo U280", luts=1_303_680, dsps=9024, bram36=2016,
                freq_hz=333e6, hbm_bw=460e9, ddr_bw=38e9, power_w=100.0)

# NVIDIA V100 PCIe (paper Table 1), for the comparison rows only
V100_PEAK_FP16_TENSOR = 112e12
V100_HBM_BW = 900e9


def dsp_packing_factor(bits: int) -> int:
    """p in Eq. (1): 1 for 16-bit, 2 for 8-bit, 4 for 4-bit MACs."""
    if bits <= 4:
        return 4
    if bits <= 8:
        return 2
    return 1


def dsp_peak_ops(spec: FPGASpec, bits: int = 4, frac: float = 1.0) -> float:
    """Eq. (1): peak = p * PEs * 2 * f (ops/s) of a DSP-based design."""
    return dsp_packing_factor(bits) * (spec.dsps * frac) * 2 * spec.freq_hz


def lutmul_peak_ops(spec: FPGASpec, bits: int = 4, frac: float = 1.0,
                    lut_overhead: float = 1.0) -> float:
    """LUTMUL's peak: (#LUTs / LUTs per multiplier) parallel MACs * 2 * f;
    ``lut_overhead`` > 1 counts the adder-tree and control LUTs a
    multiplier needs beside its ROM LUTs (Fig. 6: about one more)."""
    mults = (spec.luts * frac) / (luts_per_multiply(bits) * lut_overhead)
    return mults * 2 * spec.freq_hz


def memory_bound_ops(bw_bytes: float, ctc_ratio: float) -> float:
    """Eq. (2): the rate a bandwidth allows at a compute-to-communication
    ratio."""
    return bw_bytes * ctc_ratio


def roofline(spec: FPGASpec, bits: int = 4, frac: float = 1.0,
             lut_overhead: float = 2.0) -> dict:
    """Fig. 1's curves: both peaks, the bandwidth, the attainable rate at an
    arithmetic intensity (ops/byte) under each peak, and the ridge points."""
    dsp_peak = dsp_peak_ops(spec, bits, frac)
    lut_peak = lutmul_peak_ops(spec, bits, frac, lut_overhead)
    bw = spec.hbm_bw * frac

    def attainable(intensity_ops_per_byte: float, peak: float) -> float:
        return min(peak, bw * intensity_ops_per_byte)

    return {
        "dsp_peak_ops": dsp_peak,
        "lutmul_peak_ops": lut_peak,
        "bandwidth": bw,
        "dsp_attainable": lambda i: attainable(i, dsp_peak),
        "lutmul_attainable": lambda i: attainable(i, lut_peak),
        "dsp_ridge_intensity": dsp_peak / bw,
        "lutmul_ridge_intensity": lut_peak / bw,
    }


# ---------------------------------------------------------------------------
# the dataflow throughput model (Table 2): an II=1 pixel pipeline, folded
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvLayer:
    """One convolution of the dataflow pipeline."""
    name: str
    cin: int
    cout: int
    k: int               # kernel size
    h_out: int
    w_out: int
    stride: int = 1
    depthwise: bool = False
    bits: int = 4

    @property
    def mults(self) -> int:
        """Multipliers when fully unrolled (COUT x CIN x K^2)."""
        if self.depthwise:
            return self.cout * self.k * self.k
        return self.cout * self.cin * self.k * self.k

    @property
    def macs(self) -> int:
        return self.mults * self.h_out * self.w_out

    @property
    def ops(self) -> int:
        return 2 * self.macs


def layer_cycles(layer: ConvLayer, fold: int) -> int:
    """A frame's initiation cycles in one layer: pixels x fold."""
    return layer.h_out * layer.w_out * fold


def layer_luts(layer: ConvLayer, fold: int, lut_overhead: float = 2.0
               ) -> float:
    """LUTs of one folded layer: mults / fold multipliers of Eq. (3) each,
    times the adder and control overhead (Fig. 6: about 2x)."""
    parallel_mults = layer.mults / fold
    return parallel_mults * luts_per_multiply(layer.bits) * lut_overhead


def pipeline_fps(layers: list[ConvLayer], folds: list[int],
                 freq_hz: float) -> float:
    """Steady-state dataflow throughput: f / the slowest layer's cycles."""
    bottleneck = max(layer_cycles(lyr, f) for lyr, f in zip(layers, folds))
    return freq_hz / bottleneck


def balance_folding(layers: list[ConvLayer], lut_budget: float,
                    freq_hz: float, lut_overhead: float = 2.0,
                    full_parallel_prefix: int = 0) -> dict:
    """Per-layer folds that maximize FPS under a LUT budget, as the paper's
    design: the first ``full_parallel_prefix`` layers unfolded, every other
    layer folded to ``ceil(target / pixels)`` (capped to [1, mults]) for a
    target cycle count found by a 64-step geometric bisection."""
    def cost_at(target_cycles: float) -> tuple[float, list[int]]:
        folds = []
        for i, lyr in enumerate(layers):
            if i < full_parallel_prefix:
                folds.append(1)
                continue
            pixels = lyr.h_out * lyr.w_out
            folds.append(max(1, min(lyr.mults,
                                    math.ceil(target_cycles / pixels))))
        total = sum(layer_luts(lyr, f, lut_overhead)
                    for lyr, f in zip(layers, folds))
        return total, folds

    lo, hi = 1.0, 1e9
    best = None
    for _ in range(64):
        mid = math.sqrt(lo * hi)
        total, folds = cost_at(mid)
        if total <= lut_budget:
            best = (mid, folds, total)
            hi = mid
        else:
            lo = mid
    if best is None:
        raise ValueError("LUT budget too small even at maximum folding")
    _, folds, total = best
    return {
        "folds": folds,
        "total_luts": total,
        "fps": pipeline_fps(layers, folds, freq_hz),
        "bottleneck_cycles": max(layer_cycles(lyr, f)
                                 for lyr, f in zip(layers, folds)),
    }
