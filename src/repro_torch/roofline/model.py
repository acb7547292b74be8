"""Hardware presets and the sketch-ingest roofline of the port.

Counterpart of ``repro/roofline/model.py`` for what the sketch needs:
``HWConfig``, the preset registry ``HW_PRESETS`` and ``hw_for`` (the
reference's three presets as they are, plus ``gpu_h100``, the card the
port runs on), and the analytic ``sketch_ingest_cost`` /
``sketch_roofline``. The model-side terms (``param_count``,
``model_flops``, ...) arrive with the config dataclasses of the model
stack (ROADMAP.md Queue 1 item 16).

``platform.hw_config`` picks the preset of the card in use;
``chip_smoke.py`` reads its rates from ``gpu_h100``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class HWConfig:
    name: str = "tpu_v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    link_bw: float = 50e9             # bytes/s per chip-to-chip link
    hbm_bytes: float = 16e9           # device memory per chip
    int_flops: float = 0.0            # int32 ALU op/s (0 -> use peak_flops)

    @property
    def peak_int_ops(self) -> float:
        """Peak int32 compare/select throughput, the sketch kernels' roof
        (they do no matrix work); ``peak_flops`` where a preset does not
        know its int rate."""
        return self.int_flops or self.peak_flops


# H100 SXM5 80 GB (NVIDIA's data sheet, dense rates, 700 W): 132 SMs,
# 3.35 TB/s HBM3, 989.4 TFLOP/s bf16 on the tensor cores, 900 GB/s
# NVLink, 80 GB. int32: 64 INT32 lanes per SM per clock (half of the 128
# FP32 lanes behind the 67 TFLOP/s FP32 peak, which counts an FMA as 2)
# x 132 SMs x 1.98 GHz (the card's maximum SM clock) = 16.73e12 op/s.
H100_SMS = 132
H100_MAX_SM_HZ = 1.98e9
H100_INT32_LANES_PER_SM = 64

# The reference's presets (``repro/roofline/model.py:57``), as they are:
#   cpu:      one server core's share: ~50 GFLOP/s, ~30 GB/s;
#   gpu_a100: A100-80GB SXM: 312 TFLOP/s bf16, 2.0 TB/s, 600 GB/s NVLink,
#             19.5 TFLOP/s int32;
#   tpu_v5e:  197 TFLOP/s bf16, 819 GB/s HBM, 50 GB/s ICI link.
HW_PRESETS: Dict[str, HWConfig] = {
    "cpu": HWConfig(name="cpu", peak_flops=5e10, hbm_bw=3e10,
                    link_bw=1e10, hbm_bytes=64e9, int_flops=5e10),
    "gpu_a100": HWConfig(name="gpu_a100", peak_flops=312e12, hbm_bw=2.0e12,
                         link_bw=600e9, hbm_bytes=80e9, int_flops=19.5e12),
    "tpu_v5e": HWConfig(name="tpu_v5e", peak_flops=197e12, hbm_bw=819e9,
                        link_bw=50e9, hbm_bytes=16e9, int_flops=4e12),
    "gpu_h100": HWConfig(
        name="gpu_h100", peak_flops=989.4e12, hbm_bw=3.35e12,
        link_bw=900e9, hbm_bytes=80e9,
        int_flops=H100_INT32_LANES_PER_SM * H100_SMS * H100_MAX_SM_HZ),
}


def hw_for(name: str) -> HWConfig:
    try:
        return HW_PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware preset {name!r}; "
            f"available: {sorted(HW_PRESETS)}") from None


# ---------------------------------------------------------------------------
# Sketch-ingest cost model (reference :331-394)
# ---------------------------------------------------------------------------
# First-order op counts per counter cell of the fused update, as in the
# reference: sat_add ~6 ops, fill/water-fill ~12 touches per cell, one
# residual lockstep trip ~8 ops per cell.
_SAT_ADD_OPS = 6
_FILL_OPS = 12
_TOURNAMENT_OPS = 8


def sketch_ingest_cost(*, num_rows: int, k: int, block: int, lanes: int = 128,
                       residual_trips: float = 0.0,
                       dtype_bytes: int = 4) -> Dict[str, float]:
    """Analytic bytes and ops of one fused update of an (R, k) bank.

    bytes: the state (ids, counts, errors) read and written once, the
    phase-1 delta (R x k_pad), the grouped residual layout (uids and
    nets, R x B each) and the raw block (items and weights, B each).
    flops: per-cell phase-1 and fill/water-fill work, plus
    ``residual_trips`` lockstep trips over every cell.
    """
    k_pad = ((k + lanes - 1) // lanes) * lanes
    cells = num_rows * k_pad
    state_bytes = 3 * cells * dtype_bytes * 2
    stream_bytes = (cells * dtype_bytes
                    + 2 * num_rows * block * dtype_bytes
                    + 2 * block * dtype_bytes)
    flops = cells * (_SAT_ADD_OPS + _FILL_OPS) \
        + residual_trips * cells * _TOURNAMENT_OPS
    return {"bytes": float(state_bytes + stream_bytes), "flops": float(flops)}


def sketch_roofline(cost: Dict[str, float], wall_s: float,
                    hw: Optional[HWConfig] = None) -> Dict[str, float]:
    """Roofline columns of one measured cell against ``hw`` (the H100
    preset unless given): achieved bytes/s, its share of the memory
    rate, ops per byte, the least time and which roof bounds it."""
    hw = hw or HW_PRESETS["gpu_h100"]
    achieved = cost["bytes"] / wall_s if wall_s > 0 else 0.0
    memory_s = cost["bytes"] / hw.hbm_bw
    compute_s = cost["flops"] / hw.peak_int_ops
    return {
        "achieved_bytes_per_s": achieved,
        "peak_fraction": achieved / hw.hbm_bw,
        "arith_intensity": (cost["flops"] / cost["bytes"]
                            if cost["bytes"] else 0.0),
        "bound_s": max(memory_s, compute_s),
        "bound": "memory" if memory_s >= compute_s else "compute",
    }


__all__ = ["HWConfig", "HW_PRESETS", "hw_for", "sketch_ingest_cost",
           "sketch_roofline"]
