"""Hardware presets and the roofline terms of the port.

Counterpart of ``repro/roofline/model.py``: ``HWConfig``, the preset
registry ``HW_PRESETS`` and ``hw_for`` (the reference's three presets as
they are, plus ``gpu_h100``, the card the port runs on), the analytic
``sketch_ingest_cost`` / ``sketch_roofline``, and the model-side terms
(reference :83-335): ``RooflineTerms``, ``param_count``,
``model_flops``, ``analytic_hbm_bytes`` and ``roofline_terms``, against
the ``gpu_h100`` preset (``HW``).

``platform.hw_config`` picks the preset of the card in use;
``chip_smoke.py`` reads its rates from ``gpu_h100``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.configs.base import InputShape, ModelConfig


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


# The model-side terms below are taken against the card the port runs on.
HW = HW_PRESETS["gpu_h100"]


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float                  # global (all chips)
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    chips: int
    memory_s_analytic: float = 0.0    # see analytic_hbm_bytes

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """model_flops / hlo_flops: how much of the counted work is useful."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs over the roofline-bound time x peak — the score."""
        denom = self.bound_time_s * self.chips * HW.peak_flops
        return self.model_flops / denom if denom else 0.0

    @property
    def mfu_analytic(self) -> float:
        """MFU with the analytic memory term in place of the counted
        bytes term (see analytic_hbm_bytes)."""
        bound = max(self.compute_s, self.memory_s_analytic, self.collective_s)
        denom = bound * self.chips * HW.peak_flops
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_s_analytic": self.memory_s_analytic,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
            "mfu_analytic": self.mfu_analytic,
            "chips": self.chips,
        }


def param_count(cfg: ModelConfig) -> Dict[str, float]:
    """Analytic parameter counts: total and per-token-active."""
    D, V, F = cfg.d_model, cfg.vocab_size, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pattern, n_periods, remainder = cfg.layer_pattern()
    kinds = list(pattern) * n_periods + list(remainder)

    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    mlp = (3 if cfg.mlp_gated else 2) * D * F
    moe_total = cfg.num_experts * (3 * D * F) + D * cfg.num_experts
    moe_active = cfg.experts_per_token * (3 * D * F) + D * cfg.num_experts

    mamba = 0.0
    if cfg.ssm_state:
        Din = cfg.ssm_expand * D
        nh = Din // cfg.ssm_head_dim
        conv_dim = Din + 2 * cfg.ssm_state
        mamba = (
            D * (2 * Din + 2 * cfg.ssm_state + nh)  # in_proj
            + 4 * conv_dim + conv_dim               # conv
            + 3 * nh + Din                          # A/dt/skip/norm
            + Din * D                               # out_proj
        )

    total = active = 0.0
    for kind in kinds:
        if kind == "mamba":
            total += mamba + D
            active += mamba + D
        elif kind == "mamba_attn":
            total += mamba + D
            active += mamba + D
            # shared block params counted once below
        else:
            ffn_t = moe_total if cfg.family == "moe" else mlp
            ffn_a = moe_active if cfg.family == "moe" else mlp
            total += attn + ffn_t + 2 * D
            active += attn + ffn_a + 2 * D
            if kind == "decoder_x":
                total += attn + D
                active += attn + D
    if cfg.family == "hybrid":
        shared = attn + mlp + 2 * D
        total += shared
        n_apps = sum(1 for k in kinds if k == "mamba_attn")
        active += shared * n_apps  # applied at every mamba_attn position
    if cfg.family == "encdec":
        enc = (attn + mlp + 2 * D) * cfg.encoder_layers
        total += enc
        active += enc
    emb = V * D * (1 if cfg.tie_embeddings else 2)
    total += emb + D
    active += emb + D
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Analytic useful FLOPs for one step of this (arch x shape) cell.

    train: 6·N_active·tokens (fwd+bwd);  prefill: 2·N_active·tokens;
    decode: 2·N_active·batch (one token per sequence).
    Attention score/value FLOPs are added explicitly (they are not in N·D).
    """
    pc = param_count(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    base = mult * pc["active"] * tokens

    # attention matmul flops: 2 * 2 * S_eff * H * hd per token per layer
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    pattern, n_periods, remainder = cfg.layer_pattern()
    kinds = list(pattern) * n_periods + list(remainder)
    attn_flops = 0.0
    for kind in kinds:
        if kind in ("full", "global", "decoder_x", "mamba_attn"):
            s_eff = shape.seq_len / 2 if shape.kind != "decode" else shape.seq_len
            if kind == "mamba_attn" and cfg.hh_kv_budget and shape.seq_len > 65536:
                s_eff = min(s_eff, cfg.hh_kv_budget)
            if kind == "global" and cfg.hh_kv_budget and shape.seq_len > 65536:
                s_eff = min(s_eff, cfg.hh_kv_budget)
        elif kind in ("swa", "local"):
            s_eff = min(cfg.window, shape.seq_len)
        else:  # mamba: SSD flops ~ chunked linear, fold into base
            continue
        per_token = 2 * 2 * s_eff * H * hd
        attn_flops += per_token * tokens * (mult / 2.0)
    return base + attn_flops


def analytic_hbm_bytes(cfg: ModelConfig, shape: InputShape,
                       microbatches: int = 1, remat: bool = True) -> float:
    """Global device-memory traffic per step (first-order model), the
    reference's formula:

      train:  weights x (fwd+bwd reads + grad write + opt r/w, xM for
              FSDP regathers) + activations x passes + attention probs
      decode: weights + KV caches (+ new-token writes)
      prefill: weights + activations + cache writes
    """
    pc = param_count(cfg)
    P = pc["active"] if shape.kind == "decode" else pc["total"]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    D, L = cfg.d_model, cfg.num_layers

    # attention probs traffic (bf16): tokens x S_eff x heads, fwd(+bwd)
    H = max(cfg.num_heads, 1)
    pattern, n_periods, remainder = cfg.layer_pattern()
    kinds = list(pattern) * n_periods + list(remainder)
    probs = 0.0
    for kind in kinds:
        if kind in ("full", "global", "decoder_x", "mamba_attn"):
            s_eff = shape.seq_len / 2
        elif kind in ("swa", "local"):
            s_eff = min(cfg.window, shape.seq_len)
        else:
            continue
        probs += tokens * s_eff * H * 2

    if shape.kind == "train":
        passes = 3 if remat else 2                       # fwd + bwd (+refwd)
        w = P * 2 * (passes * microbatches)              # bf16 reads (FSDP regather/mb)
        w += P * 4 * 2 + P * 4 * 4 + P * 2               # grad f32 r/w, m/v r/w, cast
        acts = tokens * D * 2 * L * 8 * passes / (microbatches ** 0)  # ~8 tensors/layer
        return w + acts + probs * (2 if remat else 1) * 2
    if shape.kind == "prefill":
        acts = tokens * D * 2 * L * 6
        cache = tokens * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * 2 * L
        return P * 2 + acts + probs + cache
    # decode: weights + cache read per token
    KV, hd = max(cfg.num_kv_heads, 1), cfg.resolved_head_dim
    cache = 0.0
    for kind in kinds:
        if kind in ("full", "global", "decoder_x", "mamba_attn"):
            c_len = shape.seq_len
            if cfg.hh_kv_budget and shape.seq_len > 65536:
                c_len = cfg.hh_kv_budget
        elif kind in ("swa", "local"):
            c_len = min(cfg.window, shape.seq_len)
        elif kind == "mamba":
            Din = cfg.ssm_expand * D
            cache += shape.global_batch * Din * cfg.ssm_state * 4 * 2
            continue
        else:
            continue
        cache += shape.global_batch * c_len * KV * hd * 2 * 2
    return P * 2 + cache + shape.global_batch * D * 2 * L * 6


def roofline_terms(
    *,
    hlo_flops_global: float,
    hlo_bytes_global: float,
    collective_bytes_global: float,
    chips: int,
    cfg: ModelConfig,
    shape: InputShape,
    microbatches: int = 1,
    remat: bool = True,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=hlo_flops_global / (chips * HW.peak_flops),
        memory_s=hlo_bytes_global / (chips * HW.hbm_bw),
        collective_s=collective_bytes_global / (chips * HW.link_bw),
        hlo_flops=hlo_flops_global,
        hlo_bytes=hlo_bytes_global,
        collective_bytes=collective_bytes_global,
        model_flops=model_flops(cfg, shape),
        chips=chips,
        memory_s_analytic=analytic_hbm_bytes(cfg, shape, microbatches, remat)
        / (chips * HW.hbm_bw),
    )


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


__all__ = ["HWConfig", "HW_PRESETS", "HW", "hw_for", "RooflineTerms",
           "param_count", "model_flops", "analytic_hbm_bytes",
           "roofline_terms", "sketch_ingest_cost", "sketch_roofline"]
