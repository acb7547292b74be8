"""The layout rules of the kernels with layouts (sketch kernels 1, 2 and
3, and decode attention, kernel 6): the wrappers' limits are the CUDA
sources' own, each size names the layout the sources choose for it, and
each layout counts its own launches. (On the card, each C entry point
refuses a launch whose layout disagrees with its rule:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` run both sides of
every limit, and hold ``decode_layout`` to the built source's.)"""
from __future__ import annotations

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import kernel as decode
from repro_torch.kernels.sketch_update import kernel


def _constants(source) -> dict:
    text = (kernel.CSRC / source).read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_layout_limits_are_the_sources():
    residual, banked = _constants("residual.cu"), _constants("fused_update.cu")
    assert (kernel.RESIDUAL_STAGE_ROWS, kernel.RESIDUAL_SUM_ROWS) == (
        residual["kStageRows"], residual["kSumRows"])
    assert kernel.BANKED_STAGE_SLOTS == banked["kStageSlots"]
    assert kernel.FUSED_STAGE_SLOTS == banked["kFusedStageSlots"]


@pytest.mark.parametrize("R,want", [
    (1, "staged"), (25, "staged"), (128, "staged"),
    (129, "summary+chain"), (3125, "summary+chain"), (8192, "summary+chain"),
    (8193, "summary+chain/scratch")])
def test_residual_layout_by_rows(R, want):
    assert kernel.residual_layout(R) == want


@pytest.mark.parametrize("K,want", [
    (1, "staged"), (3200, "staged"), (24576, "staged"),
    (24577, "unstaged"), (400000, "unstaged")])
def test_banked_layout_by_slots(K, want):
    assert kernel.banked_layout(K) == want


@pytest.mark.parametrize("K,want", [
    (1, "staged"), (2048, "staged"), (3200, "staged"), (24576, "staged"),
    (24577, "unstaged"), (40000, "unstaged"), (65536, "unstaged")])
def test_fused_layout_by_slots(K, want):
    assert kernel.fused_layout(K) == want


def test_each_layout_counts_its_own_launches():
    assert tuple(kernel.sketch_update_kernel_fused.launches) == \
        kernel.FUSED_LAYOUTS
    assert tuple(kernel.sketch_residual_kernel.launches) == \
        kernel.RESIDUAL_LAYOUTS
    assert tuple(kernel.sketch_residual_kernel_banked.launches) == \
        kernel.BANKED_LAYOUTS
    for fn in (kernel.sketch_update_kernel_fused,
               kernel.sketch_residual_kernel,
               kernel.sketch_residual_kernel_banked):
        assert all(isinstance(n, int) for n in fn.launches.values())


def test_unbiased_layout_limit_is_the_source():
    assert kernel.UNBIASED_STAGE_SLOTS == \
        _constants("unbiased_update.cu")["kStageSlots"]
    assert tuple(kernel.sketch_unbiased_kernel.launches) == \
        kernel.UNBIASED_LAYOUTS


@pytest.mark.parametrize("K,want", [
    (1, "staged"), (2084, "staged"), (16384, "staged"),
    (16385, "global"), (400000, "global")])
def test_unbiased_layout_by_slots(K, want):
    assert kernel.unbiased_layout(K) == want


def test_decode_layout_constants_are_the_sources():
    got = _constants(decode.SOURCE)
    assert (decode.G_MAX, decode.THREADS_MAX, decode.THREADS_MAX_WIDE,
            decode.MIN_THREADS, decode.STAGE_F32_BYTES, decode.SUB_MAX,
            decode.SCORE_FLOATS, decode.CHUNK_MAX, decode.TARGET_CTAS,
            decode.COMBINE_CTAS, decode.COMBINE_SLOTS) == (
        got["kGMax"], got["kThreadsMax"], got["kThreadsMaxWide"],
        got["kMinThreads"], got["kStageF32Bytes"], got["kSubMax"],
        got["kScoreFloats"], got["kChunkMax"], got["kTargetCtas"],
        got["kCombineCtas"], got["kCombineSlots"])


# B, C: the Gemma3-27B serving shapes (KV = 16, G = 2, hd = 128): the SS±
# heavy-hitter cache, a ring cache, and the attention phase's decode step
@pytest.mark.parametrize("B,C,chunk", [(2, 8192, 64), (2, 1024, 8),
                                       (8, 8192, 256)])
def test_decode_chunks_cover_the_card_at_the_serving_shapes(B, C, chunk):
    """One CTA holds every kv-head of its slots, and both launches have at
    least one CTA for each of the H100's 132 SMs."""
    lay = decode.decode_layout(B, C, 16, 2, 128)
    assert lay.chunk == chunk and lay.kv_groups == lay.g_groups == 1
    assert lay.split_ctas * B >= 132 and lay.combine * B >= 132
    assert (lay.threads, lay.rep, lay.sub) == (256, 1, 8)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_mesh_paths_local_rows_keep_their_layouts(ranks):
    """The shard_map paths hand kernels 3 and 2 the rank's rows only: the
    main spec's 128 shards of 3,125 slots as 128, 64 or 32 sketches
    (kernel 3's layout goes by the rows of 128 slots in one sketch, 25
    here), and the 8-shard dyadic bank at bits = 24 as s_loc * 24 rows
    of the layers' 96,000 slots (kernel 2's by the slots in a row). Each
    local shape names the layout of the single-device run and passes the
    wrappers' size checks."""
    from repro_torch.core.quantiles import dyadic_layer_capacities
    from repro_torch.core.spacesaving import capacity_for

    k = -(-capacity_for(1e-5, 2.0) // 128)            # per shard
    E, rows = 128 // ranks, -(-k // 128)
    assert (k, rows) == (3125, 25)
    assert kernel.residual_layout(rows) == "staged"
    kernel._check_sizes("sketch_residual_kernel", E, rows, 65536,
                        E * rows * 128, E * 65536)
    K = max(dyadic_layer_capacities(24, eps=1e-3, alpha=2.0))
    R = (8 // ranks) * 24
    assert K == 96000 and kernel.banked_layout(K) == "unstaged"
    kernel._check_sizes("sketch_residual_kernel_banked", R, K, R * 65536,
                        R * K)
