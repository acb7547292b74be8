"""The flash-attention wrapper's shape rule, on the CPU.

``flash_path(dtype, hd, aligned)`` picks the kernel before the launch:
the wgmma kernel takes bf16 at hd 64, 128 and 256 with every operand
16-byte aligned (the TMA's rule), the mma.sync kernel every other bf16
shape, the f32 kernel f32. The kernels run only on the card; the rule is
held here so the dispatch stays honest without one.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention.kernel import (MAX_HD, PATHS,
                                                        WGMMA_HD,
                                                        flash_attention_kernel,
                                                        flash_path)

HDS = range(1, MAX_HD + 1)


@pytest.mark.parametrize("aligned", [True, False])
def test_f32_never_takes_a_tensor_core_path(aligned):
    assert {flash_path(torch.float32, hd, aligned) for hd in HDS} == {"f32"}


@pytest.mark.parametrize("aligned", [True, False])
def test_bf16_takes_wgmma_only_at_its_widths_when_aligned(aligned):
    for hd in HDS:
        want = "wgmma" if aligned and hd in WGMMA_HD else "mma"
        assert flash_path(torch.bfloat16, hd, aligned) == want, hd


def test_wgmma_widths_are_whole_tma_boxes():
    """Each wgmma width is a whole number of 64-column (128-byte) boxes."""
    assert WGMMA_HD == (64, 128, 256)
    assert all(hd % 64 == 0 and hd <= MAX_HD for hd in WGMMA_HD)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_other_dtypes_have_no_kernel(dtype):
    with pytest.raises(ValueError, match="no kernel"):
        flash_path(dtype, 128, True)


def test_every_path_has_its_own_launch_count():
    assert set(flash_attention_kernel.launches) == set(PATHS)
    assert all(isinstance(n, int) for n in flash_attention_kernel.launches
               .values())
