"""CPU checks of ``chip_smoke.py``'s helpers that the timing tools share.

``tools/fused_ab.py``, ``tools/fused_phases.py`` and
``tools/residual_ab.py`` capture a block's kernel operands with
``chip_smoke.run_plain`` driven by a kernel, which updates its operands
in place; the captured operands must still be the block's own, as they
were before its update.
"""
from __future__ import annotations

import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.streams import bounded_stream
from repro_torch.kernels.sketch_update.ref import fused_update_ref
from repro_torch.sketch.api import SketchSpec

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_place(ids, counts, errors, *prep, variant):
    """``fused_update_ref`` written back into its operands, as kernel 1
    updates them."""
    for t, new in zip((ids, counts, errors),
                      fused_update_ref(ids, counts, errors, *prep,
                                       variant=variant)):
        t.copy_(new)
    return ids, counts, errors


@pytest.mark.parametrize("variant", ["sspm", "lazy"])
@pytest.mark.parametrize("at", [1, -1])
def test_run_plain_captures_the_operands_before_the_update(monkeypatch,
                                                           variant, at):
    cs = _chip_smoke()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    spec = SketchSpec(kind="frequency", eps=0.05, alpha=2.0, variant=variant,
                      shards=4, bits=12, backend="kernel")
    stream = bounded_stream(600, 0.5, universe=1 << 12, seed=3)
    cpu = torch.device("cpu")
    want_bank, (want_st, want_args), _ = cs.run_plain(
        spec, stream, 256, cpu, cs.fused_path, fused_update_ref, at)
    bank, (st, args), _ = cs.run_plain(spec, stream, 256, cpu, cs.fused_path,
                                       _in_place, at)
    assert all(torch.equal(a, b) for a, b in zip(want_bank, bank))
    assert all(torch.equal(a, b) for a, b in zip(want_st, st))
    assert all(torch.equal(a, b) for a, b in zip(want_args, args))
    # the captured state is the one the block's update starts from
    out = fused_update_ref(*st, *args, variant=spec.variant_id)
    assert not all(torch.equal(a, b) for a, b in zip(out, st))
