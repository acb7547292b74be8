#!/usr/bin/env python3
"""Time the residual kernels (2 and 3) of this checkout against another's.

    python3 tools/residual_ab.py OTHER_CHECKOUT [--reps N] [--rounds M]

OTHER_CHECKOUT holds another version of the repo (for example the parent
commit, unpacked with ``git archive``). Its ``repro_torch`` package is
loaded beside this one under another name, so each side runs its own
full wrappers (``kernel.sketch_residual_kernel`` and
``sketch_residual_kernel_banked``: operand checks, scratch, launch) and
its own CUDA sources, each built with nvcc into its checkout's
``build/``. Both run on the same operands, captured from
``chip_smoke.py``'s runs (the framework side driven with this
checkout's kernels): kernel 3 on path A's and path B's last blocks and
on the block-lazy run's block 1, kernel 2 on the banked run's last
block. A round times each side in the order other, this, this, other;
each timing is N calls, each on its own copy of the state: ms per call
from the host (``chip_smoke.stream_ms``: CUDA events around the calls,
the wrappers' host time included) and device ms per call
(``chip_smoke.device_ms``). Every output is held to the plain version.
Prints one JSON line per block (every sample, and each side's medians)
and the card's name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def other_kernels(other: pathlib.Path):
    """The kernel module of OTHER_CHECKOUT's ``repro_torch``, loaded as the
    package ``other_repro_torch``."""
    init = other / "src" / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        "other_repro_torch", init, submodule_search_locations=[str(init.parent)])
    package = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = package
    spec.loader.exec_module(package)
    return importlib.import_module("other_repro_torch.kernels.sketch_update.kernel")


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("residual_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import dataclasses

    import chip_smoke as cs
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch.api import SketchSpec

    device = torch.device("cuda")
    B = 65536
    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="block")
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="block")
    a_spec = dataclasses.replace(main_spec, shards=None)
    main_stream = cs.make_stream(64, B, seed=1)
    k3, k2 = "sketch_residual_kernel", "sketch_residual_kernel_banked"
    # (label, spec, stream, path, kernel, block)
    blocks = (
        ("kernel 3, path A last block", a_spec, cs.make_stream(32, B, seed=4),
         cs.split_path, k3, -1),
        ("kernel 3, path B last block", main_spec, main_stream,
         cs.split_path, k3, -1),
        ("kernel 3, block lazy block 1", lazy_spec,
         cs.make_stream(16, B, seed=2), cs.split_path, k3, 1),
        ("kernel 2, banked last block", main_spec, main_stream,
         cs.banked_path, k2, -1),
    )
    sides = {"other": other_kernels(opts.other.resolve()), "this": kernel}
    for label, spec, stream, path, name, at in blocks:
        v = spec.variant_id
        _, (st, args), _ = cs.run_plain(spec, stream, B, device, path,
                                        getattr(kernel, name), at)
        want = (ref.residual_phase if name == k3
                else ref.residual_phase_banked)(*st, *args, variant=v)
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other") * opts.rounds:
            fn = getattr(sides[who], name)
            out = fn(*(t.clone() for t in st), *args, variant=v)  # warm-up
            if not cs._same(want, out):
                print(json.dumps(dict(block=label, side=who,
                                      equal_to_plain=False)))
                return 1
            call = lambda c: fn(*c, *args, variant=v)
            times[who].append(dict(
                stream_ms=cs.stream_ms(call, st, opts.reps, 1)[0],
                device_ms=cs.device_ms(call, st, opts.reps)))
        median = {who: {key: statistics.median(t[key] for t in ts)
                        for key in ("stream_ms", "device_ms")}
                  for who, ts in times.items()}
        print(json.dumps(dict(block=label, median=median, samples=times,
                              equal_to_plain=True,
                              **cs.trips(st, args, want, v))), flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
