#!/usr/bin/env python3
"""Time kernel 1 (the fused bank update) of this checkout against another's.

    python3 tools/fused_ab.py OTHER_CHECKOUT [--reps N] [--rounds M]

OTHER_CHECKOUT holds another version of the repo (for example the parent
commit, unpacked with ``git archive``); its ``repro_torch`` is loaded
beside this one under another name (``residual_ab.other_kernels``), so
each side runs its own full wrapper and CUDA source. Both run on the same
operands, captured from ``chip_smoke.py``'s runs on the ``kernel``
backend (the framework side driven with this checkout's kernel 1): the
main run's last block (R = 128, K = 3,200, SS±) and the lazy run's
block 1 (R = 1, K = 2,048, Lazy).

Each block is also split by step without any switch in the kernel: the
same block is launched with its per-row scalars zeroed cumulatively, so
each launch is a valid update that runs the steps up to one more:

- ``delta``: i0 = mu = nnu = w_del = 0 (step 1, the monitored delta);
- ``+i0``: the empty fill's count back (step 2);
- ``+mu``: the unit inserts back (step 3, the water-fill);
- ``+nnu``: the non-unit inserts back (step 4, the evictions);
- ``+w_del``: the whole block (step 5, the SS± drain).

A round times each side in the order other, this, this, other; each
timing is N calls, each on its own copy of the state: device ms per call
(``chip_smoke.device_ms``) and ms per call from the host
(``chip_smoke.stream_ms``, the wrapper's host time included). Every
output is held to the plain version. Prints one JSON line per block and
split (every sample, each side's medians, the block's work) and the
card's name and power limit; needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

SPLITS = ("delta", "+i0", "+mu", "+nnu", "+w_del")


def split_args(args, upto: int):
    """The prep ``(delta, h_uids, h_net, i0, mu, nnu, w_del)`` with the
    per-row scalars past the first ``upto`` of (i0, mu, nnu, w_del)
    zeroed."""
    head, scalars = list(args[:3]), list(args[3:])
    return head + [s if j < upto else s.new_zeros(s.shape)
                   for j, s in enumerate(scalars)]


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("other", type=pathlib.Path)
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=3)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("fused_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch.api import SketchSpec
    from residual_ab import other_kernels

    device = torch.device("cuda")
    B = 65536
    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="kernel")
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="kernel")
    blocks = (
        ("kernel 1, main last block", main_spec, cs.make_stream(64, B, seed=1),
         -1),
        ("kernel 1, lazy block 1", lazy_spec, cs.make_stream(16, B, seed=2),
         1),
    )
    name = "sketch_update_kernel_fused"
    sides = {"other": getattr(other_kernels(opts.other.resolve()), name),
             "this": getattr(kernel, name)}
    for label, spec, stream, at in blocks:
        v = spec.variant_id
        _, (st, full), _ = cs.run_plain(spec, stream, B, device, cs.fused_path,
                                        sides["this"], at)
        for upto, split in enumerate(SPLITS):
            args = split_args(full, upto)
            want = ref.fused_update_ref(*st, *args, variant=v)
            times = {"other": [], "this": []}
            for who in ("other", "this", "this", "other") * opts.rounds:
                fn = sides[who]
                out = fn(*(t.clone() for t in st), *args, variant=v)  # warm-up
                if not cs._same(want, out):
                    print(json.dumps(dict(block=label, split=split, side=who,
                                          equal_to_plain=False)))
                    return 1
                call = lambda c: fn(*c, *args, variant=v)
                times[who].append(dict(
                    stream_ms=cs.stream_ms(call, st, opts.reps, 1)[0],
                    device_ms=cs.device_ms(call, st, opts.reps)))
            median = {who: {key: statistics.median(t[key] for t in ts)
                            for key in ("stream_ms", "device_ms")}
                      for who, ts in times.items()}
            print(json.dumps(dict(block=label, split=split, median=median,
                                  samples=times, equal_to_plain=True,
                                  **cs.fused_trips(st, args, want, v))),
                  flush=True)
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
