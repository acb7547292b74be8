#!/usr/bin/env python3
"""Kernel 1's time by step inside one launch, from SM cycle stamps.

    python3 tools/fused_phases.py [SOURCE]

Copies SOURCE (default: this checkout's ``csrc/fused_update.cu``) into
``build/fused_phases/``, adds ``clock64()`` stamps by thread 0 of every
CTA at the step boundaries of ``fused_update_kernel`` (after the scalars,
after step 1, step 2, the water-level search, the placement, steps 4
and 5, and the write-back) into a ``__device__`` array, builds it with
the port's nvcc flags and runs it (ctypes, the C entry's own arguments)
on the main run's last block and the lazy run's block 1, the operands
captured as ``tools/fused_ab.py`` captures them. The output is held to
the plain version. Prints, per block, each step's SM cycles (mean and
most over the CTAs) and the same in us at the card's highest SM clock,
then the card's name and power limit; needs one CUDA card. A stamp
moves the compiler's schedule a little, so a step boundary is blurred
by the few hundred cycles around it; the launch as a whole is timed by
``tools/fused_ab.py``.
"""
from __future__ import annotations

import ctypes
import hashlib
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "sketch_update" / "csrc"
STEPS = ("step 1", "step 2", "search", "placement", "step 4", "step 5",
         "write-back")
SLOTS = 16   # stamps per CTA in the array


def stamp(k: int) -> str:
    return (f"  if (threadIdx.x == 0) phase_stamps[blockIdx.x * {SLOTS} + {k}]"
            f" = clock64();\n")


def instrument(text: str) -> str:
    """The source with stamps 0-7 at the step boundaries and a C entry
    that copies the stamps out; raises if a boundary is not found."""
    search = re.search(r"\n(    const int T = water_level\([^\n]*\n)", text)
    marks = [
        ("  int w0, w1;\n  warp_run(K, w0, w1);\n", 0, True),
        ("  if (staged) cp_async_wait();\n  else __syncthreads();\n", 1, True),
        ("  // 3. unit-weight water-fill of inserts [0, mu)\n", 2, False),
        (search.group(1) if search else "<water_level call>", 3, True),
        ("  // 4. non-unit inserts [mu, mu + nnu) evict", 4, False),
        ("  // 5. SS± only: drain rem", 5, False),
        ("  if (staged) {\n    for (int s = tid; s < K; s += kThreads) {", 6,
         False),
        ("      if (drain) ger[s] = er[s];\n    }\n  }\n", 7, True),
    ]
    for mark, k, after in marks:
        if text.count(mark) != 1:
            raise SystemExit(f"fused_phases: no single step boundary {k} "
                             f"({mark.strip()[:50]!r}) in the source")
        text = text.replace(mark, mark + stamp(k) if after else stamp(k) + mark)
    include = '#include "residual_common.cuh"\n'
    text = text.replace(include, include + "__device__ long long phase_stamps"
                        f"[65536 * {SLOTS}];\n", 1)
    return text + ('\nextern "C" int read_phase_stamps(void* host, int n) {\n'
                   "  return static_cast<int>(cudaMemcpyFromSymbol(host, "
                   "phase_stamps, 8 * static_cast<size_t>(n)));\n}\n")


def build(source: pathlib.Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    text = instrument(source.read_text())
    out = ROOT / "build" / "fused_phases"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "fused_update_stamped.cu"
    cu.write_text(text)
    lib = out / f"libfused_stamped-{hashlib.sha256(text.encode()).hexdigest()[:16]}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}",
                           "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if done.returncode:
        raise SystemExit(f"fused_phases: nvcc failed\n{done.stdout}{done.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.sketch_fused_update.argtypes = ([ctypes.c_void_p] * 12
                                        + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    dll.sketch_fused_update.restype = ctypes.c_int
    dll.read_phase_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.read_phase_stamps.restype = ctypes.c_int
    return dll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_phases: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.sketch_update import kernel, ref
    from repro_torch.sketch.api import SketchSpec

    source = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else \
        CSRC / "fused_update.cu"
    dll = build(source)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True).stdout.split()[0])
    device = torch.device("cuda")
    B = 65536
    main_spec = SketchSpec(kind="frequency", eps=1e-5, alpha=2.0,
                           variant="sspm", shards=128, bits=24,
                           backend="kernel")
    lazy_spec = SketchSpec(kind="frequency", eps=1e-3, alpha=2.0,
                           variant="lazy", bits=24, backend="kernel")
    for label, spec, stream, at in (
            ("main, last block", main_spec, cs.make_stream(64, B, seed=1), -1),
            ("lazy, block 1", lazy_spec, cs.make_stream(16, B, seed=2), 1)):
        v = spec.variant_id
        _, (st, args), _ = cs.run_plain(spec, stream, B, device, cs.fused_path,
                                        kernel.sketch_update_kernel_fused, at)
        R, K = st[0].shape
        want = ref.fused_update_ref(*st, *args, variant=v)
        layout = kernel.fused_layout(K)
        n = R * -(-K // 32) if layout == "unstaged" else 0
        scratch = torch.empty(max(n, 1), dtype=torch.int32, device=device)
        for _ in range(3):   # the last launch's stamps are read
            out = [t.clone() for t in st]
            # uoff NULL: the dense prep's (R, B) rows, G = R * B
            err = dll.sketch_fused_update(
                *(t.data_ptr() for t in (*out, *args)), None,
                scratch.data_ptr(), R, K, args[1].numel(), v,
                kernel.FUSED_LAYOUTS.index(layout), n,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f"fused_phases: launch refused ({err})")
            torch.cuda.synchronize()
        if not cs._same(want, out):
            raise SystemExit("fused_phases: the stamped kernel differs from "
                             "the plain version")
        stamps = (ctypes.c_longlong * (R * SLOTS))()
        if dll.read_phase_stamps(stamps, R * SLOTS):
            raise SystemExit("fused_phases: could not read the stamps")
        rows = [stamps[r * SLOTS:r * SLOTS + 8] for r in range(R)]
        print(f"{label} (R = {R}, K = {K}): SM cycles per step, mean / most "
              f"over the CTAs (us at {clock_mhz:.0f} MHz)")
        for k, step in enumerate((*STEPS, "launch")):
            col = ([row[k + 1] - row[k] for row in rows] if k < len(STEPS)
                   else [row[7] - row[0] for row in rows])
            mean = statistics.mean(col)
            print(f"  {step:11s} {mean:11.0f} / {max(col):9d}  "
                  f"({mean / clock_mhz:.3f} / {max(col) / clock_mhz:.3f})")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
