"""Quickstart: the SpaceSaving± public API of the PyTorch port.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``, with
the same steps, sizes and prints: the exact reference sketches (paper
Algs 1-4 on the two-heap structure), the spec-driven surface
(``repro_torch.sketch.api``: one SketchSpec for frequencies AND
quantiles, single-host or hash-sharded), the stateful StreamSession
(buffering + windowed bounded deletions), mergeability, and checkpoint
round trips. The sketches are bit for bit the reference's, so every
number printed is the reference example's. ``--device`` (default
``cuda``) is where the sketches live; without a card, ``cuda`` raises.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import SpaceSavingPM, capacity_for
from repro_torch.core.streams import bounded_stream
from repro_torch.sketch import SketchSpec, StreamSession, api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the sketches live (cuda or cpu)")
    device = ap.parse_args().device

    # --- 1. the paper's reference implementation (two heaps + dict) ------
    eps, alpha = 0.01, 2.0       # accuracy 1%, at most half the stream deleted
    sketch = SpaceSavingPM(capacity_for(eps, alpha))    # 2*alpha/eps counters

    stream = bounded_stream("zipf", n_insert=50_000, delete_ratio=0.5, seed=0)
    sketch.process(stream)

    f = np.zeros(1 << 16, np.int64)
    np.add.at(f, stream[:, 0], stream[:, 1])
    top_true = np.argsort(f)[::-1][:5]
    print("true top-5:", top_true.tolist())
    print("estimated :", [(int(i), sketch.query(int(i))) for i in top_true])
    # Thm 4 guarantee: |f - f_hat| <= eps * (I - D)
    I = int((stream[:, 1] > 0).sum()); D = int((stream[:, 1] < 0).sum())
    bound = eps * (I - D)
    errs = [abs(sketch.query(int(i)) - int(f[i])) for i in top_true]
    print(f"errors {errs} all <= eps*(I-D) = {bound:.0f}:",
          all(e <= bound for e in errs))

    # --- 2. the spec-driven surface: one spec, every backend --------------
    spec = SketchSpec(kind="frequency", eps=eps, alpha=alpha,  # Thm-4 sizing
                      bits=16)                          # universe [0, 2^16)
    state = api.make(spec, device)
    for s in range(0, len(stream) - 8192 + 1, 8192):
        state = api.update(spec, state, stream[s:s + 8192, 0],
                           stream[s:s + 8192, 1])
    ids, counts = api.topk(spec, state, 5)
    print("torch sketch top-5:", list(zip(ids.tolist(), counts.tolist())))

    # the same spec hash-sharded over 4 banks: one field, same surface
    sh_spec = dataclasses.replace(spec, k=512, eps=None, shards=4)
    sh = StreamSession(sh_spec, block=8192,   # buffering + padding built in
                       device=device)
    sh.extend(stream[:, 0], stream[:, 1])
    print("sharded top-3 :", sh.topk(3)[0].tolist())

    # --- 3. mergeability (the distributed-reduce property) ----------------
    half = len(stream) // 2
    m_spec = dataclasses.replace(spec, k=512, eps=None)
    a = api.update(m_spec, api.make(m_spec, device), stream[:half, 0],
                   stream[:half, 1])
    b = api.update(m_spec, api.make(m_spec, device), stream[half:, 0],
                   stream[half:, 1])
    merged = api.merge(m_spec, a, b)
    print("merged top-3:", api.topk(m_spec, merged, 3)[0].tolist())

    # ... and checkpointing: a tagged numpy dict, restored bit-identically
    restored = api.restore(m_spec, api.save(m_spec, merged), device)
    assert torch.equal(restored.ids, merged.ids)

    # --- 4. quantiles in the bounded-deletion model (DSS±) ----------------
    q_spec = SketchSpec(kind="quantile", bits=16, eps=0.05, alpha=alpha)
    qs = StreamSession(q_spec, block=8192, device=device)
    qs.extend(stream[:, 0], stream[:, 1])
    print("median estimate:", qs.quantile(0.5),
          "| p99 estimate:", qs.quantile(0.99))
    print("done.")


if __name__ == "__main__":
    main()
