"""Dyadic SpaceSaving± as a training-telemetry quantile monitor, on the
PyTorch port.

The counterpart of ``examples/quantile_monitor.py`` on ``repro_torch``,
with the same steps, sizes and prints. It tracks the distribution of
per-step gradient norms over a sliding window (bounded deletions) with
ONE :class:`repro_torch.sketch.StreamSession` over a
``SketchSpec(kind='quantile', ...)``: the trainer asks "what is the p95
gradient norm over the last W steps?" to drive adaptive clipping, a
deterministic answer with the paper's rank-error guarantee. The
session's windowed ``observe`` path buffers the updates, flushes
fixed-size zero-weight-padded blocks (one fused bank-engine launch a
block) and feeds the expiries back in as deletions.

``--shards S`` is one spec field: the same session runs on the shard x
level bank (``repro_torch.sketch.dyadic_sharded``), queries read owner
shards only, and ``consolidated()`` folds back to a single-host
DyadicState for checkpoints. ``--device`` (default ``cuda``) is where
the bank lives; without a card, ``cuda`` raises.

    PYTHONPATH=src python examples_torch/quantile_monitor.py [--shards 4]
"""
import argparse
import collections

import numpy as np

from repro_torch.sketch import SketchSpec, StreamSession, dyadic

BITS = 12           # quantize gradient norms into 2^12 buckets
SCALE = 100.0       # norm 0..40.95 -> bucket id
WINDOW = 200
BLOCK = 256         # fixed flush size -> one compiled ingest cell
BUDGET = 2048       # total counters across the 12 layers


def to_bucket(x: float) -> int:
    return int(min((1 << BITS) - 1, max(0, round(x * SCALE))))


class WindowedQuantileMonitor:
    """Sliding-window quantiles = one windowed StreamSession.

    ``shards=S`` swaps the single-host bank for the shard x level bank,
    with the same observe/quantile API and the same guarantees.
    """

    def __init__(self, window: int = WINDOW, shards: int = 0,
                 device: str = "cuda"):
        spec = SketchSpec(kind="quantile", bits=BITS, k=BUDGET,
                          shards=shards or None)
        # donate=False: .state below is public, so ingest must not
        # update buffers a caller may still hold
        self.session = StreamSession(spec, block=BLOCK, window=window,
                                     donate=False, device=device)

    def observe(self, bucket: int) -> None:
        self.session.observe(bucket)  # insert + scheduled expiry deletion

    def quantile(self, q: float) -> float:
        return self.session.quantile(q) / SCALE

    @property
    def state(self):
        self.session.flush()
        return self.session.state


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=0,
                    help="distribute the bank over S hash shards")
    ap.add_argument("--device", default="cuda",
                    help="where the bank lives (cuda or cpu)")
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    mon = WindowedQuantileMonitor(shards=args.shards, device=args.device)

    # synthetic training: grad norms drift down, with a spike burst
    true_window = collections.deque(maxlen=WINDOW)
    for step in range(1, 1001):
        base = 4.0 * np.exp(-step / 400) + 0.5
        g = float(rng.lognormal(np.log(base), 0.3))
        if 600 <= step < 620:
            g *= 8  # divergence burst
        mon.observe(to_bucket(g))
        true_window.append(g)

        if step % 100 == 0 or step == 615:
            p95_est = mon.quantile(0.95)
            p95_true = float(np.quantile(true_window, 0.95))
            clip = max(1.0, p95_est)
            print(f"step {step:4d}  p95(est) {p95_est:6.2f}  "
                  f"p95(true) {p95_true:6.2f}  -> clip@{clip:.2f}")
    assert int(mon.state.mass) == len(true_window)
    print("ok: windowed p95 tracked through drift and burst "
          f"(|F|1 = {int(mon.state.mass)} = window size).")
    if args.shards:
        # checkpoint compaction: fold shards back to one DyadicState
        cons = mon.session.consolidated()
        p95c = dyadic.quantile(cons, 0.95) / SCALE
        print(f"consolidated ({args.shards} shards -> 1 bank): "
              f"p95 {p95c:.2f}")


if __name__ == "__main__":
    main()
