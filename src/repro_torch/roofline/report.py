"""Roofline report of the port's dry-run: experiments/dryrun_torch/*.json
-> markdown.

    python -m repro_torch.roofline.report [--dir experiments/dryrun_torch] [--mesh single]

Counterpart of ``repro/roofline/report.py``, on the records
``launch/dryrun.py`` writes (the reference's record fields, counted from
a trace of one rank's step). ``markdown_table`` and ``interesting_cells``
give the reference's text for the same records; ``memory_table`` judges
"fits" against the device memory of the card the port runs on (the
``gpu_h100`` preset, 80 GB), not the TPU's 16 GB. Every figure is a
count from a trace against the preset's rates, not a measurement.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

from repro_torch.roofline.model import HW


def load_records(d: Path, mesh: str = "single") -> List[Dict]:
    recs = []
    for f in sorted(d.glob(f"*__{mesh}.json")):
        r = json.loads(f.read_text())
        if r.get("ok"):
            recs.append(r)
    return recs


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def _fmt_big(x: float) -> str:
    for unit, div in (("P", 1e15), ("T", 1e12), ("G", 1e9), ("M", 1e6)):
        if abs(x) >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}"


def markdown_table(recs: List[Dict]) -> str:
    hdr = (
        "| arch | shape | chips | compute | mem(HLO) | mem(anl) | collective "
        "| dominant | HLO FLOPs | MODEL/HLO | MFU |\n"
        "|---|---|--:|--:|--:|--:|--:|---|--:|--:|--:|\n"
    )
    rows = []
    for r in recs:
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['chips']} "
            f"| {_fmt_s(t['compute_s'])} | {_fmt_s(t['memory_s'])} "
            f"| {_fmt_s(t.get('memory_s_analytic', 0.0))} "
            f"| {_fmt_s(t['collective_s'])} | **{t['dominant']}** "
            f"| {_fmt_big(t['hlo_flops'])} | {t['useful_ratio']:.2f} "
            f"| {t['mfu']*100:.2f}% ({t.get('mfu_analytic', 0)*100:.1f}%) |"
        )
    return hdr + "\n".join(rows) + "\n"


def sketch_kernel_table(json_path) -> str:
    """A kernel benchmark's ``sketch_update`` rows -> roofline markdown:
    achieved stream rate against the preset's memory bound, peak
    fraction and arithmetic intensity per (dist, state, shape) cell,
    beside the fused-vs-split speedup. Raises KeyError where a row lacks
    the roofline columns."""
    data = json.loads(Path(json_path).read_text())
    rows = data["sketch_update"]
    hdr = (
        "| dist | state | k | B | fused ms | fused/split | GB/s | "
        "peak% | flop/B | bit-identical |\n"
        "|---|---|--:|--:|--:|--:|--:|--:|--:|---|\n"
    )
    out = []
    for r in rows:
        out.append(
            f"| {r['dist']} | {r['state']} | {r['k']} | {r['block']} "
            f"| {r['fused_ms']:.2f} | {r['fused_speedup']:.2f}x "
            f"| {r['achieved_bytes_per_s']/1e9:.2f} "
            f"| {r['peak_fraction']*100:.1f}% "
            f"| {r['arith_intensity']:.3f} "
            f"| {'yes' if r['bit_identical'] else '**NO**'} |"
        )
    return hdr + "\n".join(out) + "\n"


def memory_table(recs: List[Dict], hbm_bytes: float = HW.hbm_bytes) -> str:
    """Per-device memory of each record, and whether it fits the card's
    ``hbm_bytes`` (the ``gpu_h100`` preset's 80 GB unless given)."""
    hdr = (
        f"| arch | shape | args | output | temp "
        f"| fits {hbm_bytes/1e9:.0f}G HBM? | compile |\n"
        "|---|---|--:|--:|--:|---|--:|\n"
    )
    rows = []
    for r in recs:
        m = r.get("memory", {})
        arg = m.get("argument_size_in_bytes", 0)
        out = m.get("output_size_in_bytes", 0)
        tmp = m.get("temp_size_in_bytes", 0)
        alias = m.get("alias_size_in_bytes", 0)
        # live = args + outputs + temps - aliased (donated buffers reused)
        live = arg + out + tmp - alias
        fits = "yes" if live < hbm_bytes else f"**NO** ({live/1e9:.1f}G)"
        rows.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_big(arg)}B | {_fmt_big(out)}B "
            f"| {_fmt_big(tmp)}B | {fits} | {r.get('compile_s', 0):.0f}s |"
        )
    return hdr + "\n".join(rows) + "\n"


def interesting_cells(recs: List[Dict]) -> Dict[str, Dict]:
    """worst roofline fraction / most collective-bound / paper-representative."""
    worst = min(recs, key=lambda r: r["roofline"]["mfu"])

    def coll_frac(r):
        t = r["roofline"]
        tot = t["compute_s"] + t["memory_s"] + t["collective_s"]
        return t["collective_s"] / tot if tot else 0.0
    coll = max(recs, key=coll_frac)
    # paper-representative: the SS± KV-eviction long-context decode
    rep = next(
        (r for r in recs if r["shape"] == "long_500k" and r["arch"] == "gemma3_27b"),
        recs[0],
    )
    return {"worst_mfu": worst, "most_collective": coll, "paper_representative": rep}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    recs = load_records(Path(args.dir), args.mesh)
    print(f"## Roofline — {args.mesh}-pod ({len(recs)} cells)\n")
    print(markdown_table(recs))
    print("\n## Memory analysis\n")
    print(memory_table(recs))
    cells = interesting_cells(recs)
    print("\n## Hillclimb candidates\n")
    for k, r in cells.items():
        print(f"- **{k}**: {r['arch']} x {r['shape']} "
              f"(dom={r['roofline']['dominant']}, mfu={r['roofline']['mfu']*100:.2f}%)")


if __name__ == "__main__":
    main()


__all__ = ["load_records", "markdown_table", "sketch_kernel_table",
           "memory_table", "interesting_cells", "main"]
