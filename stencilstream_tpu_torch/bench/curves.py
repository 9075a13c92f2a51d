"""Throughput-vs-grid-size curves from recorded metrics files.

Counterpart of ``stencilstream_tpu/bench/curves.py``. The reference's
headline figure is a throughput-over-grid-size plot per app and backend;
this module renders the same series, from the ``metrics.*.json`` files of
the bench's ``grid_scaling`` mode, as a markdown table on the card that
recorded them::

    python -m stencilstream_tpu_torch.bench.curves metrics/ -o throughput_curves.md

Its efficiency table gives each series' share of the analytic model at its
largest size. The port's model is a bound, not calibrated (see
:mod:`.model`), so a share above 1.05, which no card can reach, is flagged
as a wiring fault.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from collections import defaultdict

from .model import SHARE_LIMIT

__all__ = ["collect", "render_markdown", "main"]


def collect(directory: str) -> dict:
    """Group metrics files by ``app[.variant].backend`` series ->
    ``{size: result}``."""
    series: dict[str, dict[int, dict]] = defaultdict(dict)
    for path in sorted(glob.glob(os.path.join(directory, "metrics.*.json"))):
        with open(path) as f:
            r = json.load(f)
        if "recorded_utc" not in r:
            # Files without a stamp: the file's mtime says when they were made.
            r["recorded_utc"] = time.strftime(
                "%Y-%m-%d %H:%M:%SZ (mtime)", time.gmtime(os.path.getmtime(path))
            )
        parts = r["variant"].split(".")
        # variant = app[.kernelvariant].backend.size
        series[".".join(parts[:-1])][int(parts[-1])] = r
    return dict(series)


def render_markdown(series: dict, device: str = "", note: str = "") -> str:
    sizes = sorted({s for curve in series.values() for s in curve})
    lines = [
        "# Throughput vs grid size",
        "",
        f"GCell/s per app x backend across square grid sizes{' on ' + device if device else ''}.",
        "The port's restatement of the reference's headline figure (throughput over",
        "grid size). Generated by `python -m stencilstream_tpu_torch.bench.curves`",
        "from `metrics.*.json` files (grid_scaling mode).",
        "",
    ]
    stamps = sorted(
        {r["recorded_utc"][:10] for curve in series.values() for r in curve.values() if r.get("recorded_utc")}
    )
    if stamps:
        span = stamps[0] if len(stamps) == 1 else f"{stamps[0]} – {stamps[-1]}"
        lines.append(
            f"Recorded: {span}. Each file names the card it ran on (`card`); compare numbers "
            f"only within one recording run on one card."
        )
    lines += [
        "",
        "| series | " + " | ".join(f"{s}^2" for s in sizes) + " |",
        "|---" * (len(sizes) + 1) + "|",
    ]
    for key in sorted(series):
        row = [key]
        for s in sizes:
            r = series[key].get(s)
            row.append(f"{r['cells_per_s'] / 1e9:.1f}" if r else "—")
        lines.append("| " + " | ".join(row) + " |")
    lines.append("")
    if note:
        lines.append(note)
        lines.append("")
    # Efficiency at the largest size of each series, against the model
    # wired to the configuration that ran (its real iters_per_pass, the
    # bytes and cells of its geometry): a share of that bound, not of the
    # single-pass roofline, which temporally blocked runs exceed.
    lines.append("Largest-size efficiency (from the model report; share = measured over the bound):")
    lines.append("")
    lines.append("| series | size | GCell/s | GFLOP/s | FLOP util | share of bound |")
    lines.append("|---|---|---|---|---|---|")
    for key in sorted(series):
        if not series[key]:
            continue
        s = max(series[key])
        r = series[key][s]
        m = r.get("model", {})
        acc = m.get("model_accuracy")
        acc_s = f"{acc:.2f}" if acc is not None else "—"
        if acc is not None and acc > SHARE_LIMIT:
            acc_s += " (!)"
        lines.append(
            f"| {key} | {s}^2 | {r['cells_per_s'] / 1e9:.1f} | "
            f"{r.get('gflops', 0):.0f} | {m.get('flop_utilization', 0):.2f} | {acc_s} |"
        )
    lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stencilstream-torch-curves")
    ap.add_argument("directory", help="directory holding metrics.*.json files")
    ap.add_argument("-o", "--output", default=None, help="output markdown path")
    ap.add_argument("--note", default="", help="footnote rendered under the size table")
    args = ap.parse_args(argv)

    series = collect(args.directory)
    if not series:
        print(f"no metrics.*.json files in {args.directory}", file=sys.stderr)
        return 1
    first = next(iter(next(iter(series.values())).values()))
    device = first.get("card") or first.get("model", {}).get("hardware", "")
    md = render_markdown(series, device, note=args.note)
    if args.output:
        with open(args.output, "w") as f:
            f.write(md)
        print(f"wrote {args.output}")
    else:
        print(md)
    return 0


if __name__ == "__main__":
    sys.exit(main())
