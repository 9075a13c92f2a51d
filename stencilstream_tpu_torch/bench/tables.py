"""Render a performance table from a recorded details file.

Counterpart of ``stencilstream_tpu/bench/tables.py``: the recorded file is
the single source of the table's numbers, so no hand-kept table drifts from
it::

    python -m stencilstream_tpu_torch.bench.tables details.json

prints the markdown rows. ``details.json`` holds ``results``, one entry a
case (``case``, ``app``, ``grid``, ``gcells_per_s``, ``gflops``, optionally
``vs_baseline``, ``model``, and convection's ``with_err`` / ``folded``),
``<name>_error`` entries for cases that failed, and ``card``, the card's
name and power limit. The baselines are the reference FPGA's published
peaks.

The port's model is a bound, not calibrated (:mod:`.model`): a row whose
``model_accuracy``, its share of the bound, is above 1.05 (a share no card
can give) is flagged as a wiring fault.
"""

from __future__ import annotations

import argparse
import json
import sys

from .model import SHARE_LIMIT

__all__ = ["render_rows", "main"]


_LABELS = {
    "hotspot_monotile": "HotSpot, shared-memory-resident ({g}², monotile)",
    "hotspot_tiling": "HotSpot, HBM-resident (tiles; {g}², tiling{cfg})",
    "jacobi_monotile": "Jacobi5, shared-memory-resident ({g}², monotile)",
    "jacobi_tiling": "Jacobi5, HBM-resident (tiles; {g}², tiling{cfg})",
    "jacobi_tiling_bf16": "Jacobi5, HBM-resident (tiles), bf16 storage ({g}², tiling{cfg})",
    "hotspot_tiling_bf16": "HotSpot, HBM-resident (tiles), bf16 storage ({g}², tiling{cfg})",
    "fdtd_monotile": "FDTD ({g}², k=2, 8-field cells, monotile)",
    "fdtd_tiling": "FDTD ({g}², k=2, 8-field cells, tiling)",
    "fdtd_tiling_bf16": "FDTD, bf16 storage ({g}², k=2, 8-field cells, tiling)",
    "convection_tiling": "Convection ({gx}×{gy}, k=3, 11-field cells, tiling{cfg})",
}
#: The reference FPGA's published peaks (BASELINE.md).
_BASELINES = {"hotspot": "122.7 GCell/s (1.84 TFLOP/s)",
              "jacobi5_general": "176.08 GCell/s (1.58 TFLOP/s)"}


def render_rows(details: dict) -> str:
    card = details.get("card", "one NVIDIA card")
    lines = [
        f"| Case | This framework ({card}) | Reference FPGA peak | Ratio |",
        "|---|---|---|---|",
    ]
    for r in details.get("results", []):
        case = r.get("case", "")
        g = r["grid"]
        cfg = ""
        if r.get("folded"):
            cfg += ", folded"
        if r.get("with_err") is False:
            cfg += ", lean Err"
        label = _LABELS.get(case, case).format(g=g[0], gx=g[0], gy=g[1], cfg=cfg)
        tput = f"**{r['gcells_per_s']:.1f} GCell/s ({r['gflops'] / 1000:.2f} TFLOP/s)**"
        base = _BASELINES.get(r["app"], "n/a (figure only)")
        ratio = f"**{r['vs_baseline']:.2f}×**" if "vs_baseline" in r else "—"
        lines.append(f"| {label} | {tput} | {base} | {ratio} |")
        acc = r.get("model", {}).get("model_accuracy")
        if acc is not None and acc > SHARE_LIMIT:
            lines.append(f"|   ↳ model_accuracy {acc:.2f} ABOVE THE BOUND — re-check the wiring | | | |")
    for k, v in details.items():
        if k.endswith("_error"):
            lines.append(f"| {k} | FAILED: {v} | | |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stencilstream-torch-tables")
    ap.add_argument("details", help="path to the recorded details JSON")
    args = ap.parse_args(argv)
    with open(args.details) as f:
        details = json.load(f)
    print(render_rows(details))
    return 0


if __name__ == "__main__":
    sys.exit(main())
