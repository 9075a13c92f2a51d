"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's updater through the port's entry point
(``create_update``), makes the inputs on the card from the seed and warms
up with two calls. The window is a closed loop with one caller: ``grid =
update(grid)`` until ``--seconds`` have passed, so it is one simulation
continued call by call (or started again from the seed's grid every
``calls_per_run`` calls, where the traffic says so). Each call is timed by
the host clock and by CUDA events recorded on the stream around it. With
``--trace 1`` the first seconds of the window's calls, from the third on,
run under ``torch.profiler``. A traced segment in which the profiler saw
fewer launches than the port's counters counted is thrown away and another
one is traced; a run with no complete segment exits with 1 and prints no
result.

Once the window has closed, the peak memory is read, the program's state
freed, and the kept grids compared with the plain reference
(:mod:`benchmark.check`). The last line of standard output is the result
as one JSON object; the numbers compared and their limits are the last
lines of standard error. Without a CUDA card, or with JAX or the JAX
package loaded, the run exits with 1 and prints no result.

A run sees its cell's ``chips`` cards and no others (:mod:`benchmark.pin`).
A cell whose traffic gives a ``mesh`` of more than one block keeps its grid
in blocks over them (:mod:`benchmark.layout`): the kept grids and the
inputs are made block by block on each block's card, a call's time is the
longest of its cards' event pairs, ``peak_mem_gib`` the largest over the
cards of the card's peak less its kept grids, and the check runs block by
block.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
import warnings  # noqa: E402
from collections import defaultdict  # noqa: E402

if __name__ == "__main__":  # before torch is imported: the run sees its cell's cards alone
    from .pin import pin

    pin(sys.argv[1:])

import torch  # noqa: E402

from . import trace as tracing  # noqa: E402
from .check import require_blocks, run_checks  # noqa: E402
from .layout import Layout, mesh_of  # noqa: E402
from .roofline import bound_s, peak_for  # noqa: E402
from .spec import Spec  # noqa: E402

__all__ = ["run_cell", "forbidden_modules", "main"]

#: Top-level module names that may not be loaded once the window has closed.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "stencilstream_tpu"})
WARMUP_CALLS = 2
#: Calls the chained check follows from the seed's inputs.
CHAIN_CALLS = 2
#: Seconds of the window a traced segment profiles, from its third call on.
TRACE_SECONDS = 3.0
#: Segments a traced run tries before it gives up on a complete one.
TRACE_SEGMENTS = 3


def log(*parts) -> None:
    print("ssbench:", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi read nothing"


def _json_number(value: float):
    return value if math.isfinite(value) else repr(value)


def run_cell(spec: Spec, cell_name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", wrap=None) -> dict:
    """One run; returns the result object. ``wrap(update, app)``, when
    given, puts another updater in the program's place (the control and
    the faults; in a cell of several blocks ``app`` converts between the
    grid and its blocks); ``device="cpu"`` runs the port's plain versions
    (tests). A cell of several blocks puts block ``k`` on card ``k`` of
    ``"cuda"``, and every block on a device that names one (``"cpu"``,
    ``"cuda:0"``)."""
    t_begin = time.perf_counter()
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cell = spec.cell(cell_name)
    config, traffic, limits = spec.config(cell["config"]), spec.traffic(cell["traffic"]), spec.limits(cell_name)
    app, reference = spec.app(cell["config"]), spec.reference(cell["config"])
    H, W, n = traffic["height"], traffic["width"], traffic["n_iterations"]
    calls_per_run = traffic.get("calls_per_run", 0)
    if calls_per_run and calls_per_run < CHAIN_CALLS:
        raise ValueError(f"calls_per_run must be 0 or at least {CHAIN_CALLS}")
    ny, nx = mesh_of(traffic, cell["chips"])
    if ny * nx == 1:
        devices = [dev]
    elif on_card and dev.index is None:
        devices = [torch.device("cuda", k) for k in range(ny * nx)]
    else:
        devices = [dev] * (ny * nx)
    layout = Layout(H, W, (ny, nx), devices)
    cards = layout.devices()
    if layout.whole:
        (only,) = layout.blocks

        def inputs(key):
            return app.make_inputs(H, W, seed, dev)

        def to_grid(blocks):
            return app.to_grid(blocks[only])

        def from_grid(grid):
            return {only: app.from_grid(grid)}
    else:
        require_blocks(reference, config)

        def inputs(key):
            rows, cols, device = layout.blocks[key]
            return app.make_block_inputs(H, W, seed, rows, cols, device)

        def to_grid(blocks):
            return app.to_grid(blocks)

        def from_grid(grid):
            return app.from_grid(grid, layout)

    # The kept grids come first, so that the peak is theirs plus the rest.
    dtype = getattr(torch, config["dtype"])

    def grid_buffers():
        return {key: {f: torch.empty(len(rows), len(cols), dtype=dtype, device=device) for f in config["fields"]}
                for key, (rows, cols, device) in layout.blocks.items()}

    kept = {"chain": grid_buffers(), "sample_in": grid_buffers(), "sample_out": grid_buffers()}
    kept_bytes = defaultdict(int)
    for bufs in kept.values():
        for key, fields in bufs.items():
            kept_bytes[layout.blocks[key][2]] += sum(t.numel() * t.element_size() for t in fields.values())
    kept["chain_calls"] = CHAIN_CALLS

    card = card_line() if on_card else "cpu: the port's plain versions, host clock"
    if on_card:
        from stencilstream_tpu_torch.backends import cuda_lib

        builds = not cuda_lib.library_path().exists()
    else:
        builds = False

    t_inputs = time.perf_counter()
    grid = to_grid({key: inputs(key) for key in layout.blocks})
    update = app.make_update(config, traffic)
    if wrap is not None:
        update = wrap(update, app if layout.whole else types.SimpleNamespace(to_grid=to_grid, from_grid=from_grid))
    t_warm = time.perf_counter()
    for _ in range(WARMUP_CALLS):
        update(grid)
    t_warmed = time.perf_counter()
    if builds:
        log(f"set-up built the port's CUDA library: warm-up took {t_warmed - t_warm:.1f} s")
    log(f"set-up: imports {t_begin - T_START:.3f} s, kept grids and card {t_inputs - t_begin:.3f} s, "
        f"inputs and updater {t_warm - t_inputs:.3f} s, warm-up {t_warmed - t_warm:.3f} s")
    initial = grid if calls_per_run else None

    def keep(name, g):
        for key, fields in from_grid(g).items():
            for field, t in fields.items():
                kept[name][key][field].copy_(t)
        if on_card:
            for d in cards:
                torch.cuda.synchronize(d)

    rng = random.Random(seed)
    events = []
    starts, ends = [], []
    prof = trace = segment_start = None
    streams = [torch.cuda.current_stream(d) for d in cards] if on_card else []
    segments = 0

    def start_profiler():
        profiler = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if on_card else []))
        profiler.start()
        return profiler

    if traced:  # started before the window: the profiler's own start-up is set-up
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        prof = start_profiler()
    i = 0
    t_window = time.perf_counter()
    while True:
        if calls_per_run and i and i % calls_per_run == 0:
            grid = initial
        take = rng.random() * (i + 1) < 1.0  # a reservoir of one call
        if take:
            keep("sample_in", grid)
        tracing_call = prof is not None and i >= CHAIN_CALLS
        if tracing_call and segment_start is None:
            counters_before = tracing.launch_counters()
            segment_start = time.perf_counter()
        if on_card:
            pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in streams]
            for (e0, _), stream in zip(pairs, streams):
                e0.record(stream)
        s = time.perf_counter()
        if tracing_call:
            with torch.profiler.record_function(tracing.CALL_SPAN):
                out = update(grid)
        else:
            out = update(grid)
        e = time.perf_counter()
        if on_card:
            for (_, e1), stream in zip(pairs, streams):
                e1.record(stream)
            events.append(pairs)
        starts.append(s)
        ends.append(e)
        if take:
            keep("sample_out", out)
        if i == CHAIN_CALLS - 1:
            keep("chain", out)
        grid = out
        i += 1
        done = e - t_window >= seconds and i >= CHAIN_CALLS
        if tracing_call and (done or e - segment_start >= TRACE_SECONDS):
            prof.stop()
            segment = tracing.reduce(prof, counters_before, tracing.launch_counters(), [d.index for d in cards])
            prof = segment_start = None
            segments += 1
            if segment["complete"]:
                trace = segment
            else:
                log("the profiler missed launches in traced segment", segments, "(counted / seen):",
                    json.dumps({k: [v, segment["launches_seen"][k]] for k, v in segment["launches"].items() if v}))
                if segments < TRACE_SEGMENTS and not done:
                    prof = start_profiler()
        if done:
            break
    if prof is not None:  # the window closed before a call was traced
        prof.stop()
    if on_card:
        for d in cards:
            torch.cuda.synchronize(d)
        call_ms = [max(a.elapsed_time(b) for a, b in pairs) for pairs in events]
        peaks = [torch.cuda.max_memory_allocated(d) for d in cards]
    else:
        call_ms = [(e - s) * 1e3 for s, e in zip(starts, ends)]
        peaks = []
    setup_s = t_window - T_START
    if len(peaks) > 1:
        log("peak / kept bytes by card:", json.dumps({str(d): [p, kept_bytes[d]] for d, p in zip(cards, peaks)}))
    if traced and trace is None:
        raise RuntimeError(f"no complete trace: {segments} traced segment(s), the profiler missed launches "
                           "in each, or the window closed before a call was traced")
    del grid, out, initial, update, events, streams, prof
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peak_entry = peak_for(spec.peaks(), kind)
    bound = bound_s(config, traffic, peak_entry, cell["chips"]) if peak_entry else (None, None)
    record = {
        "config": config, "traffic": traffic, "chips": cell["chips"], "cells_per_call": H * W * n,
        "calls": len(starts), "window_s": ends[-1] - starts[0], "call_ms": call_ms,
        "setup_s": setup_s, "peak_bytes": peaks, "kept_bytes": [kept_bytes[d] for d in cards] if peaks else [],
        "bound_s": bound[0], "bound_by": bound[1], "trace": trace,
    }
    metrics = {}
    for m in spec.metrics(traced):
        value = spec.reader(m["name"])(record)
        if value is None:
            log(f"metric {m['name']} has nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace is not None:
        log("launches counted / seen by the profiler:",
            json.dumps({k: [v, trace["launches_seen"][k]] for k, v in trace["launches"].items() if v}))

    t_check = time.perf_counter()
    numbers = run_checks(reference, config, traffic, kept, layout, inputs)
    del kept
    log(f"the reference check took {time.perf_counter() - t_check:.2f} s")
    checks = {k: {"value": _json_number(v), "limit": limits[k]} for k, v in numbers.items()}
    failed = [k for k, v in numbers.items() if not v <= limits[k]]
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": max(peaks, default=0)}
    result = {"correct": not failed, "attempted": len(starts), "failed": len(failed),
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace["busy_us"] / 1e6
        device_info["window_s"] = trace["window_us"] / 1e6
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    result["card"] = card
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 1
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
        return 1
    log(f"correct {str(result['correct']).lower()}, {result['attempted']} calls")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
