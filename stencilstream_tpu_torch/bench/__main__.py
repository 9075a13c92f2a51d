"""Benchmark CLI, the counterpart of ``python -m stencilstream_tpu.bench``
and of the reference's per-example ``benchmark.jl`` scripts
(``examples/*/scripts/benchmark.jl``).

Usage, on a CUDA card::

    python -m stencilstream_tpu_torch.bench max_perf hotspot --backend tiling
    python -m stencilstream_tpu_torch.bench grid_scaling jacobi --variant jacobi5_general
    python -m stencilstream_tpu_torch.bench max_perf fdtd
    python -m stencilstream_tpu_torch.bench strong_scaling hotspot --size 2048

Modes mirror the reference CLI (``benchmark.jl:22-40``):

* ``max_perf``: one large-grid run (8192^2 unless ``--size``);
* ``grid_scaling``: throughput across square grids of 512^2 to 8192^2;
* ``strong_scaling``: a fixed problem (2048^2 unless ``--size``) through
  ``distributed`` on meshes of 1, 2, 4, ... of the visible CUDA devices.

Each run writes ``metrics.<variant>.json`` into ``--out-dir`` (made if
missing; ``harness.write_metrics``, with the card's name and power limit)
and prints a summary line and ``Walltime: X s``. The apps and their
inputs are the JAX CLI's: HotSpot with random temperatures and powers
(seed 42), Jacobi's block initialisation, FDTD's one ring filling the grid,
the convection experiment at ``size // 3`` resolution; cell bytes come
from the grid, operations from the transition function's
``n_operations``.

It runs on the card (``--device cuda``, the default), and exits with an
error when there is none; ``--device cpu`` runs the kernels' plain versions
on the host, for the tests. Flags of the JAX CLI it does not take:
``--unroll``, ``--shift-impl`` and ``--vmem-budget`` (the TPU kernels'
unrolling, neighbour-shift lowering and VMEM budget, which the CUDA kernels
do not have), and ``--window-mode extended`` (the port's ``tiling`` takes
``clamped`` or ``linecache``). A kernel that fails raises: there is no
fallback to the ``reference`` backend to forbid.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core.cell import cell_leaves


def _cell_bytes(grid) -> int:
    return sum(t.element_size() for t in cell_leaves(grid.arrays))


def _hotspot_case(size, backend, backend_kwargs, device):
    from ..backends import create_update
    from ..core import Grid, Params
    from ..models.hotspot import HotspotCell, derive_coefficients

    rng = np.random.default_rng(42)
    grid = Grid.from_numpy(
        HotspotCell(
            temp=rng.uniform(70, 90, (size, size)).astype(np.float32),
            power=rng.uniform(0, 1e-3, (size, size)).astype(np.float32),
        ),
        device=device,
    )
    kernel = derive_coefficients(size, size)

    def make(n):
        return create_update(
            Params(
                transition_function=kernel,
                halo_value=HotspotCell(temp=0.0, power=0.0),
                n_iterations=n,
                blocking=True,
            ),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, _cell_bytes(grid), kernel.n_operations


def _jacobi_case(size, backend, backend_kwargs, device, variant="jacobi5_general"):
    from ..backends import create_update
    from ..core import Params
    from ..models import jacobi

    tf_cls = jacobi.VARIANTS[variant]
    kernel = jacobi.make_kernel(variant, [0.2] * tf_cls.n_coefficients)
    grid = jacobi.init_grid(size, size, device=device)

    def make(n):
        return create_update(
            Params(transition_function=kernel, n_iterations=n, blocking=True),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, _cell_bytes(grid), kernel.n_operations


def _fdtd_case(size, backend, backend_kwargs, device):
    from ..models import fdtd

    # The grid is derived from the (cumulative) ring extent: width =
    # ceil(2r/dx + 2) (Parameters.hpp:243-251), so a single ring of
    # r = (size-2)/2*dx gives a size^2 grid; cells beyond the disk are
    # perfect metal, so a material boundary stays in play.
    dx = 10e-9
    radius = (size - 2) / 2 * dx
    params = fdtd.Parameters.from_json(
        {
            "tau": 100e-15,
            "dx": dx,
            "time": {"t_cutoff": 7.0, "t_detect": 4.0, "t_max": 1.0},
            "source": {"frequency": 120e12, "phase": 3.0, "x": 0, "y": 0, "radius": 0.0},
            "cavity_rings": [{"radius": radius, "mu_r": 11.56, "eps_r": 1.0, "sigma": 0.0}],
        }
    )
    resolver = fdtd.CoefResolver(params)
    grid = fdtd.init_grid(params, resolver, device=device)

    def make(n):
        update, _ = fdtd.build_simulation(
            params, resolver=resolver, backend=backend, n_iterations=n, **backend_kwargs
        )
        return update

    return grid, make, _cell_bytes(grid), fdtd.FDTDKernel.n_operations


def _convection_case(size, backend, backend_kwargs, device, folded=False):
    from ..backends import create_update
    from ..core import Params
    from ..models import convection
    from ..trace_cells import convection_experiment

    e = convection_experiment(max(size // 3, 8))
    # Default: the production kernel, the straight one with the lean Err
    # path (what convection.run drives for nerr-1 of every nerr
    # iterations); --folded benchmarks the folded variant.
    folded = folded and backend != "reference"
    lean = backend != "reference"
    if folded:
        grid = convection.init_folded_grid(e, device=device)
        tf = convection.make_folded_pseudo_transient_kernel(e, with_err=not lean)
        halo = convection.folded_zero_cell()
    else:
        grid = convection.init_grid(e, device=device)
        tf = convection.make_pseudo_transient_kernel(e, with_err=not lean)
        halo = convection.zero_cell()

    def make(n):
        return create_update(
            Params(transition_function=tf, halo_value=halo, n_iterations=n, blocking=True),
            backend=backend,
            **backend_kwargs,
        )

    return grid, make, _cell_bytes(grid), tf.n_operations


CASES = {
    "hotspot": _hotspot_case,
    "jacobi": _jacobi_case,
    "fdtd": _fdtd_case,
    "convection": _convection_case,
}


def _measure(make, grid, *, backend, variant, n_iterations, n_samples, cell_bytes, flops, spec):
    """One benchmark of ``make(n_iterations)`` on ``grid``, its model wired
    to the configuration that ran."""
    from .harness import model_inputs, run_benchmark
    from .model import model_report

    update = make(n_iterations)
    result = run_benchmark(
        lambda: update(grid),
        variant=variant,
        grid_shape=grid.shape,
        n_iterations=n_iterations,
        cell_bytes=cell_bytes,
        flops_per_cell=flops,
        n_samples=n_samples,
        spec=spec,
    )
    mk, stats = model_inputs(
        update.get_params().transition_function, grid, backend, n_iterations, result.walltime_s, flops, update,
        spec=spec,
    )
    result.model = model_report(spec, grid.shape[0] * grid.shape[1], n_iterations, cell_bytes, result.walltime_s,
                                flops_per_cell=flops, **mk)
    result.kernel = stats
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="stencilstream-torch-bench")
    parser.add_argument(
        "mode",
        choices=["max_perf", "grid_scaling", "strong_scaling"],
        help="max_perf: one large-grid run; grid_scaling: throughput vs grid size (the reference's "
        "deep-grid-scaling sweep); strong_scaling: a fixed problem over growing device meshes "
        "(distributed backend; the reference's multi-rank sweep, benchmark.jl:22-40)",
    )
    parser.add_argument("app", choices=sorted(CASES))
    parser.add_argument("--backend", default="tiling")
    parser.add_argument("--variant", default=None, help="jacobi kernel variant")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--n-iterations", type=int, default=256)
    parser.add_argument("--samples", type=int, default=3)
    parser.add_argument("--strip-rows", type=int, default=None, help="tiling, window mode linecache: rows a strip")
    parser.add_argument("--iters-per-pass", type=int, default=None)
    parser.add_argument(
        "--window-mode", choices=["clamped", "linecache"], default=None,
        help="tiling window discipline (linecache: column panels streamed strip by strip, rows carried on chip)",
    )
    parser.add_argument(
        "--folded", action="store_true",
        help="convection: benchmark the folded coordinate-plane kernel variant instead of the straight one",
    )
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu: the plain versions, for the tests")
    args = parser.parse_args(argv)

    from ..experiments.common import card_line, resolve_device
    from .harness import write_metrics
    from .model import GpuSpec

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"stencilstream-torch-bench: {e}", file=sys.stderr)
        return 1
    spec = GpuSpec.detect(device)
    card = card_line(device)
    os.makedirs(args.out_dir, exist_ok=True)

    backend_kwargs = {}
    if args.backend in ("tiling", "distributed"):
        if args.iters_per_pass:
            backend_kwargs["iters_per_pass"] = args.iters_per_pass
    if args.backend == "tiling":
        if args.strip_rows:
            backend_kwargs["strip_rows"] = args.strip_rows
        if args.window_mode:
            backend_kwargs["window_mode"] = args.window_mode

    case = CASES[args.app]
    case_kwargs = {}
    if args.app == "jacobi" and args.variant:
        case_kwargs["variant"] = args.variant
    if args.app == "convection" and args.folded:
        case_kwargs["folded"] = True

    if args.mode == "strong_scaling":
        import torch

        from ..parallel import make_mesh

        size = args.size or 2048
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        n = 1
        while n <= n_dev:
            mesh = make_mesh(n) if device.type == "cuda" else make_mesh(n, devices=[device] * n)
            grid, make, cell_bytes, flops = case(
                size, "distributed", dict(mesh=mesh, **backend_kwargs), device, **case_kwargs
            )
            result = _measure(
                make, grid, backend="distributed", variant=f"{args.app}.distributed.{size}.n{n}",
                n_iterations=args.n_iterations, n_samples=args.samples, cell_bytes=cell_bytes, flops=flops,
                spec=spec,
            )
            if args.app == "convection":
                result.extra.update(with_err=False, folded=args.folded)
            path = write_metrics(result, args.out_dir, card)
            print(f"{result.variant}: {result.cells_per_s / 1e9:.3f} GCell/s on {n} device(s) -> {path} [{card}]")
            print(f"Walltime: {result.walltime_s} s")
            n *= 2
        return 0

    sizes = [args.size or 8192] if args.mode == "max_perf" else [512, 1024, 2048, 4096, 8192]
    for size in sizes:
        grid, make, cell_bytes, flops = case(size, args.backend, backend_kwargs, device, **case_kwargs)
        result = _measure(
            make, grid, backend=args.backend,
            variant=f"{args.app}{'.' + args.variant if args.variant else ''}.{args.backend}.{size}",
            n_iterations=args.n_iterations, n_samples=args.samples, cell_bytes=cell_bytes, flops=flops, spec=spec,
        )
        if args.app == "convection":
            result.extra.update(
                with_err=args.backend == "reference", folded=args.folded and args.backend != "reference"
            )
        path = write_metrics(result, args.out_dir, card)
        print(
            f"{result.variant}: {result.cells_per_s / 1e9:.2f} GCell/s ({result.gflops:.0f} GFLOP/s), "
            f"walltime {result.walltime_s:.3f} s -> {path} [{card}]"
        )
        print(f"Walltime: {result.walltime_s} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
