"""HotSpot on the PyTorch/CUDA port against the JAX package.

The same numpy inputs go through both packages (via
``stencilstream_tpu_torch.interop``); JAX runs on the CPU. The port's HotSpot
keeps the JAX package's float32 association, including the four
multiply-adds XLA fuses, so the two agree to the last bit here; the stated
tolerances leave room only for a different platform's rounding.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.models import hotspot as jhs

from stencilstream_tpu_torch import Grid, interop
from stencilstream_tpu_torch.backends.auto import choose_backend
from stencilstream_tpu_torch.models import hotspot as hs
from stencilstream_tpu_torch.utils import io


def _np_cell(shape, seed):
    rng = np.random.default_rng(seed)
    return jhs.HotspotCell(
        temp=rng.uniform(70, 90, shape).astype(np.float32),
        power=rng.uniform(0, 1e-3, shape).astype(np.float32),
    )


def _both(shape, seed):
    """The same inputs as a JAX grid and as a port grid on the CPU."""
    jgrid = JGrid.from_numpy(_np_cell(shape, seed))
    return jgrid, interop.hotspot_grid(jgrid.to_numpy(), device="cpu")


def test_reference_matches_jax_reference():
    """64x64, 100 iterations: port reference vs JAX reference
    (rtol 1e-6, atol 1e-5)."""
    jgrid, grid = _both((64, 64), 1234)
    j_out, _ = jhs.run(jgrid, 100, backend="reference")
    kernel = interop.hotspot_kernel(dataclasses.asdict(jhs.derive_coefficients(64, 64)))
    out, _ = hs.run(grid, 100, backend="reference", kernel=kernel)
    np.testing.assert_allclose(out.to_numpy().temp, j_out.to_numpy().temp, rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(out.to_numpy().power, j_out.to_numpy().power)


@pytest.mark.parametrize("seed", range(8))
def test_reference_matches_jax_bit_for_bit_at_any_coefficients(seed):
    """48x40, 30 iterations, coefficients drawn at random (Cap not a power
    of two, so XLA's fused ``1 - Cap*(2Ry+2Rx+Rz)`` rounds differently from
    the unfused one in about one draw of three): exact."""
    rng = np.random.default_rng(100 + seed)
    coefs = dict(
        Rx_1=rng.uniform(0.01, 0.4), Ry_1=rng.uniform(0.01, 0.4),
        Rz_1=rng.uniform(0.001, 0.1), Cap_1=rng.uniform(0.1, 0.9),
    )
    jkernel = jhs.HotspotKernel(**{k: np.float32(v) for k, v in coefs.items()})
    jgrid, grid = _both((48, 40), seed)
    j_out, _ = jhs.run(jgrid, 30, backend="reference", kernel=jkernel)
    out, _ = hs.run(grid, 30, backend="reference", kernel=interop.hotspot_kernel(jkernel))
    np.testing.assert_array_equal(out.to_numpy().temp, j_out.to_numpy().temp)


def test_hotspot_golden():
    """The frozen numbers of tests/test_goldens.py::test_hotspot_golden
    (rtol 1e-6)."""
    rng = np.random.default_rng(1234)
    g = Grid.from_numpy(
        hs.HotspotCell(
            temp=rng.uniform(70, 90, (64, 64)).astype(np.float32),
            power=rng.uniform(0, 1e-3, (64, 64)).astype(np.float32),
        ),
        device="cpu",
    )
    out, _ = hs.run(g, 100, backend="reference")
    t = out.to_numpy().temp
    np.testing.assert_allclose(t.sum(), 327761.4375, rtol=1e-6)
    np.testing.assert_allclose(t[17, 42], 71.0649185180664, rtol=1e-6)


def test_derive_coefficients_matches_jax():
    for shape in [(64, 64), (1024, 1024), (16, 24)]:
        ours = hs.derive_coefficients(*shape)
        theirs = jhs.derive_coefficients(*shape)
        assert ours.cuda_params() == (theirs.Rx_1, theirs.Ry_1, theirs.Rz_1, theirs.Cap_1)


@pytest.mark.parametrize(
    "shape,n,expect",
    [((64, 64), 30, "monotile"), ((2200, 1024), 10, "tiling")],
    ids=["64x64-monotile", "2200x1024-tiling"],
)
def test_slice_auto_matches_jax_reference(shape, n, expect):
    """The slice: the port's hotspot.run(backend="auto") on the CPU (the
    kernels' plain versions, backend chosen by the H100 capacity law)
    against JAX's hotspot.run(backend="reference") (rtol 1e-6, atol 1e-5).
    At 2200x1024 a 132-SM card cannot hold the grid in shared memory, so
    auto takes the tiling path with p=8: one full pass and one partial."""
    jgrid, grid = _both(shape, 7)
    j_out, _ = jhs.run(jgrid, n, backend="reference")
    out, update = hs.run(grid, n, backend="auto")
    assert update.resolved_backend == expect
    if expect == "tiling":
        assert update.resolved_config["iters_per_pass"] == 8
    np.testing.assert_allclose(out.to_numpy().temp, j_out.to_numpy().temp, rtol=1e-6, atol=1e-5)
    assert update.get_n_processed_cells() == shape[0] * shape[1] * n
    assert update.get_walltime() > 0


def test_auto_resolves_the_main_path_shapes():
    """1024^2 -> monotile, 8192^2 -> tiling, judged by an H100's limits
    (zero-stride views: no 8192^2 memory is touched)."""

    def lazy(h, w):
        z = torch.zeros(1, 1).expand(h, w)
        return Grid(hs.HotspotCell(temp=z, power=z))

    kernel = hs.HotspotKernel()
    assert choose_backend(lazy(1024, 1024), kernel) == "monotile"
    assert choose_backend(lazy(8192, 8192), kernel) == "tiling"
    assert choose_backend(lazy(2048, 2048), kernel) == "tiling"


def test_runtime_parameters_are_live():
    """Mutating the transition function through get_params() applies to
    the next call."""
    _, grid = _both((16, 16), 3)
    out, update = hs.run(grid, 3, backend="tiling")
    update.get_params().transition_function.Cap_1 = np.float32(0.0)
    unchanged = update(grid)
    np.testing.assert_array_equal(unchanged.to_numpy().temp, grid.to_numpy().temp)
    assert not np.array_equal(out.to_numpy().temp, grid.to_numpy().temp)


@pytest.mark.parametrize("binary", [False, True], ids=["text", "binary"])
def test_cli_protocol_and_output(tmp_path, capsys, binary):
    """The CLI reads temp/power files, prints the Walltime/GFlops protocol
    and writes what the reference backend computes."""
    cell = _np_cell((12, 10), 11)
    ext = ".bin" if binary else ".txt"
    paths = [str(tmp_path / f"{n}{ext}") for n in ("temp", "power", "out")]
    for path, arr in zip(paths, (cell.temp, cell.power)):
        if binary:
            io.write_float_grid_binary(path, arr)
        else:
            with open(path, "w") as f:
                f.write("\n".join(f"{v:.9g}" for v in arr.ravel()))
    assert hs.main(["12", "10", "4", *paths, "--device", "cpu"]) == 0
    stdout = capsys.readouterr().out
    assert "Walltime:" in stdout and "GFlops:" in stdout
    want, _ = hs.run(interop.hotspot_grid(cell, device="cpu"), 4, backend="reference")
    want = want.to_numpy().temp
    if binary:
        got = io.read_float_grid_binary(paths[2], 12, 10)
        np.testing.assert_array_equal(got, want)
    else:
        lines = open(paths[2]).read().splitlines()
        assert lines[5].split("\t")[0] == "5"
        got = np.array([float(l.split("\t")[1]) for l in lines], np.float32).reshape(12, 10)
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_io_readers_match_the_jax_package(tmp_path):
    from stencilstream_tpu.utils import io as jio

    arr = np.random.default_rng(2).uniform(0, 100, (6, 7)).astype(np.float32)
    text = tmp_path / "g.txt"
    text.write_text(" ".join(f"{v:.9g}" for v in arr.ravel()) + "\n")
    np.testing.assert_array_equal(
        io.read_float_grid_text(str(text), 6, 7), jio.read_float_grid_text(str(text), 6, 7)
    )
    with pytest.raises(ValueError):
        io.read_float_grid_text(str(text), 7, 7)
    with pytest.raises(ValueError):
        io.read_float_grid_binary(os.devnull, 2, 2)
