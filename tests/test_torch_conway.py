"""Conway's Game of Life on the PyTorch/CUDA port against the JAX package.

Cells are bool on both sides and every update is integer counting, so the
port is held to the JAX package exactly.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import conway as jc
from stencilstream_tpu.utils import io as jio

from stencilstream_tpu_torch import Params, create_update, interop
from stencilstream_tpu_torch.models import conway
from stencilstream_tpu_torch.utils import io as pio


def _soup(shape, seed, density=0.4):
    return np.random.default_rng(seed).random(shape) < density


def test_conway_golden():
    """The frozen number of tests/test_goldens.py::test_conway_golden: the
    seed-1234 32x32 soup has 124 cells alive after 20 generations."""
    rng = np.random.default_rng(1234)
    rng.uniform(70, 90, (64, 64))  # the golden's stream alignment
    rng.uniform(0, 1e-3, (64, 64))
    soup = rng.random((32, 32)) < 0.35
    out, _ = conway.run(interop.conway_grid(soup, device="cpu"), 20, backend="reference")
    assert int(out.to_numpy().sum()) == 124


@pytest.mark.parametrize(
    "backend,port_kw,jax_kw",
    [
        ("reference", {}, {}),
        ("tiling", dict(iters_per_pass=3), dict(strip_rows=8, iters_per_pass=3)),
        ("tiling", dict(iters_per_pass=3, window_mode="linecache", strip_rows=8),
         dict(strip_rows=8, iters_per_pass=3)),
        ("monotile", {}, {}),
        ("auto", {}, {}),
    ],
    ids=["reference", "tiling", "tiling-linecache", "monotile", "auto"],
)
def test_matches_jax(backend, port_kw, jax_kw):
    """A random 20x36 soup, 7 generations from iteration offset 2 (the last
    tiling pass is partial): exact."""
    soup = _soup((20, 36), 5)
    want = j_create_update(
        JParams(
            transition_function=jc.ConwayKernel(), halo_value=jnp.asarray(False),
            iteration_offset=2, n_iterations=7,
        ),
        backend=backend,
        **jax_kw,
    )(JGrid.from_numpy(soup)).to_numpy()
    got = create_update(
        Params(conway.ConwayKernel(), halo_value=False, iteration_offset=2, n_iterations=7),
        backend=backend,
        **port_kw,
    )(interop.conway_grid(soup, device="cpu")).to_numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_char_io_matches_jax():
    g = _soup((5, 7), 2)
    ours, theirs = io.StringIO(), io.StringIO()
    pio.write_char_grid(ours, g)
    jio.write_char_grid(theirs, g)
    assert ours.getvalue() == theirs.getvalue()
    np.testing.assert_array_equal(pio.read_char_grid(io.StringIO(ours.getvalue()), 5, 7), g)
    assert pio.read_char_grid(io.StringIO("X.\n.X\n"), 2, 2).tolist() == [[True, False], [False, True]]


def test_char_input_errors():
    """The errors of tests/test_models_basic.py::test_char_input_errors."""
    with pytest.raises(ValueError, match="truncated"):
        pio.read_char_grid(io.StringIO("X."), 2, 2)
    with pytest.raises(ValueError, match="unexpected character"):
        pio.read_char_grid(io.StringIO("XQ\n.."), 2, 2)


def test_cli_blinker(monkeypatch, capsys):
    """A blinker through the CLI's stdin/stdout protocol, on the CPU."""
    monkeypatch.setattr("sys.stdin", io.StringIO(".....\n.....\n.XXX.\n.....\n.....\n"))
    assert conway.main(["5", "5", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ".....\n..X..\n..X..\n..X..\n.....\n"
