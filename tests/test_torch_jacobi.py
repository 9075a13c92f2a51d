"""Jacobi on the PyTorch/CUDA port against the JAX package.

The same numpy inputs go through both packages; JAX runs on the CPU, its
Pallas backends in interpret mode. The port keeps the association and the
fused multiply-adds with which XLA evaluates each variant, so at halo 0.0
the two references agree to the last bit.

At a non-zero halo XLA folds a halo tap's product into a constant and fuses
the centre product with it instead (the top row of jacobi5_general runs as
``fma(t(0,0), c4, h*c0)``); the port's functors do not special-case halo
taps. Cells within n of the grid edge after n iterations may then differ by
a few ulps (atol 1e-6 at values in [0, 1], where an ulp is at most 6e-8);
every cell farther in is held bit for bit.
"""

import inspect
import json

import jax.numpy as jnp
import numpy as np
import pytest

from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.models import jacobi as jj
from stencilstream_tpu.utils import io as jio

from stencilstream_tpu_torch import Grid, Params, create_update, interop
from stencilstream_tpu_torch.models import jacobi

#: Distinct coefficients, so a tap taken from the wrong neighbour shows.
COEFS = {
    "jacobi1_general": [0.9],
    "jacobi4_general": [0.1, 0.2, 0.3, 0.4],
    "jacobi5_general": [0.15, 0.2, 0.25, 0.1, 0.3],
    "jacobi9_general": [0.05, 0.1, 0.15, 0.2, 0.02, 0.13, 0.07, 0.11, 0.17],
}


def _kernels(variant):
    jkernel = jj.make_kernel(variant, COEFS.get(variant, []))
    return jkernel, interop.jacobi_kernel(variant, jkernel)


def _jax_run(jkernel, x, n, halo, backend, **kw):
    params = JParams(transition_function=jkernel, halo_value=jnp.float32(halo), n_iterations=n)
    return j_create_update(params, backend=backend, **kw)(JGrid.from_numpy(x)).to_numpy()


def _port_run(kernel, x, n, halo, backend, **kw):
    params = Params(transition_function=kernel, halo_value=halo, n_iterations=n)
    update = create_update(params, backend=backend, **kw)
    return update(Grid.from_numpy(x, device="cpu")).to_numpy(), update


@pytest.mark.parametrize("halo", [0.0, 0.5])
@pytest.mark.parametrize("variant", sorted(jj.VARIANTS))
def test_reference_matches_jax_reference(variant, halo):
    """A random 24x40 grid, n=5: bit for bit at halo 0; at halo 0.5 bit for
    bit beyond 5 cells of the edge, atol 1e-6 within (module docstring)."""
    x = np.random.default_rng(0).random((24, 40)).astype(np.float32)
    jkernel, kernel = _kernels(variant)
    want = _jax_run(jkernel, x, 5, halo, "reference")
    got, _ = _port_run(kernel, x, 5, halo, "reference")
    if halo == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[5:-5, 5:-5], want[5:-5, 5:-5])
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "backend,port_kw,jax_kw",
    [
        ("tiling", dict(iters_per_pass=2), dict(strip_rows=8, iters_per_pass=2)),
        ("tiling", dict(iters_per_pass=4, window_mode="linecache", strip_rows=8),
         dict(strip_rows=8, iters_per_pass=2)),
        ("monotile", {}, {}),
    ],
    ids=["tiling", "tiling-linecache", "monotile"],
)
def test_jacobi5_backends_match_jax(backend, port_kw, jax_kw):
    """jacobi5_general, 24x40, n=5 (the tiling passes end partial): the
    port's kernels' plain versions against JAX's Pallas backend in
    interpret mode, with the geometry given explicitly (JAX's ``run``
    would apply its TPU-tuned table). Bit for bit."""
    x = np.random.default_rng(1).random((24, 40)).astype(np.float32)
    jkernel, kernel = _kernels("jacobi5_general")
    want = _jax_run(jkernel, x, 5, 0.0, backend, **jax_kw)
    got, update = _port_run(kernel, x, 5, 0.0, backend, **port_kw)
    np.testing.assert_array_equal(got, want)
    if backend == "tiling":
        assert update.resolved_config["iters_per_pass"] == port_kw["iters_per_pass"]


@pytest.mark.parametrize("shape", [(7, 9), (13, 5), (24, 40)])
def test_init_grid_matches_jax(shape):
    np.testing.assert_array_equal(
        jacobi.init_grid(*shape, device="cpu").to_numpy(), jj.init_grid(*shape).to_numpy()
    )


def test_entry_points_default_to_the_card():
    assert inspect.signature(jacobi.init_grid).parameters["device"].default == "cuda"


@pytest.mark.parametrize("variant", ["jacobi5_general", "jacobi9_general", "jacobi2_constant"])
def test_show_config_matches_jax(variant, capsys):
    assert jacobi.main(["show-config", variant]) == 0
    ours = capsys.readouterr().out
    assert jj.main(["show-config", variant]) == 0
    theirs = capsys.readouterr().out
    assert ours == theirs
    assert json.loads(ours)["variant"] == variant


def test_raw_dump_reads_back_through_jax(tmp_path, capsys):
    """The CLI's raw float32 dump, read by the JAX package's reader, holds
    what the port's reference backend computes."""
    path = str(tmp_path / "out.bin")
    coefs = ["0.15", "0.2", "0.25", "0.1", "0.3"]
    assert jacobi.main(["12", "10", "6", path, *coefs, "--backend", "tiling", "--device", "cpu"]) == 0
    assert "Walltime:" in capsys.readouterr().out
    want, _ = jacobi.run(
        jacobi.init_grid(12, 10, device="cpu"),
        jacobi.make_kernel("jacobi5_general", [float(c) for c in coefs]), 6, backend="reference",
    )
    np.testing.assert_array_equal(jio.read_float_grid_binary(path, 12, 10), want.to_numpy())


def test_make_kernel_checks_the_coefficient_count():
    with pytest.raises(ValueError, match="takes 5"):
        jacobi.make_kernel("jacobi5_general", [0.1])
    k = jacobi.make_kernel("jacobi9_general", [0.1] * 9)
    assert isinstance(k.coef, tuple) and len(k.cuda_params()) == 9
    assert jacobi.make_kernel("jacobi2_constant").cuda_params() == ()
