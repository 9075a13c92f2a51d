"""Durable checkpoints of the PyTorch/CUDA port against the JAX package's.

The two packages share one file layout (``utils/checkpoint.py`` in each): a
file written by either loads in the other, field for field and bit for bit,
for a two-field HotSpot cell, a one-array grid, Conway's bool cells,
convection's 11 fields and, by their bits, bfloat16 fields. A run paused
into a file and resumed from it through ``iteration_offset`` equals one
uninterrupted run bit for bit (Jacobi5 at halo 0, where the two packages'
``reference`` backends agree bit for bit).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stencilstream_tpu.core import Grid as JGrid
from stencilstream_tpu.core import Params as JParams
from stencilstream_tpu.backends import create_update as j_create_update
from stencilstream_tpu.models import convection as jc
from stencilstream_tpu.models import jacobi as jj
from stencilstream_tpu.models.hotspot import HotspotCell as JHotspotCell
from stencilstream_tpu.utils import checkpoint as jck

from test_convection import tiny_experiment

from stencilstream_tpu_torch import Grid, Params, create_update
from stencilstream_tpu_torch.core.cell import cell_field_names, cell_leaves
from stencilstream_tpu_torch.models import convection as pc
from stencilstream_tpu_torch.models import jacobi as pj
from stencilstream_tpu_torch.models.hotspot import HotspotCell
from stencilstream_tpu_torch.utils import checkpoint as pck

JACOBI5 = [0.15, 0.2, 0.25, 0.1, 0.3]


def _grids(kind: str):
    """(JAX grid, port grid) of the same numpy values."""
    rng = np.random.default_rng(len(kind))
    if kind == "hotspot":
        temp, power = (rng.normal(size=(9, 7)).astype(np.float32) for _ in range(2))
        return (JGrid.from_numpy(JHotspotCell(temp=temp, power=power)),
                Grid.from_numpy(HotspotCell(temp=temp, power=power), device="cpu"))
    if kind == "one-array":
        x = rng.normal(size=(6, 11)).astype(np.float32)
        return JGrid.from_numpy(x), Grid.from_numpy(x, device="cpu")
    if kind == "conway":
        x = rng.random((10, 13)) < 0.4
        return JGrid.from_numpy(x), Grid.from_numpy(x, device="cpu")
    e = tiny_experiment(res=8)
    fields = {f: rng.normal(size=(e.nx + 1, e.ny + 1)).astype(np.float32) for f in pc.FIELDS}
    return (JGrid.from_numpy(jc.ThermalConvectionCell(**fields)),
            Grid.from_numpy(pc.ThermalConvectionCell(**fields), device="cpu"))


def _numpy_leaves(grid) -> list:
    arrays = grid.to_numpy()
    if dataclasses.is_dataclass(arrays):
        return [np.asarray(getattr(arrays, f.name)) for f in dataclasses.fields(arrays)]
    return [np.asarray(arrays)]


KINDS = ["hotspot", "one-array", "conway", "convection"]


@pytest.mark.parametrize("kind", KINDS)
def test_jax_writes_and_the_port_loads(kind, tmp_path):
    jgrid, pgrid = _grids(kind)
    path = str(tmp_path / "ck.npz")
    jck.save_checkpoint(path, jgrid, iteration=17)
    with np.load(path) as data:
        keys = [k for k in data.files if k.startswith("leaf")]
    names = cell_field_names(pgrid.arrays)
    assert keys == ([f"leaf{i}:.{n}" for i, n in enumerate(names)] if names else ["leaf0:_"])
    got, it = pck.load_checkpoint(path, like=pgrid.make_similar())
    assert it == 17
    for a, b in zip(_numpy_leaves(got), _numpy_leaves(jgrid)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_the_port_writes_and_jax_loads(kind, tmp_path):
    jgrid, pgrid = _grids(kind)
    path = str(tmp_path / "ck.npz")
    pck.save_checkpoint(path, pgrid, iteration=5)
    got, it = jck.load_checkpoint(path, like=jgrid)
    assert it == 5
    for a, b in zip(_numpy_leaves(got), _numpy_leaves(pgrid)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bfloat16_written_by_jax_loads_bit_for_bit(tmp_path):
    """JAX's ``np.savez`` writes a bfloat16 field as a two-byte void array;
    the port reads it as the prototype's bfloat16, bit for bit, and writes
    it back the same way."""
    rng = np.random.default_rng(3)
    temp, power = (rng.normal(size=(5, 8)).astype(jnp.bfloat16) for _ in range(2))
    path = str(tmp_path / "bf16.npz")
    jck.save_checkpoint(path, JGrid.from_numpy(JHotspotCell(temp=temp, power=power)), iteration=2)
    with np.load(path) as data:
        assert data["leaf0:.temp"].dtype == np.dtype("V2")
    like = Grid.from_numpy(HotspotCell(temp=temp, power=power), device="cpu").make_similar()
    got, it = pck.load_checkpoint(path, like=like)
    assert it == 2 and got.arrays.temp.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.to_numpy().temp, temp.view(np.uint16))
    np.testing.assert_array_equal(got.to_numpy().power, power.view(np.uint16))
    again = str(tmp_path / "again.npz")
    pck.save_checkpoint(again, got, iteration=2)
    with np.load(path) as a, np.load(again) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_float8_fields_round_trip_by_their_bits(tmp_path):
    x = torch.tensor(np.random.default_rng(4).uniform(-4, 4, (6, 6)), dtype=torch.float32).to(torch.float8_e4m3fn)
    path = str(tmp_path / "e4m3.npz")
    pck.save_checkpoint(path, Grid(x), iteration=1)
    with np.load(path) as data:
        assert data["leaf0:_"].dtype == np.dtype("V1")
    got, _ = pck.load_checkpoint(path, like=Grid(torch.zeros(1, 1, dtype=torch.float8_e4m3fn)))
    assert got.arrays.dtype == torch.float8_e4m3fn
    assert torch.equal(got.arrays.view(torch.uint8), x.view(torch.uint8))


def test_field_count_mismatch_raises(tmp_path):
    _, pgrid = _grids("hotspot")
    path = str(tmp_path / "ck.npz")
    pck.save_checkpoint(path, pgrid)
    with pytest.raises(ValueError, match="checkpoint has 2 fields, expected 1"):
        pck.load_checkpoint(path, like=Grid(torch.zeros(2, 2)))


def test_resume_equals_one_run(tmp_path):
    """Save at 3, reload, continue 3 from ``iteration_offset`` 3 == one run
    of 6 (after ``tests/test_checkpoint.py``), bit for bit."""
    kernel = pj.make_kernel("jacobi5_general", JACOBI5)
    grid = pj.init_grid(12, 12, device="cpu")
    full = create_update(Params(transition_function=kernel, n_iterations=6))(grid).to_numpy()
    mid = create_update(Params(transition_function=kernel, n_iterations=3))(grid)
    path = str(tmp_path / "ck.npz")
    pck.save_checkpoint(path, mid, iteration=3)
    restored, it = pck.load_checkpoint(path, like=grid)
    assert it == 3
    up = create_update(Params(transition_function=kernel, iteration_offset=it, n_iterations=3))
    np.testing.assert_array_equal(up(restored).to_numpy(), full)


def test_a_jax_run_resumes_in_the_port(tmp_path):
    """JAX runs 3 iterations and checkpoints; the port loads the file and
    runs 3 more: the one-shot run of 6 of either package, bit for bit."""
    path = str(tmp_path / "ck.npz")
    jgrid = jj.init_grid(13, 19)
    jkernel = jj.make_kernel("jacobi5_general", JACOBI5)
    mid = j_create_update(JParams(transition_function=jkernel, n_iterations=3), backend="reference")(jgrid)
    jck.save_checkpoint(path, mid, iteration=3)
    jfull = j_create_update(JParams(transition_function=jkernel, n_iterations=6), backend="reference")(jgrid)
    like = pj.init_grid(13, 19, device="cpu")
    restored, it = pck.load_checkpoint(path, like=like)
    up = create_update(Params(transition_function=pj.make_kernel("jacobi5_general", JACOBI5), iteration_offset=it,
                              n_iterations=3), backend="reference")
    np.testing.assert_array_equal(up(restored).to_numpy(), np.asarray(jfull.to_numpy()))
    assert len(cell_leaves(restored.arrays)) == 1
