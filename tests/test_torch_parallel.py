"""The port's meshes and halo exchange (``stencilstream_tpu_torch.parallel``)
against the JAX package's, which runs inside ``jax.shard_map`` on the eight
virtual CPU devices of tests/conftest.py. The port's mesh names the CPU
device at every position. The extended blocks must agree bit for bit,
mesh-edge zeros included: an exchange only moves bytes.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from stencilstream_tpu import parallel as jparallel
from stencilstream_tpu.models import hotspot as jhs

from stencilstream_tpu_torch import parallel
from stencilstream_tpu_torch.models import hotspot as hs


def _np_cell(shape, seed):
    rng = np.random.default_rng(seed)
    return jhs.HotspotCell(
        temp=rng.uniform(70, 90, shape).astype(np.float32),
        power=rng.uniform(0, 1e-3, shape).astype(np.float32),
    )


def _port_blocks(cell, mesh):
    """The port's blocks of a global numpy cell, one per mesh position."""
    ny, nx = mesh.shape
    H, W = cell.temp.shape
    h, w = H // ny, W // nx
    return [[hs.HotspotCell(**{f: torch.tensor(getattr(cell, f)[iy * h : (iy + 1) * h, ix * w : (ix + 1) * w])
                               for f in ("temp", "power")})
             for ix in range(nx)] for iy in range(ny)]


def _jax_extended(cell, shape, fn):
    """``fn(local)`` inside ``shard_map`` over a JAX mesh of ``shape``; the
    global result, block (iy, ix) of it the extended block of that
    position."""
    mesh = jparallel.make_mesh(shape=shape)
    spec = jhs.HotspotCell(temp=P("y", "x"), power=P("y", "x"))
    out = jax.shard_map(fn, mesh=mesh, in_specs=(spec,), out_specs=spec)(jax.tree.map(jax.numpy.asarray, cell))
    return jax.tree.map(np.asarray, out)


def _assert_blocks_equal(ext, jout, shape):
    ny, nx = shape
    for f in ("temp", "power"):
        whole = getattr(jout, f)
        bh, bw = whole.shape[0] // ny, whole.shape[1] // nx
        for iy in range(ny):
            for ix in range(nx):
                got = getattr(ext[iy][ix], f).numpy()
                assert got.shape == (bh, bw)
                np.testing.assert_array_equal(got, whole[iy * bh : (iy + 1) * bh, ix * bw : (ix + 1) * bw],
                                              err_msg=f"{f} at {(iy, ix)}")


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_factor_matches_jax(n):
    assert parallel.mesh_factor(n) == jparallel.mesh_factor(n)


@pytest.mark.parametrize(
    "shape,halo",
    [(shape, halo) for shape in [(2, 2), (4, 1)] for halo in [3, (2, 4), (2, 0)]] + [((2, 2), (12, 20))],
    ids=[f"{s}-{h}" for s in ["2x2", "4x1"] for h in ["halo3", "rows2-cols4", "rows2-cols0"]] + ["2x2-whole-block"],
)
def test_exchange_halo_matches_jax(shape, halo):
    """Two-phase exchange on a 24x40 cell: rows, then columns of the
    row-extended blocks (corners from the diagonal neighbours), zeros at
    the mesh's edges; a frame as deep as a (2, 2) block reaches its
    neighbours' far edges."""
    cell = _np_cell((24, 40), 3)
    mesh = parallel.make_mesh(shape=shape, devices=["cpu"] * 4)
    ext = parallel.exchange_halo(_port_blocks(cell, mesh), halo, mesh)
    jout = _jax_extended(cell, shape, lambda local: jparallel.exchange_halo(local, halo, ("y", "x"), shape))
    _assert_blocks_equal(ext, jout, shape)


@pytest.mark.parametrize("shape", [(4, 1), (2, 1)], ids=["4x1", "2x1"])
def test_exchange_halo_rows_matches_jax(shape):
    cell = _np_cell((24, 12), 4)
    mesh = parallel.make_mesh(shape=shape, devices=["cpu"] * 4)
    blocks = _port_blocks(cell, mesh)
    ext = parallel.exchange_halo_rows([row[0] for row in blocks], 2)
    jout = _jax_extended(cell, shape, lambda local: jparallel.exchange_halo_rows(local, 2, "y", shape[0]))
    _assert_blocks_equal([[b] for b in ext], jout, shape)


def test_make_mesh_takes_repeated_devices():
    mesh = parallel.make_mesh(shape=(2, 2), devices=["cpu"] * 4)
    assert mesh.shape == (2, 2) and mesh.size == 4
    assert mesh.device_set() == [torch.device("cpu")]
    assert parallel.make_mesh(shape=(3,), devices=["cpu"] * 3).shape == (3,)
    assert parallel.make_mesh(n_devices=6, devices=["cpu"] * 8).shape == (2, 3)
    with pytest.raises(ValueError, match="only 2 available"):
        parallel.make_mesh(shape=(2, 2), devices=["cpu"] * 2)


def test_make_mesh_needs_a_cuda_device_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
