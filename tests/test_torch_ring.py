"""The ring backend of the PyTorch/CUDA port against the JAX package.

The port's ring names the CPU device at every position; the JAX package's
runs inside ``shard_map`` on as many of the eight virtual CPU devices of
tests/conftest.py. Each case is held three ways, as in
tests/test_torch_distributed.py: the port's ``reference`` bit for bit, JAX's
``reference`` and JAX's ``ring`` (``local_compute="xla"``; one case
``"pallas"`` in interpret mode) at the tolerances stated there.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from test_torch_distributed import APPS, assert_matches, jax_run, make_case, multi_device_kind, port_run

from stencilstream_tpu_torch import probe
from stencilstream_tpu_torch.parallel import make_mesh

#: (ring positions, iterations a pass, chunk rows) for n=5 from iteration
#: 2 on 21 rows: one position; two at p=2, where the second lap's first
#: position runs 1 of its 2 steps and the second none (a partial pass, a
#: partial lap), with chunks of 4 rows (21 is no multiple); four at p=1
#: (JAX's dryrun_multichip partial lap), default chunks.
RINGS = [(1, 2, 5), (2, 2, 4), (4, 1, None)]

_JAX = {}


def _ring_mesh(n):
    return make_mesh(shape=(n,), devices=["cpu"] * n)


@pytest.mark.parametrize("local_compute", ["kernel", "plain"])
@pytest.mark.parametrize("n_ring,ipp,chunk_rows", RINGS, ids=[f"ring{r[0]}" for r in RINGS])
@pytest.mark.parametrize("app", APPS)
def test_ring_matches_reference_and_jax(app, n_ring, ipp, chunk_rows, local_compute):
    case = make_case(app)
    if app == "probe_radius2":
        ipp, chunk_rows = 1, None  # its halo at p=1 is 4 rows; default chunks of 4
    out, update = port_run(case, "ring", mesh=_ring_mesh(n_ring), iters_per_pass=ipp, chunk_rows=chunk_rows,
                           local_compute=local_compute)
    assert update.resolved_config["ring"] == n_ring
    got = out.to_numpy()
    want, _ = port_run(case, "reference")
    assert_matches(got, want.to_numpy(), "exact", case.n, "port reference")
    key = (app, n_ring, ipp, chunk_rows)
    if key not in _JAX:
        _JAX[key] = (jax_run(case, "reference"), jax_run(
            case, "ring", mesh=JMesh(np.asarray(jax.devices()[:n_ring]), ("ring",)), iters_per_pass=ipp,
            chunk_rows=chunk_rows, local_compute="xla"))
    jref, jring = _JAX[key]
    assert_matches(got, jref, case.kind, case.n, "JAX reference")
    assert_matches(got, jring, multi_device_kind(app, case.kind), case.n, "JAX ring")
    if app.startswith("probe"):
        probe.check_probe_grid(out, case.offset + case.n)


def test_ring_matches_jax_pallas_in_interpret_mode():
    """HotSpot on a ring of two, p=2, chunks of 8 rows (JAX's Pallas chunk
    windows take whole sublane tiles)."""
    case = make_case("hotspot", shape=(24, 20))
    want = jax_run(case, "ring", mesh=JMesh(np.asarray(jax.devices()[:2]), ("ring",)), iters_per_pass=2,
                   chunk_rows=8, local_compute="pallas")
    out, _ = port_run(case, "ring", mesh=_ring_mesh(2), iters_per_pass=2, chunk_rows=8)
    assert_matches(out.to_numpy(), want, "exact", case.n, "JAX ring pallas")


@pytest.mark.parametrize("n", [1, 4, 8, 9])
def test_ring_laps_from_an_offset(n):
    """Conway on a ring of two at p=2 from iteration 3: whole laps, a lap
    that ends after its first position, and n=1."""
    case = make_case("conway", shape=(19, 23), offset=3, n=n, seed=4)
    out, _ = port_run(case, "ring", mesh=_ring_mesh(2), iters_per_pass=2, chunk_rows=3)
    want, _ = port_run(case, "reference")
    assert_matches(out.to_numpy(), want.to_numpy(), "exact", n, "port reference")


def test_chunks_must_hold_the_halo():
    case = make_case("hotspot")
    with pytest.raises(ValueError, match="chunk_rows=2"):
        port_run(case, "ring", mesh=_ring_mesh(2), iters_per_pass=4, chunk_rows=2)
