"""The plain references against the port's own plain path, at small sizes."""

import pytest
import torch

from benchmark.check import rel_err
from benchmark.spec import Spec


@pytest.mark.parametrize("config,shape,n", [("hotspot", (64, 48), 30), ("hotspot", (2048, 8), 40),
                                            ("jacobi5", (40, 72), 25), ("jacobi5", (33, 17), 60)])
def test_reference_matches_port(config, shape, n):
    spec = Spec()
    cfg, app, ref = spec.config(config), spec.app(config), spec.reference(config)
    traffic = {"height": shape[0], "width": shape[1], "n_iterations": n, "backend": "reference", "options": {}}
    fields = app.make_inputs(*shape, 3, "cpu")
    port = app.from_grid(app.make_update(cfg, traffic)(app.to_grid(fields)))
    want = ref.run(fields, n, cfg)
    # float32 rounds each iteration's result, about one unit in the last place
    # (2**-23 of the largest value) each: room for two
    assert rel_err(port, want) < n * 2 * 2.0**-23
    # the program rounds in float32: it is not the float64 reference bit for bit
    assert rel_err(port, want) > 0


@pytest.mark.parametrize("config", ["hotspot", "jacobi5"])
def test_bfloat16_reference_is_far_off(config):
    spec = Spec()
    cfg, app, ref = spec.config(config), spec.app(config), spec.reference(config)
    fields = app.make_inputs(48, 40, 5, "cpu")
    assert rel_err(ref.run(fields, 10, cfg, torch.bfloat16), ref.run(fields, 10, cfg)) > 1e-3


def test_hotspot_reference_clamps_edges():
    """A uniform grid without power or ambient drift stays put: the clamped
    edge neighbours add nothing (Rodinia's boundary rule)."""
    spec = Spec()
    cfg, ref = spec.config("hotspot"), spec.reference("hotspot")
    amb = cfg["constants"]["amb_temp"]
    fields = {"temp": torch.full((8, 9), amb), "power": torch.zeros(8, 9)}
    out = ref.run(fields, 5, cfg)["temp"]
    assert torch.equal(out, torch.full((8, 9), amb, dtype=torch.float64))


def test_jacobi5_reference_halo():
    """A single unit cell in a corner: the taps that fall outside see the
    halo, the rest spread the coefficients."""
    spec = Spec()
    cfg, ref = spec.config("jacobi5"), spec.reference("jacobi5")
    v = torch.zeros(4, 5)
    v[0, 0] = 1.0
    out = ref.run({"value": v}, 1, cfg)["value"]
    c = cfg["coefficients"]
    assert out[0, 0].item() == pytest.approx(c["center"], rel=1e-7)
    assert out[1, 0].item() == pytest.approx(c["up"], rel=1e-7)  # (1, 0) reads its up neighbour
    assert out[0, 1].item() == pytest.approx(c["left"], rel=1e-7)
    assert out.sum().item() == pytest.approx(c["center"] + c["up"] + c["left"], rel=1e-7)


def test_inputs_follow_the_seed():
    spec = Spec()
    for config in ("hotspot", "jacobi5"):
        app = spec.app(config)
        a, b = app.make_inputs(32, 32, 2**33 + 1, "cpu"), app.make_inputs(32, 32, 2**33 + 1, "cpu")
        c = app.make_inputs(32, 32, 2**33 + 2, "cpu")
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)
    t = spec.app("hotspot").make_inputs(64, 64, 9, "cpu")
    assert 70 <= t["temp"].min() and t["temp"].max() <= 90
    assert 0 <= t["power"].min() and t["power"].max() <= 1e-3
    v = spec.app("jacobi5").make_inputs(8, 8, 9, "cpu")["value"]
    assert (v[2:6, 2:6] >= 0.5).all() and v[:2].eq(0).all() and v[6:].eq(0).all()
