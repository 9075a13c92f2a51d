"""The port's strip microbenchmark pass (``experiments/strip.py``, the plain
version of ``csrc/micro_strip.cu``) against JAX's TPU kernels of
``experiments/micro_shifts.py``, ``micro_operands.py`` and ``micro_order.py``
run in TPU interpret mode on the CPU, and the three entry points.

Inputs: ``np.random.default_rng(seed).random(..., float32)``, in [0, 1).
The scripts are loaded from ``experiments/`` by their paths; ``micro_order.py``
runs an 8192^2 sweep when imported, so only its imports, constants and
functions are executed (by its syntax tree).

Tolerance. The port rounds each sub-step as XLA on the CPU contracts one
sub-step of the interpreted kernel (products of select results unfused, the
others fused: ``strip.py``). Over several unrolled sub-steps XLA contracts
some cells otherwise, and not alike from cell to cell, so no one order of
operations matches it everywhere: :data:`EXACT` variants agree bit for bit,
the others within 1e-6 absolute per pass (a few float32 ulps at these
values; a wrong tap, coefficient or window moves cells by 1e-2 and more).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from experiment_scripts import load_definitions, load_script
from stencilstream_tpu_torch.experiments import micro_operands, micro_order, micro_shifts, strip

#: Variants whose every cell XLA rounds as the port does.
EXACT = {"wrap", "hoisted", "shiftonly", "smem10"}
ATOL_PER_PASS = 1e-6
SIZE = 256


SHIFTS = load_script("micro_shifts")
OPERANDS = load_script("micro_operands")
ORDER = load_definitions("micro_order")
#: micro_operands' cases (``micro_operands.py:136-144``).
OPERAND_CASES = {
    "baseline": dict(n_smem=0, use_coef_refs=False, use_hv_ref=False, use_elem_out=False, use_outwhere=True),
    "smem10": dict(n_smem=10, use_coef_refs=False, use_hv_ref=False, use_elem_out=False, use_outwhere=True),
    "coef": dict(n_smem=0, use_coef_refs=True, use_hv_ref=False, use_elem_out=False, use_outwhere=True),
    "hv": dict(n_smem=0, use_coef_refs=False, use_hv_ref=True, use_elem_out=False, use_outwhere=True),
    "elemout": dict(n_smem=0, use_coef_refs=False, use_hv_ref=False, use_elem_out=True, use_outwhere=True),
    "nowhere": dict(n_smem=0, use_coef_refs=False, use_hv_ref=False, use_elem_out=False, use_outwhere=False),
    "all": dict(n_smem=10, use_coef_refs=True, use_hv_ref=True, use_elem_out=True, use_outwhere=True),
}


def _grid(seed=0):
    return np.random.default_rng(seed).random((SIZE, SIZE), np.float32)


def _port(x, variant, n_passes, **kw):
    y = torch.from_numpy(x.copy())
    for _ in range(n_passes):
        y = strip.strip_pass(y, variant, **kw)
    return y.numpy()



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small tensor operations; on one thread
    they do not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _compare(got, want, variant, n_passes):
    assert got.shape == want.shape and not np.isnan(want).any()
    if variant in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PER_PASS * n_passes)


SHIFT_VARIANTS = [v for v, s in strip.VARIANTS.items() if s.script == "micro_shifts"]


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("p", [8, 16])
@pytest.mark.parametrize("variant", SHIFT_VARIANTS)
def test_micro_shifts_variant_matches_jax(variant, p, n_passes):
    """Every micro_shifts variant at 256^2, T=32, hp=p (the script's halo
    for p a multiple of 8)."""
    x = _grid()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(SHIFTS.run(jnp.asarray(x), jnp.asarray(n_passes, jnp.int32), T=32, hp=p, p=p,
                                     variant=variant))
    _compare(_port(x, variant, n_passes, T=32, hp=p, p=p), want, variant, n_passes)


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("case", list(OPERAND_CASES))
def test_micro_operands_case_matches_jax(case, n_passes, monkeypatch):
    """Every micro_operands case, its SIZE set to 256, with the script's
    operands (``jnp.arange(16)``; the coefficients and halo value as it
    hands them to its kernel)."""
    monkeypatch.setattr(OPERANDS, "SIZE", SIZE)
    x = _grid(1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(OPERANDS.run(jnp.asarray(x), jnp.arange(16, dtype=jnp.float32), n_passes=n_passes,
                                       **OPERAND_CASES[case]))
    scalars = strip.StripScalars(coefs=(0.15, 0.2, 0.25, 0.1, 0.3), hv=0.0, extras=tuple(range(10)))
    got = _port(x, case, n_passes, T=OPERANDS.T, hp=OPERANDS.HP, p=OPERANDS.P, scalars=scalars)
    _compare(got, want, case, n_passes)


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("order", micro_order.ORDERS)
def test_micro_order_matches_jax(order, n_passes, monkeypatch):
    """micro_order's four accumulation orders, its SIZE overridden."""
    monkeypatch.setattr(ORDER, "SIZE", SIZE)
    x = _grid(2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(ORDER.run(jnp.asarray(x), variant=order, n_passes=n_passes))
    _compare(_port(x, order, n_passes, T=ORDER.T, hp=ORDER.HP, p=ORDER.P), want, order, n_passes)


def test_same_rounding_pairs_agree_exactly():
    """inter_cf rounds as centerfirst and grouped_nwse as centerlast; the
    two pairs differ."""
    x = torch.from_numpy(_grid(3))
    kw = dict(T=128, hp=8, p=8)
    run = {v: strip.strip_pass(x, v, **kw) for v in micro_order.ORDERS}
    assert torch.equal(run["inter_cf"], run["centerfirst"])
    assert torch.equal(run["grouped_nwse"], run["centerlast"])
    assert not torch.equal(run["centerfirst"], run["centerlast"])


def test_script_constants_are_the_ports():
    """The port keeps its own copy of the scripts' constants."""
    assert strip.COEFS == (SHIFTS.W0, SHIFTS.WN, SHIFTS.WS, SHIFTS.WW, SHIFTS.WE)
    assert (micro_operands.SIZE, micro_operands.T, micro_operands.HP, micro_operands.P) == (
        8192, OPERANDS.T, OPERANDS.HP, OPERANDS.P)
    assert (micro_order.SIZE, micro_order.T, micro_order.HP, micro_order.P) == (8192, ORDER.T, ORDER.HP, ORDER.P)
    assert set(OPERAND_CASES) == set(micro_operands.CASES)


def test_geometry_the_kernels_do_not_take_raises():
    x = torch.zeros(100, 64)
    with pytest.raises(ValueError, match="whole strips"):
        strip.strip_pass(x, "wrap", T=32, hp=8, p=8)
    with pytest.raises(ValueError, match="unknown strip variant"):
        strip.strip_pass(torch.zeros(96, 64), "roll", T=32, hp=8, p=8)
    with pytest.raises(ValueError, match="hp == p"):
        strip.strip_pass(torch.zeros(128, 64), "shrink", T=32, hp=16, p=8)


def test_entry_points_run_the_plain_versions_on_the_cpu(capsys):
    """Each entry point at a small size with ``--device cpu``: one line per
    variant, none failed."""
    assert micro_shifts.main(["--size", "64", "--iters", "16", "--strips", "16", "--ps", "8",
                              "--variants", "wrap,inline,composite,shrink", "--device", "cpu"]) == 0
    assert micro_operands.main(["--size", "256", "--n1", "1", "--n2", "2", "--device", "cpu"]) == 0
    assert micro_order.main(["--size", "256", "--n1", "1", "--n2", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 + len(micro_operands.CASES) + len(micro_order.ORDERS)
    assert all("GCell/s marginal" in line and "cpu: plain versions" in line for line in out), out


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """``--device cuda`` (the default) without a card raises: nothing
    carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (micro_shifts.main, micro_operands.main, micro_order.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--size", "64"])


def test_strip_pass_on_the_cpu_launches_nothing():
    before = strip.launches
    x = torch.from_numpy(_grid(4))
    assert torch.equal(strip.strip_pass(x, "inline", T=32, hp=8, p=8),
                       strip.strip_pass_plain(x, "inline", T=32, hp=8, p=8))
    assert strip.launches == before
