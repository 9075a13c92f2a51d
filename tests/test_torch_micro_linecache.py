"""The port's line-cache microbenchmark pass (``experiments/linecache.py``,
the plain version of ``csrc/micro_linecache.cu``) against JAX's TPU kernels
of ``experiments/micro_linecache.py`` (``run_lc``) and ``experiments/
lc_bisect.py`` (``build``) run in TPU interpret mode on the CPU, and the two
entry points.

Inputs: ``np.random.default_rng(seed).random(..., float32)``, in [0, 1),
with zero pad rows below, as the scripts pad theirs. The pad rows of the
output are NaN on both sides (the TPU kernel never writes them) and count as
equal; so do rows [0, 2p) of the ``*_noinit`` variants (their carry is never
initialised: NaN in interpret mode and in the plain version), which are
excluded, as on the TPU they are undefined.

Tolerance: 1e-6 absolute per pass. The port sums each level as its
``jacobi5_general`` functor does (the centre's product, then a fused
multiply-add a tap), so that ``micro_linecache --check`` holds bit for bit
against the tile pass on the card; XLA on the CPU contracts the interpreted
kernel's multiply-adds otherwise, and not alike in every cell. A wrong tap,
carry or strip moves cells by 1e-2 and more. JAX's interpret mode cannot
lower ``run_lc(io_alias=True)`` (the aliased output has the input's padded
shape, the loop body another), so alias is held against the port's own
non-aliased pass.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from experiment_scripts import load_definitions, load_script
from stencilstream_tpu_torch.experiments import lc_bisect, linecache as lc, micro_linecache

ATOL_PER_PASS = 1e-6
SIZE = 256

LINECACHE = load_script("micro_linecache")
#: lc_bisect puts a path of its own on ``sys.path`` at module level: only
#: its definitions are loaded.
BISECT = load_definitions("lc_bisect")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions run many small tensor operations; on one thread
    they do not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _padded(rows, seed=0, size=SIZE):
    return lc.zero_pad(np.random.default_rng(seed).random((size, size), np.float32), rows)


def _compare(got, want, n_passes, skip=0):
    """Equal within the tolerance, NaN where the other side is NaN."""
    got, want = got[skip:], want[skip:]
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    both = ~np.isnan(want)
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=ATOL_PER_PASS * n_passes)


@pytest.mark.parametrize("n_passes", [1, 2])
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("stitch", [False, True])
@pytest.mark.parametrize("T", [32, 64])
def test_run_lc_matches_jax(T, stitch, blocked, n_passes):
    """micro_linecache's kernel at 256^2, p=8, with the script's pad rows
    (T for the blocked output, 8 otherwise); a second pass reads the first
    one's NaN pad rows into its last strip on both sides."""
    x = _padded(T if blocked else 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(LINECACHE.run_lc(jnp.asarray(x), T=T, p=8, n_passes=n_passes, io_alias=False, H=SIZE,
                                           stitch=stitch, blocked=blocked))
    variant = "lc" + ("s" if stitch else "") + ("b" if blocked else "")
    y = torch.from_numpy(x)
    for _ in range(n_passes):
        y = lc.linecache_pass(y, variant, H=SIZE, T=T, p=8)
    assert np.isnan(want[SIZE:]).all()
    _compare(y.numpy(), want, n_passes)


@pytest.mark.parametrize("variant", ["noscratch", "scratch3d", "scratch3d_noinit", "scratch2d", "scratch2d_noinit"])
def test_lc_bisect_variant_matches_jax(variant, monkeypatch):
    """lc_bisect's five scratch layouts, its H and Wd patched to 256 (p=8,
    strips of 128, 8 pad rows)."""
    monkeypatch.setattr(BISECT, "H", SIZE)
    monkeypatch.setattr(BISECT, "Wd", SIZE)
    x = _padded(8, seed=1)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(BISECT.build(variant)(jnp.asarray(x)))
    got = lc.linecache_pass(torch.from_numpy(x), variant, H=SIZE, T=BISECT.T, p=BISECT.p).numpy()
    skip = lc.undefined_rows(variant, BISECT.p)
    if skip:
        assert np.isnan(want[:skip]).all() and np.isnan(got[:skip]).all()
    _compare(got, want, 1, skip)


def test_noscratch_strips_are_independent():
    """With no carry, a strip's result does not depend on the strip above;
    with one, it does."""
    x = torch.from_numpy(_padded(8, seed=2))
    y = x.clone()
    y[: 128 + 8] = 0.5  # every row the first strip reads (it starts at row hp = 8)
    a = lc.linecache_pass(x, "noscratch", H=SIZE, T=128, p=8)
    b = lc.linecache_pass(y, "noscratch", H=SIZE, T=128, p=8)
    assert torch.equal(a[128:SIZE], b[128:SIZE])
    c = lc.linecache_pass(x, "scratch3d", H=SIZE, T=128, p=8)
    d = lc.linecache_pass(y, "scratch3d", H=SIZE, T=128, p=8)
    assert not torch.equal(c[128:SIZE], d[128:SIZE])


@pytest.mark.parametrize("variant", ["lc", "lcsb"])
def test_alias_keeps_the_inputs_pad_rows(variant):
    """alias: the rows of the grid as without it, the pad rows the input's
    (an in-place pass on the TPU never wrote them)."""
    x = torch.from_numpy(_padded(64, seed=3))
    plain = lc.linecache_pass(x, variant, H=SIZE, T=64, p=8)
    alias = lc.linecache_pass(x, variant, H=SIZE, T=64, p=8, alias=True)
    assert torch.equal(alias[:SIZE], plain[:SIZE])
    assert torch.equal(alias[SIZE:], x[SIZE:]) and plain[SIZE:].isnan().all()


def test_strip_height_does_not_change_the_result():
    """With a carry between strips the result is one walk from the top."""
    x = torch.from_numpy(_padded(16, seed=4))
    a = lc.linecache_pass(x, "lc", H=SIZE, T=32, p=16)
    b = lc.linecache_pass(x, "lc", H=SIZE, T=128, p=16)
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_check_holds_against_the_tile_pass():
    """micro_linecache --check on the CPU: one pass of lc at T=256, p=8
    equals one tile pass of p=8 on rows [2p, H - 2p), bit for bit."""
    x0 = np.random.default_rng(5).random((512, 300), np.float32)
    assert micro_linecache.check(x0, torch.device("cpu")) == 0.0


def test_variant_names_parse_as_the_script_parses_them():
    """The script's names (``micro_linecache.py:181-196``): kind, T, p,
    alias."""
    expect = {"pad224x16": ("pad", 224, 16, False), "lc256x16": ("lc", 256, 16, False),
              "lc256x16a": ("lc", 256, 16, True), "lcsb128x8a": ("lcsb", 128, 8, True),
              "lcs64x8": ("lcs", 64, 8, False), "lcb256x32": ("lcb", 256, 32, False)}
    for name, want in expect.items():
        assert micro_linecache.parse_variant(name) == want
    assert micro_linecache.COEFS == LINECACHE.COEFS


def test_geometry_the_kernel_does_not_take_raises():
    with pytest.raises(ValueError, match="rows below the grid"):
        lc.linecache_pass(torch.zeros(260, 64), "lc", H=256, T=64, p=8)
    with pytest.raises(ValueError, match="blocked output"):
        lc.linecache_pass(torch.zeros(272, 64), "lcb", H=256, T=64, p=8)
    with pytest.raises(ValueError, match="whole strips"):
        lc.linecache_pass(torch.zeros(272, 64), "lc", H=256, T=48, p=8)
    with pytest.raises(ValueError, match="unknown line-cache variant"):
        lc.linecache_pass(torch.zeros(272, 64), "lcx", H=256, T=64, p=8)


def test_entry_points_run_the_plain_versions_on_the_cpu(capsys):
    """micro_linecache (the tile-pass baseline, plain, stitched and blocked
    with alias, and --check) and lc_bisect at its 1024^2 with ``--device
    cpu``."""
    assert micro_linecache.main(["--size", "256", "--iters", "16", "--variants", "pad64x8,lc64x8,lcsb64x8a",
                                 "--device", "cpu"]) == 0
    assert micro_linecache.main(["--size", "512", "--check", "--device", "cpu"]) == 0
    assert lc_bisect.main(["scratch2d", "--passes", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 6, out
    assert all("GCell/s marginal" in line for line in out[:3]), out
    assert out[3].startswith("interior max err (rows 16:496): 0.000e+00")
    assert out[4].startswith("scratch2d: OK in ") and "ms a pass" in out[5]


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro_linecache.main(["--size", "256"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lc_bisect.main(["scratch3d"])


def test_linecache_pass_on_the_cpu_launches_nothing():
    before = lc.launches
    x = torch.from_numpy(_padded(8, seed=6))
    assert torch.equal(lc.linecache_pass(x, "scratch3d", H=SIZE, T=128, p=8).nan_to_num(7.0),
                       lc.linecache_pass_plain(x, "scratch3d", H=SIZE, T=128, p=8).nan_to_num(7.0))
    assert lc.launches == before
