"""The port's native host I/O against its Python path and the JAX package's I/O.

``stencilstream_tpu_torch/native`` is a copy of the JAX package's
``io_kernels.cpp``, built with ``g++`` into the port's ``_build/``. The
cases of ``tests/test_native_io.py`` run against it, then each format the
port's ``utils/io.py`` writes is held byte for byte against its own Python
path (``native.available`` patched to ``False``) and against the JAX
package's ``utils/io.py`` on the same arrays.
"""

import io

import numpy as np
import pytest

from stencilstream_tpu.utils import io as jio

from stencilstream_tpu_torch import native
from stencilstream_tpu_torch.utils import io as ssio


@pytest.fixture
def python_path(monkeypatch):
    """The port's I/O with the native library switched off."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_the_library_builds_into_the_build_directory():
    assert native.available()
    path, seconds = native.build()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libss_io_") and seconds == 0.0
    assert native.library_path() == path and native.BUILD_DIR.name == "_build"


def test_char_grid_roundtrip():
    rng = np.random.default_rng(0)
    g = rng.random((13, 29)) < 0.4
    text = native.format_char_grid(g)
    assert text.decode().count("\n") == 13
    np.testing.assert_array_equal(native.parse_char_grid(text, 13, 29), g)


def test_char_grid_matches_python():
    rng = np.random.default_rng(1)
    g = rng.random((7, 11)) < 0.5
    py = "".join("".join("X" if v else "." for v in row) + "\n" for row in g)
    assert native.format_char_grid(g).decode() == py
    np.testing.assert_array_equal(native.parse_char_grid(py.encode(), 7, 11), g)


def test_char_grid_errors():
    with pytest.raises(ValueError, match=r"unexpected character at cell \(1, 0\)"):
        native.parse_char_grid(b"XXQ.", 2, 2)
    with pytest.raises(ValueError, match="truncated"):
        native.parse_char_grid(b"X.", 2, 2)


def test_parse_floats_matches_numpy():
    vals = np.random.default_rng(2).normal(size=100).astype(np.float32)
    text = " ".join(f"{v:.9g}" for v in vals).encode()
    np.testing.assert_array_equal(native.parse_floats(text, 100), vals)


def test_parse_floats_truncated():
    with pytest.raises(ValueError, match="parsed 2"):
        native.parse_floats(b"1.0 2.0", 5)


def test_indexed_text_matches_python():
    vals = np.array([1.5, -2.0, 3.25e-5, 80.0], np.float32)
    want = "".join(f"{i}\t{v:g}\n" for i, v in enumerate(vals))
    assert native.format_indexed_text(vals).decode() == want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csv_matches_savetxt(tmp_path, dtype):
    g = np.random.default_rng(3).normal(size=(5, 7)).astype(dtype)
    p = tmp_path / "py.csv"
    np.savetxt(p, g, fmt="%g", delimiter=",")
    assert native.format_csv(g) == p.read_bytes()


def test_io_module_dispatch_roundtrip():
    g = np.random.default_rng(4).random((9, 9)) < 0.3
    buf = io.StringIO()
    ssio.write_char_grid(buf, g)
    buf.seek(0)
    np.testing.assert_array_equal(ssio.read_char_grid(buf, 9, 9), g)


def _write_all(module, directory, arrays) -> dict:
    """Every text format ``module`` writes, as bytes, for the same arrays."""
    cells, temps, frame32, frame64 = arrays
    buf = io.StringIO()
    module.write_char_grid(buf, cells)
    module.write_indexed_text(str(directory / "temps.txt"), temps)
    module.write_csv_frame(str(directory / "f32.csv"), frame32)
    module.write_csv_frame(str(directory / "f64.csv"), frame64)
    return {"char": buf.getvalue().encode(), **{name: (directory / name).read_bytes()
                                               for name in ("temps.txt", "f32.csv", "f64.csv")}}


def test_native_output_equals_the_python_path_and_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    arrays = (rng.random((17, 23)) < 0.3, rng.uniform(70, 90, (31, 29)).astype(np.float32),
              rng.normal(size=(12, 40)).astype(np.float32) * 1e-3, rng.normal(size=(8, 9)) * 1e7)
    dirs = {k: tmp_path / k for k in ("native", "python", "jax")}
    for d in dirs.values():
        d.mkdir()
    got = _write_all(ssio, dirs["native"], arrays)
    want = _write_all(jio, dirs["jax"], arrays)
    monkeypatch.setattr(native, "available", lambda: False)
    python = _write_all(ssio, dirs["python"], arrays)
    for k in got:
        assert got[k] == python[k], k
        assert got[k] == want[k], k


def test_readers_agree_with_the_python_path(tmp_path, monkeypatch):
    """``read_float_grid_text`` and ``read_char_grid`` give the same arrays on
    both paths; the native reader leaves a stream just past the last cell,
    as ``std::cin >> char`` does."""
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(6, 5)).astype(np.float32)
    path = tmp_path / "vals.txt"
    path.write_text("\n".join(" ".join(f"{v:.9g}" for v in row) for row in vals) + "\n")
    text = "X.X\n.X.\nXX.\n\ntail"
    got = (ssio.read_float_grid_text(str(path), 6, 5), io.StringIO(text))
    cells = ssio.read_char_grid(got[1], 3, 3)
    monkeypatch.setattr(native, "available", lambda: False)
    want = (ssio.read_float_grid_text(str(path), 6, 5), io.StringIO(text))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(cells, ssio.read_char_grid(want[1], 3, 3))
    assert got[1].read() == "\n\ntail"


def test_python_path_without_the_library(python_path, tmp_path):
    assert not native.available()
    ssio.write_indexed_text(str(tmp_path / "t.txt"), np.array([[1.5, 2.0]], np.float32))
    assert (tmp_path / "t.txt").read_text() == "0\t1.5\n1\t2\n"


def test_a_failing_compile_raises_with_the_compilers_message(tmp_path, monkeypatch):
    """A compile error is never swallowed: no Python path is taken."""
    broken = tmp_path / "io_kernels.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.available()
    finally:
        native._library.cache_clear()
