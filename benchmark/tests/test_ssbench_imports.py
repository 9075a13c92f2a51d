"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names: ``stencilstream_tpu_torch`` is the port and
is allowed, ``stencilstream_tpu`` is not."""

import ast
import subprocess
import sys

from benchmark import run
from benchmark.spec import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "stencilstream_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in (ROOT / "benchmark").rglob("*.py"):
        bad = {m for m in _imports(path) if m.split(".")[0] in FORBIDDEN}
        if bad:
            found[str(path.relative_to(ROOT))] = sorted(bad)
    assert found == {}


def test_the_port_is_no_forbidden_name():
    assert "stencilstream_tpu_torch".split(".")[0] not in FORBIDDEN


def test_runtime_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "stencilstream_tpu_torch_extra", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "stencilstream_tpu", raising=False)
    assert "stencilstream_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "stencilstream_tpu.core", object())
    assert run.forbidden_modules() == ["stencilstream_tpu"]


def test_the_port_loads_no_jax():
    """The port's modules that a run loads import no JAX (a fresh process)."""
    code = ("import sys; from benchmark.spec import Spec; s = Spec(); "
            "[s.app(c) for c in ('hotspot', 'jacobi5')]; "
            "import stencilstream_tpu_torch.backends.auto, stencilstream_tpu_torch.backends.cuda_lib; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'stencilstream_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
