"""Loading the ``experiments/`` scripts by their paths, for the parity tests
of the port's microbenchmark kernels.

Some scripts change ``sys.path`` or run a sweep at module level; the loaders
here leave the test process's ``sys.path`` as they found it.
"""

import ast
import importlib.util
import sys
import types
from pathlib import Path

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"


def load_script(name: str):
    """An ``experiments/`` script as a module, loaded by its path."""
    spec = importlib.util.spec_from_file_location(f"_experiments_{name}", EXPERIMENTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


def load_definitions(name: str):
    """A script's imports, constants and functions only: no statement that
    calls anything at module level runs."""
    tree = ast.parse((EXPERIMENTS / f"{name}.py").read_text())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom, ast.FunctionDef))
            or (isinstance(node, ast.Assign) and not any(isinstance(n, ast.Call) for n in ast.walk(node.value)))]
    module = types.ModuleType(f"_experiments_{name}")
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(EXPERIMENTS / f"{name}.py"), "exec"), module.__dict__)
    return module
