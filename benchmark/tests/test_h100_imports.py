"""What the benchmark's modules import, by top-level module name compared
whole (`ag2video_torch` shares a prefix with `ag2video_tpu`)."""

import ast
import os

import pytest

from benchmark.tests import tiny

FORBIDDEN = {"jax", "jaxlib", "flax", "ag2video_tpu"}
MODULES = sorted(
    os.path.relpath(os.path.join(d, f), tiny.BENCH)
    for d, _, fs in os.walk(tiny.BENCH) if "__pycache__" not in d
    for f in fs if f.endswith(".py"))


def top_level_imports(path):
    with open(os.path.join(tiny.BENCH, path)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [m for m in MODULES
                                  if m.startswith("reference" + os.sep)])
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "math", "re", "typing",
                                       "torch"}


def test_nothing_reads_the_jax_benchmark():
    for path in MODULES:
        if path == os.path.join("tests", "test_h100_imports.py"):
            continue
        with open(os.path.join(tiny.BENCH, path)) as f:
            assert "bench.py" not in f.read().replace("benchmark", ""), path
