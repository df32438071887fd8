"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole)."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "ssl_cr_histo_tpu"}


def modules(sub=""):
    root = os.path.join(HERE, sub)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" and node.args:
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(imported(path)) & JAX


@pytest.mark.parametrize("path", sorted(modules("reference")), ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = set(imported(path))
    assert "ssl_cr_histo_tpu_torch" not in names and not names & JAX
    assert names <= {"__future__", "glob", "importlib", "math", "os", "numpy", "torch", "port_bench"}, names


def test_names_compared_whole():
    # the port's name begins with the JAX package's: a prefix test would
    # refuse it, a whole-name test does not
    assert "ssl_cr_histo_tpu_torch" not in JAX
