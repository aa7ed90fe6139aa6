"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: every import of every module,
compared by its top-level name as a whole."""
import ast
import os

import pytest

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "interpret_quality_tpu"}
PORT = "interpret_quality_tpu_torch"


def sources(sub=""):
    top = os.path.join(PKG, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, PKG))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, PKG))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in set(top_level_imports(path))


def test_the_check_compares_whole_names():
    # the port's name begins with the JAX package's, and is allowed
    assert PORT.split(".")[0] not in FORBIDDEN
    assert "interpret_quality_tpu" in FORBIDDEN
