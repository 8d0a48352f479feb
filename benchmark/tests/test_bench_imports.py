"""No module of the benchmark imports JAX or the JAX package, and none of
the reference imports the measured package; each import's top-level name
(before the first dot) compared whole. The runtime scan of
``sys.modules`` compares the same way."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "rdfc_gan_tpu"}


def _modules(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_imports(path))
    assert "rdfc_gan_torch" not in names
    # ``os`` and ``importlib`` load each net's type file (``engines.py``)
    assert names <= {"__future__", "math", "contextlib", "importlib", "os",
                     "torch"}, names


def test_runtime_scan_compares_whole_top_level_names(monkeypatch):
    from harness import common

    monkeypatch.setitem(sys.modules, "rdfc_gan_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert common.forbidden_modules() == [] or not {
        "jax", "rdfc_gan_tpu"} & set(common.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in common.forbidden_modules()
