"""No module of the benchmark imports jax or the JAX package, and the
reference imports nothing of the program."""

import ast
import os

import pytest

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "panagram_tpu"}


def modules():
    for root, _dirs, files in os.walk(run.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), run.ROOT)


def imported(path: str) -> set:
    """Top-level names of every module `path` imports, at any depth."""
    tree = ast.parse(open(os.path.join(run.ROOT, path)).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(p for p in modules()
                                        if p.startswith("portbench/reference/")))
def test_reference_is_plain(path):
    assert imported(path) <= {"__future__", "torch"}


def test_names_compared_whole():
    assert "panagram_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "panagram_tpu.ops".split(".")[0] in FORBIDDEN


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "panagram_tpu_torch_x",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib.xla"]
