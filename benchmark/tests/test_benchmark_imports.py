"""What the benchmark may load: no JAX, no JAX package, no JAX-era bench
files; the port only in ``program.py``, the modes and the program side of
the model kinds (``models/``), inside functions; the reference nothing of
the program."""

from __future__ import annotations

import ast
import os
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "omnifusion_tpu", "bench"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    top = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_under_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_file_of_the_benchmark_names_the_jax_era_records():
    for path in _sources():
        src = open(path).read()
        assert "BENCH" + "_" not in src and "MULTICHIP" + "_" not in src, path


def test_only_the_program_modes_and_kinds_import_the_port_inside_functions():
    allowed = ("program.py", "modes" + os.sep, "models" + os.sep, "tests" + os.sep)
    for path in _sources():
        rel = os.path.relpath(path, harness.HERE)
        if any(n.split(".")[0] == "omnifusion_torch" for n in _imports(path)):
            assert rel.startswith(allowed), rel
        top = ast.Module(body=ast.parse(open(path).read(), path).body, type_ignores=[])
        for node in top.body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert all(n.split(".")[0] != "omnifusion_torch" for n in names), (rel, names)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "omnifusion_torch", (path, name)


def test_the_run_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "omnifusion_torchish", sys)
    monkeypatch.setitem(sys.modules, "jaxified", sys)
    assert not {"omnifusion_torchish", "jaxified"} & set(harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "omnifusion_tpu", sys)
    assert {"jax.numpy", "omnifusion_tpu"} <= set(harness.forbidden_modules())
