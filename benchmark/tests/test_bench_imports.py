"""Nothing under benchmark/ imports JAX, Flax or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program."""

from __future__ import annotations

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "harp_tpu"}


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(under: str) -> list:
    return [os.path.join(d, f) for d, _, files in os.walk(under) for f in files
            if f.endswith(".py")]


def test_no_module_under_benchmark_imports_jax_or_harp_tpu():
    bad = {p: imported_tops(p) & FORBIDDEN for p in sources(BENCH)}
    assert not {p: t for p, t in bad.items() if t}


def test_the_reference_imports_nothing_of_the_program():
    bad = {p: t for p in sources(os.path.join(BENCH, "reference"))
           if (t := imported_tops(p) & {"harp_tpu_torch", "harp_tpu"})}
    assert not bad


def test_names_are_compared_whole():
    assert "harp_tpu" not in {"harp_tpu_torch".split(".")[0]}
    assert imported_tops(__file__) & FORBIDDEN == set()
