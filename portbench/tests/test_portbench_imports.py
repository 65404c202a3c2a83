"""No module of the benchmark imports JAX or the JAX package, and the
reference, the traffic and the metric arithmetic import nothing of the
program (top-level module names compared whole)."""

import ast
from pathlib import Path

import pytest

from portbench import harness

FILES = sorted(harness.PORTBENCH.rglob("*.py"))
INDEPENDENT = ("reference", "traffic", "metrics")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.PORTBENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & {"jax", "jaxlib", "flax", "c_ofdm_tpu"}


@pytest.mark.parametrize("path", [p for p in FILES if p.relative_to(
    harness.PORTBENCH).parts[0] in INDEPENDENT + ("peaks.py",)],
    ids=lambda p: str(p.relative_to(harness.PORTBENCH)))
def test_reference_and_traffic_independent_of_the_program(path):
    assert "c_ofdm_tpu_torch" not in set(_imports(path))
