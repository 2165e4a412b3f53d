"""Nothing the benchmark runs imports JAX or the JAX package (compared
by whole top-level name: `repro_torch` is not `repro`), the reference
imports nothing of the program, and a run without a card prints no
result."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_or_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    mods = _imports(path)
    assert not mods & (FORBIDDEN | PROGRAM)
    assert mods <= {"__future__", "dataclasses", "math", "numpy", "torch",
                    "reference"}


def test_only_the_program_module_imports_the_program():
    users = [p.name for p in SOURCES if _imports(p) & PROGRAM]
    assert users == ["program.py"]


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "ngram-tracked-ingest", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=120)
    if proc.returncode == 0:      # a card is there: the run must be whole
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
        return
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_in_a_bare_checkout_fails(tmp_path):
    """With only BENCHMARK.json and the benchmark's folder, there is no
    program to measure."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "ngram-scoring-read", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
