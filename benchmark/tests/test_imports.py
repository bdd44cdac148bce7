"""What the benchmark and its reference import: no top-level name ``jax``,
``jaxlib``, ``flax`` or ``svd_xtend_tpu`` (compared whole, the part before
the first dot), and in the reference nothing of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "svd_xtend_tpu"}
PROGRAM = "svd_xtend_tpu_torch"


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_benchmark_imports_no_jax():
    """Every module of the benchmark, its kinds and its metric readers, imported
    in one process."""
    code = ("import pathlib, importlib\n"
            "import benchmark.run, benchmark.harness, benchmark.kinds.generate, "
            "benchmark.kinds.train\n"
            "from benchmark import harness\n"
            "for p in sorted((harness.DATA_DIR / 'metrics').glob('*.py')):\n"
            "    harness.load_reader(harness.DATA_DIR, p.stem)\n")
    loaded = _loaded(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert PROGRAM in loaded


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded("import benchmark.reference.svd, benchmark.reference.pipeline")
    assert not loaded & (FORBIDDEN | {PROGRAM}), loaded & (FORBIDDEN | {PROGRAM})


def test_reference_sources():
    """The reference's own import statements, read from its files."""
    for path in sorted((REPO / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN | {PROGRAM}, (path, name)


def test_run_compares_whole_top_level_names():
    """The command's own look at sys.modules: the program's name begins with
    the JAX package's and is not caught; the JAX package and JAX are."""
    from benchmark import run
    assert run.forbidden_modules([PROGRAM, f"{PROGRAM}.models.unet", "jaxtyping"]) == []
    assert run.forbidden_modules(["svd_xtend_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "svd_xtend_tpu"]
