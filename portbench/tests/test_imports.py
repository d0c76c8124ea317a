"""What the benchmark imports: never JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
in the reference nothing of the program."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "openmm_agbnp_plugin_tpu"}
PROGRAM = "openmm_agbnp_plugin_tpu_torch"


def imported(path):
    """Top-level names of the modules a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not FORBIDDEN & set(imported(path)), path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "os", "sqlite3", "numpy", "torch"}
    for path in sources("reference"):
        names = set(imported(path))
        assert PROGRAM not in names, path
        assert names <= allowed, (path, names - allowed)


REHEARSAL = """
import sys, time, pathlib
sys.path.insert(0, {tests!r})
import conftest, harness

class Patch:
    def setattr(self, obj, name, value):
        setattr(obj, name, value)

co = conftest.Checkout(pathlib.Path({tmp!r}))
co.add_cell("t-md", "1li2", "md_strict40",
            dict(energy_rel=1e-4, pos_gap_nm=1e-3, vel_rel=1e-2),
            dict(neighbor_every=4), dict(check_extra_windows=0))
out = co.run("t-md", seconds=0.2, monkeypatch=Patch())
assert out["correct"], out
print("PROGRAM", {program!r} in sys.modules)
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_a_rehearsal_loads_no_jax(tmp_path):
    code = REHEARSAL.format(tests=os.path.dirname(__file__),
                            tmp=str(tmp_path), program=PROGRAM)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "PROGRAM True" in lines
    assert "FORBIDDEN []" in lines


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result, also in a checkout of BENCHMARK.json and portbench alone."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the command would run")
    bare = tmp_path / "bare"
    shutil.copytree(BENCH, bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for cwd in (ROOT, str(bare)):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "1li2-md",
             "--seed", "3", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0
        assert out.stdout == ""
