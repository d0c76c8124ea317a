"""On the card: one short run of every cell, each with a seed of its own,
through the command as the benchmark runs it.  Run there with

    python -m pytest -m cuda portbench/tests/test_cuda.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

from test_spec import spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_runs_correct_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for k, w in enumerate(spec()["workloads"]):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", w["name"],
             "--seed", str(2 ** 31 + 17 * k + trace), "--seconds", "3",
             "--trace", str(trace)],
            capture_output=True, text=True, timeout=360, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert res["device"]["platform"] == "gpu"
        assert res["metrics"]
