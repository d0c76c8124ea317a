"""Helpers of the benchmark's CPU tests: a copy of the benchmark's files
in a temporary checkout, where a test adds throwaway cells, and a helper
that runs one cell there on the CPU (the card check skipped)."""

from __future__ import annotations

import json
import os
import shutil
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU with CUDA "
                            "(skips without one)")


class Checkout:
    """A temporary checkout holding BENCHMARK.json and a copy of the
    benchmark's files (its data linked), where cells can be added."""

    def __init__(self, path):
        self.root = str(path)
        self.bench = os.path.join(self.root, "portbench")
        shutil.copytree(BENCH, self.bench, ignore=shutil.ignore_patterns(
            "data", "tests", "__pycache__"))
        os.symlink(os.path.join(BENCH, "data"),
                   os.path.join(self.bench, "data"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), self.root)

    def spec(self):
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            return json.load(f)

    def write(self, rel, obj):
        path = os.path.join(self.root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f, indent=2)

    def add_cell(self, name, config, traffic, limits, config_edits=None,
                 traffic_edits=None):
        """A throwaway cell `name`: a copy of configuration `config` and
        traffic `traffic` with the edits, and the cell in every metric of
        BENCHMARK.json that lists a cell of the same traffic kind."""
        with open(os.path.join(self.bench, "configs", config + ".json")) as f:
            cfg = json.load(f)
        with open(os.path.join(self.bench, "traffic",
                               traffic + ".json")) as f:
            tr = json.load(f)
        cfg.update(config_edits or {})
        tr.update(traffic_edits or {})
        self.write(f"portbench/configs/{name}.json", cfg)
        self.write(f"portbench/traffic/{name}.json", tr)
        self.write(f"portbench/cells/{name}.json",
                   dict(config=name, traffic=name, chips=1, why="a test",
                        limits=limits))
        spec = self.spec()
        like = [w["name"] for w in spec["workloads"]
                if w["traffic"] == traffic]
        spec["workloads"].append(dict(name=name, config=name, traffic=name,
                                      chips=1, why="a test"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and set(like) & set(m["workloads"]):
                m["workloads"].append(name)
        self.write("BENCHMARK.json", spec)

    def run(self, workload, seed=7, seconds=0.5, trace=0, hooks=None,
            monkeypatch=None):
        """One run of a cell on the CPU: the result dict."""
        import torch

        import harness

        monkeypatch.setattr(harness, "HERE", self.bench)
        monkeypatch.setattr(harness, "ROOT", self.root)
        args = harness.parse(["--workload", workload, "--seed", str(seed),
                              "--seconds", str(seconds), "--trace",
                              str(trace)])
        return harness.run(args, time.perf_counter(),
                           device=torch.device("cpu"), hooks=hooks)


@pytest.fixture
def checkout(tmp_path):
    return Checkout(tmp_path)
