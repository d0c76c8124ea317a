"""BENCHMARK.json against the benchmark's files: every cell, configuration,
traffic mix, traffic kind and per-layer metric is found by its name, and
a new cell or metric takes only new files."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def test_every_cell_is_found_by_name():
    import harness

    s = spec()
    assert s["paths"] == ["portbench"]
    names = [c["name"] for c in s["configs"]]
    for c in s["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = load("configs", c["name"] + ".json")
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, cfg["system_file"]))
        assert cfg["system_file"].startswith("portbench/data/")
    for w in s["workloads"]:
        cell = load("cells", w["name"] + ".json")
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) \
            == (w["config"], w["traffic"], w["chips"], w["why"])
        assert w["config"] in names
        kind = load("traffic", w["traffic"] + ".json")["kind"]
        mod = harness.load_module("kinds", kind + ".py")
        for fn in ("setup", "window", "slice", "work", "release", "check"):
            assert callable(getattr(mod, fn))
        assert cell["limits"] and all(v > 0 for v in cell["limits"].values())
        reports = {m["name"] for m in harness.cell_metrics(s, w["name"],
                                                           "end_to_end")}
        assert "setup_s" in reports and len(reports) >= 2
        assert harness.cell_metrics(s, w["name"], "per_layer")


def test_names_units_and_metric_readers():
    import harness

    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    seen = set()
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in seen
        seen.add(m["name"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert m["moves"] in e2e
        assert callable(harness.load_module("metrics",
                                            m["name"] + ".py").read)
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(
                s, w, "end_to_end")}
    for w in s["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


def test_a_missing_cell_is_refused(checkout, monkeypatch):
    with pytest.raises(FileNotFoundError):
        checkout.run("no-such-cell", monkeypatch=monkeypatch)


def test_a_throwaway_cell_and_metric_take_only_new_files(checkout,
                                                         monkeypatch):
    """A new cell (a copy of 1li2 with 4-step windows) and a new per-layer
    metric, added as files, run without an edit to any file the benchmark
    has."""
    before = {p: open(os.path.join(BENCH, p), "rb").read()
              for p in ("harness.py", "common.py", "kinds/md.py")}
    checkout.add_cell("t-md", "1li2", "md_strict40",
                      dict(energy_rel=1e-4, pos_gap_nm=1e-3, vel_rel=1e-2),
                      dict(neighbor_every=4), dict(check_extra_windows=0))
    with open(os.path.join(checkout.bench, "metrics",
                           "md.steps_timed.py"), "w") as f:
        f.write("def read(data):\n    return data.get('units')\n")
    s = checkout.spec()
    s["per_layer"].append(dict(name="md.steps_timed", unit="count",
                               better="higher", source="program_counter",
                               layer="MD loop (md/simulation.py run_md)",
                               moves="ns_per_day", workloads=["t-md"]))
    checkout.write("BENCHMARK.json", s)
    out = checkout.run("t-md", seconds=0.2, trace=1, monkeypatch=monkeypatch)
    assert out["correct"] is True
    assert out["metrics"]["md.steps_timed"]["value"] % 4 == 0
    assert out["metrics"]["md.regrows"]["value"] == 0
    out = checkout.run("t-md", seconds=0.2, trace=0, monkeypatch=monkeypatch)
    assert set(out["metrics"]) == {"ns_per_day", "setup_s"}
    assert list(out)[-1] == "checks"
    for p, b in before.items():
        assert open(os.path.join(BENCH, p), "rb").read() == b
