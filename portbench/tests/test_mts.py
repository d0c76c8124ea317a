"""The 4 fs protocol's cell, 1li2-mts4fs: found by name with its metrics,
its kind, reference and metrics import nothing of JAX (nor the reference
anything of the program), both metric readers read the program's
counters, and its check passes the program where the control fails and
sees a program whose SHAKE leaves out a substep or whose step takes one
fast substep in place of two.  The runs drive small CPU copies of the
cell."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import BENCH, ROOT
from test_imports import FORBIDDEN, PROGRAM, imported

CELL = "1li2-mts4fs"
# the AGBNP1 MD metrics the cell reports besides its own
SHARED = ("ns_per_day", "md.regrows", "window.build_ms",
          "step.kernels_per_step", "kernels.pair_roofline_pct.md",
          "device.idle_pct.md", "device.idle_ms.tree",
          "device.idle_ms.pairs", "device.idle_ms.window",
          "md.host_reads_per_window", "tree.row_fill_pct.md",
          "md.graph_step_pct")
OWN = ("md.mts_substeps_per_step", "constraints.shake_sweeps_per_step")
NEW_FILES = ("kinds/md_mts.py", "reference/agbnp_mts.py",
             "metrics/md.mts_substeps_per_step.py",
             "metrics/constraints.shake_sweeps_per_step.py")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def limits():
    with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
        return json.load(f)["limits"]


def test_the_cell_is_found_by_name():
    import harness

    ctx = harness.Context(CELL, 2 ** 31 + 13, 51, 1, torch.device("cpu"))
    cfg = ctx.config
    assert cfg["agbnp_version"] == 1 and cfg["mts_inner"] == 2
    assert cfg["dt_fs"] == 4.0 and cfg["constraints"] == "X-H"
    assert cfg["neighbor_every"] == 10 and cfg["reduced"] == ["nsteps"]
    assert cfg["nsteps_source"] == 10000 // 4
    assert ctx.traffic["kind"] == "md_mts"
    assert ctx.traffic["slice_windows"] * cfg["neighbor_every"] == 40
    kind = harness.load_module("kinds", "md_mts.py")
    md = os.path.join(harness.HERE, "kinds", "md.py")
    for fn in ("setup", "window", "slice", "work", "release"):
        assert getattr(kind, fn).__code__.co_filename == md
    # every run_md call of the kind's copy of md.py takes mts_inner, and
    # its Simulation the constraints; the md kind's own copy neither
    assert kind._md._md_kw(cfg)["mts_inner"] == 2
    assert kind._md.common.simulation is kind._simulation
    plain = harness.load_module("kinds", "md.py")
    assert "mts_inner" not in plain._md_kw(cfg)
    assert plain.common.simulation is not kind._simulation
    s = spec()
    reports = {m["name"] for m in harness.cell_metrics(s, CELL, "per_layer")
               + harness.cell_metrics(s, CELL, "end_to_end")}
    assert reports == set(SHARED + OWN) | {"setup_s"}
    for m in s["per_layer"]:
        if m["name"] in OWN:
            assert m["workloads"] == [CELL]
            assert m["source"] == "program_counter"
            assert m["moves"] == "ns_per_day"
    (w,) = [w for w in s["workloads"] if w["name"] == CELL]
    assert w["chips"] == 1 and w["config"] == "1li2-mts4"
    assert set(limits()) == {"energy_rel", "pos_gap_nm", "vel_rel",
                             "constraint_rel"}


def test_the_configuration_is_its_own():
    s = spec()
    seen = [(c["source"], tuple(c["reduced"])) for c in s["configs"]]
    assert len(set(seen)) == len(seen)
    mine = next(c for c in s["configs"] if c["name"] == "1li2-mts4")
    assert mine["reduced"] == ["nsteps"]
    with open(os.path.join(BENCH, "configs", "1li2-mts4.json")) as f:
        cfg = json.load(f)
    assert cfg["source"] == mine["source"] and "r-RESPA" in mine["source"]
    with open(os.path.join(BENCH, "configs", "1li2.json")) as f:
        base = json.load(f)
    # 1li2's deployment at the 4 fs step: the integrator, its step and
    # window, the constraints
    differ = {k for k in base if base[k] != cfg.get(k)}
    assert differ == {"name", "what", "source", "integrator", "dt_fs",
                      "nsteps", "nsteps_source", "assumed",
                      "neighbor_every", "guarantees"}
    assert "every X-H bond at its length" in cfg["guarantees"]


def test_the_new_files_import_nothing_forbidden():
    for rel in NEW_FILES:
        names = set(imported(os.path.join(BENCH, rel)))
        assert not FORBIDDEN & names, rel
    assert PROGRAM not in set(imported(os.path.join(BENCH, "reference",
                                                    "agbnp_mts.py")))


@pytest.mark.parametrize("metric,counter,n,want", [
    ("md.mts_substeps_per_step", "md.mts_substep", 1, 2.0),
    ("constraints.shake_sweeps_per_step", "constraints.shake_sweeps", 4,
     8.0),
])
def test_the_readers(monkeypatch, metric, counter, n, want):
    import harness
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    mod = harness.load_module("metrics", metric + ".py")
    spans = [dict(name="md.step")] * 40
    counts = [dict(name=counter, n=n)] * 80
    monkeypatch.setattr(profiling, "recorded",
                        lambda: dict(spans=spans, counts=counts, dropped=0))
    assert mod.read(dict(kind="md")) == want
    assert mod.read(dict(kind="score")) is None
    # a program that records no such counter (the strict step, or the
    # parent), or no steps
    monkeypatch.setattr(profiling, "recorded",
                        lambda: dict(spans=spans, counts=[], dropped=0))
    assert mod.read(dict(kind="md")) is None
    monkeypatch.setattr(profiling, "recorded",
                        lambda: dict(spans=[], counts=counts, dropped=0))
    assert mod.read(dict(kind="md")) is None


def small_cell(checkout, every):
    """A copy of the cell with `every`-step windows, one checked window."""
    name = f"t-mts{every}"
    checkout.add_cell(name, "1li2-mts4", "md_mts4_10", limits(),
                      dict(neighbor_every=every), dict(check_extra_windows=0))
    return name


def test_the_program_passes_where_the_control_fails(checkout, monkeypatch):
    """2-step windows: the program within every limit, the reference in
    bfloat16 in its place outside one (portbench/control.py's
    readings)."""
    import control
    import harness

    cell = small_cell(checkout, 2)
    monkeypatch.setattr(harness, "HERE", checkout.bench)
    monkeypatch.setattr(harness, "ROOT", checkout.root)
    [(_, prog, ctrl)] = control.readings(cell, [2 ** 31 + 13], 0.2,
                                         device=torch.device("cpu"))
    assert all(prog[k] <= v for k, v in limits().items()), prog
    assert any(ctrl[k] > v for k, v in limits().items()), ctrl


class _SkipSecondShake:
    """The program's constraints with every second SHAKE call (the second
    substep's) left out: the positions pass through, the residual reads
    0, so the program's own check sees nothing."""

    def __init__(self, cons):
        self.cons, self.calls = cons, 0

    def __getattr__(self, name):
        return getattr(self.cons, name)

    def shake(self, x, x_ref):
        self.calls += 1
        if self.calls % 2 == 0:
            return x, x.new_zeros(x.shape[:-2])
        return self.cons.shake(x, x_ref)


def _no_shake(real):
    def step(slow, fast, masses, dt, temp, friction, inner,
             constraints=None):
        return real(slow, fast, masses, dt, temp, friction, inner,
                    constraints=_SkipSecondShake(constraints))

    return step


def _one_substep(real):
    def step(slow, fast, masses, dt, temp, friction, inner,
             constraints=None):
        return real(slow, fast, masses, dt, temp, friction, 1,
                    constraints=constraints)

    return step


@pytest.mark.parametrize("fault", [_no_shake, _one_substep])
def test_a_planted_fault_is_caught(checkout, monkeypatch, fault):
    """The program's r-RESPA step with SHAKE left out of its second
    substep, or with one fast substep of 4 fs in place of two of 2 fs
    (4-step windows): `correct` turns false, where the sound program's
    run is correct."""
    import openmm_agbnp_plugin_tpu_torch.md.simulation as sim_mod

    cell = small_cell(checkout, 4)
    out = checkout.run(cell, seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is True, out["checks"]
    monkeypatch.setattr(sim_mod, "mts_langevin_step",
                        fault(sim_mod.mts_langevin_step))
    out = checkout.run(cell, seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is False, out["checks"]
