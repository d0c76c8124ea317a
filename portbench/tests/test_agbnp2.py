"""The AGBNP2 cell, 1li2-md-v2: found by name, its kind and reference
import nothing of JAX (nor the reference anything of the program), and
its check sees a program that leaves the MS self volumes out of the Born
radii.  The runs drive a 2-step-window copy of the cell on the CPU."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import BENCH, ROOT
from test_imports import FORBIDDEN, PROGRAM, imported

CELL = "1li2-md-v2"
# the metrics the cell reports besides its own MS stage's three
SHARED = ("ns_per_day", "md.regrows", "step.kernels_per_step",
          "device.idle_pct.md", "md.host_reads_per_window",
          "device.idle_ms.tree", "device.idle_ms.pairs",
          "device.idle_ms.window", "tree.row_fill_pct.md")
OWN = ("device.idle_ms.ms", "ms.particle_fill_pct", "ms_tree.row_fill_pct")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_cell_is_found_by_name():
    import harness

    ctx = harness.Context(CELL, 2 ** 31 + 11, 51, 1, torch.device("cpu"))
    assert ctx.config["agbnp_version"] == 2
    assert ctx.config["reduced"] == ["nsteps"]
    assert ctx.config["descreen_horizon"] == 2.0
    assert ctx.traffic["kind"] == "md_agbnp2"
    kind = harness.load_module("kinds", "md_agbnp2.py")
    md = os.path.join(harness.HERE, "kinds", "md.py")
    for fn in ("setup", "window", "slice", "work", "release"):
        assert getattr(kind, fn).__code__.co_filename == md
    s = spec()
    reports = {m["name"] for m in harness.cell_metrics(s, CELL, "per_layer")
               + harness.cell_metrics(s, CELL, "end_to_end")}
    assert reports == set(SHARED + OWN) | {"setup_s"}
    for m in s["per_layer"]:
        if m["name"] in OWN:
            assert m["workloads"] == [CELL]


def test_the_configuration_is_its_own():
    # A configuration with another's source and cuts is no new one.
    s = spec()
    seen = [(c["source"], tuple(c["reduced"])) for c in s["configs"]]
    assert len(set(seen)) == len(seen)
    mine = next(c for c in s["configs"] if c["name"] == "1li2-v2")
    with open(os.path.join(BENCH, "configs", "1li2-v2.json")) as f:
        assert json.load(f)["source"] == mine["source"]
    assert "AGBNP2" in mine["source"]


def test_the_new_files_import_nothing_forbidden():
    for rel in ("kinds/md_agbnp2.py", "reference/agbnp2.py"):
        names = set(imported(os.path.join(BENCH, rel)))
        assert not FORBIDDEN & names, rel
    assert PROGRAM not in set(imported(os.path.join(BENCH, "reference",
                                                    "agbnp2.py")))


def limits():
    with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
        return json.load(f)["limits"]


def small_cell(checkout):
    """A copy of the cell with 2-step windows, one checked window."""
    checkout.add_cell("t-v2", "1li2-v2", "md_v2_strict40", limits(),
                      dict(neighbor_every=2), dict(check_extra_windows=0))
    return "t-v2"


def test_the_program_passes_where_the_control_fails(checkout, monkeypatch):
    """The program within every limit, the reference in bfloat16 in its
    place outside one (portbench/control.py's readings)."""
    import control
    import harness

    cell = small_cell(checkout)
    monkeypatch.setattr(harness, "HERE", checkout.bench)
    monkeypatch.setattr(harness, "ROOT", checkout.root)
    [(_, prog, ctrl)] = control.readings(cell, [2 ** 31 + 11], 0.2,
                                         device=torch.device("cpu"))
    assert all(prog[k] <= v for k, v in limits().items()), prog
    assert any(ctrl[k] > v for k, v in limits().items()), ctrl


def test_a_program_without_the_ms_self_volumes_is_caught(checkout,
                                                         monkeypatch):
    """The program's MS tree pass returns no self volumes to the parent
    atoms: its energy and trajectory are AGBNP2's without the MS
    particles' part of the Born radii, and `correct` turns false."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp2_torch as P2

    real = P2._MSCavity.apply

    def dropped(*args):
        e_vdw, e_large, sv_ms = real(*args)
        return e_vdw, e_large, torch.zeros_like(sv_ms)

    monkeypatch.setattr(P2._MSCavity, "apply", dropped)
    out = checkout.run(small_cell(checkout), seconds=0.2,
                       monkeypatch=monkeypatch)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["energy_rel"]["value"] > limits()["energy_rel"]


def test_agbnp2_against_the_program():
    """The reference against the program's float64 CPU path (AGBNP2 +
    OPLS, 1 nm cut-off) at the DMS positions of all 1,310 atoms: energy to
    1e-10 relative, forces to 1e-9 of the largest."""
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    from reference.agbnp2 import AGBNP2System
    from reference.dms import read_dms

    path = os.path.join(BENCH, "data", "1li2_agbnp1.dms")
    sysd = read_dms(path)
    sim = Simulation(load_dms(path), device="cpu", version=2, cutoff=1.0,
                     dtype=torch.float64)
    x = torch.as_tensor(sysd["positions"])
    e, f, counts = sim.force_fn()(x)
    if sim._check_overflow(counts, None, None):
        sim._regrow(counts, None, None)
        e, f, counts = sim.force_fn()(x)
    e_ref, f_ref = AGBNP2System(sysd, "cpu", torch.float64,
                                1.0).energy_forces(x)
    assert abs(float(e - e_ref)) <= 1e-10 * abs(float(e_ref))
    assert float((f - f_ref).abs().max()) <= 1e-9 * float(f_ref.abs().max())
