"""The WU impulse cell, 1li2-md-wu4: found by name with its metrics, its
kind, reference and metric import nothing of JAX (nor the reference
anything of the program), and its check sees a program whose impulse
drops the factor k.  The runs drive small CPU copies of the cell."""

from __future__ import annotations

import json
import os

import torch

from conftest import BENCH, ROOT
from test_imports import FORBIDDEN, PROGRAM, imported

CELL = "1li2-md-wu4"
# the AGBNP1 MD metrics the cell reports besides its own
SHARED = ("ns_per_day", "md.regrows", "window.build_ms",
          "step.kernels_per_step", "kernels.pair_roofline_pct.md",
          "device.idle_pct.md", "device.idle_ms.tree",
          "device.idle_ms.pairs", "device.idle_ms.window",
          "md.host_reads_per_window", "tree.row_fill_pct.md",
          "md.graph_step_pct")
OWN = ("md.wu_impulse_pct",)
NEW_FILES = ("kinds/md_wu.py", "reference/agbnp_wu.py",
             "metrics/md.wu_impulse_pct.py")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def limits():
    with open(os.path.join(BENCH, "cells", CELL + ".json")) as f:
        return json.load(f)["limits"]


def test_the_cell_is_found_by_name():
    import harness

    ctx = harness.Context(CELL, 2 ** 31 + 13, 51, 1, torch.device("cpu"))
    assert ctx.config["agbnp_version"] == 1 and ctx.config["wu_every"] == 4
    assert ctx.config["reduced"] == ["nsteps"]
    assert ctx.config["neighbor_every"] % ctx.config["wu_every"] == 0
    assert ctx.traffic["kind"] == "md_wu"
    kind = harness.load_module("kinds", "md_wu.py")
    md = os.path.join(harness.HERE, "kinds", "md.py")
    for fn in ("setup", "window", "slice", "work", "release"):
        assert getattr(kind, fn).__code__.co_filename == md
    # every run_md call of the kind's copy of md.py takes wu_every; the md
    # kind's own copy does not
    assert kind._md._md_kw(ctx.config)["wu_every"] == 4
    plain = harness.load_module("kinds", "md.py")
    assert "wu_every" not in plain._md_kw(ctx.config)
    s = spec()
    reports = {m["name"] for m in harness.cell_metrics(s, CELL, "per_layer")
               + harness.cell_metrics(s, CELL, "end_to_end")}
    assert reports == set(SHARED + OWN) | {"setup_s"}
    for m in s["per_layer"]:
        if m["name"] in OWN:
            assert m["workloads"] == [CELL]
    (w,) = [w for w in s["workloads"] if w["name"] == CELL]
    assert w["chips"] == 1 and w["config"] == "1li2-wu4"


def test_the_configuration_is_its_own():
    s = spec()
    seen = [(c["source"], tuple(c["reduced"])) for c in s["configs"]]
    assert len(set(seen)) == len(seen)
    mine = next(c for c in s["configs"] if c["name"] == "1li2-wu4")
    with open(os.path.join(BENCH, "configs", "1li2-wu4.json")) as f:
        cfg = json.load(f)
    assert cfg["source"] == mine["source"] and "r-RESPA" in mine["source"]
    with open(os.path.join(BENCH, "configs", "1li2.json")) as f:
        base = json.load(f)
    # 1li2's deployment, the impulse added
    differ = {k for k in base if base[k] != cfg.get(k)}
    assert differ == {"name", "what", "source", "assumed", "guarantees"}


def test_the_new_files_import_nothing_forbidden():
    for rel in NEW_FILES:
        names = set(imported(os.path.join(BENCH, rel)))
        assert not FORBIDDEN & names, rel
    assert PROGRAM not in set(imported(os.path.join(BENCH, "reference",
                                                    "agbnp_wu.py")))


def test_the_wu_impulse_reader(monkeypatch):
    import harness
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    mod = harness.load_module("metrics", "md.wu_impulse_pct.py")
    spans = [dict(name="md.step")] * 40
    counts = [dict(name="md.wu_impulse", n=1)] * 10
    monkeypatch.setattr(profiling, "recorded",
                        lambda: dict(spans=spans, counts=counts, dropped=0))
    assert mod.read(dict(kind="md")) == 25.0
    assert mod.read(dict(kind="score")) is None
    # a program that records no impulse (the strict step, or the parent)
    monkeypatch.setattr(profiling, "recorded",
                        lambda: dict(spans=spans, counts=[], dropped=0))
    assert mod.read(dict(kind="md")) is None


def small_cell(checkout, every):
    """A copy of the cell with `every`-step windows, one checked window."""
    name = f"t-wu{every}"
    checkout.add_cell(name, "1li2-wu4", "md_wu4_40", limits(),
                      dict(neighbor_every=every), dict(check_extra_windows=0))
    return name


def test_the_program_passes_where_the_control_fails(checkout, monkeypatch):
    """2-step windows (each an impulse of weight 2 and a skip step): the
    program within every limit, the reference in bfloat16 in its place
    outside one (portbench/control.py's readings)."""
    import control
    import harness

    cell = small_cell(checkout, 2)
    monkeypatch.setattr(harness, "HERE", checkout.bench)
    monkeypatch.setattr(harness, "ROOT", checkout.root)
    [(_, prog, ctrl)] = control.readings(cell, [2 ** 31 + 13], 0.2,
                                         device=torch.device("cpu"))
    assert all(prog[k] <= v for k, v in limits().items()), prog
    assert any(ctrl[k] > v for k, v in limits().items()), ctrl


def test_an_impulse_without_its_factor_is_caught(checkout, monkeypatch):
    """The program's impulse kicks with F + F_WU where it should kick with
    F + k F_WU (16-step windows, four blocks each): `correct` turns false
    (seen: pos_gap_nm 8.4e-4 and vel_rel 0.114 against 1.5e-6 and 6.9e-4
    for the sound program)."""
    import openmm_agbnp_plugin_tpu_torch.md.simulation as sim_mod

    real = sim_mod.wu_impulse_langevin_steps

    def dropped(split_fn, skip_fn, masses, dt, temp, friction, k, **kw):
        def split(pos):
            e, f, f_wu, c = split_fn(pos)
            return e, f, f_wu / k, c

        return real(split, skip_fn, masses, dt, temp, friction, k, **kw)

    cell = small_cell(checkout, 16)
    out = checkout.run(cell, seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is True, out["checks"]
    monkeypatch.setattr(sim_mod, "wu_impulse_langevin_steps", dropped)
    out = checkout.run(cell, seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is False, out["checks"]
