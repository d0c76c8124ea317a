"""The check sees a broken timed path: each run drives a small cell of each
traffic kind on the CPU with a fault planted in the program underneath,
and `correct` must come out false (and true without a fault).  The faults
are those each kind can have: a step that returns its state unchanged, a
wrong answer where it is produced, and, with a batch, half of it left
out."""

from __future__ import annotations

import json
import os

import pytest
import torch

from conftest import BENCH


def limits(cell):
    """The limits of a cell of the benchmark, which the small cells take."""
    with open(os.path.join(BENCH, "cells", cell + ".json")) as f:
        return json.load(f)["limits"]


def broken_step(make, fault):
    """langevin_middle_step `make` with `fault` planted in its step."""
    def factory(*args, **kw):
        step = make(*args, **kw)

        def bad(pos, vel, noise):
            out = step(pos, vel, noise)
            new_pos, new_vel = out[0], out[1]
            if fault == "unchanged":
                new_pos, new_vel = pos, vel
            elif fault == "altered":
                new_pos = new_pos.clone()
                new_pos[..., 0, 0] += 0.01
            elif fault == "half":
                half = pos.shape[0] // 2
                new_pos, new_vel = new_pos.clone(), new_vel.clone()
                new_pos[half:], new_vel[half:] = pos[half:], vel[half:]
            return (new_pos, new_vel) + tuple(out[2:])

        return bad

    return factory


@pytest.mark.parametrize("fault", [None, "unchanged", "altered"])
def test_md_trajectory_faults(checkout, monkeypatch, fault):
    import openmm_agbnp_plugin_tpu_torch.md.simulation as sim_mod

    checkout.add_cell("t-md", "1li2", "md_strict40", limits("1li2-md"),
                      dict(neighbor_every=4), dict(check_extra_windows=0))
    if fault:
        monkeypatch.setattr(sim_mod, "langevin_middle_step", broken_step(
            sim_mod.langevin_middle_step, fault))
    out = checkout.run("t-md", seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_ensemble_faults(checkout, monkeypatch, fault):
    import openmm_agbnp_plugin_tpu_torch.parallel.ensemble as ens_mod

    checkout.add_cell("t-ens", "1li2", "ens4_strict40", limits("2clr-ens4"),
                      dict(neighbor_every=4),
                      dict(replicas=2, check_first_replicas=1))
    if fault:
        monkeypatch.setattr(ens_mod, "langevin_middle_step", broken_step(
            ens_mod.langevin_middle_step, fault))
    out = checkout.run("t-ens", seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "half", "altered"])
def test_score_faults(checkout, monkeypatch, fault):
    from openmm_agbnp_plugin_tpu_torch import ConformerScorer

    real = ConformerScorer.score

    def score(self, positions, **kw):
        if fault == "half":
            half = len(positions) // 2
            e = real(self, positions[:half], **kw)["energy"]
            return dict(energy=torch.cat([e, e.mean().expand(
                len(positions) - half)]))
        res = real(self, positions, **kw)
        res["energy"] = res["energy"].clone()
        res["energy"][0] *= 1.01
        return res

    checkout.add_cell("t-score", "1li2", "score16_closed",
                      limits("1li2-score16"), None,
                      dict(poses_per_call=4, check_calls=1, slice_calls=1))
    if fault:
        monkeypatch.setattr(ConformerScorer, "score", score)
    out = checkout.run("t-score", seconds=0.2, monkeypatch=monkeypatch)
    assert out["correct"] is (fault is None), out["checks"]
