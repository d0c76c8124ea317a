"""The benchmark's reference against the program's float64 CPU path on
1li2: the reference was written apart from the program, so agreement to
rounding shows that both compute the plugin's energy."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from conftest import BENCH

from reference.agbnp import System
from reference.dms import read_dms
from reference.langevin import langevin

DMS = os.path.join(BENCH, "data", "1li2_agbnp1.dms")


@pytest.fixture(scope="module")
def sysd():
    return read_dms(DMS)


def program_sim(**kw):
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    return Simulation(load_dms(DMS), device="cpu", version=1, cutoff=1.0,
                      dtype=torch.float64, skin=0.25, pair_kernel=False, **kw)


def test_dms_reader_matches_the_program(sysd):
    from openmm_agbnp_plugin_tpu_torch import load_dms

    d = load_dms(DMS)
    assert sysd["n"] == 1310
    np.testing.assert_array_equal(sysd["positions"], d.positions)
    np.testing.assert_array_equal(sysd["velocities"], d.velocities)
    np.testing.assert_array_equal(sysd["radius"], d.agbnp_radius)
    np.testing.assert_array_equal(sysd["hydrogen"], d.ishydrogen == 1)
    np.testing.assert_array_equal(sysd["exclusions"], d.exclusions)
    np.testing.assert_allclose(sysd["dihedral_fc"], d.dihedral_fc,
                               rtol=1e-15)


@pytest.mark.parametrize("cutoff,horizon", [(None, None), (1.0, None),
                                            (1.0, 1.0)])
def test_agbnp_against_the_program(sysd, cutoff, horizon):
    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams

    p = AGBNPParams(radius=sysd["radius"], gamma=sysd["gamma"],
                    alpha=sysd["alpha"], charge=sysd["charge"],
                    ishydrogen=sysd["hydrogen"].astype(int))
    m = AGBNPModel(p, device="cpu", dtype=torch.float64, version=1,
                   cutoff=cutoff, descreen_horizon=horizon,
                   positions=sysd["positions"], pair_kernel=False)
    pos = torch.as_tensor(sysd["positions"])
    e_p, f_p = m.energy_forces(pos)
    ref = System(sysd, "cpu", torch.float64, cutoff, horizon, False)
    e, f = ref.energy_forces(pos)
    assert abs(float(e) - float(e_p)) <= 1e-12 * abs(float(e_p))
    assert float((f - f_p).abs().max()) <= 1e-12 * float(f_p.abs().max())


def test_md_energy_forces_and_langevin_against_the_program(sysd):
    from openmm_agbnp_plugin_tpu_torch.md.integrators import \
        langevin_middle_step

    sim = program_sim(descreen_horizon="cutoff")
    fn = sim.force_fn()
    pos, vel = sim.positions, sim.velocities
    ref = System(sysd, "cpu", torch.float64, 1.0, 1.0, True)
    e, f = ref.energy_forces(pos)
    e_p, f_p, _ = fn(pos)
    assert abs(float(e) - float(e_p)) <= 1e-12 * abs(float(e_p))
    assert float((f - f_p).abs().max()) <= 1e-12 * float(f_p.abs().max())
    gen = torch.Generator().manual_seed(5)
    noise = [torch.randn(pos.shape, generator=gen, dtype=torch.float64)
             for _ in range(3)]
    step = langevin_middle_step(fn, sim.masses, 0.001, 300.0, 1.0)
    x, v = pos, vel
    energies = []
    for xi in noise:
        x, v, e_step, *_ = step(x, v, xi)
        energies.append(float(e_step))
    xr, vr, er = langevin(ref, pos, vel, sysd["masses"], noise, 0.001, 300.0,
                          1.0)
    assert float((xr - x).abs().max()) <= 1e-12
    assert float((vr - v).abs().max()) <= 1e-9
    np.testing.assert_allclose(er, energies, rtol=1e-12)


def test_a_lower_dtype_runs_and_reads_far(sysd):
    """The control: the reference in bfloat16 gives finite numbers far
    from float64's."""
    pos = torch.as_tensor(sysd["positions"])
    e64, f64 = System(sysd, "cpu", torch.float64, 1.0, 1.0,
                      True).energy_forces(pos)
    e16, f16 = System(sysd, "cpu", torch.bfloat16, 1.0, 1.0,
                      True).energy_forces(pos)
    assert torch.isfinite(f16).all() and np.isfinite(float(e16))
    assert abs(float(e16) - float(e64)) > 1e-3 * abs(float(e64))
