"""The JAX suite's parity cases that had no twin in the port, on the CPU.

The reference's two secondary fixtures (tests/test_fixtures_extra.py):
gaussvol.xyz (136 atoms, all heavy) through the port's loader, its f64
oracle against the port's AGBNPModel (versions 0 and 1, converged by the
PanicButton loop from the positions-free capacities), and agbnpGBSA.dat,
the heavy-atom slice of gaussvol.dat with pre-inflated radii, whose
GaussVol energy is the full fixture's 872.514.  Then io/dms.py::save_dms
round trip on trp-cage (tests/test_md.py) and the translation invariance
of the AGBNP1 model on the 264-atom fixture (tests/test_jax_pipeline.py).
The bars are the JAX suite's.
"""

import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io import gaussvol_dat as jax_io
from openmm_agbnp_plugin_tpu_torch import AGBNPModel
from openmm_agbnp_plugin_tpu_torch.io.gaussvol_dat import (
    load_agbnp_gbsa_dat, load_gaussvol_dat, load_gaussvol_xyz)
from openmm_agbnp_plugin_tpu_torch.models.constants import \
    AGBNP_RADIUS_INCREMENT
from openmm_agbnp_plugin_tpu_torch.models.oracle import (
    AGBNPParams, agbnp1_energy_forces, gvolsa_energy_forces)

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data")


def _converged(model, pos):
    """energy_forces with the PanicButton loop: the heavy-only molecule has
    the full fixture's overlap tree in fewer atoms, so the positions-free
    capacities undersize and the first evaluations overflow."""
    for _ in range(8):
        e, f, out = model.energy_forces(pos, with_details=True)
        if not model.check_and_grow(out["diag"]):
            return float(e), f.numpy()
    raise RuntimeError("capacities failed to converge")


@pytest.fixture(scope="module")
def xyz_system(fixture_dir):
    elements, pos, radius, charge, gamma, alpha, ish = load_gaussvol_xyz(
        os.path.join(fixture_dir, "gaussvol.xyz"))
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    return elements, params, pos


def test_gaussvol_xyz_loader(xyz_system, fixture_dir):
    """136 heavy atoms in C, N, O, S; Angstrom -> nm and kcal -> kJ as the
    stdin reader; every array bitwise the JAX package's loader's."""
    elements, params, pos = xyz_system
    assert params.n == 136
    assert (params.ishydrogen == 0).all()
    assert set(elements) <= {"C", "N", "O", "S"}
    assert pos.max() < 3.0 and params.radius.max() < 0.25
    ref = jax_io.load_gaussvol_xyz(os.path.join(fixture_dir, "gaussvol.xyz"))
    got = load_gaussvol_xyz(os.path.join(fixture_dir, "gaussvol.xyz"))
    assert list(got[0]) == list(ref[0])
    for x, y in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(x, y)


def test_gaussvol_xyz_oracle_vs_model(xyz_system):
    """The port's f64 oracle against its AGBNPModel on the heavy-only
    fixture, GVolSA (v0, the full fixture's 872.514: hydrogens carry
    neither gamma nor volume) and AGBNP1 (v1), and a finite-difference
    check of the v1 forces."""
    _, params, pos = xyz_system
    e0_o, f0_o, _ = gvolsa_energy_forces(params, pos)
    assert e0_o == pytest.approx(872.514, abs=1e-3)
    e0, f0 = _converged(AGBNPModel(params, device="cpu", version=0), pos)
    assert e0 == pytest.approx(e0_o, abs=1e-8)
    np.testing.assert_allclose(f0, f0_o, atol=1e-9)

    e1_o, f1_o = agbnp1_energy_forces(params, pos)
    m1 = AGBNPModel(params, device="cpu", version=1)
    e1, f1 = _converged(m1, pos)
    assert e1 == pytest.approx(e1_o, abs=1e-7)
    np.testing.assert_allclose(f1, f1_o, atol=1e-8)

    rng = np.random.default_rng(3)
    atom = int(rng.integers(params.n))
    d = rng.uniform(-2e-4, 2e-4, size=3)
    pos2 = pos.copy()
    pos2[atom] += d
    e2, _ = m1.energy_forces(pos2)
    assert float(e2) - e1 == pytest.approx(-np.dot(f1[atom], d), rel=0.05,
                                           abs=1e-6)


def test_agbnp_gbsa_matches_dat_heavy_subset(fixture_dir):
    """agbnpGBSA.dat's ids index gaussvol.dat's heavy atoms, its radii are
    theirs plus the 0.05 nm AGBNP increment, its charges formal; GaussVol
    (v0) on that subset gives the oracle's energy, 872.514."""
    ids, pos_g, radius_large, charge, gamma, probe = load_agbnp_gbsa_dat(
        os.path.join(fixture_dir, "agbnpGBSA.dat"))
    pos_d, radius_d, charge_d, gamma_d, alpha_d, ish_d = load_gaussvol_dat(
        os.path.join(fixture_dir, "gaussvol.dat"))
    assert len(ids) == 136
    assert (ish_d[ids] == 0).all()
    np.testing.assert_allclose(pos_g, pos_d[ids], atol=1e-9)
    np.testing.assert_allclose(radius_large,
                               radius_d[ids] + AGBNP_RADIUS_INCREMENT,
                               atol=1e-6)
    assert set(np.round(charge, 3)) <= {-1.001, 0.001, 1.001}

    params = AGBNPParams(radius=radius_d[ids], gamma=gamma_d[ids],
                         alpha=alpha_d[ids], charge=charge_d[ids],
                         ishydrogen=ish_d[ids])
    e_o, f_o, _ = gvolsa_energy_forces(params, pos_g)
    assert e_o == pytest.approx(872.514, abs=1e-3)
    e, f = _converged(AGBNPModel(params, device="cpu", version=0), pos_g)
    assert e == pytest.approx(e_o, abs=1e-8)
    np.testing.assert_allclose(f, f_o, atol=1e-9)


def test_dms_save_roundtrip(tmp_path):
    """save_dms writes new positions and velocities into a copy of
    trp-cage's .dms that load_dms reads back (1e-12)."""
    from openmm_agbnp_plugin_tpu_torch.io.dms import load_dms, save_dms

    src = os.path.join(DATA, "trpcage_agbnp1.dms")
    dst = str(tmp_path / "out.dms")
    dms = load_dms(src)
    newpos = dms.positions + 0.123
    newvel = dms.velocities + 0.456
    save_dms(src, dst, newpos, newvel)
    dms2 = load_dms(dst)
    np.testing.assert_allclose(dms2.positions, newpos, atol=1e-12)
    np.testing.assert_allclose(dms2.velocities, newvel, atol=1e-12)
    np.testing.assert_array_equal(dms2.charges, dms.charges)


def test_translation_invariance(gaussvol_system):
    """AGBNP1 on the 264-atom fixture: the energy of a translated copy
    within 1e-8 kJ/mol, the net force below 1e-8."""
    params, pos = gaussvol_system
    m = AGBNPModel(params, device="cpu", version=1)
    e, f, out = m.energy_forces(pos, with_details=True)
    assert not m.check_and_grow(out["diag"])
    e2, f2 = m.energy_forces(pos + np.array([1.0, -2.0, 0.5]))
    assert float(e2) == pytest.approx(float(e), abs=1e-8)
    assert np.abs(f2.numpy().sum(0)).max() < 1e-8
