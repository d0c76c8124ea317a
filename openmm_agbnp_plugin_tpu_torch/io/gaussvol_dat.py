"""Parser for the reference test fixture format (gaussvol.dat).

Format (reference platforms/reference/tests/TestReferenceAGBNPForce.cpp:45-71):
first line is the atom count, then one line per atom:
    id  x  y  z  radius  charge  gamma  ishydrogen
with coordinates/radius in Angstrom and gamma in kcal/mol/A^2.  The test
program converts to nm / kJ/mol and derives the dispersion alpha parameter
from TIP4P-water LJ combination rules; we reproduce that here so the fixture
yields exactly the particle table the reference golden numbers were computed
from.
"""

from __future__ import annotations

import math

import numpy as np

ANG2NM = 0.1
KCAL2KJ = 4.184

# TIP4P water oxygen LJ parameters and water number density
# (reference TestReferenceAGBNPForce.cpp:51-54)
SIGMA_W = 3.15365 * ANG2NM
EPSILON_W = 0.155 * KCAL2KJ
RHO_W = 0.033428 / ANG2NM ** 3
EPSILON_LJ = 0.155 * KCAL2KJ


def tip4p_alpha(radius_nm: np.ndarray) -> np.ndarray:
    """Dispersion alpha from TIP4P LJ combination rules.

    alpha = -16 pi rho sqrt(eps_w eps_LJ) sqrt(sigma_w * 2r)^6 / 3
    (reference TestReferenceAGBNPForce.cpp:65-68).
    """
    sigma_lj = 2.0 * radius_nm
    sij = np.sqrt(SIGMA_W * sigma_lj)
    eij = math.sqrt(EPSILON_W * EPSILON_LJ)
    return -16.0 * math.pi * RHO_W * eij * sij ** 6 / 3.0


def load_gaussvol_dat(path: str):
    """Returns (positions_nm [N,3], radius_nm, charge, gamma_kj, alpha, ishydrogen)."""
    with open(path) as f:
        tokens = f.read().split()
    natoms = int(tokens[0])
    data = np.array(tokens[1:], dtype=np.float64).reshape(natoms, 8)
    pos = data[:, 1:4] * ANG2NM
    radius = data[:, 4] * ANG2NM
    charge = data[:, 5]
    gamma = data[:, 6] * KCAL2KJ / ANG2NM ** 2
    ish = data[:, 7].astype(np.int64)
    alpha = tip4p_alpha(radius)
    return pos, radius, charge, gamma, alpha, ish


def load_gaussvol_xyz(path: str):
    """Parser for the reference's heavy-atom fixture gaussvol.xyz
    (reference platforms/reference/tests/gaussvol.xyz): first line is the
    atom count, then one line per atom
        element  x  y  z  radius  charge  gamma  ishydrogen
    — the gaussvol.dat columns with an element symbol in place of the id.
    All 136 atoms are heavy (ishydrogen == 0 throughout), which exercises
    the H-masking paths from the no-hydrogens side.  Units and the derived
    TIP4P dispersion alpha follow the same conversion the stdin test
    applies (TestReferenceAGBNPForce.cpp:45-71).

    Returns (elements [N] str, positions_nm [N,3], radius_nm, charge,
    gamma_kj, alpha, ishydrogen)."""
    with open(path) as f:
        lines = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    natoms = int(lines[0][0])
    rows = lines[1:1 + natoms]
    if len(rows) != natoms:
        raise ValueError(f"{path}: expected {natoms} atoms, got {len(rows)}")
    elements = np.array([r[0] for r in rows])
    data = np.array([r[1:8] for r in rows], dtype=np.float64)
    pos = data[:, 0:3] * ANG2NM
    radius = data[:, 3] * ANG2NM
    charge = data[:, 4]
    gamma = data[:, 5] * KCAL2KJ / ANG2NM ** 2
    ish = data[:, 6].astype(np.int64)
    alpha = tip4p_alpha(radius)
    return elements, pos, radius, charge, gamma, alpha, ish


def load_agbnp_gbsa_dat(path: str):
    """Parser for the reference's heavy-atom GBSA fixture agbnpGBSA.dat
    (reference platforms/reference/tests/agbnpGBSA.dat): first line is the
    atom count, then one line per atom
        id  x  y  z  radius_large  charge  gamma  sigma  sigma  probe
    with the id referring to the atom's row in gaussvol.dat, radius_large
    already inflated by the 0.5 A AGBNP radius increment (AGBNPForce.h:17),
    integer formal charges offset by +0.001, and constant
    gamma/sigma/probe columns (0.066 kcal/mol/A^2, 3.5 A, 0.1).

    Returns (ids [N] int, positions_nm [N,3], radius_large_nm, charge,
    gamma_kj, probe_nm)."""
    with open(path) as f:
        tokens = f.read().split()
    natoms = int(tokens[0])
    data = np.array(tokens[1:], dtype=np.float64).reshape(natoms, 10)
    ids = data[:, 0].astype(np.int64)
    pos = data[:, 1:4] * ANG2NM
    radius_large = data[:, 4] * ANG2NM
    charge = data[:, 5]
    gamma = data[:, 6] * KCAL2KJ / ANG2NM ** 2
    probe = data[:, 9] * ANG2NM
    return ids, pos, radius_large, charge, gamma, probe
