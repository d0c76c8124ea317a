"""Reader for Desmond DMS (SQLite) molecular systems with AGBNP parameters.

The reference benchmarks load .dms files through a modified OpenMM
DesmondDMSFile with `implicitSolvent='AGBNP'` (reference
example/t4lysozyme_benchmark.py:8-10); the AGBNP per-particle parameters live
in the `agbnp2` SQLite table (radius in Angstrom, igamma in kcal/mol/A^2,
ialpha in kcal/mol*A^3) and hydrogens are identified by atomic number.  This
module reads the same tables directly with sqlite3 — no OpenMM dependency —
and also extracts the bonded/nonbonded force-field terms needed to run the
full MD benchmarks (stretch/angle/dihedral/pair/exclusion + OPLS geometric
combination rules, reference example systems' `nonbonded_info`).

Units out: nm, kJ/mol, ps, atomic charges (e).
"""

from __future__ import annotations

import dataclasses
import sqlite3

import numpy as np

ANG2NM = 0.1
KCAL2KJ = 4.184


@dataclasses.dataclass
class DMSSystem:
    """A molecular system loaded from a .dms file."""

    positions: np.ndarray      # [N,3] nm
    velocities: np.ndarray     # [N,3] nm/ps
    masses: np.ndarray         # [N] amu
    charges: np.ndarray        # [N] e
    anum: np.ndarray           # [N] atomic numbers

    # AGBNP per-particle parameters (addParticle semantics)
    agbnp_radius: np.ndarray   # [N] nm
    agbnp_gamma: np.ndarray    # [N] kJ/mol/nm^2
    agbnp_alpha: np.ndarray    # [N] kJ/mol nm^3
    ishydrogen: np.ndarray     # [N] int

    # bonded force field
    bond_idx: np.ndarray       # [nb,2] int
    bond_r0: np.ndarray        # [nb] nm
    bond_k: np.ndarray         # [nb] kJ/mol/nm^2 (OpenMM convention: E=k(r-r0)^2)
    angle_idx: np.ndarray      # [na,3]
    angle_theta0: np.ndarray   # [na] rad
    angle_k: np.ndarray        # [na] kJ/mol/rad^2 (E=k(th-th0)^2)
    dihedral_idx: np.ndarray   # [nd,4]
    dihedral_phi0: np.ndarray  # [nd] rad
    dihedral_fc: np.ndarray    # [nd,7] kJ/mol (fc0..fc6 trig series)

    # nonbonded
    lj_sigma: np.ndarray       # [N] nm
    lj_epsilon: np.ndarray     # [N] kJ/mol
    exclusions: np.ndarray     # [ne,2] int (excluded pairs, includes bonds)
    pair_idx: np.ndarray       # [np,2] int (1-4 scaled pairs)
    pair_aij: np.ndarray       # [np] kJ/mol nm^12
    pair_bij: np.ndarray       # [np] kJ/mol nm^6
    pair_qij: np.ndarray       # [np] e^2

    # constraints (from constraint_ah{1,2,3} tables): X-H bond constraints
    constraint_idx: np.ndarray  # [nc,2] int (heavy, hydrogen)
    constraint_d: np.ndarray    # [nc] nm

    @property
    def n(self):
        return self.positions.shape[0]


def _fetch(cur, query, default=None):
    try:
        return cur.execute(query).fetchall()
    except sqlite3.OperationalError:
        return default if default is not None else []


def load_dms(path: str) -> DMSSystem:
    import os

    if not os.path.exists(path):
        # sqlite3.connect would silently create an empty db file
        raise FileNotFoundError(path)
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    cur = con.cursor()

    rows = cur.execute(
        "SELECT id, anum, x, y, z, vx, vy, vz, mass, charge, nbtype "
        "FROM particle ORDER BY id").fetchall()
    n = len(rows)
    arr = np.array([[r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10]]
                    for r in rows], dtype=np.float64)
    anum = arr[:, 0].astype(np.int64)
    positions = arr[:, 1:4] * ANG2NM
    velocities = arr[:, 4:7] * ANG2NM  # A/ps -> nm/ps
    masses = arr[:, 7]
    charges = arr[:, 8]
    nbtype = arr[:, 9].astype(np.int64)

    # AGBNP parameters from the agbnp2 table (one row per particle)
    ag = _fetch(cur, "SELECT id, radius, igamma, ialpha FROM agbnp2 ORDER BY id")
    if not ag:
        ag = _fetch(cur, "SELECT id, radius, igamma, ialpha FROM agbnp1 ORDER BY id")
    agbnp_radius = np.zeros(n)
    agbnp_gamma = np.zeros(n)
    agbnp_alpha = np.zeros(n)
    for pid, radius, igamma, ialpha in ag[:n]:
        pid = int(pid)
        agbnp_radius[pid] = radius * ANG2NM
        agbnp_gamma[pid] = igamma * KCAL2KJ / ANG2NM ** 2
        agbnp_alpha[pid] = ialpha * KCAL2KJ * ANG2NM ** 3
    ishydrogen = (anum == 1).astype(np.int64)

    # bonded terms --------------------------------------------------------
    sh = _fetch(cur, "SELECT p0, p1, r0, fc FROM stretch_harm_term t "
                     "JOIN stretch_harm_param p ON t.param = p.id")
    sh = np.array(sh, dtype=np.float64).reshape(-1, 4)
    bond_idx = sh[:, :2].astype(np.int64)
    bond_r0 = sh[:, 2] * ANG2NM
    # Desmond fc is in kcal/mol/A^2 for E = fc*(r-r0)^2
    bond_k = sh[:, 3] * KCAL2KJ / ANG2NM ** 2

    ah = _fetch(cur, "SELECT p0, p1, p2, theta0, fc FROM angle_harm_term t "
                     "JOIN angle_harm_param p ON t.param = p.id")
    ah = np.array(ah, dtype=np.float64).reshape(-1, 5)
    angle_idx = ah[:, :3].astype(np.int64)
    angle_theta0 = np.deg2rad(ah[:, 3])
    angle_k = ah[:, 4] * KCAL2KJ

    dt = _fetch(cur, "SELECT p0, p1, p2, p3, phi0, fc0, fc1, fc2, fc3, fc4, fc5, fc6 "
                     "FROM dihedral_trig_term t JOIN dihedral_trig_param p ON t.param = p.id")
    dt = np.array(dt, dtype=np.float64).reshape(-1, 12)
    dihedral_idx = dt[:, :4].astype(np.int64)
    dihedral_phi0 = np.deg2rad(dt[:, 4])
    dihedral_fc = dt[:, 5:12] * KCAL2KJ

    # nonbonded -----------------------------------------------------------
    nbp = _fetch(cur, "SELECT id, sigma, epsilon FROM nonbonded_param ORDER BY id")
    sig_by_type = {}
    eps_by_type = {}
    for tid, sigma, epsilon in nbp:
        sig_by_type[int(tid)] = sigma * ANG2NM
        eps_by_type[int(tid)] = epsilon * KCAL2KJ
    lj_sigma = np.array([sig_by_type.get(t, 0.0) for t in nbtype])
    lj_epsilon = np.array([eps_by_type.get(t, 0.0) for t in nbtype])

    ex = _fetch(cur, "SELECT p0, p1 FROM exclusion")
    exclusions = np.array(ex, dtype=np.int64).reshape(-1, 2)

    pr = _fetch(cur, "SELECT p0, p1, aij, bij, qij FROM pair_12_6_es_term t "
                     "JOIN pair_12_6_es_param p ON t.param = p.id")
    pr = np.array(pr, dtype=np.float64).reshape(-1, 5)
    pair_idx = pr[:, :2].astype(np.int64)
    # aij kcal/mol*A^12, bij kcal/mol*A^6, qij e^2
    pair_aij = pr[:, 2] * KCAL2KJ * ANG2NM ** 12
    pair_bij = pr[:, 3] * KCAL2KJ * ANG2NM ** 6
    pair_qij = pr[:, 4]

    # constraints ---------------------------------------------------------
    cons_idx = []
    cons_d = []
    for nh in (1, 2, 3, 4):
        tbl = f"constraint_ah{nh}"
        cols = ", ".join(f"p{i}" for i in range(nh + 1))
        dcols = ", ".join(f"r{i+1}" for i in range(nh))
        got = _fetch(cur, f"SELECT {cols}, {dcols} FROM {tbl}_term t "
                          f"JOIN {tbl}_param p ON t.param = p.id", default=None)
        if not got:
            continue
        for row in got:
            heavy = int(row[0])
            for i in range(nh):
                cons_idx.append((heavy, int(row[1 + i])))
                cons_d.append(row[1 + nh + i] * ANG2NM)
    constraint_idx = np.array(cons_idx, dtype=np.int64).reshape(-1, 2)
    constraint_d = np.array(cons_d, dtype=np.float64)

    con.close()
    return DMSSystem(
        positions=positions, velocities=velocities, masses=masses,
        charges=charges, anum=anum,
        agbnp_radius=agbnp_radius, agbnp_gamma=agbnp_gamma,
        agbnp_alpha=agbnp_alpha, ishydrogen=ishydrogen,
        bond_idx=bond_idx, bond_r0=bond_r0, bond_k=bond_k,
        angle_idx=angle_idx, angle_theta0=angle_theta0, angle_k=angle_k,
        dihedral_idx=dihedral_idx, dihedral_phi0=dihedral_phi0,
        dihedral_fc=dihedral_fc,
        lj_sigma=lj_sigma, lj_epsilon=lj_epsilon,
        exclusions=exclusions, pair_idx=pair_idx,
        pair_aij=pair_aij, pair_bij=pair_bij, pair_qij=pair_qij,
        constraint_idx=constraint_idx, constraint_d=constraint_d,
    )


def save_dms(path_in: str, path_out: str, positions=None, velocities=None):
    """Copy a .dms file and write back positions/velocities (nm, nm/ps).

    The reference benchmarks persist state exactly this way: copy the SQLite
    file and update the particle table (reference
    example/trpcage_benchmark.py:9-43).
    """
    import shutil

    if path_in != path_out:
        shutil.copyfile(path_in, path_out)
    con = sqlite3.connect(path_out)
    cur = con.cursor()
    if positions is not None:
        pos = np.asarray(positions) / ANG2NM
        cur.executemany("UPDATE particle SET x=?, y=?, z=? WHERE id=?",
                        [(float(p[0]), float(p[1]), float(p[2]), i)
                         for i, p in enumerate(pos)])
    if velocities is not None:
        vel = np.asarray(velocities) / ANG2NM
        cur.executemany("UPDATE particle SET vx=?, vy=?, vz=? WHERE id=?",
                        [(float(v[0]), float(v[1]), float(v[2]), i)
                         for i, v in enumerate(vel)])
    con.commit()
    con.close()
