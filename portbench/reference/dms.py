"""Read a Desmond DMS (SQLite) file into plain NumPy arrays.

The benchmark's own reader: the reference never sees what the program
loaded.  It reads the tables that define the deployment's energy (the
particle table, the OPLS terms and exclusions, and the per-atom AGBNP
parameters of the `agbnp2` table) and converts Desmond's units (Angstrom,
kcal/mol, degrees) to nm, kJ/mol and radians.
"""

from __future__ import annotations

import os
import sqlite3

import numpy as np

ANG = 0.1
KCAL = 4.184


def _rows(cur, query):
    try:
        return cur.execute(query).fetchall()
    except sqlite3.OperationalError:
        return []


def read_dms(path: str) -> dict:
    """The system in `path` as a dict of NumPy arrays (nm, kJ/mol, ps, e)."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        cur = con.cursor()
        part = np.array(cur.execute(
            "SELECT anum, x, y, z, vx, vy, vz, mass, charge, nbtype "
            "FROM particle ORDER BY id").fetchall(), dtype=np.float64)
        n = part.shape[0]
        nb = {int(t): (s * ANG, e * KCAL) for t, s, e in cur.execute(
            "SELECT id, sigma, epsilon FROM nonbonded_param").fetchall()}
        types = part[:, 9].astype(np.int64)
        ag = np.zeros((n, 3))
        for pid, r, g, a in _rows(cur, "SELECT id, radius, igamma, ialpha "
                                       "FROM agbnp2 ORDER BY id"):
            ag[int(pid)] = (r * ANG, g * KCAL / ANG ** 2, a * KCAL * ANG ** 3)

        def table(query, width):
            return np.array(_rows(cur, query), dtype=np.float64).reshape(
                -1, width)

        bonds = table("SELECT p0, p1, r0, fc FROM stretch_harm_term t JOIN "
                      "stretch_harm_param p ON t.param = p.id", 4)
        angles = table("SELECT p0, p1, p2, theta0, fc FROM angle_harm_term t "
                       "JOIN angle_harm_param p ON t.param = p.id", 5)
        diheds = table("SELECT p0, p1, p2, p3, phi0, fc0, fc1, fc2, fc3, fc4, "
                       "fc5, fc6 FROM dihedral_trig_term t JOIN "
                       "dihedral_trig_param p ON t.param = p.id", 12)
        pairs = table("SELECT p0, p1, aij, bij, qij FROM pair_12_6_es_term t "
                      "JOIN pair_12_6_es_param p ON t.param = p.id", 5)
        excl = np.array(_rows(cur, "SELECT p0, p1 FROM exclusion"),
                        dtype=np.int64).reshape(-1, 2)
    finally:
        con.close()
    return dict(
        n=n,
        positions=part[:, 1:4] * ANG,
        velocities=part[:, 4:7] * ANG,
        masses=part[:, 7],
        charge=part[:, 8],
        hydrogen=part[:, 0].astype(np.int64) == 1,
        sigma=np.array([nb.get(t, (0.0, 0.0))[0] for t in types]),
        epsilon=np.array([nb.get(t, (0.0, 0.0))[1] for t in types]),
        radius=ag[:, 0], gamma=ag[:, 1], alpha=ag[:, 2],
        bond_idx=bonds[:, :2].astype(np.int64), bond_r0=bonds[:, 2] * ANG,
        bond_k=bonds[:, 3] * KCAL / ANG ** 2,
        angle_idx=angles[:, :3].astype(np.int64),
        angle_theta0=np.deg2rad(angles[:, 3]), angle_k=angles[:, 4] * KCAL,
        dihedral_idx=diheds[:, :4].astype(np.int64),
        dihedral_phi0=np.deg2rad(diheds[:, 4]),
        dihedral_fc=diheds[:, 5:12] * KCAL,
        pair_idx=pairs[:, :2].astype(np.int64),
        pair_aij=pairs[:, 2] * KCAL * ANG ** 12,
        pair_bij=pairs[:, 3] * KCAL * ANG ** 6, pair_qij=pairs[:, 4],
        exclusions=excl,
    )
