"""The 4 fs production protocol on reference/agbnp.py's System, any dtype:
r-RESPA with the force split into a slow and a fast class, and X-H bond
constraints held by SHAKE and RATTLE.

The split (r-RESPA: Tuckerman, Berne & Martyna, J. Chem. Phys. 97, 1990
(1992)), each class minus the gradient of its energy by autograd:

* slow: AGBNP1 (every term of reference/agbnp.py) and the LJ + Coulomb
  sum over the pairs within the cutoff that are not excluded;
* fast: the harmonic bonds and angles, the dihedral series and the 1-4
  pair table.

The two energies add up to System.energy.

The constraints are the DMS file's X-H tables (constraint_ah1..3: one
heavy atom and 1 to 3 hydrogens at fixed distances), read here by the
benchmark's own reader (Angstrom to nm), the tables that upstream applies
through DesmondDMSFile.createSystem.  SHAKE (Ryckaert, Ciccotti &
Berendsen, J. Comput. Phys. 23, 327 (1977)) is the plain pairwise
iteration against the bond vectors before the drift: each constraint in
turn moves its two atoms along its old bond vector, mass-weighted, to
close its error in |r|^2, sweeping until every relative distance error
|r^2 - d^2| / (2 d^2) is within 1e-12.  The constraints are taken in
sets in which no atom appears twice, so that one set is one vectorised
update and the sweep is the sequential one.  RATTLE (Andersen, J.
Comput. Phys. 52, 24 (1983)) iterates likewise on the velocities until
each bond's relative velocity has no component along the bond above
1e-12 of its size.  A sweep whose SHAKE would divide by a bond turned
perpendicular to its old one takes the current length instead (d^2).
Both stop after MAX_SWEEPS sweeps where a lower dtype cannot reach the
tolerance.

The step (mts_langevin) is the middle-scheme Langevin r-RESPA step, from
x and v with one standard-normal draw per substep:

    v <- v + dt F_slow(x) / m;  RATTLE
    `inner` times, delta = dt / inner, a = exp(-friction delta):
      v <- v + delta F_fast(x) / m;  RATTLE
      x0 <- x;  x <- x + delta/2 v
      v <- a v + sqrt(1 - a^2) sqrt(kT/m) xi
      x <- x + delta/2 v
      x' <- SHAKE(x, against x0);  v <- v + (x' - x) / delta;  x <- x'

and its energy is the slow energy plus the fast energy at the step's
start.  Departures from OpenMM's MTSLangevinIntegrator with
constraints=HBonds: the slow kick is one impulse of dt at the step's
start, not two half kicks of dt/2 around the substeps; the O-step's
noise is drawn in every substep (as OpenMM does) but handed in by the
caller; the constraints are SHAKE and RATTLE iterated to 1e-12, where
OpenMM applies its own constraint algorithms (CCMA, SETTLE) to the
integrator's tolerance, and RATTLE follows every kick where OpenMM
projects the velocities once a substep.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math
import os
import sqlite3

import numpy as np
import torch

from .agbnp import COULOMB, System
from .dms import ANG
from .langevin import KB

TOLERANCE = 1e-12   # relative, of SHAKE's distances and RATTLE's rates
MAX_SWEEPS = 200    # a lower dtype's SHAKE and RATTLE stop here


def read_constraints(path: str):
    """The X-H constraints of the DMS file at path: (idx [nc, 2] int64 of
    (heavy, hydrogen), d [nc] nm) from its constraint_ah1..3 tables."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    idx, dist = [], []
    con = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        cur = con.cursor()
        for k in (1, 2, 3):
            cols = ", ".join(f"t.p{i}" for i in range(k + 1))
            lens = ", ".join(f"p.r{i + 1}" for i in range(k))
            try:
                rows = cur.execute(
                    f"SELECT {cols}, {lens} FROM constraint_ah{k}_term t "
                    f"JOIN constraint_ah{k}_param p ON t.param = p.id"
                ).fetchall()
            except sqlite3.OperationalError:
                rows = []
            for row in rows:
                for j in range(k):
                    idx.append((int(row[0]), int(row[1 + j])))
                    dist.append(row[1 + k + j] * ANG)
    finally:
        con.close()
    return np.array(idx, np.int64).reshape(-1, 2), np.array(dist, np.float64)


def _disjoint_sets(idx):
    """The rows of idx in sets in which no atom appears twice (greedy)."""
    sets = []
    for k, (a, b) in enumerate(idx.tolist()):
        for rows, atoms in sets:
            if a not in atoms and b not in atoms:
                rows.append(k)
                atoms.update((a, b))
                break
        else:
            sets.append(([k], {a, b}))
    return [np.array(rows, np.int64) for rows, _ in sets]


class MTSSystem(System):
    """System with the r-RESPA split and the X-H constraints of
    read_constraints (constraints=(idx, d))."""

    def __init__(self, sysd, device, dtype=torch.float64, cutoff=None,
                 horizon=None, include_mm=True, constraints=None):
        super().__init__(sysd, device, dtype, cutoff, horizon, include_mm)
        idx, d = constraints
        inv_m = 1.0 / np.asarray(sysd["masses"], np.float64)
        self.cons = []
        for rows in _disjoint_sets(idx):
            a, b = idx[rows, 0], idx[rows, 1]
            self.cons.append(tuple(
                torch.as_tensor(x, device=self.device,
                                dtype=torch.int64 if x.dtype.kind == "i"
                                else dtype)
                for x in (a, b, d[rows], inv_m[a], inv_m[b])))
        self.cons_all = tuple(torch.as_tensor(x, device=self.device)
                              for x in (idx[:, 0], idx[:, 1], d))

    # -- the split ---------------------------------------------------------

    def slow_energy(self, pos):
        """AGBNP1 and the LJ + Coulomb sum within the cutoff."""
        levels = self.topology(pos.detach())
        pi, pj, d, inside = self._pairs(pos)
        e = self.agbnp_energy(pos, levels, pi, pj, d, inside)
        m = inside["mm"]
        a, b, dd = pi[m], pj[m], d[m]
        sr6 = (self.sigma[a] * self.sigma[b] / (dd * dd)) ** 3
        eps = self.sqrt_eps[a] * self.sqrt_eps[b]
        return e + torch.sum(4.0 * eps * (sr6 * sr6 - sr6)
                             + COULOMB * self.charge[a] * self.charge[b] / dd)

    def fast_energy(self, pos):
        """Bonds, angles, dihedrals and the 1-4 pairs: mm_energy over no
        nonbonded pair."""
        none = torch.zeros(0, dtype=torch.int64, device=pos.device)
        return self.mm_energy(pos, none, none, pos.new_zeros(0),
                              {"mm": torch.zeros(0, dtype=torch.bool,
                                                 device=pos.device)})

    def _forces(self, energy, pos):
        with torch.enable_grad():
            x = pos.detach().to(self.dtype).requires_grad_(True)
            e = energy(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g

    def slow_forces(self, pos):
        """(slow energy, slow force) at pos [N, 3]."""
        return self._forces(self.slow_energy, pos)

    def fast_forces(self, pos):
        """(fast energy, fast force) at pos [N, 3]."""
        return self._forces(self.fast_energy, pos)

    # -- the constraints ---------------------------------------------------

    def shake(self, x, x_ref):
        """x moved onto the constraints along the bond vectors of x_ref
        (the positions before the drift)."""
        for _ in range(MAX_SWEEPS):
            worst = 0.0
            for a, b, d, ima, imb in self.cons:
                r = x[a] - x[b]
                rref = x_ref[a] - x_ref[b]
                d2 = d * d
                diff = torch.sum(r * r, dim=-1) - d2
                worst = max(worst, float(torch.max(torch.abs(diff) / d2)))
                rr = torch.sum(r * rref, dim=-1)
                rr = torch.where(torch.abs(rr) > 1e-12 * d2, rr, d2)
                g = (diff / (2.0 * (ima + imb) * rr))[:, None] * rref
                x = x.index_add(0, a, -ima[:, None] * g)
                x = x.index_add(0, b, imb[:, None] * g)
            if not 0.5 * worst > TOLERANCE:
                break
        return x

    def rattle(self, x, v):
        """v without a component of any bond's relative velocity along
        the bond (x constrained)."""
        for _ in range(MAX_SWEEPS):
            worst = 0.0
            for a, b, _, ima, imb in self.cons:
                r = x[a] - x[b]
                rv = torch.sum(r * (v[a] - v[b]), dim=-1)
                rr = torch.sum(r * r, dim=-1)
                size = torch.sqrt(rr) * torch.linalg.vector_norm(
                    v[a] - v[b], dim=-1)
                worst = max(worst, float(torch.max(
                    torch.abs(rv) / torch.clamp(size, min=1e-30))))
                k = (rv / ((ima + imb) * rr))[:, None] * r
                v = v.index_add(0, a, -ima[:, None] * k)
                v = v.index_add(0, b, imb[:, None] * k)
            if not worst > TOLERANCE:
                break
        return v

    def constraint_error(self, x):
        """The largest relative distance error |(|r| - d)| / d of the
        constraints at x, in float64."""
        a, b, d = self.cons_all
        x = x.to(torch.float64)
        r = torch.linalg.vector_norm(x[a] - x[b], dim=-1)
        return float(torch.max(torch.abs(r - d) / d))


def mts_langevin(system, pos, vel, masses, noise, dt, temperature, friction,
                 inner):
    """Outer steps from (pos, vel), one for each entry of noise (inner
    standard-normal draws [N, 3] each), in the system's dtype (an
    MTSSystem): the module's r-RESPA middle step with SHAKE and RATTLE.
    Returns (pos, vel, energies): the energy at the start of each outer
    step."""
    dtype = system.dtype
    pos, vel = pos.to(dtype), vel.to(dtype)
    inv_m = (1.0 / torch.as_tensor(masses, dtype=torch.float64,
                                   device=pos.device))[:, None]
    sigma = torch.sqrt(KB * temperature * inv_m).to(dtype)
    inv_m = inv_m.to(dtype)
    delta = dt / inner
    a = math.exp(-friction * delta)
    b = math.sqrt(1.0 - a * a)
    energies = []
    for draws in noise:
        e_slow, f_slow = system.slow_forces(pos)
        vel = system.rattle(pos, vel + dt * f_slow * inv_m)
        e_fast0 = None
        for i in range(inner):
            e_fast, f_fast = system.fast_forces(pos)
            e_fast0 = e_fast if e_fast0 is None else e_fast0
            vel = system.rattle(pos, vel + delta * f_fast * inv_m)
            pos0 = pos
            pos = pos + 0.5 * delta * vel
            vel = a * vel + b * sigma * draws[i].to(dtype)
            pos = pos + 0.5 * delta * vel
            posc = system.shake(pos, pos0)
            vel = vel + (posc - pos) / delta
            pos = posc
        energies.append(float(e_slow + e_fast0))
    return pos, vel, energies
