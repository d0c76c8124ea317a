"""The port's 4 fs production protocol against the benchmark's plain
reference (portbench/reference/agbnp_mts.py), float64, on the CPU.

The reference is written apart from the port and imports nothing of it:
AGBNP1 + OPLS by autograd (reference/agbnp.py) split into the r-RESPA
slow class (AGBNP1, LJ + Coulomb within the cut-off) and fast class
(bonds, angles, dihedrals, 1-4 pairs), the DMS file's X-H constraints
read by its own reader and held by plain pairwise SHAKE and RATTLE
iterated to 1e-12, and the middle-scheme r-RESPA Langevin step.  The
port is `Simulation.force_fn(split=True)` (the analytic AGBNP1 forces
with the fused MM sum, the bonded and 1-4 terms) and
`Simulation(constraints=True).run_md(dt=0.004, mts_inner=2)` (the
star-cluster Newton SHAKE and the block RATTLE).  Held on a slice of
1li2, its first 118 atoms and their hydrogens (251 atoms, 136 of its
665 X-H constraints), at seeded jittered positions (1 nm cut-off, MM),
and over 8 outer steps fed the reference's noise, in one rebuild window
and with a rebuild every step.
The reference in bfloat16, the benchmark's control, must read far
outside every tolerance.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.utils import profiling as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from reference.agbnp_mts import MTSSystem, mts_langevin, \
    read_constraints  # noqa: E402
from reference.dms import read_dms  # noqa: E402
from test_torch_agbnp2_reference import rel  # noqa: E402

torch.set_num_threads(2)

DMS = os.path.join(ROOT, "portbench", "data", "1li2_agbnp1.dms")
HEAVY = 118  # the slice: the first HEAVY atoms and their hydrogens
# relative energy: the same float64 terms summed in other orders
ENERGY = 1e-10
# of max|f|: the port's analytic slow forces and its bonded terms against
# the reference's autograd, in float64
FORCE = 1e-10
DT, TEMPERATURE, FRICTION, INNER, STEPS = 0.004, 300.0, 1.0, 2, 8
# the port against the reference after STEPS outer steps (32 fs): (rebuild
# window, max|x - x_ref| nm, velocities and energies relative).  A window
# a step: the same float64 terms summed in other orders, the port's four
# Newton sweeps and block RATTLE against the reference's pairwise
# iterations to 1e-12 (seen: 4.9e-14 nm, 5.9e-13, 7.9e-15).  One 8-step
# window: the port holds the window's tree and neighbor list from its
# start while the reference builds its tree afresh every step, which
# moves the slow force by what the tree's rows drift in 32 fs (seen:
# 9.8e-8 nm, 3.4e-6, 6.9e-8; 1.0e-15 in energy at the window's start)
WINDOWS = [(1, 1e-12, 1e-10, 1e-12), (STEPS, 1e-6, 1e-4, 1e-6)]
# the largest relative X-H distance error at the end (seen: 2.3e-15)
VIOLATION = 1e-10


def _keep(idx):
    """The slice's atoms, sorted: 0..HEAVY-1 and the hydrogens the X-H
    constraint table binds to them."""
    return np.unique(np.concatenate([np.arange(HEAVY),
                                     idx[idx[:, 0] < HEAVY, 1]]))


def _rows(idx, keep, n):
    """Which rows of idx lie in keep, and idx renumbered into it."""
    new = np.full(n, -1, np.int64)
    new[keep] = np.arange(keep.size)
    inside = (new[idx] >= 0).all(axis=1)
    return inside, new[idx[inside]]


def _sub_sysd(s, keep):
    """read_dms's dict of the atoms keep: the terms among them."""
    n = s["n"]
    out = {k: (v[keep] if isinstance(v, np.ndarray) and v.shape[:1] == (n,)
               else v) for k, v in s.items()}
    out["n"] = keep.size
    for pre in ("bond", "angle", "dihedral", "pair"):
        inside, idx = _rows(s[pre + "_idx"], keep, n)
        for k in s:
            if k.startswith(pre + "_"):
                out[k] = s[k][inside]
        out[pre + "_idx"] = idx
    out["exclusions"] = _rows(s["exclusions"], keep, n)[1]
    return out


def _sub_dms(d, keep):
    """load_dms's system of the atoms keep: the terms among them."""
    n = d.positions.shape[0]
    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if not f.name.endswith("_idx") and v.shape[:1] == (n,):
            kw[f.name] = v[keep]
    for pre in ("bond", "angle", "dihedral", "pair", "constraint"):
        inside, idx = _rows(getattr(d, pre + "_idx"), keep, n)
        for f in dataclasses.fields(d):
            if f.name.startswith(pre + "_"):
                kw[f.name] = getattr(d, f.name)[inside]
        kw[pre + "_idx"] = idx
    kw["exclusions"] = _rows(d.exclusions, keep, n)[1]
    return dataclasses.replace(d, **kw)


@pytest.fixture(scope="module")
def systems():
    idx, dist = read_constraints(DMS)
    keep = _keep(idx)
    inside, sub_idx = _rows(idx, keep, read_dms(DMS)["n"])
    cons = (sub_idx, dist[inside])
    sysd = _sub_sysd(read_dms(DMS), keep)
    ref = MTSSystem(sysd, "cpu", torch.float64, 1.0, 1.0, True, cons)
    sim = Simulation(_sub_dms(load_dms(DMS), keep), device="cpu",
                     version=1, cutoff=1.0, dtype=torch.float64, skin=0.25,
                     descreen_horizon="cutoff", constraints=True)
    assert sim.constraints.clusters is not None
    assert sim.constraints.n_constraints == sub_idx.shape[0] == 136
    return sysd, ref, sim, cons


def _jittered(sysd, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(sysd["positions"]
                           + rng.normal(0.0, 0.005, (sysd["n"], 3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_forces(systems, seed):
    """force_fn(split=True)'s slow class (AGBNP1 and the fused MM
    nonbonded sum) and fast class (bonds, angles, dihedrals, 1-4 pairs)
    are the reference's, and add up to the whole force."""
    sysd, ref, sim, _ = systems
    x = _jittered(sysd, seed)
    slow, fast = sim.force_fn(split=True)
    e_slow, f_slow, _ = slow(x)
    e_fast, f_fast = fast(x)
    es_ref, fs_ref = ref.slow_forces(x)
    ef_ref, ff_ref = ref.fast_forces(x)
    assert rel(float(e_slow), float(es_ref)) <= ENERGY
    assert rel(float(e_fast), float(ef_ref)) <= ENERGY
    assert rel(f_slow, fs_ref) <= FORCE and rel(f_fast, ff_ref) <= FORCE
    # the two classes make the whole: the reference's, and the port's
    e, f = ref.energy_forces(x)
    assert rel(float(es_ref + ef_ref), float(e)) <= ENERGY
    assert rel(fs_ref + ff_ref, f) <= FORCE
    e_port, f_port, _ = sim.force_fn()(x)
    assert rel(float(e_slow + e_fast), float(e_port)) <= ENERGY
    assert rel(f_slow + f_fast, f_port) <= FORCE
    # a fast class worth splitting: stiffer than the slow one
    assert float(ff_ref.abs().max()) > float(fs_ref.abs().max())


def _noise(n, seed):
    """The draws the port takes from a generator seeded `seed`: one
    [n, 3] a substep, grouped by outer step."""
    gen = torch.Generator().manual_seed(seed)
    return [[torch.randn((n, 3), generator=gen, dtype=torch.float64)
             for _ in range(INNER)] for _ in range(STEPS)]


@pytest.mark.parametrize("every,pos_nm,vel_rel,energy_rel", WINDOWS)
def test_mts_window_fed_the_reference_noise(systems, every, pos_nm,
                                            vel_rel, energy_rel):
    """run_md(dt=0.004, mts_inner=2) with the X-H constraints over 8 outer
    steps in rebuild windows of `every` against the reference's r-RESPA
    step on the same draws: positions, velocities and energies within
    the windows' tolerance (WINDOWS), the constraints held to VIOLATION
    at the end, an md.step span an outer step, two md.mts_substep
    counters and two SHAKE calls of the star path's sweeps."""
    sysd, ref, sim, _ = systems
    x0 = torch.as_tensor(sysd["positions"])
    v0 = torch.as_tensor(sysd["velocities"])
    xr, vr, er = mts_langevin(ref, x0, v0, sysd["masses"],
                              _noise(sysd["n"], 5), DT, TEMPERATURE,
                              FRICTION, INNER)
    PR.reset()
    with PR.record():
        out = sim.run_md(STEPS, dt=DT, temperature=TEMPERATURE,
                         friction=FRICTION, neighbor_every=every,
                         mts_inner=INNER, pos=x0, vel=v0,
                         generator=torch.Generator().manual_seed(5))
    rec = PR.recorded()
    PR.reset()

    def count(name):
        return sum(c["n"] for c in rec["counts"] if c["name"] == name)

    assert out["regrows"] == 0
    assert sum(s["name"] == "md.step" for s in rec["spans"]) == STEPS
    assert count("md.mts_substep") == INNER * STEPS
    assert count("constraints.shake_sweeps") == \
        INNER * STEPS * sim.constraints.sweeps
    assert rel(out["energies"][0], er[0]) <= ENERGY
    assert rel(out["energies"], np.asarray(er)) <= energy_rel
    assert float(torch.abs(out["final_pos"] - xr).max()) <= pos_nm
    assert rel(out["final_vel"], vr) <= vel_rel
    assert float(sim.constraints.max_violation(out["final_pos"])) \
        <= VIOLATION
    assert ref.constraint_error(out["final_pos"]) <= VIOLATION
    assert ref.constraint_error(xr) <= 1e-11
    # the substeps and the constraints matter: one substep of 4 fs, and
    # the same window unconstrained, are far off
    xs, vs, _ = mts_langevin(ref, x0, v0, sysd["masses"],
                             [d[:1] for d in _noise(sysd["n"], 5)], DT,
                             TEMPERATURE, FRICTION, 1)
    assert rel(vs, vr) > 1e3 * rel(out["final_vel"], vr)
    assert ref.constraint_error(x0) < 1e-3


def test_bfloat16_reference_reads_far_off(systems):
    """The benchmark's control, the reference in bfloat16, is far outside
    the tolerances the port meets: both force classes, the window's
    positions, velocities and constraints."""
    sysd, ref, _, cons = systems
    control = MTSSystem(sysd, "cpu", torch.bfloat16, 1.0, 1.0, True, cons)
    x = _jittered(sysd, 0)
    es_ref, fs_ref = ref.slow_forces(x)
    ef_ref, ff_ref = ref.fast_forces(x)
    es, fs = control.slow_forces(x)
    ef, ff = control.fast_forces(x)
    assert rel(float(es), float(es_ref)) > 1e4 * ENERGY
    assert rel(fs.double(), fs_ref) > 1e4 * FORCE
    assert rel(ff.double(), ff_ref) > 1e4 * FORCE
    x0 = torch.as_tensor(sysd["positions"])
    v0 = torch.as_tensor(sysd["velocities"])
    noise = _noise(sysd["n"], 5)[:2]
    args = (sysd["masses"], noise, DT, TEMPERATURE, FRICTION, INNER)
    xr, vr, _ = mts_langevin(ref, x0, v0, *args)
    xc, vc, _ = mts_langevin(control, x0, v0, *args)
    assert float(torch.abs(xc.double() - xr).max()) > 1e4 * WINDOWS[1][1]
    assert rel(vc.double(), vr) > 1e4 * WINDOWS[1][2]
    assert ref.constraint_error(xc) > 1e3 * VIOLATION
