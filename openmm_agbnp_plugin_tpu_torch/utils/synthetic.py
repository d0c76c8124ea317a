"""Large systems on a synthetic protein-like ball (the JAX package's
benchmarks/synthetic_scale.py: its generator, its scaling run and the
harness's synth10k leg, bench.py's 10,240-atom run).

synthetic_system and synthetic_dms are copies of the reference generator
(numpy and scipy only, so the port never imports the JAX package): for the
same natoms and seed their arrays are bitwise the reference's.  run times
AGBNPModel evaluations of the ball (AGBNP1, CutoffNonPeriodic 1 nm, the
cell-grid candidates above 3000 atoms, the tile lists) after its
PanicButton loop.  run_md drives the port's Simulation on the bonded ball
(AGBNP1 + the MM force field, rebuild windows) through
benchmark_langevin and its PanicButton regrow.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

# PanicButton regrows a run_md call may take (the 10,240-atom ball took 4
# on an H100 from its initial sizing: capacities drift up as it heats),
# and the evaluations of run's PanicButton loop (the reference's 8)
MAX_REGROW = 8


def synthetic_system(natoms: int, seed: int = 0):
    """Protein-like synthetic ball: jittered cubic lattice at protein
    density (95 atoms/nm^3) trimmed to a sphere, 60% heavy atoms with
    AGBNP-like radii/charges, common gamma, hydrogens interleaved.  A
    lattice keeps realistic minimum separations (~0.17 nm), which uniform
    placement does not.  Returns (pos, radius, gamma, alpha, charge,
    ishydrogen)."""
    rng = np.random.default_rng(seed)
    density = 95.0  # atoms / nm^3, protein-like
    a = density ** (-1.0 / 3.0)  # ~0.219 nm lattice constant
    m = int(np.ceil((natoms * 6 / np.pi) ** (1.0 / 3.0))) + 2
    g = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1)
         .reshape(-1, 3) - (m - 1) / 2.0) * a
    g = g + rng.uniform(-0.12 * a, 0.12 * a, size=g.shape)
    order = np.argsort(np.linalg.norm(g, axis=1), kind="stable")
    pos = g[order[:natoms]]
    ish = (rng.uniform(size=natoms) < 0.4).astype(np.int64)
    radius = np.where(ish > 0, 0.125,
                      rng.choice([0.15, 0.16, 0.17, 0.19], size=natoms))
    gamma = np.where(ish > 0, 0.0, 48.9528)
    alpha = np.where(ish > 0, -20.0, rng.uniform(-90.0, -40.0, size=natoms))
    charge = rng.uniform(-0.15, 0.15, size=natoms)
    charge -= charge.mean()
    return pos, radius, gamma, alpha, charge, ish


def synthetic_dms(natoms: int):
    """The synthetic ball as a Simulation-ready bonded system (a namespace
    with the DMS fields Simulation reads).  Each atom is bonded to its 3
    nearest neighbors (harmonic, LJ-excluded), so the tree-rich first-shell
    overlaps are held by bonds and LJ keeps the second shell (~0.31 nm) at
    bay: a dense bonded polymer ball, stable under 300 K Langevin, whose
    overlap-tree demand stays near its initial sizing."""
    from scipy.spatial import cKDTree

    pos, radius, gamma, alpha, charge, ish = synthetic_system(natoms)
    tree = cKDTree(pos)
    dd, jj = tree.query(pos, k=4)
    bonds = []
    seen = set()
    for i in range(natoms):
        for m in range(1, 4):
            j = int(jj[i, m])
            a, b = (i, j) if i < j else (j, i)
            if (a, b) not in seen:
                seen.add((a, b))
                bonds.append((a, b, float(dd[i, m])))
    bond_idx = np.array([(a, b) for a, b, _ in bonds], np.int32)
    bond_r0 = np.array([d for _, _, d in bonds])
    z2 = np.zeros((0, 2), np.int32)
    return SimpleNamespace(
        agbnp_radius=radius, agbnp_gamma=gamma, agbnp_alpha=alpha,
        charges=charge, ishydrogen=ish, positions=pos,
        velocities=np.zeros_like(pos),
        masses=np.where(ish > 0, 1.008, 12.011), n=natoms,
        # LJ wall just inside the second-neighbor shell; bonded first
        # neighbors are excluded below
        lj_sigma=np.where(ish > 0, 0.22, 0.28),
        lj_epsilon=np.where(ish > 0, 0.08, 0.30),
        bond_idx=bond_idx, bond_r0=bond_r0,
        bond_k=np.full(len(bonds), 1.5e5),
        angle_idx=np.zeros((0, 3), np.int32), angle_theta0=np.zeros(0),
        angle_k=np.zeros(0),
        dihedral_idx=np.zeros((0, 4), np.int32),
        dihedral_phi0=np.zeros(0), dihedral_fc=np.zeros((0, 5)),
        exclusions=bond_idx, pair_idx=z2, pair_aij=np.zeros(0),
        pair_bij=np.zeros(0), pair_qij=np.zeros(0))


def _device(device, what: str):
    """The device a run takes: None is the first CUDA device (raises
    without one)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}: no CUDA device; pass device='cpu'")
        device = "cuda:0"
    return torch.device(device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(natoms: int, repeats: int = 10, device=None):
    """The reference's scaling run (benchmarks/synthetic_scale.py:58-89):
    an AGBNPModel (version 1, cutoff 1 nm, given the ball's positions, so
    its capacities, neighbor width, cell grid and tile-list budgets are
    sized from them) of the natoms-atom synthetic ball, the PanicButton
    loop of up to 8 evaluations and check_and_grow, then `repeats` timed
    evaluations, synchronised.  Prints the reference's three lines.

    device: None is the first CUDA device (raises without one); float32
    on a card, float64 on the CPU (as the reference picks by platform).
    Returns dict(s_per_eval, natoms, init_s, first_s (the PanicButton
    loop, the kernels' first launches included), regrows, overflow (left
    after the loop), energy, force (of the last timed evaluation), grid,
    kmax, caps, offs, pair_tiles, model)."""
    from ..models.agbnp_torch import AGBNPModel
    from ..models.params import AGBNPParams

    device = _device(device, "run")
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    pos, radius, gamma, alpha, charge, ish = synthetic_system(natoms)
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    t0 = time.perf_counter()
    m = AGBNPModel(params, device=device, dtype=dtype, version=1,
                   cutoff=1.0, positions=pos)
    init_s = time.perf_counter() - t0
    print(f"n={natoms} init {init_s:.1f}s "
          f"grid={'on' if m.neighbor_grid is not None else 'off'} "
          f"kmax={m.neighbor_kmax} caps={m.caps.caps}", flush=True)

    t0 = time.perf_counter()
    regrows = 0
    for _ in range(MAX_REGROW):  # PanicButton loop
        e, f, out = m.energy_forces(pos, with_details=True)
        overflow = m.check_and_grow(out["diag"])
        if not overflow:
            break
        regrows += 1
    _sync(device)
    first_s = time.perf_counter() - t0
    print(f"  first eval (incl the kernels' first launches) {first_s:.1f}s "
          f"E={float(e):.2f}", flush=True)
    if not (torch.isfinite(e) and torch.isfinite(f).all()):
        raise RuntimeError(f"run({natoms}): non-finite energy or forces")

    t0 = time.perf_counter()
    for _ in range(repeats):
        e, f = m.energy_forces(pos)
    _sync(device)
    dt = (time.perf_counter() - t0) / max(repeats, 1)
    print(f"  steady-state eval {dt * 1e3:.2f} ms", flush=True)
    return dict(s_per_eval=dt, natoms=natoms, init_s=init_s,
                first_s=first_s, regrows=regrows, overflow=overflow,
                energy=float(e), force=f,
                grid=m.neighbor_grid is not None, kmax=m.neighbor_kmax,
                caps=m.caps.caps, offs=m.caps.offs,
                pair_tiles=m.pair_tiles, model=m)


def run_md(natoms: int, nsteps: int = 100, device=None,
           neighbor_every: int = 20):
    """MD of the natoms-atom synthetic ball (the reference's run_md,
    benchmarks/synthetic_scale.py:152-197): Simulation(version=1, cutoff 1
    nm, the MM force field) from synthetic_dms, its velocities drawn at
    300 K (seed 1, as the reference's large-N run starts), then
    benchmark_langevin: nsteps timed after an equal warm-up, rebuilds
    every neighbor_every steps, the capacities regrown and the run
    repeated on an overflow, up to MAX_REGROW times.

    device: None is the first CUDA device (raises without one); float32
    on a card, float64 on the CPU (as the reference picks by platform).
    Returns benchmark_langevin's dict plus "windows" (rebuild windows of
    the timed run), "natoms", "init_s" (the Simulation's set-up) and
    "sim"."""
    device = _device(device, "run_md")
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    from ..md.simulation import Simulation

    t0 = time.perf_counter()
    sim = Simulation(synthetic_dms(natoms), device=device, version=1,
                     cutoff=1.0, dtype=dtype, include_mm=True)
    sim.set_velocities_to_temperature(300.0, seed=1)
    init_s = time.perf_counter() - t0
    res = sim.benchmark_langevin(nsteps=nsteps, dt=0.001, temperature=300.0,
                                 neighbor_every=neighbor_every,
                                 max_regrow=MAX_REGROW)
    res.update(windows=-(-res["steps_run"] // neighbor_every),
               natoms=natoms, init_s=init_s, sim=sim)
    return res
