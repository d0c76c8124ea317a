"""Large systems on a synthetic protein-like ball (the JAX package's
benchmarks/synthetic_scale.py: its generator, its scaling run and the
harness's synth10k leg, bench.py's 10,240-atom run).

synthetic_system and synthetic_dms are copies of the reference generator
(numpy and scipy only, so the port never imports the JAX package): for the
same natoms and seed their arrays are bitwise the reference's.  run times
AGBNPModel evaluations of the ball (AGBNP1, CutoffNonPeriodic 1 nm, the
cell-grid candidates above 3000 atoms, the tile lists) after its
PanicButton loop.  run_md drives the port's Simulation on the bonded ball
(AGBNP1 + the MM force field, rebuild windows) through the reference's
protocol: benchmark_langevin from rest up to WINDOWED_ATOMS atoms, the
windowed heat-then-time protocol (_run_md_windows) above.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..md.integrators import KB

# the evaluations of run's PanicButton loop (the reference's 8)
MAX_REGROW = 8
# run_md runs _run_md_windows above this many atoms (the reference's
# literal, benchmarks/synthetic_scale.py:172-173)
WINDOWED_ATOMS = 8000


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
    nm, the MM force field) from synthetic_dms.  Up to WINDOWED_ATOMS atoms
    it starts from the generator's zero velocities and runs
    benchmark_langevin (nsteps timed after an equal warm-up, rebuilds every
    neighbor_every steps, the capacities regrown and the run repeated on
    an overflow, up to its default 3 times); above, _run_md_windows (heat
    windows from 300 K velocities, then timed windows, each window retried
    on an overflow).

    device: None is the first CUDA device (raises without one); float32
    on a card, float64 on the CPU (as the reference picks by platform).
    Returns the protocol's dict plus "natoms", "init_s" (the Simulation's
    set-up) and "sim"; benchmark_langevin's also "windows" (rebuild
    windows of the timed run)."""
    device = _device(device, "run_md")
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    from ..md.simulation import Simulation

    t0 = time.perf_counter()
    sim = Simulation(synthetic_dms(natoms), device=device, version=1,
                     cutoff=1.0, dtype=dtype, include_mm=True)
    init_s = time.perf_counter() - t0
    if natoms > WINDOWED_ATOMS:
        res = _run_md_windows(sim, nsteps, neighbor_every)
    else:
        res = sim.benchmark_langevin(nsteps=nsteps, dt=0.001,
                                     temperature=300.0,
                                     neighbor_every=neighbor_every)
        res.update(windows=-(-res["steps_run"] // neighbor_every))
    res.update(natoms=natoms, init_s=init_s, sim=sim)
    return res


def _run_md_windows(sim, nsteps, neighbor_every, dt=0.001,
                    temperature=300.0, heat_windows: int = 4,
                    max_regrow: int = 12, generator=None):
    """Window-by-window large-N MD (the reference's _run_md_windows,
    benchmarks/synthetic_scale.py:199-299) with the full PanicButton
    contract: every window, heat and timed alike, that overflows any
    capacity channel is thrown away, the overflowed channels are regrown
    (headroom min(1.3 x 1.25^(k-1), 2.6) at the k-th regrow) and the window
    is rerun from its own starting state: positions, velocities and the
    generator's state, so a retried window draws the same noise.  A
    RuntimeError naming the channels still over is raised past max_regrow
    regrows.

    The velocities are drawn at `temperature` (seed 1); the noise comes
    from `generator` (None: a generator on sim's device seeded 0).
    heat_windows windows run first; if they regrew, the capacities are
    shrunk to fit the heated positions (sim.resize_caps_to_current) once.
    Then max(1, nsteps // neighbor_every - heat_windows) timed windows,
    each timed on the host clock around the runner call and the read of
    its counts (the sync); a window whose clean run came right after a
    regrow is not timed.  ns_day and ms_step come from the median of the
    timed windows.

    The reference also ends the sample early when a window raises
    anything but a RuntimeError (a remote TPU worker lost mid-run); that
    branch has no counterpart on a card, where it would turn a fault into
    a shorter sample, so every error propagates.  One check the reference
    lacks: a window that did not overflow but whose energies are not
    finite (the dynamics blew up) raises a RuntimeError at once; the
    reference counts it clean and regrows the next window's cell grid on
    the non-finite positions until max_regrow.

    Returns dict(ns_day, elapsed_s (the timed windows' sum), ms_step,
    windows (timed), steps_done ((windows + heat_windows) x
    neighbor_every), energies (the last window's), overflow (False),
    regrows), as the reference, plus steps_run (every step the runner ran,
    thrown-away attempts included), regrow_log ((window label, the
    overflow report) a regrow), window_log (a clean window's label, its
    first and last energy and the kinetic temperature at its end, over 3N
    degrees of freedom), shrunk (the capacities after shrink-to-fit:
    dict(caps, offs, kmax), or None) and final_pos."""
    if generator is None:
        generator = torch.Generator(device=sim.device).manual_seed(0)
    regrows = 0
    steps_run = 0
    regrow_log = []
    window_log = []
    shrunk = None
    ndof = 3 * sim.masses.shape[0]

    def make_run():
        return sim.make_langevin_runner(dt, temperature, 1.0,
                                        neighbor_every=neighbor_every)

    run = make_run()
    sim.set_velocities_to_temperature(temperature, seed=1)
    pos, vel = sim.positions, sim.velocities

    def advance(pos, vel, label):
        """One clean window from (pos, vel, the generator's state): regrow
        and retry on any overflow.  Returns (pos, vel, energies, elapsed
        of the clean run, whether it regrew)."""
        nonlocal run, regrows, steps_run
        state = generator.get_state()
        regrew = False
        while True:
            t0 = time.perf_counter()
            out = run(pos, vel, neighbor_every, generator=generator)
            # the window's host read synchronized the device
            elapsed = time.perf_counter() - t0
            steps_run += neighbor_every
            diag = out[3]
            rep = sim.overflow_report(*diag)
            if not rep:
                e, v = out[2].double(), out[1].double()
                ke = 0.5 * torch.sum(sim.masses[:, None] * v ** 2)
                stats = (float(e[0]), float(e[-1]),
                         float(2 * ke / (ndof * KB)))
                if not all(np.isfinite(stats)):
                    raise RuntimeError(
                        f"{label}: non-finite energies or velocities without "
                        f"an overflow (the dynamics blew up); the last clean "
                        f"windows: {window_log[-3:]}")
                window_log.append((label, *stats))
                return out[0], out[1], out[2], elapsed, regrew
            regrows += 1
            if regrows > max_regrow:
                raise RuntimeError(
                    f"PanicButton failed to converge after {max_regrow} "
                    f"regrows; still over: {rep}")
            print(f"  {label}: overflow {rep} -> regrow "
                  f"({regrows}/{max_regrow})", flush=True)
            regrow_log.append((label, rep))
            regrew = True
            run = out = None  # let the old model go before the new one
            sim._regrow(*diag,
                        headroom=min(1.3 * 1.25 ** (regrows - 1), 2.6))
            _free_cached(sim.device)
            run = make_run()
            generator.set_state(state)

    for w in range(heat_windows):
        pos, vel, e, _, _ = advance(pos, vel, f"heat window {w}")
    if regrows:
        # shrink-to-fit: regrows only grow, so the heated capacities carry
        # the transient's spike and the escalated headroom
        run = None
        sim.resize_caps_to_current(pos)
        _free_cached(sim.device)
        run = make_run()
        shrunk = dict(caps=sim.agbnp.caps.caps, offs=sim.agbnp.caps.offs,
                      kmax=sim.kmax)
        print(f"  shrink-to-fit: caps={shrunk['caps']} "
              f"kmax={shrunk['kmax']}", flush=True)
    nwin = max(1, nsteps // neighbor_every - heat_windows)
    times = []
    for w in range(nwin):
        pos, vel, e, elapsed, regrew = advance(pos, vel, f"timed window {w}")
        if not regrew:
            times.append(elapsed)
    med = float(np.median(times)) if times else float("inf")
    return dict(ns_day=neighbor_every * dt * 1e-3 / med * 86400.0,
                elapsed_s=float(np.sum(times)),
                ms_step=med / neighbor_every * 1e3,
                windows=len(times),
                steps_done=(len(times) + heat_windows) * neighbor_every,
                energies=e.cpu().numpy(), overflow=False, regrows=regrows,
                steps_run=steps_run, regrow_log=regrow_log,
                window_log=window_log, shrunk=shrunk, final_pos=pos)


def _free_cached(device):
    """Hand the old capacities' cached blocks back to the card before the
    next window's (a regrow or shrink builds a new model)."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
