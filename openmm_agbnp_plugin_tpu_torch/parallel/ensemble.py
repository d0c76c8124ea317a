"""Replica-ensemble MD: R replicas of one system as a batch on one device.

Counterpart of the JAX package's parallel/ensemble.py (BASELINE config 5:
batched AGBNP1 MD on R replicas of one system for free-energy workflows).
The JAX runner vmaps the whole force pipeline and integrator over a
leading replica axis; here the axis is written out: the replicas' neighbor
lists are built in one pass (ops/neighbors.py), their overlap trees are one
tree over the disjoint union of their atoms (ops/tree.py, nrep), the pair
sweeps run the kernels' replica axis (one launch for all replicas), and
the Langevin step moves [R, N, 3] arrays.  A step of R replicas therefore
launches about as many kernels as a step of one.

Each replica has its own torch.Generator (seeded seed + r, as the JAX
package keys replica r with PRNGKey(seed + r)), or the runner takes the
noise as an array.  Rebuild windows, the vdW-compact WU topology, the
window's host read of its diagnostics and the stop on overflow follow
Simulation.make_langevin_runner.  As in JAX, each step is the Simulation's
own: its forces come from sim.force_fn (which projects virtual sites and
spreads their forces, on [R, N, 3]) and the Langevin step applies
sim.constraints (SHAKE/RATTLE per replica; the SHAKE residual [R] rides
the window's diagnostics and is read with the overflow counts);
neighbor_every <= 0 evaluates every step on the model's own candidate
pairs (JAX ensemble.py:73-97).  Versions 0 and 1 on both paths; version 2
on the per-step path only, through the batched AGBNP2 evaluation (each
replica's MS candidates found on the device every step, the 18-entry
counts [R, 18]): the JAX package's windowed runner fails on version 2 (its
window hands the atomic tree's levels to a force function that unpacks an
AGBNP2 topology, reference md/simulation.py:421-422), so the port's
refuses it.  MTS is not in the JAX runners either.

With mesh (a `replica` mesh, parallel/sharding.py::replica_mesh, one rank a
process), each rank holds a contiguous block of the replicas, with their
generators seeded seed + r by their global index r, and runs the same
batched path on its block; the energies and diagnostics come back from
every rank by all_gather (each window's overflow check reads every
rank's, so all ranks stop together), the states stay on their rank.
"""

from __future__ import annotations

import time

import torch

from ..md.integrators import langevin_middle_step, running_max
from ..ops import tree as T


def check_replica_sim(sim, what: str):
    """Refuse version 2 on a windowed replica path (rebuild windows,
    T-REMD cycles): it runs on the per-step path only."""
    if sim.agbnp2 is not None:
        raise NotImplementedError(
            f"{what}: version 2 runs on the per-step path only, "
            "ReplicaEnsemble.make_runner(neighbor_every=0) (one batched "
            "AGBNP2 evaluation a step); the JAX package's windowed replica "
            "runners and T-REMD fail on version 2 too (their window hands "
            "the atomic tree to a force function that unpacks an AGBNP2 "
            "topology); versions 0 and 1 run everywhere")


def replica_generators(device, nrep: int, seed: int, start: int = 0):
    """One generator per replica start .. start + nrep - 1, replica r seeded
    seed + r."""
    return [torch.Generator(device=device).manual_seed(seed + r)
            for r in range(start, start + nrep)]


def replica_block(mesh, nrep: int) -> slice:
    """The replicas of this rank: all of them without a mesh, its
    contiguous block of the replica mesh otherwise."""
    return slice(0, nrep) if mesh is None else mesh.block(nrep)


def gather_replicas(mesh, x):
    """x [Rb, ...] of this rank's replicas -> [R, ...] of every rank's (x
    itself without a mesh; None stays None)."""
    return x if mesh is None or x is None else mesh.gather(x)


def gather_diag(mesh, diag):
    """A replica diagnostics tuple with every rank's replicas."""
    return tuple(gather_replicas(mesh, x) for x in diag)


def noise_source(shape, dtype, device, generators, noise):
    """draw() -> the next standard-normal [R, N, 3] draw: the next entry of
    noise [steps, R, N, 3], or one [N, 3] draw from each replica's
    generator."""
    if (generators is None) == (noise is None):
        raise ValueError("give exactly one of generators and noise")
    used = 0

    def draw():
        nonlocal used
        if noise is not None:
            out = noise[used]
        else:
            out = torch.stack([torch.randn(shape[1:], generator=g,
                                           dtype=dtype, device=device)
                               for g in generators])
        used += 1
        return out

    return draw


def diag_max(a, b):
    """Elementwise maxima of two replica diagnostics tuples."""
    return b if a is None else tuple(running_max(x, y) for x, y in zip(a, b))


def window_start(sim, ff, pos, vdw_caps=None, vdw_relax: float = 0.5):
    """A window's build at pos [R, N, 3] (Simulation.window_build) and the
    force there: (build, force_fn(pos)), for run_window's `start` when the
    force at the window's first positions is wanted before the window
    runs (T-REMD's exchange energy)."""
    build = sim.window_build(pos, ff, vdw_caps, vdw_relax)
    return build, _window_force_fn(sim, ff, build)(pos)


def _window_force_fn(sim, ff, build):
    pairs, topo, vdw_topo, _ = build
    return sim.force_fn(pairs=pairs, topology=topo, ff=ff,
                        vdw_topology=vdw_topo)


def _replay_first(fn, first):
    """fn, whose first call returns `first` (fn's result at that call's
    positions, evaluated earlier) instead of evaluating again."""
    pending = [first]

    def replay(x):
        return pending.pop() if pending else fn(x)

    return replay


def run_window(sim, ff, pos, vel, ninner, temps, draw, dt, friction,
               vdw_caps=None, vdw_relax: float = 0.5, start=None):
    """One rebuild window of ninner Langevin steps for R replicas, replica
    r at bath temperature temps[r].  start: window_start's result at pos,
    whose build and force the window takes instead of computing them
    again (the same values: the build and the evaluation are
    deterministic).  Returns (pos, vel, energies [ninner] of [R], the
    window's diagnostics (counts [R, C], neighbor_max [R], sibling maxima
    [R, 7], WU kept rows [R, 7], SHAKE residual [R] or None without
    constraints), its build (pairs, topology, vdw_topology))."""
    build = (sim.window_build(pos, ff, vdw_caps, vdw_relax)
             if start is None else start[0])
    pairs, topo, vdw_topo, (bcounts, nbmax, sibs, vdw_counts) = build
    fn = _window_force_fn(sim, ff, build)
    if start is not None:
        fn = _replay_first(fn, start[1])
    step = langevin_middle_step(fn, sim.masses, dt, temps, friction,
                                constraints=sim.constraints)
    energies, counts, shake = [], None, None
    for _ in range(ninner):
        pos, vel, e, c, sh = step(pos, vel, draw())
        energies.append(e)
        counts = running_max(counts, c)
        shake = running_max(shake, sh)
    counts = T.merge_counts(counts, bcounts)
    return (pos, vel, energies, (counts, nbmax, sibs, vdw_counts, shake),
            (pairs, topo, vdw_topo))


def run_steps(sim, ff, pos, vel, nsteps, temps, draw, dt, friction):
    """nsteps Langevin steps of R replicas, each evaluating the full force
    on the model's own candidate pairs (a tree build a step; the JAX
    package's per-step replica_run).  Returns (pos, vel, energies [nsteps]
    of [R], diagnostics as run_window's: the steps' maximum counts, zero
    neighbor, sibling and WU entries, the SHAKE residual)."""
    step = langevin_middle_step(sim.force_fn(ff=ff), sim.masses, dt, temps,
                                friction, constraints=sim.constraints)
    energies, counts, shake = [], None, None
    for _ in range(nsteps):
        pos, vel, e, c, sh = step(pos, vel, draw())
        energies.append(e)
        counts = running_max(counts, c)
        shake = running_max(shake, sh)
    z = torch.zeros((pos.shape[0], 7), dtype=torch.int64, device=pos.device)
    return pos, vel, energies, (counts, z[:, 0], z, z, shake)


def worst_replica(diag):
    """A replica runner's diagnostics reduced to the worst replica, in the
    form Simulation.overflow_report takes."""
    return tuple(None if x is None else torch.amax(x, dim=0) for x in diag)


class ReplicaEnsemble:
    """R independent replicas of a Simulation, one batch on its device.

    sim: a md.simulation.Simulation (its dtype, device, cutoff,
    capacities, tile budgets, constraints and virtual sites apply to every
    replica; version 2 on the per-step path only).  mesh: a `replica`
    mesh whose size divides n_replicas; each rank runs its block (None:
    every replica in this process)."""

    def __init__(self, sim, n_replicas: int, mesh=None):
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.sim = sim
        self.n_replicas = int(n_replicas)
        self.device = sim.device
        self.mesh = mesh
        self.block = replica_block(mesh, self.n_replicas)

    def initial_states(self, jitter: float = 0.0, seed: int = 0):
        """(pos [R, N, 3], vel [R, N, 3], generators): the Simulation's
        state on every replica, positions displaced by jitter nm of
        standard-normal noise (a generator seeded `seed`), and one noise
        generator per replica (seed + r).  With a mesh, this rank's block
        of them (the same numbers as without)."""
        sim, R, blk = self.sim, self.n_replicas, self.block
        pos = sim.positions.expand((R,) + tuple(sim.positions.shape)).clone()
        if jitter > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            pos = pos + jitter * torch.randn(pos.shape, generator=gen,
                                             dtype=pos.dtype,
                                             device=self.device)
        pos = pos[blk].clone()
        vel = sim.velocities.expand(pos.shape).clone()
        return pos, vel, replica_generators(self.device, pos.shape[0], seed,
                                            start=blk.start)

    def make_runner(self, dt=0.001, temperature=300.0, friction=1.0,
                    neighbor_every: int = 20, vdw_compact: bool = True,
                    vdw_relax: float = 0.5):
        """run(states, nsteps, noise=None) -> (states, (energies [R,
        nsteps], counts [R, C], neighbor_max [R], sibling maxima [R, 7], WU
        kept rows [R, 7], SHAKE residual [R] or None without
        constraints)).

        Every neighbor_every steps each replica's neighbor list and tree
        topology (with vdw_compact its compacted WU topology) are rebuilt;
        a short remainder window closes a run that neighbor_every does not
        divide.  The noise comes from the states' generators (advanced in
        place) or, when given, from noise [nsteps, R, N, 3].  The window's
        diagnostics are read once at its end; a window that overflowed in
        any replica, or whose SHAKE missed its tolerance, stops the run,
        and the energies then cover the steps run.  The diagnostics are
        maxima over the windows run.

        neighbor_every <= 0: every step evaluates the full force on the
        model's own candidate pairs (run_steps; up to 2000 atoms, as
        Simulation.force_fn allows), no WU compaction; the diagnostics are
        the steps' maximum counts with zero neighbor, sibling and WU
        entries, read by the caller (JAX's per-step replica_run).  Version
        2 runs here only (its counts [R, 18]); neighbor_every > 0 raises
        NotImplementedError for it (check_replica_sim).

        With a mesh, states are this rank's block (initial_states) and
        noise [nsteps, Rb, N, 3] its block's; the energies and
        diagnostics are every rank's, [R, ...]."""
        sim, mesh = self.sim, self.mesh
        ff = sim.ff_state()
        nloc = self.block.stop - self.block.start
        temps = torch.full((nloc,), float(temperature),
                           dtype=sim.dtype, device=self.device)

        def states_draw(states, noise):
            pos, vel, gens = states
            return pos, vel, gens, noise_source(
                pos.shape, pos.dtype, pos.device,
                None if noise is not None else gens, noise)

        if neighbor_every <= 0:
            def run_per_step(states, nsteps: int, noise=None):
                pos, vel, gens, draw = states_draw(states, noise)
                pos, vel, es, diag = run_steps(sim, ff, pos, vel, nsteps,
                                               temps, draw, dt, friction)
                return (pos, vel, gens), (
                    gather_replicas(mesh, torch.stack(es, dim=1)),
                    *gather_diag(mesh, diag))

            return run_per_step

        check_replica_sim(sim, "ReplicaEnsemble.make_runner(neighbor_every "
                          "> 0)")
        vdw_caps = sim._ensure_vdw_caps(vdw_relax) if vdw_compact else None

        def run(states, nsteps: int, noise=None):
            pos, vel, gens, draw = states_draw(states, noise)
            energies, diag, done = [], None, 0
            while done < nsteps:
                ninner = min(neighbor_every, nsteps - done)
                pos, vel, es, wdiag, _ = run_window(
                    sim, ff, pos, vel, ninner, temps, draw, dt, friction,
                    vdw_caps, vdw_relax)
                energies.extend(es)
                wdiag = gather_diag(mesh, wdiag)
                diag = diag_max(diag, wdiag)
                done += ninner
                if sim._check_overflow(*worst_replica(wdiag)):
                    break  # the window's host read
            return (pos, vel, gens), (
                gather_replicas(mesh, torch.stack(energies, dim=1)), *diag)

        return run

    def benchmark(self, nsteps=100, dt=0.001, temperature=300.0,
                  friction=1.0, jitter=1e-3, neighbor_every: int = 20):
        """Timed run of nsteps after a warm-up run of as many, which the
        timed run continues.  Returns ns/day per replica and aggregate, ms
        per step, the energies [R, steps run], the final states and whether
        any replica overflowed (its channels in overflow_report).  Version
        2 runs the per-step path whatever neighbor_every says (its only
        replica path)."""
        if self.sim.agbnp2 is not None:
            neighbor_every = 0
        run = self.make_runner(dt, temperature, friction,
                               neighbor_every=neighbor_every)
        states, _ = run(self.initial_states(jitter=jitter), nsteps)
        self.sim._sync()
        t0 = time.perf_counter()
        states, (energies, *diag) = run(states, nsteps)
        self.sim._sync()
        elapsed = time.perf_counter() - t0
        report = self.sim.overflow_report(*worst_replica(diag))
        steps = int(energies.shape[1])
        ns_day = steps * dt * 1e-3 / elapsed * 86400.0
        return dict(ns_day_per_replica=ns_day,
                    replica_ns_day_aggregate=ns_day * self.n_replicas,
                    ms_per_step=elapsed * 1e3 / max(steps, 1),
                    elapsed_s=elapsed, steps_run=steps, energies=energies,
                    states=states, overflow=bool(report),
                    overflow_report=report)
