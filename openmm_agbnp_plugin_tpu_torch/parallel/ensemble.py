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
Simulation.make_langevin_runner.  Versions 0 and 1; no constraints, MTS
or virtual sites (the JAX runner builds a version-1 tree and a plain
Langevin step, ensemble.py:99-129).
"""

from __future__ import annotations

import time

import torch

from ..md.integrators import langevin_middle_step, running_max
from ..ops import tree as T


def check_replica_sim(sim, what: str):
    """Refuse the Simulation options a replica runner does not carry."""
    if sim.agbnp2 is not None:
        raise NotImplementedError(f"{what}: version 2 is not ported to the "
                                  "replica runners")
    if sim.constraints is not None:
        raise NotImplementedError(f"{what}: constraints are not ported to "
                                  "the replica runners")
    if sim.vsites is not None:
        raise NotImplementedError(f"{what}: virtual sites are not ported to "
                                  "the replica runners")


def replica_generators(device, nrep: int, seed: int):
    """One generator per replica, replica r seeded seed + r."""
    return [torch.Generator(device=device).manual_seed(seed + r)
            for r in range(nrep)]


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
    [R, 7], WU kept rows [R, 7]), its build (pairs, topology,
    vdw_topology))."""
    build = (sim.window_build(pos, ff, vdw_caps, vdw_relax)
             if start is None else start[0])
    pairs, topo, vdw_topo, (bcounts, nbmax, sibs, vdw_counts) = build
    fn = _window_force_fn(sim, ff, build)
    if start is not None:
        fn = _replay_first(fn, start[1])
    step = langevin_middle_step(fn, sim.masses, dt, temps, friction)
    energies, counts = [], None
    for _ in range(ninner):
        pos, vel, e, c, _ = step(pos, vel, draw())
        energies.append(e)
        counts = running_max(counts, c)
    counts = T.merge_counts(counts, bcounts)
    return (pos, vel, energies, (counts, nbmax, sibs, vdw_counts),
            (pairs, topo, vdw_topo))


def worst_replica(diag):
    """A replica runner's diagnostics reduced to the worst replica, in the
    form Simulation.overflow_report takes."""
    return tuple(None if x is None else torch.amax(x, dim=0) for x in diag)


class ReplicaEnsemble:
    """R independent replicas of a Simulation, one batch on its device.

    sim: a md.simulation.Simulation (version 0 or 1; its dtype, device,
    cutoff, capacities and tile budgets apply to every replica)."""

    def __init__(self, sim, n_replicas: int):
        check_replica_sim(sim, "ReplicaEnsemble")
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.sim = sim
        self.n_replicas = int(n_replicas)
        self.device = sim.device

    def initial_states(self, jitter: float = 0.0, seed: int = 0):
        """(pos [R, N, 3], vel [R, N, 3], generators): the Simulation's
        state on every replica, positions displaced by jitter nm of
        standard-normal noise (a generator seeded `seed`), and one noise
        generator per replica (seed + r)."""
        sim, R = self.sim, self.n_replicas
        pos = sim.positions.expand((R,) + tuple(sim.positions.shape)).clone()
        if jitter > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            pos = pos + jitter * torch.randn(pos.shape, generator=gen,
                                             dtype=pos.dtype,
                                             device=self.device)
        vel = sim.velocities.expand(pos.shape).clone()
        return pos, vel, replica_generators(self.device, R, seed)

    def make_runner(self, dt=0.001, temperature=300.0, friction=1.0,
                    neighbor_every: int = 20, vdw_compact: bool = True,
                    vdw_relax: float = 0.5):
        """run(states, nsteps, noise=None) -> (states, (energies [R,
        nsteps], counts [R, C], neighbor_max [R], sibling maxima [R, 7], WU
        kept rows [R, 7])).

        Every neighbor_every steps each replica's neighbor list and tree
        topology (with vdw_compact its compacted WU topology) are rebuilt;
        a short remainder window closes a run that neighbor_every does not
        divide.  The noise comes from the states' generators (advanced in
        place) or, when given, from noise [nsteps, R, N, 3].  The window's
        diagnostics are read once at its end; a window that overflowed in
        any replica stops the run, and the energies then cover the steps
        run.  The diagnostics are maxima over the windows run."""
        if neighbor_every <= 0:
            raise ValueError("the replica runner rebuilds in windows: "
                             "neighbor_every > 0")
        sim = self.sim
        ff = sim.ff_state()
        vdw_caps = sim._ensure_vdw_caps(vdw_relax) if vdw_compact else None
        temps = torch.full((self.n_replicas,), float(temperature),
                           dtype=sim.dtype, device=self.device)

        def run(states, nsteps: int, noise=None):
            pos, vel, gens = states
            draw = noise_source(pos.shape, pos.dtype, pos.device,
                                None if noise is not None else gens, noise)
            energies, diag, done = [], None, 0
            while done < nsteps:
                ninner = min(neighbor_every, nsteps - done)
                pos, vel, es, wdiag, _ = run_window(
                    sim, ff, pos, vel, ninner, temps, draw, dt, friction,
                    vdw_caps, vdw_relax)
                energies.extend(es)
                diag = wdiag if diag is None else tuple(
                    running_max(x, y) for x, y in zip(diag, wdiag))
                done += ninner
                if sim._check_overflow(*worst_replica(wdiag)):
                    break  # the window's host read
            return (pos, vel, gens), (torch.stack(energies, dim=1), *diag)

        return run

    def benchmark(self, nsteps=100, dt=0.001, temperature=300.0,
                  friction=1.0, jitter=1e-3, neighbor_every: int = 20):
        """Timed run of nsteps after a warm-up run of as many, which the
        timed run continues.  Returns ns/day per replica and aggregate, ms
        per step, the energies [R, steps run], the final states and whether
        any replica overflowed (its channels in overflow_report)."""
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
