"""Temperature replica-exchange MD (T-REMD), the replicas as one batch.

Counterpart of the JAX package's parallel/remd.py.  Replicas keep their
configurations in place and trade temperature rungs.  A cycle runs
steps_per_cycle middle-Langevin steps of every replica at its rung's
temperature (one batch: ops/kernels' replica axis, the union overlap tree,
parallel/ensemble.py's windows), then one even/odd exchange sweep:

- on cycle c the rung pairs (0, 1), (2, 3), ... are tried for even c and
  (1, 2), (3, 4), ... for odd c, each accepted with the Metropolis
  probability min(1, exp[(beta_i - beta_j)(U_i - U_j)]), U_i the potential
  of the configuration that holds rung i, against one uniform drawn for
  the pair at its lower rung;
- an accepted swap rescales both replicas' velocities by sqrt(T_new /
  T_old).

The exchange energies are taken at each cycle's last positions, with the
remainder window's topology or a fresh tree when the cycle has no
remainder window (JAX remd.py:224-242).  That fresh tree is the next
window's build at the same positions (an exchange moves no atom), so the
next cycle's first window takes it, and its first step the force the
exchange evaluation gave, instead of building and evaluating again.  The
evaluation on a remainder window's topology leaves out the WU force pass
(the energy never depends on it).  The host reads only per-cycle scalars
(U, rungs, acceptances) and the cycle's overflow counts and SHAKE
residual; an overflow in any replica raises.  As in JAX (remd.py:92), the
Simulation's version, cutoff, constraints and virtual sites apply to
every replica: each window's step is its force_fn and constrained
Langevin step (parallel/ensemble.py::run_window).

With mesh (a `replica` mesh), each rank runs the windows of its contiguous
block of replicas and only scalars cross ranks, as the JAX package's
docstring has it: each cycle gathers the replicas' exchange energies (and
the overflow counts); every rank holds the whole rung vector and the
exchange generator seeded alike, so each makes the same swap decision, and
rescales the velocities of its own replicas.  Coordinates never leave
their rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..md.integrators import KB
from ..ops.tree import merge_counts
from .ensemble import diag_max, check_replica_sim, gather_diag, \
    gather_replicas, noise_source, replica_block, replica_generators, \
    run_window, window_start, worst_replica


def geometric_ladder(t_min: float, t_max: float, n: int):
    """Geometric temperature ladder: the standard spacing that gives
    roughly uniform exchange acceptance when the heat capacity is flat."""
    if n == 1:
        return np.asarray([t_min])
    r = (t_max / t_min) ** (1.0 / (n - 1))
    return t_min * r ** np.arange(n)


def attempt_swaps(u, rung, U, betas, parity: int):
    """One even/odd neighbor-swap sweep over temperature rungs.

    u [R]: uniforms in [0, 1), u[q] serving the pair whose lower rung is q.
    rung[r]: the rung replica r holds (a permutation of 0..R-1).  U[r]: the
    potential energy of replica r.  betas [R]: 1/(kB T) of each rung.
    parity 0 pairs rungs (0, 1), (2, 3), ...; 1 pairs (1, 2), (3, 4), ...

    Returns (new_rung, accept_by_rung), accept_by_rung[q] True iff rung q
    took part in an accepted swap.  A pure function of its inputs."""
    R = rung.shape[0]
    dev = rung.device
    q = torch.arange(R, device=dev)
    # partner rung under this parity; out-of-range partners are masked off
    up = (q - parity) % 2 == 0
    partner = torch.where(up, q + 1, q - 1)
    valid = (partner >= 0) & (partner < R)
    partner_c = torch.clamp(partner, 0, R - 1)
    # the replica holding each rung (inverse permutation), and its U
    ror = torch.empty_like(rung)
    ror[rung.long()] = torch.arange(R, dtype=rung.dtype, device=dev)
    U_rung = U[ror.long()]
    # symmetric in the pair: the same delta and the same uniform from both
    # sides
    delta = (betas - betas[partner_c]) * (U_rung - U_rung[partner_c])
    u_pair = u[torch.minimum(q, partner_c)]
    accept = valid & (u_pair < torch.exp(torch.clamp(delta, max=0.0)))
    new_rung_of_rung = torch.where(accept, partner_c, q).to(rung.dtype)
    return new_rung_of_rung[rung.long()], accept


def pair_acceptance(accept):
    """Acceptance per adjacent-rung pair (q, q + 1) from accept [C, R] (per
    rung, a run's cycles), over the cycles whose parity q % 2 tried it (NaN
    where none did)."""
    C, R = accept.shape
    rates = np.full(max(R - 1, 0), np.nan)
    for q in range(R - 1):
        tried = [c for c in range(C) if c % 2 == q % 2]
        if tried:
            rates[q] = accept[tried, q].mean()
    return rates


class TemperatureREMD:
    """T-REMD over AGBNP implicit-solvent replicas on one device, or over
    the ranks of a replica mesh.

    sim: a md.simulation.Simulation (version 0 or 1, as the JAX
    package's T-REMD runs; its version, cutoff, constraints and virtual
    sites apply to every replica; version 2 raises NotImplementedError).
    temperatures: the rung ladder, one replica per rung; replica r starts
    at rung r.  mesh: a `replica` mesh whose size divides the replica
    count; each rank runs its block (None: every replica in this
    process)."""

    def __init__(self, sim, temperatures, mesh=None):
        check_replica_sim(sim, "TemperatureREMD")
        self.sim = sim
        self.temps = np.asarray(temperatures, dtype=np.float64)
        if self.temps.ndim != 1 or self.temps.shape[0] < 1:
            raise ValueError("need at least one temperature")
        self.n_replicas = int(self.temps.shape[0])
        self.device = sim.device
        self.mesh = mesh
        self.block = replica_block(mesh, self.n_replicas)

    def initial_states(self, jitter: float = 0.0, seed: int = 0):
        """((pos [R, N, 3], vel, generators, rung [R]), exchange
        generator): positions displaced by jitter nm (a generator seeded
        seed + 7919), replica r's noise generator seeded seed + r, the
        exchanges' seeded seed + 104729 (the JAX package's offsets).  With
        a mesh, pos, vel and the generators are this rank's block; rung
        stays whole."""
        R, sim, blk = self.n_replicas, self.sim, self.block
        pos = sim.positions.expand((R,) + tuple(sim.positions.shape)).clone()
        if jitter > 0:
            gen = torch.Generator(device=self.device).manual_seed(seed + 7919)
            pos = pos + jitter * torch.randn(pos.shape, generator=gen,
                                             dtype=pos.dtype,
                                             device=self.device)
        pos = pos[blk].clone()
        vel = sim.velocities.expand(pos.shape).clone()
        rung = torch.arange(R, dtype=torch.int64, device=self.device)
        xgen = torch.Generator(device=self.device).manual_seed(seed + 104729)
        gens = replica_generators(self.device, pos.shape[0], seed,
                                  start=blk.start)
        return (pos, vel, gens, rung), xgen

    def make_runner(self, dt=0.001, friction=1.0, steps_per_cycle: int = 40,
                    neighbor_every: int = 40, vdw_compact: bool = True,
                    vdw_relax: float = 0.5):
        """run(states, xgen, ncycles, noise=None, uniforms=None) -> (states,
        out) with out: U [C, R] (the potential at each exchange attempt),
        rung [C, R] (each replica's rung after the cycle), accept [C, R]
        (per rung), energies [R, C * steps_per_cycle], counts [R, C],
        neighbor_max [R], sibling maxima [R, 7], WU kept rows [R, 7] and
        shake_residual [R] (None without constraints; maxima over the
        cycles).

        A cycle's windows rebuild every neighbor_every steps (clamped to
        the cycle; a short remainder window takes the rest).  The noise
        comes from the replicas' generators or noise [C * steps_per_cycle,
        R, N, 3]; the exchange uniforms from xgen (R a cycle) or uniforms
        [C, R].  An overflow in any replica, or a SHAKE residual over the
        tolerance, raises RuntimeError.  With a mesh, states and noise
        [C * steps_per_cycle, Rb, N, 3] are this rank's block; the outputs
        are every replica's."""
        sim, mesh, blk = self.sim, self.mesh, self.block
        R = self.n_replicas
        dtype, dev = sim.dtype, self.device
        temps = torch.as_tensor(self.temps, dtype=dtype, device=dev)
        betas = torch.as_tensor(1.0 / (KB * self.temps), dtype=dtype,
                                device=dev)
        spc = int(steps_per_cycle)
        ne = min(int(neighbor_every), spc)
        nwin, rem = divmod(spc, ne)
        ff = sim.ff_state()
        vdw_caps = sim._ensure_vdw_caps(vdw_relax) if vdw_compact else None
        # version 1 has a WU force pass to leave out of the exchange energy
        u_mode = "skip" if sim.agbnp.version == 1 else "fused"

        def cycle(pos, vel, rung, draw, u, parity, start):
            temp = temps[rung[blk]]
            diag = None
            energies = []
            for k in range(nwin + (1 if rem else 0)):
                pos, vel, es, wdiag, build = run_window(
                    sim, ff, pos, vel, ne if k < nwin else rem, temp, draw,
                    dt, friction, vdw_caps, vdw_relax,
                    start=start if k == 0 else None)
                energies.extend(es)
                diag = diag_max(diag, wdiag)
            if rem:
                ev = sim.force_fn(pairs=build[0], topology=build[1], ff=ff,
                                  vdw_topology=build[2],
                                  wu_mode=u_mode)(pos)
                start = None
            else:
                # no remainder window: the next window's build at the final
                # positions, and the force there, give the exchange energy
                start = window_start(sim, ff, pos, vdw_caps, vdw_relax)
                ev = start[1]
                bc, nb, sb, wc = start[0][3]
                diag = (merge_counts(diag[0], bc), torch.maximum(diag[1], nb),
                        torch.maximum(diag[2], sb), torch.maximum(diag[3], wc),
                        diag[4])
            # the exchange evaluation's tile counts are checked too
            U = gather_replicas(mesh, ev[0])
            diag = gather_diag(mesh, (merge_counts(diag[0], ev[-1]),
                                      *diag[1:]))
            new_rung, accept = attempt_swaps(u, rung, U, betas, parity)
            # accepted swap: momenta rescaled to the new bath temperature
            vel = vel * torch.sqrt(temps[new_rung[blk]]
                                   / temps[rung[blk]])[:, None, None]
            return pos, vel, new_rung, accept, U, energies, diag, start

        def run(states, xgen, ncycles: int, noise=None, uniforms=None):
            pos, vel, gens, rung = states
            draw = noise_source(pos.shape, pos.dtype, pos.device,
                                None if noise is not None else gens, noise)
            out = dict(U=[], rung=[], accept=[])
            energies, diag, start = [], None, None
            for c in range(ncycles):
                u = (uniforms[c] if uniforms is not None else
                     torch.rand(R, generator=xgen, dtype=dtype, device=dev))
                pos, vel, rung, accept, U, es, cdiag, start = cycle(
                    pos, vel, rung, draw, u, c % 2, start)
                energies.extend(es)
                diag = diag_max(diag, cdiag)
                rep = sim.overflow_report(*worst_replica(cdiag))
                if rep:  # the cycle's host read
                    raise RuntimeError(
                        f"capacity overflow in cycle {c} of T-REMD: {rep}; "
                        "regrow the Simulation's capacities and rerun")
                out["U"].append(U)
                out["rung"].append(rung)
                out["accept"].append(accept)
            res = {k: torch.stack(v) for k, v in out.items()}
            res.update(energies=gather_replicas(
                           mesh, torch.stack(energies, dim=1)),
                       counts=diag[0], neighbor_max=diag[1],
                       sibling_max=diag[2], wu_counts=diag[3],
                       shake_residual=diag[4])
            return (pos, vel, gens, rung), res

        return run

    def sample(self, ncycles=10, steps_per_cycle=40, dt=0.001, friction=1.0,
               neighbor_every: int = 40, jitter: float = 1e-3,
               seed: int = 0):
        """Run T-REMD and return the exchange statistics and timing: a
        warm-up run of ncycles, then the timed run of ncycles continuing
        it.  Raises on a capacity overflow in any replica and cycle."""
        run = self.make_runner(dt=dt, friction=friction,
                               steps_per_cycle=steps_per_cycle,
                               neighbor_every=neighbor_every)
        states, xgen = self.initial_states(jitter=jitter, seed=seed)
        states, _ = run(states, xgen, ncycles)
        self.sim._sync()
        t0 = time.perf_counter()
        states, out = run(states, xgen, ncycles)
        self.sim._sync()
        elapsed = time.perf_counter() - t0
        rates = pair_acceptance(out["accept"].cpu().numpy())
        nsteps = ncycles * steps_per_cycle
        ns_day = nsteps * dt * 1e-3 / elapsed * 86400.0
        return dict(states=states, U=out["U"].cpu().numpy(),
                    rung=out["rung"].cpu().numpy(), pair_acceptance=rates,
                    elapsed_s=elapsed, ms_per_step=elapsed * 1e3 / nsteps,
                    ns_day_per_replica=ns_day,
                    energies=out["energies"].cpu().numpy())
