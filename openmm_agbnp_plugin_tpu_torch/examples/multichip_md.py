"""Single-system MD over an `atoms` mesh of ranks.

The port's counterpart of the JAX package's examples/multichip_md.py: trp-cage
AGBNP1 Langevin MD with every step's pair phases and fixed-topology
overlap-tree passes in row blocks over the ranks of a torch.distributed
group (Simulation.make_langevin_runner(mesh=);
parallel/sharding.py::sharded_energy_forces).  The ranks are processes
started by parallel/sharding.py::run_ranks, N_RANKS (8, the JAX example's
device count) by default: on the cards, rank r on card r modulo the card
count (NCCL when each rank has its own, gloo when they share), or on the
CPU with --device cpu (gloo).  Every rank holds the same trajectory.

Usage:  python -m openmm_agbnp_plugin_tpu_torch.examples.multichip_md
            [nsteps] [--ranks R] [--device cpu]        (default 50, 8)
"""

import sys

import numpy as np
import torch

from openmm_agbnp_plugin_tpu_torch.examples import device_dtype, dms_path, \
    parser

N_RANKS = 8


def window_length(nsteps: int) -> int:
    """A rebuild window that divides nsteps (10 where it can), as the JAX
    example picks it."""
    if nsteps % 10 == 0:
        return 10
    if nsteps <= 10:
        return nsteps
    return next(w for w in range(10, 0, -1) if nsteps % w == 0)


def rank_run(nsteps: int):
    """One rank's run: (energies [nsteps], final positions, whether any
    window overflowed, this rank's device)."""
    from openmm_agbnp_plugin_tpu_torch.io.dms import load_dms
    from openmm_agbnp_plugin_tpu_torch.md.simulation import Simulation
    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import atom_mesh

    mesh = atom_mesh()
    dev, dtype = device_dtype(str(mesh.device))
    sim = Simulation(load_dms(dms_path("trpcage_agbnp1")), version=1,
                     dtype=dtype, device=dev)
    run = sim.make_langevin_runner(dt=0.001, temperature=300.0,
                                   neighbor_every=window_length(nsteps),
                                   mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos, vel, energies, diag = run(sim.positions, sim.velocities, nsteps,
                                   generator=gen)
    return energies, pos, sim._check_overflow(*diag), str(dev)


def main(nsteps: int = 50, ranks: int = N_RANKS, device=None):
    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import \
        choose_backend, run_ranks

    dev, _ = device_dtype(device)
    backend = choose_backend(ranks, dev)
    print(f"ranks: {ranks} x {dev.type} ({backend})")
    out = run_ranks(rank_run, ranks, args=(nsteps,), device=dev.type,
                    backend=backend)
    energies, pos, overflow, _ = out[0]
    energies = np.asarray(energies, np.float64)
    same = all(np.array_equal(o[1], pos) and np.array_equal(o[0], out[0][0])
               for o in out)
    ok = (np.isfinite(energies).all() and not overflow and same
          and energies.shape[0] == nsteps)
    print(f"{nsteps} steps sharded over {ranks} ranks "
          f"({', '.join(sorted(set(o[3] for o in out)))}); "
          f"E[0]={energies[0]:.2f} E[-1]={energies[-1]:.2f} kJ/mol; "
          f"ranks {'bitwise equal' if same else 'DIFFER'}")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("nsteps", nargs="?", type=int, default=50)
    p.add_argument("--ranks", type=int, default=N_RANKS)
    args = p.parse_args()
    sys.exit(main(args.nsteps, args.ranks, args.device))
