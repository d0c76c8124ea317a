"""Temperature replica-exchange MD on trp-cage, the replicas as one batch.

The port's counterpart of the JAX package's examples/remd_trpcage.py: the
whole REMD loop, per-replica AGBNP1 dynamics and the Metropolis rung swaps
(parallel/remd.py), over 8 rungs from 300 to 450 K.

Usage:  python -m openmm_agbnp_plugin_tpu_torch.examples.remd_trpcage
            [ncycles] [steps_per_cycle] [--device cpu]   (default 8 250)
"""

import sys

import numpy as np

from openmm_agbnp_plugin_tpu_torch.examples import device_dtype, dms_path, \
    parser


def main(ncycles: int = 8, spc: int = 250, device=None):
    from openmm_agbnp_plugin_tpu_torch.io.dms import load_dms
    from openmm_agbnp_plugin_tpu_torch.md.simulation import Simulation
    from openmm_agbnp_plugin_tpu_torch.parallel.remd import (
        TemperatureREMD, geometric_ladder)

    dev, dtype = device_dtype(device)
    dms = load_dms(dms_path("trpcage_agbnp1"))
    sim = Simulation(dms, version=1, dtype=dtype, device=dev)
    sim.set_velocities_to_temperature(300.0)

    ladder = geometric_ladder(300.0, 450.0, 8)
    print("ladder (K):", np.round(ladder, 1))
    remd = TemperatureREMD(sim, ladder)
    res = remd.sample(ncycles=ncycles, steps_per_cycle=spc,
                      neighbor_every=40, jitter=1e-3)

    print(f"{ncycles} cycles x {spc} steps:",
          round(res["ns_day_per_replica"], 2), "ns/day per replica,",
          round(res["ns_day_per_replica"] * len(ladder), 1),
          "ns/day aggregate")
    print("adjacent-pair acceptance:", np.round(res["pair_acceptance"], 2))
    print("rung of each replica per cycle:")
    for c, row in enumerate(res["rung"]):
        print(f"  cycle {c}: {row}")
    e = np.asarray(res["energies"], np.float64)
    print(f"potential energy range: {e.min():.2f} .. {e.max():.2f} kJ/mol")
    if not np.isfinite(e).all():
        print("FAIL (non-finite energies)")
        return 1
    return 0


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("ncycles", nargs="?", type=int, default=8)
    p.add_argument("spc", nargs="?", type=int, default=250)
    args = p.parse_args()
    sys.exit(main(args.ncycles, args.spc, args.device))
