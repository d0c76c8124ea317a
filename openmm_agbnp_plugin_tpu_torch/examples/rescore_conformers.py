"""Batched conformer rescoring on trp-cage: score a pose ensemble in one
batched AGBNP evaluation.

The port's counterpart of the JAX package's examples/rescore_conformers.py.
The reference plugin scores one conformation per Context evaluation
(openmmapi/src/AGBNPForceImpl.cpp:32-36), so rescoring B poses costs B
serial round trips; here the batch is one evaluation (api/scoring.py).

Usage:  python -m openmm_agbnp_plugin_tpu_torch.examples.rescore_conformers
            [nposes] [batch_reps] [--device cpu]       (default 64 5)
"""

import sys
import time

import numpy as np

from openmm_agbnp_plugin_tpu_torch.examples import device_dtype, dms_path, \
    parser


def main(nposes: int = 64, reps: int = 5, device=None):
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, ConformerScorer
    from openmm_agbnp_plugin_tpu_torch.io.dms import load_dms

    dev, dtype = device_dtype(device)
    dms = load_dms(dms_path("trpcage_agbnp1"))
    n = len(dms.positions)

    force = AGBNPForce()
    force.setVersion(1)
    for i in range(n):
        force.addParticle(dms.agbnp_radius[i], dms.agbnp_gamma[i],
                          dms.agbnp_alpha[i], dms.charges[i],
                          bool(dms.ishydrogen[i]))

    # a stand-in pose ensemble: independently perturbed copies of the
    # crystal conformation (real use: docking poses / MD snapshots)
    rng = np.random.default_rng(0)
    poses = dms.positions[None] + 0.004 * rng.standard_normal(
        (nposes, n, 3))

    scorer = ConformerScorer(force, dms.positions, dtype=dtype, device=dev)

    t0 = time.time()
    res = scorer.score(poses)
    first_s = time.time() - t0

    t0 = time.time()
    for _ in range(reps):
        res = scorer.score(poses)
    per_batch = (time.time() - t0) / reps

    e = res["energy"].cpu().numpy().astype(np.float64)
    if not np.isfinite(e).all():
        print("FAIL (non-finite energies)")
        return 1
    order = np.argsort(e)
    print(f"system: trp-cage ({n} atoms), {nposes} poses")
    print(f"first call (incl. kernel build): {first_s:.2f} s")
    print(f"steady state: {per_batch * 1e3:.1f} ms/batch = "
          f"{nposes / per_batch:.0f} poses/s")
    print(f"best pose: #{order[0]} at {e[order[0]]:.2f} kJ/mol; "
          f"spread {e.max() - e.min():.2f} kJ/mol")
    print("top 5:", ", ".join(f"#{i} {e[i]:.2f}" for i in order[:5]))
    return 0


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("nposes", nargs="?", type=int, default=64)
    p.add_argument("reps", nargs="?", type=int, default=5)
    args = p.parse_args()
    sys.exit(main(args.nposes, args.reps, args.device))
