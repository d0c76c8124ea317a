"""Install check: minimize -> Langevin equilibration -> Verlet
energy-conservation check on trp-cage with AGBNP1 implicit solvent.

The port's counterpart of the JAX package's examples/test_agbnp.py (the
reference's documented install test, example/test_agbnp.py:
DesmondDMSFile + createSystem(OPLS=True, implicitSolvent='AGBNP'),
minimizeEnergy, 10000 Langevin steps at 0.5 fs / 300 K, then 1000 Verlet
steps at 1 fs watching total-energy drift).  The step counts take the same
environment overrides: AGBNP_TEST_LANGEVIN_STEPS, AGBNP_TEST_VERLET_STEPS,
AGBNP_TEST_MINIMIZE_ITERS and the drift bar AGBNP_TEST_DRIFT_TOL.

Usage:  python -m openmm_agbnp_plugin_tpu_torch.examples.test_agbnp
            [system] [--device cpu]          (default trpcage_agbnp1)
"""

import os
import sys
import time

import numpy as np
import torch

from openmm_agbnp_plugin_tpu_torch.examples import device_dtype, dms_path, \
    parser

MAX_REGROW = 3


def main(system=None, device=None):
    from openmm_agbnp_plugin_tpu_torch.io.dms import load_dms
    from openmm_agbnp_plugin_tpu_torch.md.minimize import fire_minimize
    from openmm_agbnp_plugin_tpu_torch.md.simulation import Simulation

    n_lang = int(os.environ.get("AGBNP_TEST_LANGEVIN_STEPS", "10000"))
    n_verlet = int(os.environ.get("AGBNP_TEST_VERLET_STEPS", "1000"))
    n_min = int(os.environ.get("AGBNP_TEST_MINIMIZE_ITERS", "200"))

    system = system or "trpcage_agbnp1"
    dev, dtype = device_dtype(device)
    dms = load_dms(dms_path(system))
    print(f"Started at: {time.asctime()}  (device {dev}, {dms.n} atoms)")

    sim = Simulation(dms, version=1, cutoff=None, dtype=dtype, skin=0.25,
                     device=dev)
    fn = sim.force_fn()
    e0 = fn(sim.positions)[0]
    print(f"Initial potential energy: {float(e0):.3f} kJ/mol")

    print("Minimization/equilibration ...")
    pos, etrace = fire_minimize(fn, sim.positions, maxiter=n_min)
    print(f"Minimized energy: {float(etrace[-1]):.3f} kJ/mol")

    vel = torch.zeros_like(pos)
    for attempt in range(MAX_REGROW + 1):
        run = sim.make_langevin_runner(dt=0.0005, temperature=300.0,
                                       friction=1.0, neighbor_every=20)
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        pos_l, vel_l, energies, diag = run(pos, vel, n_lang, generator=gen)
        sim._sync()
        lang_s = time.perf_counter() - t0
        if not sim._check_overflow(*diag):
            break
        print(f"capacity overflow {sim.overflow_report(*diag)}: regrow")
        sim._regrow(*diag)
    else:
        print("FAIL (capacities did not converge)")
        return 1
    pos, vel = pos_l, vel_l
    print(f"Langevin {n_lang} x 0.5 fs: {lang_s:.1f} s "
          f"({n_lang * 0.0005e-3 / lang_s * 86400:.2f} ns/day), "
          f"final E_pot {float(energies[-1]):.2f} kJ/mol")

    print("Test energy conservation ...")
    vrun = sim.make_verlet_runner(dt=0.001)
    pos2, vel2, pe, ke, _ = vrun(pos, vel, n_verlet)
    sim._sync()
    etot = pe.cpu().numpy().astype(np.float64) + ke.cpu().numpy()
    drift = float(etot[-1] - etot[0])
    drift_rate = drift / (n_verlet * 0.001)  # kJ/mol per ps
    print(f"Total-energy drift over 1 ps Verlet: {drift:+.4f} kJ/mol "
          f"({drift_rate:+.4f} kJ/mol/ps)")
    tol = float(os.environ.get("AGBNP_TEST_DRIFT_TOL", "5.0"))
    ok = bool(np.isfinite(etot).all()) and abs(drift_rate) < tol
    print("PASS" if ok else "FAIL (drift too large)")
    return 0 if ok else 1


if __name__ == "__main__":
    p = parser(__doc__)
    p.add_argument("system", nargs="?", default="trpcage_agbnp1")
    args = p.parse_args()
    sys.exit(main(args.system, args.device))
