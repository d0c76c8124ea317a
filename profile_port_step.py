#!/usr/bin/env python3
"""Where the time of one MD step of the PyTorch/CUDA port goes, on one GPU.

    python3 profile_port_step.py [--steps 40] [--out TABLE.txt]

Runs the port's 1li2 MD configuration (AGBNP1 + OPLS, f32, 1 nm cutoff and
descreening horizon, rebuild every 40 steps) and prints:

  * per-phase wall time of each part of a step, synchronised around every
    call (the eager step is launch-bound, so host time is what it costs);
  * a torch.profiler trace of one rebuild window: device time by kernel,
    kernel launches per step, and the device's busy and idle share.

With --out, also writes the full profiler table to that file.  Needs a
CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port_step: no CUDA device", file=sys.stderr)
        return 1
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.neighbors import \
        half_neighbor_pairs

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", help="file for the full profiler table")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    d = load_dms(os.path.join(HERE, "benchmarks", "data", "1li2_agbnp1.dms"))
    sim = Simulation(d, device=dev, version=1, cutoff=1.0,
                     dtype=torch.float32, skin=0.25,
                     descreen_horizon="cutoff")
    m = sim.agbnp
    ff = sim.ff_state()
    a = ff["a"]
    pos = sim.positions
    mm_nb = dict(sigma=ff["mm"]["sigma"], epsq=ff["mm"]["epsq"],
                 excl_rows_perm=ff["excl_rows_perm"])

    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    pairs = half_neighbor_pairs(pos, sim.heavy_mask, sim.rcut_list, sim.kmax)
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                         a["gamma"] / m.params.roffset, a["ishydrogen"])

    def build():
        return T.build_tree(lvl1, pairs[0], pairs[1], m.caps,
                            pairs_valid=pairs[2], pair_rows=True)

    topo = T.tree_topology(build()[0])
    ap_ = {**a, "pairs_i": pairs[0], "pairs_j": pairs[1],
           "pairs_valid": pairs[2]}
    passes = M.tree_passes(ap_, pos, m.caps, m.params.roffset, topology=topo)
    s_factor = passes[2] / a["vol_vdw_all"]
    pp = M._pair_phases_kernel(a, pos, s_factor, m.cutoff, None, m.pair_pad,
                               horizon=m.descreen_horizon, mm_nb=mm_nb)
    gamma_wu = (pp["evdw_der_W"] + pp["egb_der_U"]) / a["vol_vdw_all"]
    lvl1_wu = {**passes[4], "gamma1i": gamma_wu}
    fn = sim.force_fn(pairs=pairs[:3], topology=topo, ff=ff)
    phases = {
        "neighbor list (per window)": lambda: half_neighbor_pairs(
            pos, sim.heavy_mask, sim.rcut_list, sim.kmax),
        "tree build (per window)": build,
        "tree passes: rescan2 + reduce2": lambda: M.tree_passes(
            ap_, pos, m.caps, m.params.roffset, topology=topo),
        "pair phases: 3 kernels + per-atom chain": lambda:
            M._pair_phases_kernel(a, pos, s_factor, m.cutoff, None,
                                  m.pair_pad, horizon=m.descreen_horizon,
                                  mm_nb=mm_nb),
        "WU pass: rescan_gammas + reduce": lambda: T.reduce_tree(
            T.rescan_gammas(passes[3], lvl1_wu), lvl1_wu,
            with_selfvol=False),
        "MM bonded + 1-4 (autograd)": lambda: sim.mm.bonded_and_14_forces(
            pos, ff["mm"]),
        "whole force_fn": lambda: fn(pos),
    }
    print(f"card: {card}; 1li2 {d.n} atoms, f32; wall ms per call, "
          "synchronised:", flush=True)
    for name, f in phases.items():
        print(f"  {name:42s} {wall_ms(f):9.3f}", flush=True)

    run = sim.make_langevin_runner(neighbor_every=40)
    gen = torch.Generator(device=dev).manual_seed(0)
    run(pos, sim.velocities, args.steps, generator=gen)  # warm-up
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run(pos, sim.velocities, args.steps, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side kernel events only: the operator rows above them carry
    # the same device time again
    kernels = [e for e in ka if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profiled window: {args.steps} steps, wall {wall * 1e3:.1f} ms "
          f"({wall / args.steps * 1e3:.3f} ms/step under the profiler)")
    print(f"  device busy {dev_us / 1e3:.1f} ms = "
          f"{dev_us / 1e6 / wall * 100:.1f}% of wall (idle "
          f"{100 - dev_us / 1e6 / wall * 100:.1f}%); ~{launches / args.steps:.0f}"
          " device kernels per step")
    table = ka.table(sort_by="self_device_time_total", row_limit=25)
    print(table)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(ka.table(sort_by="self_device_time_total",
                              row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
