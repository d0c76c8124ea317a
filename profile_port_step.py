#!/usr/bin/env python3
"""Where the time of one MD step of the PyTorch/CUDA port goes, on one GPU.

    python3 profile_port_step.py [SYSTEM] [--dense] [--mts-wu4]
                                 [--steps 40] [--out TABLE.txt]

Runs the port's MD configuration on SYSTEM (a name under benchmarks/data,
1li2 by default, e.g. 2clr; or a path to a .dms file): AGBNP1 + OPLS, f32,
1 nm cutoff and descreening horizon, rebuild every 40 steps, the vdW-
compact WU pass, the pair sweeps on interacting-tile lists (--dense: on
the dense grid), tree capacities sized first by single evaluations: the
JAX package's bench.py strict run; with --mts-wu4 its headline run (the WU
pass as an r-RESPA impulse every 4 steps).  It prints:

  * per-phase wall time of each part of a step, synchronised around every
    call (the eager step is launch-bound, so host time is what it costs),
    including the per-window WU compaction, the WU pass on the full and
    the compacted topology, the WU-impulse block's split and skip
    evaluations, and SHAKE and RATTLE on the DMS X-H constraint tables
    (an outer step of bench.py's mts4fs_constraints run applies SHAKE
    twice and RATTLE three times);
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
    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
        Simulation, load_dms
    from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    ap = argparse.ArgumentParser()
    ap.add_argument("system", nargs="?", default="1li2",
                    help="name under benchmarks/data or a .dms path")
    ap.add_argument("--dense", action="store_true",
                    help="pair sweeps on the dense grid, not tile lists")
    ap.add_argument("--mts-wu4", action="store_true",
                    help="profile the window with the WU pass as an "
                         "r-RESPA impulse every 4 steps (bench.py's "
                         "headline run)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--out", help="file for the full profiler table")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    path = (args.system if args.system.endswith(".dms") else os.path.join(
        HERE, "benchmarks", "data", f"{args.system}_agbnp1.dms"))
    d = load_dms(path)
    kw = dict(cutoff=1.0, descreen_horizon="cutoff",
              pair_tiles=False if args.dense else None)
    # size the tree capacities on the initial configuration first
    sizing = AGBNPModel(AGBNPParams(
        radius=d.agbnp_radius, gamma=d.agbnp_gamma, alpha=d.agbnp_alpha,
        charge=d.charges, ishydrogen=d.ishydrogen), device=dev,
        dtype=torch.float32, positions=d.positions, **kw)
    for _ in range(8):
        out = sizing.energy_forces(d.positions, with_details=True)[2]
        if not sizing.check_and_grow(out["diag"]):
            break
    sim = Simulation(d, device=dev, version=1, dtype=torch.float32,
                     skin=0.25, caps=sizing.caps, **kw)
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

    pairs = sim.neighbor_fn(pos, sim.heavy_mask, sim.rcut_list, sim.kmax)
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
    pair_kw = dict(horizon=m.descreen_horizon, mm_nb=mm_nb,
                   pair_tiles=m.pair_tiles, share_qd=m.share_qd)
    pp = M._pair_phases_kernel(a, pos, s_factor, m.cutoff, None, m.pair_pad,
                               **pair_kw)
    gamma_wu = (pp["evdw_der_W"] + pp["egb_der_U"]) / a["vol_vdw_all"]
    lvl1_wu = {**passes[4], "gamma1i": gamma_wu}
    lvl1v = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"],
                          -a["gamma"] / m.params.roffset, a["ishydrogen"])
    vdw_caps = sim._ensure_vdw_caps()

    def compaction():
        return T.compact_topology(T.rescan_volumes(topo, lvl1v), vdw_caps)

    vdw_topo = compaction()[0]
    lvl1_wuc = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"], gamma_wu,
                             a["ishydrogen"])
    mk = dict(pairs=pairs[:3], topology=topo, ff=ff, vdw_topology=vdw_topo)
    fn = sim.force_fn(**mk)
    split_fn = sim.force_fn(wu_mode="split", **mk)
    skip_fn = sim.force_fn(wu_mode="skip", **mk)
    phases = {
        "neighbor list (per window)": lambda: sim.neighbor_fn(
            pos, sim.heavy_mask, sim.rcut_list, sim.kmax),
        "tree build (per window)": build,
        "WU compaction (per window)": compaction,
        "tree passes: rescan2 + reduce2": lambda: M.tree_passes(
            ap_, pos, m.caps, m.params.roffset, topology=topo),
        "pair phases: 3 kernels + per-atom chain": lambda:
            M._pair_phases_kernel(a, pos, s_factor, m.cutoff, None,
                                  m.pair_pad, **pair_kw),
        "WU pass, full topology": lambda: T.reduce_tree(
            T.rescan_gammas(passes[3], lvl1_wu), lvl1_wu,
            with_selfvol=False),
        "WU pass, compacted topology": lambda: T.reduce_tree(
            T.rescan_volumes(vdw_topo, lvl1_wuc), lvl1_wuc,
            with_selfvol=False),
        "MM bonded + 1-4 (autograd)": lambda: sim.mm.bonded_and_14_forces(
            pos, ff["mm"]),
        "whole force_fn (compacted WU pass)": lambda: fn(pos),
        "mts_wu4 block start: split force_fn": lambda: split_fn(pos),
        "mts_wu4 other steps: skip force_fn": lambda: skip_fn(pos),
    }
    cons = Constraints.from_dms(d, device=dev)
    if cons is not None:
        gen = torch.Generator(device=dev).manual_seed(1)
        moved = pos + 0.002 * torch.randn(pos.shape, generator=gen,
                                          dtype=pos.dtype, device=dev)
        pos_c = cons.positions(pos, pos)
        vel = torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                          device=dev)
        phases[f"SHAKE ({cons.sweeps} Newton sweeps)"] = \
            lambda: cons.shake(moved, pos_c)
        phases["RATTLE"] = lambda: cons.velocities(pos_c, vel)
    print(f"card: {card}; {os.path.basename(path)} {d.n} atoms, f32, "
          f"pair_tiles {m.pair_tiles}, cell grid {sim.grid is not None}, "
          f"caps {m.caps}; wall ms per call, synchronised:", flush=True)
    for name, f in phases.items():
        print(f"  {name:42s} {wall_ms(f):9.3f}", flush=True)

    wu_every = 4 if args.mts_wu4 else 1
    run = sim.make_langevin_runner(neighbor_every=40, wu_every=wu_every)
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
    print(f"profiled window (wu_every={wu_every}): {args.steps} steps, wall "
          f"{wall * 1e3:.1f} ms "
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
