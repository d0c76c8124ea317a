#!/usr/bin/env python3
"""Where the time of one MD step of the PyTorch/CUDA port goes, on one GPU.

    python3 profile_port_step.py [SYSTEM] [--dense] [--mts-wu4]
                                 [--steps 40] [--out TABLE.txt]
    python3 profile_port_step.py [SYSTEM] --list-kernels
    python3 profile_port_step.py [SYSTEM] --caps-compare [--steps 200]
    python3 profile_port_step.py [SYSTEM] --row-probes [ROWS PARENTS REPS]
    python3 profile_port_step.py [SYSTEM] --device-shares [--dense]
                                 [--steps 200] [--root DIR] [--dump F.npz]
                                 [--version 0|1|2]
    python3 profile_port_step.py --same A.npz B.npz
    python3 profile_port_step.py --synth-trace [NATOMS] [--steps 400]

Runs the port's MD configuration on SYSTEM (a name under benchmarks/data,
1li2 by default, e.g. 2clr; or a path to a .dms file): AGBNP1 + OPLS, f32,
1 nm cutoff and descreening horizon, rebuild every 40 steps, the vdW-
compact WU pass, the pair sweeps on interacting-tile lists (--dense: on
the dense grid), the lean tree capacities the Simulation sizes from the
DMS positions: the JAX package's bench.py strict run; with --mts-wu4 its headline run (the WU
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

With --out, also writes the full profiler table to that file.

With --list-kernels it profiles the pair sweeps alone instead: the
interacting-tile-list sweeps on SYSTEM's lists as chip_smoke.py [2] builds
them (Born and descreening at horizon 1 nm, the reload from the Born
kernel's Q/dQ and keep bits, GB at cutoff 1 nm, MM fused; Born also
without its Q/dQ stores), and the dense sweeps over SYSTEM's chunk list
(the list itself; Born building its own list as the model runs it, also
walking a given one and without its Q/dQ stores; the reload from the Born
kernel's chunk-layout Q/dQ; the recompute): the 32x32 sub-tile
pairs the list kernels keep and the chunk slots the dense ones walk, and
for each sweep the CUDA-event time per call and the profiler's device time
of each of its kernels (the sweep, the reduce); the list descreening
sweeps at the column-group count the wrapper picks and at every fixed one
(the reload from Q/dQ and keep bits of a Born sweep run at that count),
the dense Born and descreening sweeps at the warps a block the wrapper
picks and at every fixed count.

With --caps-compare it times the strict run (--steps of it, after an equal
warm-up) at the padded position-free tree capacities and at the lean ones
the Simulation sizes from its positions, in turns within the one call, and
prints ms/step beside the rows per level.

With --row-probes [ROWS] [PARENTS] [REPS] (defaults 85504 34816 50) it
runs the row-move probe instead, the counterpart of the JAX package's
benchmarks/micro_pallas_gather.py: device ms and ns/row of the stock sorted
gather `table[ids]`, `torch.index_select`, the port's `segment_sum` over
every row (the padding rows form one long segment) and the sum with the
level's own lengths, which count its valid rows alone, the hand kernel
`take_rows`, `torch.cumsum`, the hand kernel `cumsum_rows` (beside
it built without its in-kernel state reset, over states zeroed ahead and
over a fresh `torch.zeros` state a call), and the whole gather-free
broadcast (boundary diffs scattered, then
`cumsum_rows`), with the broadcast's largest deviation from the gather; at
the probe's shape (segment ids from numpy seed 0, an 8-column f32 table)
and at the widest level of SYSTEM's overlap tree (2clr by default) from the
model's own tree pass; then `take_rows` beside the stock gather at every
width the tree's passes gather (1, 6, 12, 13, 26 columns) and at the padded
widths 16 and 28.  Each hand kernel is first held against its plain twin on
the timed inputs.

With --device-shares it times the strict run (--steps of it on the host
clock, after an equal warm-up) and then profiles one 40-step rebuild
window: device ms and kernel launches per step, and the shares of
`torch.segment_reduce`, of PyTorch's own index and gather kernels, and of
the hand kernel `take_rows` in the device time, and the pair sweeps' hand
kernels one by one (device ms and launches a step); --version 0 or 2 runs
that AGBNP version's Simulation instead (version 2: AGBNP2, its pair phases
on the dense grid).  --root DIR imports the
package from another checkout of this repository (an older commit unpacked
into DIR) instead of this one, so that two commits can be compared within
one call on one card; --dump F.npz saves what the run computed (one force
evaluation of each kind at the start, the timed run's energies and final
state), and --same A.npz B.npz reports whether two such files are equal
bit for bit.

With --synth-trace [NATOMS] (10,240 by default) it runs
utils/synthetic.py's windowed protocol on the synthetic ball (f32, 1 nm,
20-step windows, --steps of it, 400 by default: bench.py's synth10k leg)
and prints each clean window's first and last energy, kinetic temperature
and largest speed, until the protocol ends or stops on a window whose
dynamics blew up; then it replays the last two windows it started from
their recorded start (positions, velocities, the generator's noise), a
step a call, once with the f32 kernels and once on the f64 plain route
(pair_kernel=False), printing each step's energy and largest speed: the
two agree where the blow-up is the dynamics', not a kernel's or f32's.

Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def profile_list_kernels(dev, card, system):
    """--list-kernels: the list sweeps and the dense chunk sweeps, the list
    descreening ones at each column-group count, the dense ones at each
    count of warps a block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import cuda_time_ms, kernel_inputs, tile_list
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    inp = kernel_inputs(dev, system)
    tile = inp["tile"]
    pos_pad, pos_h = inp["born_args"][:2]
    rvalid, hvalid = inp["valid"]
    tl, nv, what_b = tile_list(inp, 1.0)
    tlg, nvg, what_g = tile_list(inp, 1.0, triangular=True)
    sp = inp["spline"]._replace(horizon=1.0)
    args = (nv, tl, *inp["born_args"], tile)
    dargs = (nv, tl, *inp["desc_args"])
    gargs = (nvg, tlg, *inp["gb_args"], tile)
    n = inp["born_args"][-1]
    chunks = PK.subtile_columns(pos_pad, pos_h, sp.hids_perm, n, horizon=1.0)
    slots = int(PK.chunk_slots(chunks).sum()) * 32
    kept_b = int(TL.subtile_live(nv, tl, pos_pad, rvalid, pos_h, hvalid,
                                 tile, 1.0).sum())
    kept_g = int(TL.subtile_live(nvg, tlg, pos_pad, rvalid, pos_pad, rvalid,
                                 tile, 1.0, triangular=True).sum())
    print(f"card: {card}; {system} pair sweeps, f32, T {tile}: Born list "
          f"{what_b}, {kept_b} kept 32x32 sub-tile pairs; GB list {what_g}, "
          f"{kept_g} kept; dense chunk list {int(chunks.ncols.sum())} "
          f"columns of {chunks.cols.numel()}, {slots} chunk slots walked",
          flush=True)

    def born():
        return TL.born_sums_tiles(*args, horizon=1.0, save_qd=True)

    def reload():
        # the Born kernel's Q/dQ and keep bits, at this setting's groups
        qd = born()[1:]
        return lambda: TL.descreening_tiles(*dargs, qd, tile, spline=sp)

    born_args, desc_args = inp["born_args"], inp["desc_args"]

    def dense_born(save_qd=True, given=None):
        # as the model runs it, building its chunk list; or walking `given`
        return PK.born_sums(*born_args, horizon=1.0, save_qd=save_qd,
                            chunks=given)

    def dense_reload():
        # the Born kernel's Q/dQ, at this setting's warps
        qd = dense_born()[1:]
        return lambda: PK.descreening(*desc_args, qd)

    # name -> (the knob that varies: None, "groups" (the list descreening
    # sweeps' column groups) or "warps" (the dense sweeps' warps a block);
    # a function that returns the call to time under the setting)
    sweeps = {
        "born_sums_tiles": (None, lambda: born),
        # the same sweep without its Q/dQ stores: what the stores cost
        "born_sums_tiles, raw only": (None, lambda: lambda:
                                      TL.born_sums_tiles(*args, horizon=1.0)),
        "gb_pair_tiles (MM)": (None, lambda: lambda: TL.gb_pair_tiles(
            *gargs, **inp["mm_kw"])),
        "descreening_tiles": ("groups", reload),
        "descreening_tiles_recompute": ("groups", lambda: lambda:
                                        TL.descreening_tiles(
                                            *dargs, None, tile, spline=sp)),
        "subtile_columns (dense chunk list)": (None, lambda: lambda:
                                               PK.subtile_columns(
                                                   pos_pad, pos_h,
                                                   sp.hids_perm, n,
                                                   horizon=1.0)),
        "born_sums (dense)": ("warps", lambda: dense_born),
        "born_sums (dense), given list": ("warps", lambda: lambda:
                                          dense_born(given=chunks)),
        "born_sums (dense), raw only": ("warps", lambda: lambda:
                                        dense_born(False)),
        "descreening (dense reload)": ("warps", dense_reload),
        "descreening (dense recompute)": ("warps", lambda: lambda:
                                          PK.descreening(
                                              *desc_args, None, spline=sp,
                                              chunks=chunks)),
        # the same two at 16 warps a block and P blocks a sub-tile
        "descreening (dense reload), split": ("parts", dense_reload),
        "descreening (dense recompute), split": ("parts", lambda: lambda:
                                                 PK.descreening(
                                                     *desc_args, None,
                                                     spline=sp,
                                                     chunks=chunks)),
    }
    picked, picked_w, picked_p = TL.column_groups, PK.chunk_warps, \
        PK.chunk_parts
    settings = dict(groups=[g for g in (1, 2, 4, 8) if g <= tile // 32],
                    warps=[w for w in (1, 2, 4, 8, 16)
                           if w <= PK.MAX_CHUNK_WARPS],
                    parts=[p for p in (1, 2, 4) if p <= PK.MAX_CHUNK_PARTS])
    try:
        for name, (knob, make) in sweeps.items():
            for v in [0] + settings[knob] if knob else [None]:
                TL.column_groups = picked if not (knob == "groups" and v) \
                    else (lambda *a, v=v: v)
                PK.chunk_warps = picked_w if not (knob == "warps" and v) \
                    else (lambda *a, v=v: v)
                PK.chunk_parts = picked_p if not (knob == "parts" and v) \
                    else (lambda *a, v=v: v)
                fn = make()
                ms = cuda_time_ms(fn, 50)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        fn()
                    torch.cuda.synchronize()
                rows = sorted((e for e in prof.key_averages()
                               if e.device_time_total > 0),
                              key=lambda e: -e.device_time_total)
                label = ""
                if knob == "groups":
                    label = f" ng={TL.column_groups(tl.shape[1], tile, dev)}"
                elif knob == "warps":
                    label = f" warps={PK.chunk_warps(pos_h.shape[1])}"
                elif knob == "parts":
                    label = f" parts={PK.chunk_parts(pos_h.shape[1])}"
                if knob and not v:
                    label += " (picked)"
                print(f"  {name}{label}: {ms:.4f} ms/call; " + "; ".join(
                    f"{e.key.split('(')[0].split()[-1]} "
                    f"{e.device_time_total / 20:.1f} us x{e.count / 20:g}"
                    for e in rows), flush=True)
    finally:
        TL.column_groups, PK.chunk_warps, PK.chunk_parts = picked, \
            picked_w, picked_p
    return 0


def caps_compare(dev, card, dms, steps, kw):
    """--caps-compare: bench.py's strict run (1 fs, rebuilds every 40
    steps) at the padded tree capacities a Simulation had before it sized
    them (TreeCaps.for_natoms, grown until clean) and at the lean ones it
    sizes now (caps_boost 1.10), in turns padded, lean, lean, padded within
    this one call; each after an equal warm-up."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation, TreeCaps

    def simulation(caps):
        return Simulation(dms, device=dev, version=1, dtype=torch.float32,
                          skin=0.25, caps=caps, **kw)

    print(f"card: {card}; {dms.n} atoms, f32, strict run, {steps} steps "
          "after an equal warm-up, ms/step on the host clock", flush=True)
    for which in ("padded", "lean", "lean", "padded"):
        sim = simulation(TreeCaps.for_natoms(dms.n) if which == "padded"
                         else None)
        r = sim.benchmark_langevin(nsteps=steps, neighbor_every=40)
        caps = sim.agbnp.caps
        print(f"  {which:6s}: {r['elapsed_s'] / r['steps_run'] * 1e3:8.3f} "
              f"ms/step ({r['ns_day']:.3f} ns/day), regrows {r['regrows']}, "
              f"overflow {r['overflow']}; rows per level {caps.caps} = "
              f"{sum(caps.caps)}, windows {caps.offs}", flush=True)
    return 0


def row_probes(dev, card, rows=85504, parents=34816, reps=50,
               system="2clr"):
    """--row-probes: the sorted row gather and its alternatives, timed on
    the card.  Returns {shape label: {probe: ms}}."""
    import torch

    from chip_smoke import (PADDED_WIDTHS, TREE_WIDTHS, cuda_time_ms,
                            probe_inputs, tree_width_tables, widest_level)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW
    from openmm_agbnp_plugin_tpu_torch.ops.tree import (
        segment_sum, sorted_lengths, sorted_segment_sum)

    ids, table, x = probe_inputs(dev, rows, parents)
    lvl = widest_level(dev, system)
    print(f"card: {card}; row probes, f32 x 8 columns, device ms per call "
          f"over {reps} calls (CUDA events behind a device sleep)",
          flush=True)
    results = {}
    for label, tab, idv, payload, lengths in (
            (f"probe: {rows} rows from {parents} parents", table, ids, x,
             None),
            (lvl["label"], lvl["table"], lvl["pmono32"], None,
             lvl["lengths"])):
        nrows, npar = idv.shape[0], tab.shape[0]
        ids64 = idv.long()
        if lengths is None:
            lengths = sorted_lengths(ids64, torch.ones_like(ids64,
                                                            dtype=torch.bool),
                                     npar)
        gathered = RW.take_rows(tab, idv)
        if not torch.equal(gathered, RW.take_rows_reference(tab, idv)):
            raise AssertionError(f"take_rows differs from its twin ({label})")
        if payload is None:
            # as the passes hand it to the sum: zero on the padding rows
            payload = gathered * (torch.arange(nrows, device=dev)
                                  < lvl["nvalid"])[:, None]
        summed = RW.cumsum_rows(payload)
        scale = float(torch.cumsum(payload.double().abs(), 0).max())
        err = float((summed.double()
                     - torch.cumsum(payload.double(), 0)).abs().max())
        if not torch.equal(summed, RW.cumsum_rows(payload)) \
                or not err <= 1e-5 * scale:
            raise AssertionError(f"cumsum_rows: not repeatable or {err:.3e} "
                                 f"from f64 at scale {scale:.4g} ({label})")
        if not torch.equal(
                segment_sum(payload, ids64, npar, ids_sorted=True),
                sorted_segment_sum(payload, lengths)):
            raise AssertionError("segment_sum over the valid rows differs "
                                 f"from the sum over every row ({label})")
        starts = RW.row_starts(idv)
        probes = {
            "table[ids] (stock gather)": lambda: tab[ids64],
            "torch.index_select": lambda: torch.index_select(tab, 0, idv),
            # a level's padding rows share one parent's id: one long
            # segment that the valid rows alone do not have
            "segment_sum (sorted), every row": lambda: segment_sum(
                payload, ids64, npar, ids_sorted=True),
            "segment sum, the level's lengths": lambda: sorted_segment_sum(
                payload, lengths),
            "take_rows (hand kernel)": lambda: RW.take_rows(tab, idv),
            "torch.cumsum": lambda: torch.cumsum(payload, 0),
            "cumsum_rows (hand kernel)": lambda: RW.cumsum_rows(payload),
            "cumsum broadcast + diff scatter": lambda: RW.cumsum_rows(
                RW.boundary_diffs(tab, starts, nrows)),
        }
        print(f"{label} ({starts[0].shape[0]} segments)", flush=True)
        results[label] = {}
        for name, fn in probes.items():
            ms = cuda_time_ms(fn, reps)
            results[label][name] = ms
            print(f"  {name:32s}: {ms:8.4f} ms ({ms / nrows * 1e6:7.3f} "
                  "ns/row)", flush=True)
        for name, ms in cumsum_reset_probe(dev, payload, reps).items():
            results[label][name] = ms
            print(f"  {name:32s}: {ms:8.4f} ms", flush=True)
        print(f"  cumsum_rows vs f64: {err / scale:.3e} of max cumsum|d|; "
              f"broadcast's max deviation from the gather: "
              f"{RW.broadcast_deviation(tab, idv):.3e} (max|v| "
              f"{float(tab.abs().max()):.4g})", flush=True)
    label = f"{lvl['label']}, the tree's widths"
    print(f"{label}: take_rows beside the stock gather table[ids] (int64 "
          "ids, as the passes ran it before)", flush=True)
    results[label] = {}
    for cols, which, tab, iv in tree_width_tables(
            dev, lvl, TREE_WIDTHS + PADDED_WIDTHS):
        ids64 = iv.long()
        out = RW.take_rows(tab, iv)
        if not torch.equal(out, tab[ids64]):
            raise AssertionError(f"take_rows differs from the stock gather "
                                 f"at {cols} columns, {which} ids")
        ms = cuda_time_ms(lambda: RW.take_rows(tab, iv), reps)
        stock = cuda_time_ms(lambda: tab[ids64], reps)
        results[label][f"{cols} columns, {which} ids"] = (ms, stock)
        print(f"  {cols:2d} columns, {which:6s} ids, "
              f"{RW.take_rows_piece_bytes(tab, out):2d}-byte pieces: "
              f"take_rows {ms:8.4f} ms, table[ids] {stock:8.4f} ms",
              flush=True)
    return results


def cumsum_reset_probe(dev, payload, reps):
    """What cumsum_rows' in-kernel reset costs: the kernel as built (the
    wrapper keeps a zeroed state a stream and the last tile clears it
    again) beside csrc/rows.cu built alone with -DCUMSUM_NO_RESET (no done
    count, no clear), over states zeroed ahead of the timed calls and over
    a fresh torch.zeros state a call (the design the reset replaces: one
    fill launch more).  Each variant is first held bitwise to the wrapper.
    Returns {probe: ms}; {} for a checkout whose rows.cu has no switch."""
    import ctypes

    import torch

    from chip_smoke import cuda_time_ms
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW
    from openmm_agbnp_plugin_tpu_torch.runtime import build

    src = build.CSRC / "rows.cu"
    if "CUMSUM_NO_RESET" not in src.read_text():
        return {}
    so = build.library_path().parent / "cumsum_no_reset.so"
    if not so.exists():
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DCUMSUM_NO_RESET",
                        "-shared", "-o", str(so), str(src)], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(str(so))
    scan = lib.agbnp_cumsum_rows
    scan.argtypes = list(build.SIGNATURES["agbnp_cumsum_rows"])
    nrows, ncols = payload.shape
    need = lib.agbnp_cumsum_state_ints(nrows, ncols)
    ntiles = -(-nrows // RW.cumsum_layout(ncols)[1])
    scratch = torch.empty((ntiles + -(-ntiles // RW.GROUP_TILES)) * ncols,
                          dtype=torch.float32, device=dev)
    out = torch.empty_like(payload)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(state):
        rc = scan(payload.data_ptr(), nrows, ncols, state.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"cumsum_rows without reset: CUDA error {rc}")

    def fresh():
        return torch.zeros(need, dtype=torch.int32, device=dev)

    run(fresh())
    if not torch.equal(out, RW.cumsum_rows(payload)):
        raise AssertionError("cumsum_rows without reset differs from the "
                             "kernel as built")
    ahead = iter([fresh() for _ in range(reps + 1)])
    return {
        "cumsum_rows, reset by last tile": cuda_time_ms(
            lambda: RW.cumsum_rows(payload), reps),
        "no reset, state zeroed ahead": cuda_time_ms(
            lambda: run(next(ahead)), reps),
        "no reset, torch.zeros a call": cuda_time_ms(
            lambda: run(fresh()), reps),
    }


def _device_kernels(prof):
    """The profiler's device-side kernel events (the operator rows above
    them carry the same device time again)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]


# kernel-name fragments of the three row movers whose shares
# --device-shares reports
SHARE_GROUPS = {
    "torch.segment_reduce": ("segment_reduce",),
    "PyTorch index/gather kernels": ("index_elementwise", "indexSelect",
                                     "index_select", "vectorized_gather",
                                     "gather_kernel", "indexFuncLargeIndex",
                                     "indexFuncSmallIndex"),
    "take_rows (hand kernel)": ("take_rows_kernel",),
    # the pair sweeps' hand kernels, of any commit: Born, GB, descreening,
    # their reduces and work lists
    "pair sweeps (hand kernels)": ("born_", "gb_subtiles", "descreen_",
                                   "subtile_reduce", "subtile_columns",
                                   "column_sums"),
}
# groups whose kernels are also listed one by one
SHARE_ITEMIZED = ("pair sweeps (hand kernels)",)


def device_shares(dev, card, dms, steps, kw, dump=None, version=1):
    """--device-shares: the strict run's ms/step on the host clock, then one
    profiled rebuild window's device time, launches and the row movers'
    shares of it.  version 0 or 2 runs that AGBNP version's Simulation
    (version 2 takes the cutoff alone: its pair phases run the dense grid
    with the 2 nm horizon, as in JAX)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import openmm_agbnp_plugin_tpu_torch as pkg
    from openmm_agbnp_plugin_tpu_torch import Simulation

    window = 40
    if version == 2:
        kw = dict(cutoff=kw["cutoff"])
    sim = Simulation(dms, device=dev, version=version, dtype=torch.float32,
                     skin=0.25, **kw)
    r = sim.benchmark_langevin(nsteps=steps, neighbor_every=window)
    ms_step = r["elapsed_s"] / r["steps_run"] * 1e3
    print(f"card: {card}; package {os.path.dirname(pkg.__file__)}; "
          f"{dms.n} atoms, f32, AGBNP version {version}, strict run, "
          f"pair_tiles {getattr(sim.agbnp, 'pair_tiles', None)}, tree rows "
          f"{sum(sim.agbnp.caps.caps)}", flush=True)
    print(f"  {steps} steps after an equal warm-up: {ms_step:.3f} ms/step on "
          f"the host clock ({r['ns_day']:.3f} ns/day), regrows "
          f"{r['regrows']}, overflow {r['overflow']}", flush=True)
    run = sim.make_langevin_runner(neighbor_every=window)
    gen = torch.Generator(device=dev).manual_seed(0)
    pos, vel = sim.positions, sim.velocities
    run(pos, vel, window, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(pos, vel, window, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = _device_kernels(prof)
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    dev_step = dev_us / 1e3 / window
    # the profiler slows the host many times over: the idle share is taken
    # against the timed run's step
    print(f"  profiled window of {window} steps: device {dev_us / 1e3:.1f} ms "
          f"= {dev_step:.3f} ms/step in {launches / window:.0f} kernels a "
          f"step ({wall / window * 1e3:.1f} ms/step under the profiler); "
          f"the device is idle {100 - dev_step / ms_step * 100:.1f}% of the "
          f"timed {ms_step:.3f} ms step", flush=True)
    for group, frags in SHARE_GROUPS.items():
        es = [e for e in kernels if any(f in e.key for f in frags)]
        us = sum(e.self_device_time_total for e in es)
        n = sum(e.count for e in es)
        print(f"    {group:30s} {us / 1e3 / window:8.4f} ms/step = "
              f"{us / max(dev_us, 1) * 100:5.2f}% of device time, "
              f"{n / window:6.1f} launches a step", flush=True)
        if group in SHARE_ITEMIZED:
            for e in sorted(es, key=lambda e: -e.self_device_time_total):
                print(f"      {e.self_device_time_total / 1e3 / window:8.4f} "
                      f"ms/step x{e.count / window:5.2f}  {e.key[:70]}",
                      flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"    top: {e.self_device_time_total / 1e3 / window:8.4f} "
              f"ms/step x{e.count / window:6.1f}  {e.key[:90]}", flush=True)
    if dump and version == 1:
        # one evaluation of each kind at a window start, and the timed run
        from chip_smoke import window_start

        w = window_start(sim, pos)
        mk = dict(pairs=w["pairs"], topology=w["topology"],
                  ff=sim.ff_state(), vdw_topology=w["vdw_topology"])
        out = dict(energies=np.asarray(r["energies"]),
                   final_pos=r["final_pos"].cpu().numpy())
        for mode in ("fused", "split", "skip"):
            res = sim.force_fn(wu_mode=mode, **mk)(pos)
            for k, v in enumerate(res):
                if isinstance(v, torch.Tensor):
                    out[f"{mode}_{k}"] = v.cpu().numpy()
        os.makedirs(os.path.dirname(os.path.abspath(dump)), exist_ok=True)
        np.savez(dump, **out)
        print(f"  wrote {sorted(out)} to {dump}", flush=True)
    return 0


def same_dumps(path_a, path_b) -> int:
    """--same: whether two --dump files hold the same arrays bit for bit."""
    import numpy as np

    a, b = np.load(path_a), np.load(path_b)
    equal = sorted(a.files) == sorted(b.files)
    for k in sorted(set(a.files) & set(b.files)):
        same = a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        worst = (float(np.abs(a[k].astype(np.float64) - b[k]).max())
                 if a[k].shape == b[k].shape and a[k].size else float("nan"))
        print(f"  {k:12s} {str(a[k].shape):14s} bitwise {same}, max|a - b| "
              f"{worst:.3e}, max|a| {float(np.abs(a[k]).max()):.6g}")
        equal = equal and same
    print(f"{path_a} vs {path_b}: {'equal bit for bit' if equal else 'DIFFER'}")
    return 0 if equal else 1


def synth_trace(dev, card, natoms: int = 10240, steps: int = 400) -> int:
    """The synthetic ball's windowed MD, window by window, and a replay in
    f32 kernels and f64 plain of the last two windows it started (see the
    module docstring)."""
    import json

    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation
    from openmm_agbnp_plugin_tpu_torch.runtime import build
    from openmm_agbnp_plugin_tpu_torch.utils import synthetic as S

    build.load_library()
    every = 20
    sim = Simulation(S.synthetic_dms(natoms), device=dev, version=1,
                     cutoff=1.0, dtype=torch.float32)
    make = sim.make_langevin_runner
    starts = []

    def recording(*args, **kw):
        run = make(*args, **kw)

        def window(pos, vel, nsteps, generator=None):
            starts.append((pos, vel, generator.get_state()))
            out = run(pos, vel, nsteps, generator=generator)
            print(json.dumps(dict(
                window=len(starts) - 1, e_first=float(out[2][0]),
                e_last=float(out[2][-1]),
                vmax=float(out[1].abs().max()),
                overflow=sorted(sim.overflow_report(*out[3])))), flush=True)
            return out

        return window

    sim.make_langevin_runner = recording
    print(f"synth-trace: {natoms} atoms, {steps} steps in {every}-step "
          f"windows on {card}", flush=True)
    try:
        r = S._run_md_windows(sim, steps, every)
        print(f"ended clean: {r['windows']} timed windows, {r['regrows']} "
              f"regrows; temperatures "
              f"{[round(w[3], 1) for w in r['window_log']]}", flush=True)
    except RuntimeError as exc:
        print(f"stopped: {exc}", flush=True)
    sim.make_langevin_runner = make
    for back in (2, 1):
        pos, vel, state = starts[-back]
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        noise = torch.stack([torch.randn(pos.shape, generator=gen,
                                         dtype=torch.float32, device=dev)
                             for _ in range(every)])
        dms = S.synthetic_dms(natoms)
        dms.positions = pos.double().cpu().numpy()
        for dtype in (torch.float32, torch.float64):
            s = Simulation(dms, device=dev, version=1, cutoff=1.0,
                           dtype=dtype, pair_kernel=dtype == torch.float32)
            run = s.make_langevin_runner(0.001, 300.0, 1.0,
                                         neighbor_every=every)
            p, v = pos.to(dtype), vel.to(dtype)
            es, vmax, over = [], [], []
            for i in range(every):
                p, v, e, diag = run(p, v, 1, noise=noise[i:i + 1].to(dtype))
                es.append(float(e[0]))
                vmax.append(float(v.abs().max()))
                over += [i] if s.overflow_report(*diag) else []
            print(json.dumps(dict(
                replay=len(starts) - back, dtype=str(dtype),
                pair_kernel=s.agbnp.pair_kernel, energies=es,
                vmax=vmax, overflowed_steps=over)), flush=True)
            del s, run
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("system", nargs="?",
                    help="name under benchmarks/data or a .dms path (1li2; "
                         "with --row-probes 2clr, names only)")
    ap.add_argument("--dense", action="store_true",
                    help="pair sweeps on the dense grid, not tile lists")
    ap.add_argument("--mts-wu4", action="store_true",
                    help="profile the window with the WU pass as an "
                         "r-RESPA impulse every 4 steps (bench.py's "
                         "headline run)")
    ap.add_argument("--steps", type=int,
                    help="steps to run (40; 200 with --device-shares)")
    ap.add_argument("--out", help="file for the full profiler table")
    ap.add_argument("--list-kernels", action="store_true",
                    help="profile the tile-list sweeps alone, at every "
                         "column-group count")
    ap.add_argument("--caps-compare", action="store_true",
                    help="time the strict run at the padded position-free "
                         "tree capacities and at the lean sized ones")
    ap.add_argument("--row-probes", nargs="*", type=int, metavar="N",
                    help="time the row-move probes: [rows] [parents] [reps]")
    ap.add_argument("--device-shares", action="store_true",
                    help="time the strict run and profile one window: "
                         "device ms/step, launches, the row movers' shares")
    ap.add_argument("--root", metavar="DIR",
                    help="import the package from this other checkout")
    ap.add_argument("--version", type=int, default=1, choices=(0, 1, 2),
                    help="with --device-shares: the AGBNP version (1)")
    ap.add_argument("--dump", metavar="F.npz",
                    help="with --device-shares: save what the run computed")
    ap.add_argument("--synth-trace", nargs="?", type=int, const=10240,
                    metavar="NATOMS",
                    help="the synthetic ball's windowed MD window by "
                         "window, and an f32 / f64 replay of its last two "
                         "windows (10240 atoms; --steps, 400)")
    ap.add_argument("--same", nargs=2, metavar="F.npz",
                    help="compare two --dump files bit for bit")
    args = ap.parse_args()
    if args.same:
        return same_dumps(*args.same)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("profile_port_step: no CUDA device", file=sys.stderr)
        return 1
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
    from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    if args.steps is None:
        args.steps = (200 if args.device_shares else
                      400 if args.synth_trace is not None else 40)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.synth_trace is not None:
        return synth_trace(dev, card, args.synth_trace, args.steps)
    if args.list_kernels or args.row_probes is not None:
        from openmm_agbnp_plugin_tpu_torch.runtime import build
        build.load_library()
    if args.list_kernels:
        return profile_list_kernels(dev, card, args.system or "1li2")
    if args.row_probes is not None:
        if len(args.row_probes) > 3:
            ap.error("--row-probes takes at most rows, parents and reps")
        row_probes(dev, card, *args.row_probes, system=args.system or "2clr")
        return 0
    args.system = args.system or "1li2"
    path = (args.system if args.system.endswith(".dms") else os.path.join(
        HERE, "benchmarks", "data", f"{args.system}_agbnp1.dms"))
    d = load_dms(path)
    kw = dict(cutoff=1.0, descreen_horizon="cutoff",
              pair_tiles=False if args.dense else None)
    if args.caps_compare:
        return caps_compare(dev, card, d, args.steps, kw)
    if args.device_shares:
        return device_shares(dev, card, d, args.steps, kw, dump=args.dump,
                             version=args.version)
    # the Simulation sizes its lean tree capacities (caps_boost 1.10) from
    # the DMS positions
    sim = Simulation(d, device=dev, version=1, dtype=torch.float32,
                     skin=0.25, **kw)
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

    # the window's topology as Simulation.window_build gives it, with the
    # per-level tree kernels' prep
    topo = T.kernel_prep(T.tree_topology(build()[0]))
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
        vt, counts = T.compact_topology(T.rescan_volumes(topo, lvl1v),
                                        vdw_caps)
        return T.kernel_prep(vt), counts

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
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        run(pos, sim.velocities, args.steps, generator=gen)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    kernels = _device_kernels(prof)
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
