#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA pair kernels from openmm_agbnp_plugin_tpu_torch/csrc, then:

  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. holds each kernel against its plain PyTorch twin on the card, in f32,
     and times both: the dense-grid sweeps at the 1li2 shapes (NP 1536,
     NHP 768, E 24; horizon and cutoff 1 nm, with and without the fused MM
     terms), the interacting-tile-list sweeps and the recomputing dense
     descreening at the 2clr shapes (NP 6144, NHP 3328, E 24; Born and
     descreening lists at horizons 1 and 2 nm, both descreening variants
     on lists with budget headroom, the GB list with and without MM);
  3. checks the fixture goldens through AGBNPModel on the card in f32
     (GVolSA 872.514, AGBNP1 -2476.66, within 0.01);
  4. checks 1li2 and 2clr AGBNP1 (no cutoff, 2 nm horizon; 2clr on the
     Born/descreening lists with on-device cell-grid tree candidates)
     against the stored f64 results of the JAX package
     (benchmarks/.parity_cache), then 2clr with Q/dQ sharing off against
     sharing on, on the list route and on the dense route;
  5. checks that two evaluations of 1li2, and of 2clr, are bitwise equal;
  6. runs the port's Simulation on 1li2 on the dense grid (f32, 400
     Langevin steps at 1 fs, neighbor list and tree topology rebuilt every
     40 steps) and checks that every energy is finite, no capacity
     overflow remains, and every dense kernel launched at least once per
     step;
  7. runs 2clr MD on the tile lists with the cell-grid neighbor build
     (caps sized first by single evaluations, then 200 timed steps after a
     200-step warm-up) with the same checks for the list kernels.

Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits non-zero before doing anything.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is nvidia-smi's
name/power-limit line, and the one before that the per-kernel JSON record.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PAIRS_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/pairs.cu"
TILES_SRC = "openmm_agbnp_plugin_tpu_torch/csrc/tiles.cu"
TPU = "openmm_agbnp_plugin_tpu/ops/pallas/pairs.py"
# name -> (source, TPU kernel it replaces, the phase whose launches count)
KERNELS = {
    "born_sums": (PAIRS_SRC, f"{TPU}:420", "md_1li2"),
    "gb_pair": (PAIRS_SRC, f"{TPU}:569", "md_1li2"),
    "descreening": (PAIRS_SRC, f"{TPU}:740", "md_1li2"),
    "descreening_recompute": (PAIRS_SRC, f"{TPU}:740", "share_off"),
    "born_sums_tiles": (TILES_SRC, f"{TPU}:842", "md_2clr"),
    "gb_pair_tiles": (TILES_SRC, f"{TPU}:966", "md_2clr"),
    "descreening_tiles": (TILES_SRC, f"{TPU}:1114", "md_2clr"),
    "descreening_tiles_recompute": (TILES_SRC, f"{TPU}:1114", "share_off"),
}
KERNEL_TOL = 1e-5     # max|kernel - twin| / max|twin|, f32 summation order
GOLDEN_TOL = 0.01     # kJ/mol (benchmarks/validate_parity.py)
PARITY_TOL = 1e-5     # relative, f32 on the card vs the JAX f64 result
MD_STEPS = 400
MD_STEPS_2CLR = 200
NEIGHBOR_EVERY = 40


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rel_err(x, ref):
    import torch

    scale = float(torch.max(torch.abs(ref)))
    diff = float(torch.max(torch.abs(x.double() - ref.double())))
    return diff / max(scale, 1e-30), diff


def cuda_time_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over reps back-to-back calls (CUDA events,
    after one warm-up call).  A device-side sleep queued first holds the
    GPU while the host enqueues every call, so the host's launch overhead
    does not enter the time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of GPU clock cycles
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def system(name):
    from openmm_agbnp_plugin_tpu_torch import AGBNPParams, load_dms

    d = load_dms(os.path.join(HERE, "benchmarks", "data",
                              f"{name}_agbnp1.dms"))
    return d, AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                          alpha=d.agbnp_alpha, charge=d.charges,
                          ishydrogen=d.ishydrogen)


def phase_build():
    from openmm_agbnp_plugin_tpu_torch.runtime import build

    t0 = time.perf_counter()
    path, compiler_log = build.build()
    build.load_library()
    dt = time.perf_counter() - t0
    for line in compiler_log.splitlines():
        if "ptxas" in line or "spill" in line or "error" in line.lower():
            log(f"  {line.strip()}")
    log(f"[1] kernels built in {dt:.2f} s -> {os.path.relpath(path, HERE)}")


def kernel_inputs(dev, name):
    """A system's layouts for the sweeps: real positions, types, tables and
    exclusion rows; screening factors from a seed; Born radii and chain
    factors from the plain twins (so every value is in its real range)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch.md.forces import MMForceField
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
        arrays_from_numpy, prepare_arrays)
    from openmm_agbnp_plugin_tpu_torch.models.constants import PIFAC
    from openmm_agbnp_plugin_tpu_torch.ops.born import (
        agbnp_swf_invbr, born_chain_factors)
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system(name)
    n = p.n
    npad = PK.pad_to(n, PK.pick_tile(n))
    an = prepare_arrays(p, dtype=np.float32, pair_pad=npad,
                        positions=d.positions,
                        pairs=(np.zeros(1, np.int32),) * 2)
    a = arrays_from_numpy(an, dev, torch.float32)
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(d.positions, dtype=torch.float32, device=dev)
    rperm = a["rperm"]
    pos_pad = torch.nn.functional.pad(pos[rperm], (0, 0, 0, npad - n)).T \
        .contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    pos_h = (pos[hids.clamp(min=0)] * hvalid[:, None]).T.contiguous()
    s_h = torch.where(hvalid, torch.as_tensor(
        rng.uniform(0.3, 1.0, hids.shape[0]), dtype=torch.float32,
        device=dev), 0.0)
    mm = MMForceField.from_dms(d, dtype=np.float32)
    er = mm.excl_rows()
    rinv = an["rinv"]
    epm = np.where(er >= 0, rinv[np.clip(er, 0, None)], -1)[an["rperm"]]
    excl = torch.full((npad, er.shape[1]), -1, dtype=torch.int32, device=dev)
    excl[:n] = torch.as_tensor(epm.astype(np.int32), device=dev)

    def padv(x):
        return torch.nn.functional.pad(x, (0, npad - n))

    sig = padv(torch.as_tensor(mm.arrays["sigma"], device=dev)[rperm])
    epsq = padv(torch.as_tensor(mm.arrays["epsq"], device=dev)[rperm])
    spline = PK.SplineArgs(a["hids_perm_pad"], a["type_rows_pad"],
                           a["type_cols_hpad"], a["ytab"], a["y2tab"], n, 1.0)
    born_args = (pos_pad, pos_h, *spline[:5], s_h, n)
    raw, q, dq = PK.born_sums_reference(*born_args, horizon=1.0,
                                        save_qd=True)
    filt, fp = agbnp_swf_invbr(1.0 / a["radii_vdw_perm"] - PIFAC * raw[:n])
    br = padv(1.0 / filt)
    gb_args = (pos_pad, a["charge_pad"], br, n)
    mm_kw = dict(cutoff=1.0, sig_pad=sig, epsq_pad=epsq, excl_rows_pad=excl)
    _, yrow, _, _ = PK.gb_pair_reference(*gb_args, **mm_kw)
    brw, bru = born_chain_factors(a["alpha_perm"], a["charge_pad"][:n],
                                  1.0 / filt, fp, yrow[:n])
    desc_args = (pos_pad, pos_h, s_h, padv(brw), padv(bru))
    shapes = dict(NP=npad, NHP=int(hids.shape[0]), E=int(er.shape[1]))
    return dict(born_args=born_args, gb_args=gb_args, mm_kw=mm_kw,
                desc_args=desc_args, qd=(q, dq), spline=spline,
                shapes=shapes, tile=PK.pick_tile(n),
                valid=(torch.arange(npad, device=dev) < n, hvalid))


def tile_list(inp, rng_dist, triangular=False):
    """A list built on the card, with the budget _sized_pair_tiles would
    give it (count x1.5, 8-aligned, at most every tile pair) or, where that
    leaves no headroom, count + 8, so entries past nv are exercised."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    pos_pad, pos_h = inp["born_args"][:2]
    rvalid, hvalid = inp["valid"]
    tile = inp["tile"]
    rb = TL.tile_bounds(pos_pad, rvalid, tile)
    cb = rb if triangular else TL.tile_bounds(pos_h, hvalid, tile)
    count = int(TL.build_tile_list(*rb, *cb, rng_dist, 1,
                                   triangular=triangular)[2])
    nti, ntj = rb[1].shape[0], cb[1].shape[0]
    ntot = nti * (nti + 1) // 2 if triangular else nti * ntj
    lmax = int(min(max(8, math.ceil(count * 1.5 / 8) * 8), ntot))
    if lmax <= count:
        lmax = count + 8
    tl, nv, _ = TL.build_tile_list(*rb, *cb, rng_dist, lmax,
                                   triangular=triangular)
    if not int(nv[0]) == count < lmax:
        raise AssertionError(f"list nv {int(nv[0])} count {count} lmax "
                             f"{lmax}")
    return tl, nv, f"nv {count}/lmax {lmax} of {ntot}"


def phase_kernels(dev):
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

    results = {name: dict(max_abs_err=0.0) for name in KERNELS}

    def compare(name, label, outs, refs):
        worst_abs = 0.0
        for k, (o, r) in enumerate(zip(outs, refs)):
            if r is None:
                if o is not None:
                    raise AssertionError(f"{name} {label}: output {k} extra")
                continue
            if tuple(o.shape) != tuple(r.shape):
                raise AssertionError(f"{name} {label}: output {k} shape "
                                     f"{tuple(o.shape)} != {tuple(r.shape)}")
            rel, diff = rel_err(o, r)
            log(f"    {name:27s} {label:34s} out{k}: max|d|/max|ref| = "
                f"{rel:.3e}")
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"{name} {label} output {k}: {rel:.3e} "
                                     f"> {KERNEL_TOL}")
            worst_abs = max(worst_abs, diff)
        rec = results[name]
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)

    # dense grid, 1li2 shapes
    li2 = kernel_inputs(dev, "1li2")
    log(f"[2] kernels vs plain twins, f32: dense grid at 1li2 "
        f"{li2['shapes']}")
    if li2["shapes"] != dict(NP=1536, NHP=768, E=24):
        raise AssertionError(f"unexpected 1li2 shapes {li2['shapes']}")
    l_born, l_gb, l_mm = li2["born_args"], li2["gb_args"], li2["mm_kw"]
    l_desc = (*li2["desc_args"], li2["qd"])
    for hz in (1.0, None):
        label = f"horizon={hz or 2.0}"
        compare("born_sums", label,
                PK.born_sums(*l_born, horizon=hz, save_qd=True),
                PK.born_sums_reference(*l_born, horizon=hz, save_qd=True))
    compare("gb_pair", "cutoff=1, MM",
            PK.gb_pair(*l_gb, **l_mm), PK.gb_pair_reference(*l_gb, **l_mm))
    compare("gb_pair", "cutoff=1, no MM",
            PK.gb_pair(*l_gb, cutoff=1.0),
            PK.gb_pair_reference(*l_gb, cutoff=1.0))
    compare("gb_pair", "no cutoff, no MM",
            PK.gb_pair(*l_gb), PK.gb_pair_reference(*l_gb))
    compare("descreening", "from Q/dQ",
            PK.descreening(*l_desc), PK.descreening_reference(*l_desc))
    timed = {
        "born_sums": (lambda: PK.born_sums(*l_born, horizon=1.0,
                                           save_qd=True),
                      lambda: PK.born_sums_reference(*l_born, horizon=1.0,
                                                     save_qd=True)),
        "gb_pair": (lambda: PK.gb_pair(*l_gb, **l_mm),
                    lambda: PK.gb_pair_reference(*l_gb, **l_mm)),
        "descreening": (lambda: PK.descreening(*l_desc),
                        lambda: PK.descreening_reference(*l_desc)),
    }

    # interacting-tile lists and the recomputing dense sweep, 2clr shapes
    clr = kernel_inputs(dev, "2clr")
    log(f"[2] kernels vs plain twins, f32: lists and recomputing "
        f"descreening at 2clr {clr['shapes']}")
    if clr["shapes"] != dict(NP=6144, NHP=3328, E=24):
        raise AssertionError(f"unexpected 2clr shapes {clr['shapes']}")
    tile = clr["tile"]
    born_args, gb_args, mm_kw = clr["born_args"], clr["gb_args"], \
        clr["mm_kw"]
    for hz in (1.0, None):
        tl, nv, what = tile_list(clr, hz or 2.0)
        label = f"horizon={hz or 2.0}, {what}"
        args = (nv, tl, *born_args, tile)
        out = TL.born_sums_tiles(*args, horizon=hz, save_qd=True)
        ref = TL.born_sums_tiles_reference(*args, horizon=hz, save_qd=True)
        compare("born_sums_tiles", label, out, ref)
        sp = clr["spline"]._replace(horizon=hz)
        dargs = (nv, tl, *clr["desc_args"])
        compare("descreening_tiles", label,
                TL.descreening_tiles(*dargs, ref[1:], tile),
                TL.descreening_tiles_reference(*dargs, ref[1:], tile))
        compare("descreening_tiles_recompute", label,
                TL.descreening_tiles(*dargs, None, tile, spline=sp),
                TL.descreening_tiles_reference(*dargs, None, tile,
                                               spline=sp))
        compare("descreening_recompute", f"horizon={hz or 2.0}",
                PK.descreening(*clr["desc_args"], None, spline=sp),
                PK.descreening_reference(*clr["desc_args"], None, spline=sp))
        if hz == 1.0:
            born_tl = (tl, nv, args, ref[1:], dargs)
    tl_g, nv_g, what = tile_list(clr, 1.0, triangular=True)
    gargs = (nv_g, tl_g, *gb_args, tile)
    for label, kw in ((f"cutoff=1, MM, {what}", mm_kw),
                      (f"cutoff=1, no MM, {what}", dict(cutoff=1.0))):
        compare("gb_pair_tiles", label, TL.gb_pair_tiles(*gargs, **kw),
                TL.gb_pair_tiles_reference(*gargs, **kw))
    _, _, args, qd, dargs = born_tl
    sp = clr["spline"]
    dense_d = (*clr["desc_args"], None)
    timed.update({
        "descreening_recompute": (
            lambda: PK.descreening(*dense_d, spline=sp),
            lambda: PK.descreening_reference(*dense_d, spline=sp)),
        "born_sums_tiles": (
            lambda: TL.born_sums_tiles(*args, horizon=1.0, save_qd=True),
            lambda: TL.born_sums_tiles_reference(*args, horizon=1.0,
                                                 save_qd=True)),
        "gb_pair_tiles": (
            lambda: TL.gb_pair_tiles(*gargs, **mm_kw),
            lambda: TL.gb_pair_tiles_reference(*gargs, **mm_kw)),
        "descreening_tiles": (
            lambda: TL.descreening_tiles(*dargs, qd, tile),
            lambda: TL.descreening_tiles_reference(*dargs, qd, tile)),
        "descreening_tiles_recompute": (
            lambda: TL.descreening_tiles(*dargs, None, tile, spline=sp),
            lambda: TL.descreening_tiles_reference(*dargs, None, tile,
                                                   spline=sp)),
    })
    log("    times: device ms per call, CUDA events behind a device sleep "
        "(dense at 1li2, the rest at 2clr; horizon and cutoff 1 nm)")
    for name, (kern, plain) in timed.items():
        results[name]["ms"] = cuda_time_ms(kern)
        results[name]["plain_ms"] = cuda_time_ms(plain)
        log(f"    {name:27s} kernel {results[name]['ms']:.4f} ms, plain "
            f"{results[name]['plain_ms']:.4f} ms")
    return results


def phase_goldens(dev):
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
        load_gaussvol_dat

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "tests", "fixtures", "gaussvol.dat"))
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    for version, anchor in ((0, 872.514), (1, -2476.66)):
        m = AGBNPModel(p, device=dev, dtype=torch.float32, version=version,
                       positions=pos)
        e, f, out = m.energy_forces(pos, with_details=True)
        if m.check_and_grow(out["diag"]):
            raise AssertionError("fixture tree overflowed its capacities")
        e = float(e)
        log(f"[3] golden v{version}: E = {e:.4f} (anchor {anchor})")
        if not abs(e - anchor) < GOLDEN_TOL:
            raise AssertionError(f"golden v{version}: {e} vs {anchor}")
        if not bool(torch.isfinite(f).all()):
            raise AssertionError(f"golden v{version}: non-finite forces")


def sized_model(dev, p, positions, **kw):
    """AGBNPModel on the card in f32 whose capacities (tree, neighbor
    width, tile budgets) were grown until one evaluation at `positions`
    is clean.  Returns (model, energy, force)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel

    m = AGBNPModel(p, device=dev, dtype=torch.float32, version=1,
                   positions=positions, **kw)
    for _ in range(8):
        e, f, out = m.energy_forces(positions, with_details=True)
        if not m.check_and_grow(out["diag"]):
            return m, e, f
    raise AssertionError("capacities did not converge")


def check_parity(name, e, f):
    import numpy as np

    ref = np.load(os.path.join(HERE, "benchmarks", ".parity_cache",
                               f"{name}_agbnp1_f64.npz"))
    e_ref, f_ref = float(ref["e"]), ref["f"]
    fn = f.double().cpu().numpy()
    if fn.shape != f_ref.shape or not np.isfinite(fn).all():
        raise AssertionError(f"{name} forces: shape {fn.shape}, finite "
                             f"{np.isfinite(fn).all()}")
    e_rel = abs(float(e) - e_ref) / abs(e_ref)
    f_rel = float(np.abs(fn - f_ref).max() / np.abs(f_ref).max())
    log(f"[4] {name} vs JAX f64: E = {float(e):.4f} (ref {e_ref:.4f}), "
        f"energy rel {e_rel:.3e}, force max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError(f"{name} parity outside {PARITY_TOL}")


def check_repeatable(name, m, positions, e, f):
    import torch

    e2, f2 = m.energy_forces(positions)
    same = bool(torch.equal(e, e2)) and bool(torch.equal(f, f2))
    log(f"[5] {name} bitwise repeatable: {same}")
    if not same:
        raise AssertionError(f"{name}: two evaluations differ")


def phase_parity(dev):
    """Phases 4-5.  Returns the launch counts of the sharing-off
    evaluations (the path of the two recomputing descreening kernels)."""
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, p = system("1li2")
    m, e, f = sized_model(dev, p, d.positions)
    check_parity("1li2", e, f)
    check_repeatable("1li2", m, d.positions, e, f)

    d, p = system("2clr")
    t0 = time.perf_counter()
    m, e, f = sized_model(dev, p, d.positions)
    log(f"[4] 2clr model sized in {time.perf_counter() - t0:.1f} s: "
        f"pair_tiles {m.pair_tiles}, neighbor_kmax {m.neighbor_kmax}, "
        f"cell grid {m.neighbor_grid.dims.tolist()} x ccap "
        f"{m.neighbor_grid.ccap}, caps {m.caps}")
    if m.pair_tiles is None or m.pair_tiles[1] is not None:
        raise AssertionError("2clr without a cutoff must run Born and "
                             "descreening on lists and GB dense")
    check_parity("2clr", e, f)
    check_repeatable("2clr", m, d.positions, e, f)
    ref_dense = AGBNPModel(p, device=dev, dtype=torch.float32, caps=m.caps,
                           positions=d.positions, pair_tiles=False)
    recompute = dict.fromkeys(("descreening_recompute",
                               "descreening_tiles_recompute"), 0)
    for route, m_on in (("lists", m), ("dense", ref_dense)):
        m_off = AGBNPModel(p, device=dev, dtype=torch.float32, caps=m.caps,
                           positions=d.positions,
                           pair_tiles=m_on.pair_tiles or False,
                           share_qd=False)
        e_on, f_on = m_on.energy_forces(d.positions)
        PK.reset_launch_counts()
        e_off, f_off = m_off.energy_forces(d.positions)
        counts = PK.launch_counts()
        for k in recompute:
            recompute[k] += counts[k]
        e_rel = abs(float(e_off) - float(e_on)) / abs(float(e_on))
        f_rel, _ = rel_err(f_off, f_on)
        log(f"[4] 2clr {route}: sharing off vs on: energy rel {e_rel:.3e}, "
            f"force max-err/max|f| {f_rel:.3e}; launches "
            f"{ {k: c for k, c in counts.items() if c} }")
        if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
            raise AssertionError(f"2clr {route}: sharing off differs")
    return recompute


def run_md(dev, card, name, steps, label, **kw):
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d, _ = system(name)
    sim = Simulation(d, device=dev, version=1, cutoff=1.0,
                     dtype=torch.float32, skin=0.25,
                     descreen_horizon="cutoff", **kw)
    PK.reset_launch_counts()
    r = sim.benchmark_langevin(nsteps=steps, dt=0.001, temperature=300.0,
                               friction=1.0, neighbor_every=NEIGHBOR_EVERY,
                               max_regrow=3)
    counts = PK.launch_counts()
    energies = r["energies"]
    ms_step = r["elapsed_s"] / steps * 1e3
    log(f"{label} {name} MD: {steps} steps x2 (warm-up + timed), regrows "
        f"{r['regrows']}, overflow {r['overflow']}, pair_tiles "
        f"{sim.agbnp.pair_tiles}, cell grid {sim.grid is not None}, "
        f"E first/last {energies[0]:.2f}/{energies[-1]:.2f}")
    log(f"    kernel launches {counts}")
    log(f"    first measurement, not a claim: {ms_step:.3f} ms/step, "
        f"{r['ns_day']:.3f} ns/day on {card}")
    if r["overflow"]:
        raise AssertionError(f"capacity overflow after {r['regrows']} "
                             "regrows")
    if energies.shape != (steps,) or not np.isfinite(energies).all():
        raise AssertionError("non-finite or missing MD energies")
    if not bool(torch.isfinite(r["final_pos"]).all()):
        raise AssertionError("non-finite final positions")
    return sim, counts


def phase_md(dev, card):
    """Phases 6-7: 1li2 on the dense grid, 2clr on the lists."""
    import torch

    _, counts_1li2 = run_md(dev, card, "1li2", MD_STEPS, "[6]",
                            pair_tiles=False)
    for name in ("born_sums", "gb_pair", "descreening"):
        if counts_1li2[name] < MD_STEPS:
            raise AssertionError(f"{name}: {counts_1li2[name]} launches < "
                                 f"{MD_STEPS} steps")

    # size the 2clr capacities by single evaluations first, so the timed
    # runs do not regrow from TreeCaps.for_natoms
    d, p = system("2clr")
    m, _, _ = sized_model(dev, p, d.positions, cutoff=1.0,
                          descreen_horizon="cutoff")
    sim, counts_2clr = run_md(dev, card, "2clr", MD_STEPS_2CLR, "[7]",
                              caps=m.caps)
    if sim.grid is None or sim.agbnp.pair_tiles is None \
            or sim.agbnp.pair_tiles[1] is None:
        raise AssertionError("2clr MD must run on both lists and the grid")
    for name in ("born_sums_tiles", "gb_pair_tiles", "descreening_tiles"):
        if counts_2clr[name] < MD_STEPS_2CLR:
            raise AssertionError(f"{name}: {counts_2clr[name]} launches < "
                                 f"{MD_STEPS_2CLR} steps")
    torch.cuda.synchronize()
    return counts_1li2, counts_2clr


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import openmm_agbnp_plugin_tpu_torch  # noqa: F401  (fails outside repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = nvidia_smi_line()
    log(f"[1] {card}")
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    phase_goldens(dev)
    counts = dict(share_off=phase_parity(dev))
    counts["md_1li2"], counts["md_2clr"] = phase_md(dev, card)
    if "jax" in sys.modules or "openmm_agbnp_plugin_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    record = []
    for name, (src, replaces, path) in KERNELS.items():
        launches = counts[path][name]
        if launches <= 0:
            raise AssertionError(f"{name}: not launched on its path {path}")
        record.append(dict(name=name, route="cuda", source=src,
                           replaces=replaces, launches=launches,
                           max_abs_err=kernels[name]["max_abs_err"],
                           ms=kernels[name]["ms"],
                           plain_ms=kernels[name]["plain_ms"]))
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(dict(kernels=record)))
    print(card)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
