#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA pair kernels from openmm_agbnp_plugin_tpu_torch/csrc, then:

  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. holds each kernel against its plain PyTorch twin on the card, in f32,
     at the 1li2 shapes (NP 1536, NHP 768, E 24; horizon and cutoff 1 nm,
     with and without the fused MM terms), and times both;
  3. checks the fixture goldens through AGBNPModel on the card in f32
     (GVolSA 872.514, AGBNP1 -2476.66, within 0.01);
  4. checks 1li2 AGBNP1 (no cutoff, 2 nm horizon) against the stored f64
     result of the JAX package (benchmarks/.parity_cache);
  5. checks that two evaluations of 4 are bitwise identical;
  6. runs the port's Simulation on 1li2 (f32, 400 Langevin steps at 1 fs,
     neighbor list and tree topology rebuilt every 40 steps) and checks that
     every energy is finite, no capacity overflow remains, and every kernel
     launched at least once per step.

Any failed check raises and the script exits non-zero.  Without a CUDA
device it exits non-zero before doing anything.  The last line of standard
output is {"ok": true, "device": {...}}; the line before it is nvidia-smi's
name/power-limit line, and the one before that the per-kernel JSON record.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "openmm_agbnp_plugin_tpu_torch/csrc/pairs.cu"
TPU_KERNELS = {
    "born_sums": "openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:420",
    "gb_pair": "openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:569",
    "descreening": "openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:740",
}
KERNEL_TOL = 1e-5     # max|kernel - twin| / max|twin|, f32 summation order
GOLDEN_TOL = 0.01     # kJ/mol (benchmarks/validate_parity.py)
PARITY_TOL = 1e-5     # relative, f32 on the card vs the JAX f64 result
MD_STEPS = 400
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


def kernel_inputs(dev):
    """1li2 layouts for the three sweeps: real positions, types, tables and
    exclusion rows; screening factors from a seed; Born radii and chain
    factors from the plain twins (so every value is in its real range)."""
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import load_dms
    from openmm_agbnp_plugin_tpu_torch.md.forces import MMForceField
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
        arrays_from_numpy, prepare_arrays)
    from openmm_agbnp_plugin_tpu_torch.models.params import AGBNPParams
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d = load_dms(os.path.join(HERE, "benchmarks", "data", "1li2_agbnp1.dms"))
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    n = p.n
    npad = PK.pad_to(n, PK.pick_tile(n))
    an = prepare_arrays(p, dtype=np.float32, pair_pad=npad,
                        positions=d.positions)
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
    born_args = (pos_pad, pos_h, a["hids_perm_pad"], a["type_rows_pad"],
                 a["type_cols_hpad"], a["ytab"], a["y2tab"], s_h, n)
    raw, q, dq = PK.born_sums_reference(*born_args, horizon=1.0,
                                        save_qd=True)
    from openmm_agbnp_plugin_tpu_torch.models.constants import PIFAC
    from openmm_agbnp_plugin_tpu_torch.ops.born import (
        agbnp_swf_invbr, born_chain_factors)
    filt, fp = agbnp_swf_invbr(1.0 / a["radii_vdw_perm"] - PIFAC * raw[:n])
    br = padv(1.0 / filt)
    gb_args = (pos_pad, a["charge_pad"], br, n)
    mm_kw = dict(cutoff=1.0, sig_pad=sig, epsq_pad=epsq, excl_rows_pad=excl)
    _, yrow, _, _ = PK.gb_pair_reference(*gb_args, **mm_kw)
    brw, bru = born_chain_factors(a["alpha_perm"], a["charge_pad"][:n],
                                  1.0 / filt, fp, yrow[:n])
    desc_args = (pos_pad, pos_h, s_h, padv(brw), padv(bru), (q, dq))
    shapes = dict(NP=npad, NHP=int(hids.shape[0]), E=int(er.shape[1]))
    return born_args, gb_args, mm_kw, desc_args, shapes


def phase_kernels(dev):
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    born_args, gb_args, mm_kw, desc_args, shapes = kernel_inputs(dev)
    log(f"[2] kernels vs plain twins at {shapes}, f32")
    if shapes != dict(NP=1536, NHP=768, E=24):
        raise AssertionError(f"unexpected 1li2 shapes {shapes}")
    results = {}

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
            log(f"    {name:11s} {label:16s} out{k}: max|d|/max|ref| = "
                f"{rel:.3e}")
            if not rel <= KERNEL_TOL:
                raise AssertionError(f"{name} {label} output {k}: {rel:.3e} "
                                     f"> {KERNEL_TOL}")
            worst_abs = max(worst_abs, diff)
        rec = results.setdefault(name, dict(max_abs_err=0.0))
        rec["max_abs_err"] = max(rec["max_abs_err"], worst_abs)

    for hz in (1.0, None):
        label = f"horizon={hz or 2.0}"
        compare("born_sums", label,
                PK.born_sums(*born_args, horizon=hz, save_qd=True),
                PK.born_sums_reference(*born_args, horizon=hz, save_qd=True))
    compare("gb_pair", "cutoff=1, MM",
            PK.gb_pair(*gb_args, **mm_kw),
            PK.gb_pair_reference(*gb_args, **mm_kw))
    compare("gb_pair", "cutoff=1, no MM",
            PK.gb_pair(*gb_args, cutoff=1.0),
            PK.gb_pair_reference(*gb_args, cutoff=1.0))
    compare("gb_pair", "no cutoff, no MM",
            PK.gb_pair(*gb_args), PK.gb_pair_reference(*gb_args))
    compare("descreening", "from Q/dQ",
            PK.descreening(*desc_args), PK.descreening_reference(*desc_args))

    timed = {
        "born_sums": (lambda: PK.born_sums(*born_args, horizon=1.0,
                                           save_qd=True),
                      lambda: PK.born_sums_reference(*born_args, horizon=1.0,
                                                     save_qd=True)),
        "gb_pair": (lambda: PK.gb_pair(*gb_args, **mm_kw),
                    lambda: PK.gb_pair_reference(*gb_args, **mm_kw)),
        "descreening": (lambda: PK.descreening(*desc_args),
                        lambda: PK.descreening_reference(*desc_args)),
    }
    for name, (kern, plain) in timed.items():
        results[name]["ms"] = cuda_time_ms(kern)
        results[name]["plain_ms"] = cuda_time_ms(plain)
        log(f"    {name:11s} kernel {results[name]['ms']:.4f} ms, plain "
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


def phase_parity(dev):
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
        load_dms

    d = load_dms(os.path.join(HERE, "benchmarks", "data", "1li2_agbnp1.dms"))
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    m = AGBNPModel(p, device=dev, dtype=torch.float32, version=1,
                   positions=d.positions)
    for _ in range(6):
        e, f, out = m.energy_forces(d.positions, with_details=True)
        if not m.check_and_grow(out["diag"]):
            break
    else:
        raise AssertionError("1li2 tree capacities did not converge")
    ref = np.load(os.path.join(HERE, "benchmarks", ".parity_cache",
                               "1li2_agbnp1_f64.npz"))
    e_ref, f_ref = float(ref["e"]), ref["f"]
    fn = f.double().cpu().numpy()
    if fn.shape != f_ref.shape or not np.isfinite(fn).all():
        raise AssertionError(f"1li2 forces: shape {fn.shape}, finite "
                             f"{np.isfinite(fn).all()}")
    e_rel = abs(float(e) - e_ref) / abs(e_ref)
    f_rel = float(np.abs(fn - f_ref).max() / np.abs(f_ref).max())
    log(f"[4] 1li2 vs JAX f64: E = {float(e):.4f} (ref {e_ref:.4f}), "
        f"energy rel {e_rel:.3e}, force max-err/max|f| {f_rel:.3e}")
    if not (e_rel <= PARITY_TOL and f_rel <= PARITY_TOL):
        raise AssertionError("1li2 parity outside 1e-5")
    e2, f2 = m.energy_forces(d.positions)
    same = bool(torch.equal(e, e2)) and bool(torch.equal(f, f2))
    log(f"[5] bitwise repeatable: {same}")
    if not same:
        raise AssertionError("two evaluations differ")


def phase_md(dev, card):
    import numpy as np
    import torch

    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

    d = load_dms(os.path.join(HERE, "benchmarks", "data", "1li2_agbnp1.dms"))
    sim = Simulation(d, device=dev, version=1, cutoff=1.0,
                     dtype=torch.float32, skin=0.25,
                     descreen_horizon="cutoff")
    PK.reset_launch_counts()
    r = sim.benchmark_langevin(nsteps=MD_STEPS, dt=0.001, temperature=300.0,
                               friction=1.0, neighbor_every=NEIGHBOR_EVERY,
                               max_regrow=3)
    counts = PK.launch_counts()
    energies = r["energies"]
    ms_step = r["elapsed_s"] / MD_STEPS * 1e3
    log(f"[6] 1li2 MD: {MD_STEPS} steps x2 (warm-up + timed), regrows "
        f"{r['regrows']}, overflow {r['overflow']}, E first/last "
        f"{energies[0]:.2f}/{energies[-1]:.2f}")
    log(f"    kernel launches {counts}")
    log(f"    first measurement, not a claim: {ms_step:.3f} ms/step, "
        f"{r['ns_day']:.3f} ns/day on {card}")
    if r["overflow"]:
        raise AssertionError(f"capacity overflow after {r['regrows']} "
                             "regrows")
    if energies.shape != (MD_STEPS,) or not np.isfinite(energies).all():
        raise AssertionError("non-finite or missing MD energies")
    pos = r["final_pos"]
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError("non-finite final positions")
    for name, c in counts.items():
        if c < MD_STEPS:
            raise AssertionError(f"{name}: {c} launches < {MD_STEPS} steps")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import openmm_agbnp_plugin_tpu_torch  # noqa: F401  (fails outside repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi_line()
    log(f"[1] {card}")
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev)
    phase_goldens(dev)
    phase_parity(dev)
    counts = phase_md(dev, card)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    record = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                   replaces=TPU_KERNELS[name], launches=counts[name],
                   max_abs_err=kernels[name]["max_abs_err"],
                   ms=kernels[name]["ms"], plain_ms=kernels[name]["plain_ms"])
              for name in TPU_KERNELS]
    print(json.dumps(dict(kernels=record)))
    print(card)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
