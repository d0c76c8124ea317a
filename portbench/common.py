"""What the traffic kinds share: the program's objects built from a
configuration, the noise they draw, and the trajectory check against the
reference."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from reference.agbnp import I4_MAXA, System
from reference.dms import read_dms
from reference.i4 import I4Tables
from reference.langevin import langevin


def dtype_of(cfg):
    return getattr(torch, cfg["dtype"])


def horizon_nm(cfg):
    """The Born sums' horizon of an MD configuration (nm)."""
    h = cfg["descreen_horizon"]
    return cfg["cutoff_nm"] if h == "cutoff" else h


def simulation(ctx):
    """The program's Simulation of the configuration."""
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    cfg = ctx.config
    if cfg["nonbonded_method"] != "CutoffNonPeriodic":
        raise ValueError("MD configurations run CutoffNonPeriodic")
    return Simulation(load_dms(ctx.path(cfg["system_file"])),
                      device=ctx.device, version=cfg["agbnp_version"],
                      cutoff=cfg["cutoff_nm"], dtype=dtype_of(cfg),
                      skin=cfg["skin_nm"],
                      descreen_horizon=cfg["descreen_horizon"])


def generator(ctx, seed):
    return torch.Generator(device=ctx.device).manual_seed(int(seed))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def release(state):
    state.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference_system(ctx, dtype, horizon, include_mm):
    sysd = read_dms(ctx.path(ctx.config["system_file"]))
    return sysd, System(sysd, ctx.device, dtype, ctx.config["cutoff_nm"],
                        horizon, include_mm)


def work_spec(ctx, sysd, horizon):
    """What roofline.pair_work needs of the configuration."""
    tab = I4Tables(sysd["radius"], sysd["hydrogen"])
    return dict(heavy=torch.as_tensor(~sysd["hydrogen"]),
                horizon=I4_MAXA if horizon is None else horizon,
                cutoff=ctx.config["cutoff_nm"],
                table_bytes=int(tab.y.size * 2 * 4))


def replay_noise(ctx, seed, steps, natoms, keep):
    """The standard-normal [natoms, 3] draws of a generator seeded `seed`,
    drawn as the program draws them (one a step, in the configuration's
    dtype), for the steps in `keep`: {step: draw}."""
    gen = generator(ctx, seed)
    out = {}
    for k in range(steps):
        xi = torch.randn((natoms, 3), generator=gen,
                         dtype=dtype_of(ctx.config), device=ctx.device)
        if k in keep:
            out[k] = xi
    return out


def sample_windows(rng, nwin, extra):
    """The first and the last window and `extra` others drawn by rng."""
    picks = {0, nwin - 1}
    rest = [w for w in range(1, nwin - 1)]
    if rest and extra:
        picks.update(int(w) for w in rng.choice(rest, min(extra, len(rest)),
                                                replace=False))
    return sorted(picks)


SATURATE = dict(pos_gap_nm=1.0, vel_rel=1000.0)


class TrajectoryCheck:
    """The windows of a trajectory against the reference: from each
    sampled window's start state, the reference takes the window's steps
    with the same noise, and the program's (or the control's) energy at
    the start and state at the end are compared with its.

    energy_rel: energy_gap at the window's start;
    pos_gap_nm: max over atoms of |x - x_ref| at its end;
    vel_rel: max over atoms of |v - v_ref| / rms(v_ref) at its end.

    The two gaps read at most SATURATE (a trajectory that left the
    reference by that much is broken whatever the number; a non-finite
    state reads it too), so a run that blows up still gives a number."""

    def __init__(self, ctx, control=None):
        cfg = ctx.config
        self.ctx = ctx
        self.sysd, self.ref = reference_system(ctx, torch.float64,
                                               horizon_nm(cfg), True)
        self.control = None if control is None else System(
            self.sysd, ctx.device, control, cfg["cutoff_nm"],
            horizon_nm(cfg), True)
        self.masses = self.sysd["masses"]
        self.worst = dict(energy_rel=0.0, pos_gap_nm=0.0, vel_rel=0.0)
        self.seconds = 0.0

    def start_state(self):
        s = self.sysd
        return (torch.as_tensor(s["positions"], device=self.ctx.device),
                torch.as_tensor(s["velocities"], device=self.ctx.device))

    def _run(self, system, pos, vel, noise):
        cfg = self.ctx.config
        return langevin(system, pos, vel, self.masses, noise,
                        cfg["dt_fs"] * 1e-3, cfg["temperature_K"],
                        cfg["friction_per_ps"])

    def window(self, start, noise, end=None, e_start=None):
        """One window from start (pos, vel) with its noise draws; end
        (pos, vel) and e_start are the program's, unused under a
        control."""
        t0 = time.perf_counter()
        x, v, es = self._run(self.ref, *start, noise)
        if self.control is not None:
            xc, vc, ec = self._run(self.control, *start, noise)
            end, e_start = (xc, vc), ec[0]
        self.seconds += time.perf_counter() - t0
        w = self.worst
        x_end = end[0].to(torch.float64)
        v_end = end[1].to(torch.float64)
        rms = float(torch.sqrt(torch.mean(v * v)))
        for key, val in (
                ("energy_rel", energy_gap(self.ref, start[0], e_start)),
                ("pos_gap_nm", float(torch.max(torch.abs(x_end - x)))),
                ("vel_rel", float(torch.max(torch.abs(v_end - v))) / rms)):
            if key in SATURATE:
                val = min(val, SATURATE[key]) if math.isfinite(val) else \
                    SATURATE[key]
            w[key] = max(w[key], val) if math.isfinite(val) else math.inf
        return w


def energy_gap(ref, pos, energy):
    """|energy - the reference's| / |the reference's| at pos, where the
    reference's is the range that pairs at a sharp cut-off leave open
    (System.energy_interval): 0 inside it."""
    e0, lo, hi = ref.energy_interval(pos.to(torch.float64))
    return max(lo - float(energy), float(energy) - hi, 0.0) / abs(e0)


def rng_for(ctx, salt):
    """A NumPy generator for the check's samples, from the seed."""
    return np.random.default_rng([ctx.seed, salt])
