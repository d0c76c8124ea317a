"""Traffic kind `md_wu`: one AGBNP1 Langevin trajectory through
Simulation.run_md with the WU force as an r-RESPA impulse every
`wu_every` steps (the configuration's), checked against the reference's
impulse integrator.

Set-up, the timed window, the traced slice and the work count are the
`md` kind's (kinds/md.py, loaded as a copy of its own), with the
configuration's `wu_every` given to every run_md call; the trace data
keeps the kind `md`, so the MD metrics read it.  The check is `md`'s with
reference/agbnp_wu.py in place of the plain Langevin step: from each
sampled window's start the reference takes the window's steps with the
replayed noise, an impulse of F + k F_WU at every k-th step from the
window's start (the program's blocks restart at each window), the force
without WU between; `energy_rel` at the start and `pos_gap_nm`,
`vel_rel` at the end.  The control runs the same integrator in bfloat16.

Traffic parameters: those of `md`.
"""

from __future__ import annotations

import torch

import common
import harness
from reference.agbnp_wu import WUSystem, wu_impulse_langevin

_md = harness.load_module("kinds", "md.py")
_md_kw = _md._md_kw


def _wu_kw(cfg):
    return dict(_md_kw(cfg), wu_every=int(cfg["wu_every"]))


# every run_md call of the copy (set-up, the timed window, the slice)
_md._md_kw = _wu_kw
setup, window, slice, work, release = (_md.setup, _md.window, _md.slice,
                                       _md.work, _md.release)


class TrajectoryCheck(common.TrajectoryCheck):
    """common.TrajectoryCheck with the WU impulse: the float64 reference
    and the control (the reference in a lower dtype) are WUSystems, each
    window taken by wu_impulse_langevin."""

    def __init__(self, ctx, control=None):
        cfg = ctx.config
        self.ctx = ctx
        self.sysd = common.read_dms(ctx.path(cfg["system_file"]))
        h = common.horizon_nm(cfg)
        self.ref = WUSystem(self.sysd, ctx.device, torch.float64,
                            cfg["cutoff_nm"], h, True)
        self.control = None if control is None else WUSystem(
            self.sysd, ctx.device, control, cfg["cutoff_nm"], h, True)
        self.masses = self.sysd["masses"]
        self.worst = dict(energy_rel=0.0, pos_gap_nm=0.0, vel_rel=0.0)
        self.seconds = 0.0

    def _run(self, system, pos, vel, noise):
        cfg = self.ctx.config
        return wu_impulse_langevin(system, pos, vel, self.masses, noise,
                                   cfg["dt_fs"] * 1e-3, cfg["temperature_K"],
                                   cfg["friction_per_ps"],
                                   int(cfg["wu_every"]))


def check(ctx, rec, control=None):
    every, nsteps, frames = rec["every"], rec["nsteps"], rec["frames"]
    chk = TrajectoryCheck(ctx, control)
    picks = common.sample_windows(common.rng_for(ctx, 1), nsteps // every,
                                  int(ctx.traffic["check_extra_windows"]))
    keep = {w * every + k for w in picks for k in range(every)}
    noise = common.replay_noise(ctx, ctx.seed, nsteps, chk.sysd["n"], keep)
    for w in picks:
        start = chk.start_state() if w == 0 else frames[w - 1]
        chk.window(start, [noise[w * every + k] for k in range(every)],
                   end=frames[w], e_start=rec["energies"][w * every])
    ctx.log(f"checked windows {picks}: the reference's trajectories took "
            f"{chk.seconds:.3f} s")
    return chk.worst
