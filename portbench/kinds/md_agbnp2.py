"""Traffic kind `md_agbnp2`: one AGBNP2 Langevin trajectory through
Simulation.run_md, checked against the AGBNP2 reference.

Set-up, the timed window, the traced slice and the work count are the
`md` kind's (kinds/md.py), unchanged: the configuration's
`agbnp_version` 2 makes Simulation run AGBNP2's windows.  The check is
`md`'s with reference/agbnp2.py in place of AGBNP1's System: from each
sampled window's start the reference takes the window's steps with the
replayed noise, `energy_rel` at the start and `pos_gap_nm`, `vel_rel` at
the end.  The reference makes the MS particles and both trees afresh at
every step; the program holds a window's MS compaction and topologies
from its start, so the end-of-window gaps also read what that leaves
out.

Traffic parameters: those of `md`.
"""

from __future__ import annotations

import torch

import common
import harness
from reference.agbnp2 import AGBNP2System

_md = harness.load_module("kinds", "md.py")
setup, window, slice, work, release = (_md.setup, _md.window, _md.slice,
                                       _md.work, _md.release)


class TrajectoryCheck(common.TrajectoryCheck):
    """common.TrajectoryCheck on AGBNP2: the float64 reference and the
    control (the reference in a lower dtype) are AGBNP2Systems."""

    def __init__(self, ctx, control=None):
        cfg = ctx.config
        self.ctx = ctx
        self.sysd = common.read_dms(ctx.path(cfg["system_file"]))
        self.ref = AGBNP2System(self.sysd, ctx.device, torch.float64,
                                cfg["cutoff_nm"])
        self.control = None if control is None else AGBNP2System(
            self.sysd, ctx.device, control, cfg["cutoff_nm"])
        self.masses = self.sysd["masses"]
        self.worst = dict(energy_rel=0.0, pos_gap_nm=0.0, vel_rel=0.0)
        self.seconds = 0.0


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
