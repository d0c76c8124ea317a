"""Traffic kind `md_mts`: one AGBNP1 Langevin trajectory through
Simulation.run_md under the 4 fs production protocol: r-RESPA outer steps
of dt_fs with `mts_inner` bonded + 1-4 substeps (the configuration's),
and the DMS file's X-H bonds held by SHAKE/RATTLE (a constrained
Simulation), checked against reference/agbnp_mts.py.

Set-up, the timed window, the traced slice and the work count are the
`md` kind's (kinds/md.py, loaded as a copy of its own), with the
configuration's `mts_inner` given to every run_md call and the copy's
Simulation built with constraints=True; neighbor_every, the window's
steps and ns_per_day count outer steps.  The trace data keeps the kind
`md`, so the MD metrics read it.  The check is `md`'s with the
reference's r-RESPA step in place of the plain Langevin step: from each
sampled window's start the reference takes the window's outer steps with
the replayed noise (`mts_inner` draws an outer step, one a substep, as
the program draws them); `energy_rel` at the start and `pos_gap_nm`,
`vel_rel` at the end, and `constraint_rel`: the largest relative X-H
distance error of the program's positions at the window's end, against
the benchmark's own constraint table (the control's own positions under
the control).  The control runs the same integrator in bfloat16.

Traffic parameters: those of `md`.
"""

from __future__ import annotations

import math
import time
import types

import torch

import common
import harness
from reference.agbnp_mts import MTSSystem, mts_langevin, read_constraints

# constraint_rel reads at most this: a bond this far from its length
# (relative) is broken whatever the number; a non-finite state reads it
SATURATE = 1.0

_md = harness.load_module("kinds", "md.py")
_md_kw = _md._md_kw


def _mts_kw(cfg):
    return dict(_md_kw(cfg), mts_inner=int(cfg["mts_inner"]))


def _simulation(ctx):
    """The program's Simulation of the configuration, constrained."""
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    cfg = ctx.config
    if cfg["nonbonded_method"] != "CutoffNonPeriodic":
        raise ValueError("MD configurations run CutoffNonPeriodic")
    if cfg["constraints"] != "X-H":
        raise ValueError("the 4 fs protocol constrains the X-H bonds")
    return Simulation(load_dms(ctx.path(cfg["system_file"])),
                      device=ctx.device, version=cfg["agbnp_version"],
                      cutoff=cfg["cutoff_nm"], dtype=common.dtype_of(cfg),
                      skin=cfg["skin_nm"],
                      descreen_horizon=cfg["descreen_horizon"],
                      constraints=True)


# every run_md call of the copy (set-up, the timed window, the slice), and
# the copy's Simulation
_md._md_kw = _mts_kw
_md.common = types.SimpleNamespace(**{**vars(common),
                                      "simulation": _simulation})
setup, window, slice, work, release = (_md.setup, _md.window, _md.slice,
                                       _md.work, _md.release)


class TrajectoryCheck(common.TrajectoryCheck):
    """common.TrajectoryCheck with the r-RESPA step and the constraints:
    the float64 reference and the control (the reference in a lower
    dtype) are MTSSystems, each window taken by mts_langevin, and the
    window's end checked against the constraint table (constraint_rel)."""

    def __init__(self, ctx, control=None):
        cfg = ctx.config
        self.ctx = ctx
        path = ctx.path(cfg["system_file"])
        self.sysd = common.read_dms(path)
        cons = read_constraints(path)
        h = common.horizon_nm(cfg)
        self.ref = MTSSystem(self.sysd, ctx.device, torch.float64,
                             cfg["cutoff_nm"], h, True, cons)
        self.control = None if control is None else MTSSystem(
            self.sysd, ctx.device, control, cfg["cutoff_nm"], h, True, cons)
        self.masses = self.sysd["masses"]
        self.worst = dict(energy_rel=0.0, pos_gap_nm=0.0, vel_rel=0.0,
                          constraint_rel=0.0)
        self.seconds = 0.0
        self.last_end = None

    def _run(self, system, pos, vel, noise):
        cfg = self.ctx.config
        out = mts_langevin(system, pos, vel, self.masses, noise,
                           cfg["dt_fs"] * 1e-3, cfg["temperature_K"],
                           cfg["friction_per_ps"], int(cfg["mts_inner"]))
        self.last_end = out[0]
        return out

    def window(self, start, noise, end=None, e_start=None):
        w = super().window(start, noise, end, e_start)
        # the control ran last: its end; else the program's
        x_end = self.last_end if self.control is not None else end[0]
        t0 = time.perf_counter()
        val = self.ref.constraint_error(x_end)
        self.seconds += time.perf_counter() - t0
        val = min(val, SATURATE) if math.isfinite(val) else SATURATE
        w["constraint_rel"] = max(w["constraint_rel"], val)
        return w


def check(ctx, rec, control=None):
    every, nsteps, frames = rec["every"], rec["nsteps"], rec["frames"]
    inner = int(ctx.config["mts_inner"])
    chk = TrajectoryCheck(ctx, control)
    picks = common.sample_windows(common.rng_for(ctx, 1), nsteps // every,
                                  int(ctx.traffic["check_extra_windows"]))
    keep = {(w * every + k) * inner + i for w in picks
            for k in range(every) for i in range(inner)}
    noise = common.replay_noise(ctx, ctx.seed, nsteps * inner,
                                chk.sysd["n"], keep)
    for w in picks:
        start = chk.start_state() if w == 0 else frames[w - 1]
        draws = [[noise[(w * every + k) * inner + i] for i in range(inner)]
                 for k in range(every)]
        chk.window(start, draws, end=frames[w],
                   e_start=rec["energies"][w * every])
    ctx.log(f"checked windows {picks}: the reference's trajectories took "
            f"{chk.seconds:.3f} s")
    return chk.worst
