"""Traffic kind `md`: one Langevin trajectory through Simulation.run_md.

Set-up builds the configuration's Simulation and warms up
`warmup_windows` rebuild windows from the DMS state (noise seeded
seed + 1); the last of them gives the step rate that sizes the timed
window.  The timed window is one run_md call of whole rebuild windows
from the DMS state, noise seeded `seed`, PanicButton retries inside it,
with a frame every window (report_interval), the trajectory a user
keeps.  ns_per_day = simulated ns / wall-day over all of it.

Traffic parameters: warmup_windows, check_extra_windows (windows checked
besides the first and the last), slice_windows (the traced slice).
"""

from __future__ import annotations

import time

import numpy as np

import common
from spans import span


def setup(ctx):
    cfg, tr = ctx.config, ctx.traffic
    sim = common.simulation(ctx)
    every = int(cfg["neighbor_every"])
    stamps = []
    with span("warmup"):
        sim.run_md(every * int(tr["warmup_windows"]), **_md_kw(cfg),
                   generator=common.generator(ctx, ctx.seed + 1),
                   report_interval=every,
                   reporter=lambda *_: stamps.append(time.perf_counter()))
    step_s = (stamps[-1] - stamps[-2]) / every
    windows = max(1, round(ctx.seconds / (step_s * every)))
    ctx.log(f"warm-up window {step_s * 1e3:.3f} ms/step: {windows} windows "
            f"of {every} steps")
    return dict(sim=sim, every=every, nsteps=windows * every)


def _md_kw(cfg):
    return dict(dt=cfg["dt_fs"] * 1e-3, temperature=cfg["temperature_K"],
                friction=cfg["friction_per_ps"],
                neighbor_every=int(cfg["neighbor_every"]))


def window(ctx, state):
    sim, every, nsteps = state["sim"], state["every"], state["nsteps"]
    frames, stamps = [], []

    def keep(_, pos, vel):
        frames.append((pos, vel))
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    with span("run_md"):
        out = sim.run_md(nsteps, **_md_kw(ctx.config),
                         generator=common.generator(ctx, ctx.seed),
                         report_interval=every, reporter=keep)
        common.sync(ctx.device)
    elapsed = time.perf_counter() - t0
    ms = np.diff([t0] + stamps) * 1e3 / every
    ctx.log("ms/step by window: " + " ".join(f"{x:.1f}" for x in ms))
    energies = np.asarray(out["energies"], dtype=np.float64)
    bad = ~np.isfinite(energies.reshape(-1, every)).all(axis=1)
    state["final"] = (out["final_pos"], out["final_vel"])
    ns = nsteps * ctx.config["dt_fs"] * 1e-6
    return dict(attempted=nsteps, failed=int(bad.sum()) * every,
                metrics=dict(ns_per_day=ns / elapsed * 86400.0),
                trace_data=dict(kind="md", regrows=out["regrows"],
                                units=nsteps, timed_s=elapsed),
                energies=energies, frames=frames, nsteps=nsteps,
                every=every)


def slice(ctx, state):
    """slice_windows more windows from the timed window's end (profiled)."""
    sim, every = state["sim"], state["every"]
    steps = every * int(ctx.traffic["slice_windows"])
    pos, vel = state["final"]
    with span("run_md"):
        sim.run_md(steps, **_md_kw(ctx.config), pos=pos, vel=vel,
                   generator=common.generator(ctx, ctx.seed + 2),
                   report_interval=every)
    return dict(slice_units=steps, work_positions=pos[None],
                work_repeats=steps)


def work(ctx):
    sysd = common.read_dms(ctx.path(ctx.config["system_file"]))
    return common.work_spec(ctx, sysd, common.horizon_nm(ctx.config))


def release(state):
    common.release(state)


def check(ctx, rec, control=None):
    every, nsteps, frames = rec["every"], rec["nsteps"], rec["frames"]
    chk = common.TrajectoryCheck(ctx, control)
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
