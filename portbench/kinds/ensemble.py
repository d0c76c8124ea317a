"""Traffic kind `ensemble`: R independent replicas of one system as a
batch on one card, through ReplicaEnsemble.make_runner.

Initial states come from ReplicaEnsemble.initial_states(jitter, seed)
(replica r's noise generator seeded seed + r).  The runner is driven one
rebuild window a call; it stops at a window that overflowed and does not
regrow, so this kind regrows as run_md does (Simulation._regrow from the
worst replica's counts, headroom 1.3 x 1.25^k) and retries the window from
its start, generators restored; the retries count in the window's time.
Set-up warms up `warmup_windows` windows (initial states seeded seed + 1),
the last of which sizes the timed window.  ns_per_day sums the replicas'
simulated time.

Traffic parameters: replicas, jitter_nm, warmup_windows, max_retries,
slice_windows, check_first_replicas (replicas checked in the first
window; every replica is checked in the last).
"""

from __future__ import annotations

import time

import numpy as np
import torch

import common
from spans import span


def _runner(ctx, ens):
    cfg = ctx.config
    return ens.make_runner(dt=cfg["dt_fs"] * 1e-3,
                           temperature=cfg["temperature_K"],
                           friction=cfg["friction_per_ps"],
                           neighbor_every=int(cfg["neighbor_every"]))


def _windows(ctx, state, states, count, out=None):
    """count windows from states, each retried after a regrow until it
    runs clean; appends (states after, energies [R, W]) to out."""
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica

    sim, ens, every = state["sim"], state["ens"], state["every"]
    for _ in range(count):
        saved = [g.get_state() for g in states[2]]
        for attempt in range(int(ctx.traffic["max_retries"]) + 1):
            with span("ensemble_window"):
                new, (energies, *diag) = state["run"](states, every)
            worst = worst_replica(diag)
            if not sim.overflow_report(*worst):
                break
            state["regrows"] += 1
            sim._regrow(*worst, headroom=min(
                1.3 * 1.25 ** (state["regrows"] - 1), 2.6))
            state["run"] = _runner(ctx, ens)
            for g, s in zip(states[2], saved):
                g.set_state(s)
        else:
            raise RuntimeError("the ensemble's capacities failed to converge")
        states = new
        if out is not None:
            out.append((states, energies))
    return states


def setup(ctx):
    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble

    tr = ctx.traffic
    sim = common.simulation(ctx)
    ens = ReplicaEnsemble(sim, int(tr["replicas"]))
    state = dict(sim=sim, ens=ens, every=int(ctx.config["neighbor_every"]),
                 regrows=0)
    state["run"] = _runner(ctx, ens)
    states = ens.initial_states(jitter=tr["jitter_nm"], seed=ctx.seed + 1)
    stamps = []
    with span("warmup"):
        for _ in range(int(tr["warmup_windows"])):
            states = _windows(ctx, state, states, 1)
            common.sync(ctx.device)
            stamps.append(time.perf_counter())
    state["windows"] = max(1, round(ctx.seconds / (stamps[-1] - stamps[-2])))
    state["regrows"] = 0
    ctx.log(f"warm-up window {stamps[-1] - stamps[-2]:.3f} s: "
            f"{state['windows']} windows")
    return state


def window(ctx, state):
    ens, every, nwin = state["ens"], state["every"], state["windows"]
    states = ens.initial_states(jitter=ctx.traffic["jitter_nm"],
                                seed=ctx.seed)
    done = []
    t0 = time.perf_counter()
    states = _windows(ctx, state, states, nwin, done)
    common.sync(ctx.device)
    elapsed = time.perf_counter() - t0
    nrep = ens.n_replicas
    energies = torch.stack([e for _, e in done]).double().cpu().numpy()
    # [windows, R, W]: a replica's window with a non-finite energy fails
    bad = ~np.isfinite(energies).all(axis=2)
    state["final"] = states
    steps = nwin * every
    ns = nrep * steps * ctx.config["dt_fs"] * 1e-6
    return dict(attempted=nrep * steps, failed=int(bad.sum()) * every,
                metrics=dict(ns_per_day=ns / elapsed * 86400.0),
                trace_data=dict(kind="md", regrows=state["regrows"],
                                units=steps, timed_s=elapsed),
                energies=energies, frames=[(s[0], s[1]) for s, _ in done],
                every=every, windows=nwin, replicas=nrep)


def slice(ctx, state):
    every = state["every"]
    count = int(ctx.traffic["slice_windows"])
    states = state["final"]
    _windows(ctx, state, states, count)
    return dict(slice_units=count * every, work_positions=states[0],
                work_repeats=count * every)


def work(ctx):
    sysd = common.read_dms(ctx.path(ctx.config["system_file"]))
    return common.work_spec(ctx, sysd, common.horizon_nm(ctx.config))


def release(state):
    common.release(state)


def _initial(ctx, chk, nrep):
    """The replicas' initial states as initial_states makes them, from the
    reference's own reading of the system: the DMS positions displaced by
    jitter x the draw of a generator seeded `seed`."""
    pos, vel = chk.start_state()
    gen = common.generator(ctx, ctx.seed)
    draw = torch.randn((nrep,) + tuple(pos.shape), generator=gen,
                       dtype=common.dtype_of(ctx.config), device=ctx.device)
    return pos[None] + ctx.traffic["jitter_nm"] * draw.double(), vel


def check(ctx, rec, control=None):
    every, nwin, nrep = rec["every"], rec["windows"], rec["replicas"]
    frames, energies = rec["frames"], rec["energies"]
    chk = common.TrajectoryCheck(ctx, control)
    rng = common.rng_for(ctx, 2)
    first = rng.choice(nrep, min(int(ctx.traffic["check_first_replicas"]),
                                 nrep), replace=False)
    picks = sorted({(0, int(r)) for r in first}
                   | {(nwin - 1, r) for r in range(nrep)})
    pos0, vel0 = _initial(ctx, chk, nrep)
    n = chk.sysd["n"]
    for r in sorted({r for _, r in picks}):
        wins = [w for w, rr in picks if rr == r]
        keep = {w * every + k for w in wins for k in range(every)}
        noise = common.replay_noise(ctx, ctx.seed + r, nwin * every, n, keep)
        for w in wins:
            start = (pos0[r], vel0) if w == 0 else (frames[w - 1][0][r],
                                                    frames[w - 1][1][r])
            chk.window(start, [noise[w * every + k] for k in range(every)],
                       end=(frames[w][0][r], frames[w][1][r]),
                       e_start=energies[w, r, 0])
    ctx.log(f"checked (window, replica) {picks}: the reference's "
            f"trajectories took {chk.seconds:.3f} s")
    return chk.worst
