"""Traffic kind `score`: conformer rescoring in a closed loop.

One client calls ConformerScorer.score (energies) on a batch of
`poses_per_call` poses, waits for the energies on the host, and calls
again.  Each pose is the DMS structure turned by a uniformly random
rotation about its centroid, moved by a translation uniform in
+-translation_nm on each axis, and jittered by jitter_nm of Gaussian
noise on every atom; the poses are made on the host from the seed during
set-up, a new batch for every call (the pool holds twice the calls the
warm-up rate predicts; should the window outrun it, the batches repeat
from the start).  Set-up scores `warmup_calls` batches of their own; the
last sizes the pool.  A call's latency runs from its submit until its
energies are on the host.

Traffic parameters: poses_per_call, jitter_nm, translation_nm,
warmup_calls, slice_calls, check_calls (calls whose every pose is
checked: the last call and others drawn from the seed).
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

import common
from reference.agbnp import System
from spans import span


def poses(rng, base, count, tr):
    """count poses of base [N, 3] (float32, [count, N, 3])."""
    q = rng.standard_normal((count, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)
    centre = base.mean(axis=0)
    shift = rng.uniform(-tr["translation_nm"], tr["translation_nm"],
                        (count, 1, 3))
    out = np.einsum("bij,nj->bni", rot, base - centre) + centre + shift
    out += tr["jitter_nm"] * rng.standard_normal(out.shape)
    return out.astype(np.float32)


def _force(ctx, dms):
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, NonbondedMethod

    cfg = ctx.config
    force = AGBNPForce()
    force.setVersion(cfg["agbnp_version"])
    for i in range(len(dms.positions)):
        force.addParticle(dms.agbnp_radius[i], dms.agbnp_gamma[i],
                          dms.agbnp_alpha[i], dms.charges[i],
                          bool(dms.ishydrogen[i]))
    force.setNonbondedMethod(getattr(NonbondedMethod,
                                     cfg["nonbonded_method"]))
    force.setCutoffDistance(cfg["cutoff_nm"])
    return force


def _call(scorer, batch):
    with span("score"):
        return scorer.score(batch)["energy"].cpu().numpy()


def setup(ctx):
    from openmm_agbnp_plugin_tpu_torch import ConformerScorer, load_dms

    tr = ctx.traffic
    dms = load_dms(ctx.path(ctx.config["system_file"]))
    scorer = ConformerScorer(_force(ctx, dms), dms.positions,
                             dtype=common.dtype_of(ctx.config),
                             device=ctx.device)
    base = np.asarray(dms.positions)
    b = int(tr["poses_per_call"])
    rng = np.random.default_rng([ctx.seed, 0])
    warm = poses(rng, base, b * int(tr["warmup_calls"]), tr)
    stamps = [time.perf_counter()]
    with span("warmup"):
        for k in range(int(tr["warmup_calls"])):
            _call(scorer, warm[k * b:(k + 1) * b])
            stamps.append(time.perf_counter())
    call_s = stamps[-1] - stamps[-2]
    calls = int(np.ceil(2 * ctx.seconds / call_s)) + int(tr["slice_calls"])
    pool = poses(rng, base, calls * b, tr).reshape(calls, b, *base.shape)
    ctx.log(f"warm-up call {call_s * 1e3:.3f} ms: a pool of {calls} batches")
    return dict(scorer=scorer, pool=pool, next=0)


def _batch(state):
    pool = state["pool"]
    k = state["next"] % pool.shape[0]
    state["next"] += 1
    return k, pool[k]


def window(ctx, state):
    scorer = state["scorer"]
    lat, out = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        k, batch = _batch(state)
        ts = time.perf_counter()
        e = _call(scorer, batch)
        lat.append(time.perf_counter() - ts)
        out.append((k, e))
    elapsed = time.perf_counter() - t0
    if state["next"] > state["pool"].shape[0]:
        ctx.log(f"the window outran the pool: {state['next']} calls")
    b = state["pool"].shape[1]
    nposes = b * len(out)
    bad = sum(int((~np.isfinite(e)).sum()) for _, e in out)
    p95 = statistics.quantiles(lat, n=20)[-1] if len(lat) > 1 else lat[0]
    return dict(attempted=nposes, failed=bad,
                metrics=dict(poses_per_s=nposes / elapsed,
                             score_p95_ms=p95 * 1e3),
                trace_data=dict(kind="score", units=nposes,
                                timed_s=elapsed),
                calls=out, pool=state["pool"])


def slice(ctx, state):
    count = int(ctx.traffic["slice_calls"])
    used = []
    for _ in range(count):
        k, batch = _batch(state)
        _call(state["scorer"], batch)
        used.append(k)
    pos = torch.as_tensor(state["pool"][used].reshape(
        -1, *state["pool"].shape[2:]), device=ctx.device)
    return dict(slice_units=count * state["pool"].shape[1],
                work_positions=pos, work_repeats=1)


def work(ctx):
    sysd = common.read_dms(ctx.path(ctx.config["system_file"]))
    return common.work_spec(ctx, sysd, None)


def release(state):
    common.release(state)


def check(ctx, rec, control=None):
    """energy_rel: the largest common.energy_gap over every pose of the
    sampled calls, of the program's energies (or the control's)."""
    calls, pool = rec["calls"], rec["pool"]
    sysd = common.read_dms(ctx.path(ctx.config["system_file"]))
    cut = ctx.config["cutoff_nm"]
    ref = System(sysd, ctx.device, torch.float64, cut, None, False)
    alt = None if control is None else System(sysd, ctx.device, control, cut,
                                              None, False)
    rng = common.rng_for(ctx, 3)
    n = len(calls)
    picks = {n - 1} | {int(c) for c in rng.choice(
        n, min(int(ctx.traffic["check_calls"]) - 1, n), replace=False)}
    worst = 0.0
    t0 = time.perf_counter()
    with torch.no_grad():
        for c in sorted(picks):
            k, e_prog = calls[c]
            for p, pos in enumerate(pool[k]):
                x = torch.as_tensor(pos, device=ctx.device)
                e = e_prog[p] if alt is None else float(alt.energy(
                    x.to(control)))
                gap = common.energy_gap(ref, x, e)
                worst = max(worst, gap) if np.isfinite(gap) else np.inf
    ctx.log(f"checked calls {sorted(picks)}: the reference took "
            f"{time.perf_counter() - t0:.3f} s")
    return dict(energy_rel=worst)
