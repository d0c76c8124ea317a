"""The port's replica runners (parallel/ensemble.py, parallel/remd.py) and
hydration sites against the JAX package's, f64 on the CPU.

The exchange move is held against a NumPy restatement (exact decisions,
both parities, R in {2, 5, 8}) and against JAX's attempt_swaps on the same
uniforms.  On trp-cage (272 atoms), R = 2, one ensemble window and one
REMD cycle are held against JAX's ReplicaEnsemble and TemperatureREMD fed
JAX's own noise: replica r's key PRNGKey(seed + r) split once a step
(ensemble.py:47, remd.py:120), and the exchange key split once a cycle
for R uniforms.  At equal temperatures REMD equals the port's ensemble
bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.api.hydration import \
    HydrationSites as JaxHydrationSites
from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.parallel.ensemble import \
    ReplicaEnsemble as JaxReplicaEnsemble
from openmm_agbnp_plugin_tpu.parallel.remd import \
    TemperatureREMD as JaxTemperatureREMD
from openmm_agbnp_plugin_tpu.parallel.remd import \
    attempt_swaps as jax_attempt_swaps
from openmm_agbnp_plugin_tpu.parallel.remd import \
    geometric_ladder as jax_geometric_ladder
from openmm_agbnp_plugin_tpu_torch import (AGBNPForce, HydrationSites,
                                           ReplicaEnsemble, Simulation,
                                           TemperatureREMD, attempt_swaps,
                                           geometric_ladder, load_dms)
from openmm_agbnp_plugin_tpu_torch.md.integrators import KB
from openmm_agbnp_plugin_tpu_torch.ops import tree as T

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
R = 2
STEPS = 4     # one window / one cycle
SEED = 3


def _numpy_attempt_swaps(u, rung, U, betas, parity):
    """Literal NumPy restatement of the even/odd Metropolis sweep."""
    n = len(rung)
    ror = np.empty(n, dtype=int)
    ror[rung] = np.arange(n)
    U_rung = U[ror]
    new_of_rung = np.arange(n)
    accept = np.zeros(n, dtype=bool)
    for q in range(parity, n - 1, 2):
        p = q + 1
        delta = (betas[q] - betas[p]) * (U_rung[q] - U_rung[p])
        if u[q] < min(1.0, np.exp(min(delta, 0.0))):
            new_of_rung[q], new_of_rung[p] = p, q
            accept[q] = accept[p] = True
    return new_of_rung[rung], accept


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("nrep", [2, 5, 8])
def test_attempt_swaps_matches_numpy_and_jax(parity, nrep):
    rng = np.random.default_rng(nrep * 10 + parity)
    U = rng.normal(scale=50.0, size=nrep)
    rung = rng.permutation(nrep)
    betas = 1.0 / (KB * geometric_ladder(300.0, 600.0, nrep))
    key = jax.random.PRNGKey(nrep + parity)
    u = np.asarray(jax.random.uniform(key, (nrep,), dtype=jnp.float64))
    new_rung, accept = attempt_swaps(torch.as_tensor(u),
                                     torch.as_tensor(rung),
                                     torch.as_tensor(U),
                                     torch.as_tensor(betas), parity)
    ref_rung, ref_accept = _numpy_attempt_swaps(u, rung, U, betas, parity)
    np.testing.assert_array_equal(new_rung.numpy(), ref_rung)
    np.testing.assert_array_equal(accept.numpy(), ref_accept)
    j_rung, j_accept = jax_attempt_swaps(
        key, jnp.asarray(rung.astype(np.int32)), jnp.asarray(U),
        jnp.asarray(betas), parity)
    np.testing.assert_array_equal(new_rung.numpy(), np.asarray(j_rung))
    np.testing.assert_array_equal(accept.numpy(), np.asarray(j_accept))
    assert sorted(new_rung.tolist()) == list(range(nrep))


def test_attempt_swaps_equal_temps_accept_all():
    """Equal temperatures: delta == 0, so every valid pair swaps."""
    n = 6
    betas = torch.full((n,), 1.0 / (KB * 300.0), dtype=torch.float64)
    rung = torch.arange(n)
    U = torch.as_tensor(np.random.default_rng(0).normal(size=n))
    for parity in (0, 1):
        u = torch.rand(n, generator=torch.Generator().manual_seed(parity),
                       dtype=torch.float64)
        new_rung, accept = attempt_swaps(u, rung, U, betas, parity)
        expected = np.zeros(n, dtype=bool)
        for q in range(parity, n - 1, 2):
            expected[q] = expected[q + 1] = True
        np.testing.assert_array_equal(accept.numpy(), expected)
        assert sorted(new_rung.tolist()) == list(range(n))


def test_geometric_ladder_matches_jax():
    for args in ((300.0, 600.0, 5), (300.0, 450.0, 8), (300.0, 600.0, 1)):
        np.testing.assert_array_equal(geometric_ladder(*args),
                                      jax_geometric_ladder(*args))


def test_hydration_sites_match_jax():
    ours, theirs = HydrationSites(AGBNPForce()), JaxHydrationSites()
    for args in ((10, 2, 3, 0.05), (11, 4, 5, 0.08), (12, 2, 7, 0.1)):
        assert (ours.add_hydrogen_bonding_site(*args)
                == theirs.add_hydrogen_bonding_site(*args))
    a, b = ours.virtual_sites(), theirs.virtual_sites()
    for k in ("site", "parent1", "parent2", "w1", "w2"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert ours.force.getNumParticles() == 3


@pytest.fixture(scope="module")
def sims():
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         pair_tiles=False, **KW)
    caps = jsim.agbnp.caps
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(caps.caps, caps.offs), **KW)
    assert tsim.kmax == jsim.kmax
    return jsim, tsim


def _jax_noise(keys, steps, shape):
    """Each replica's normal draws in its key chain: [steps, R, N, 3]."""
    out = []
    keys = list(keys)
    for _ in range(steps):
        row = []
        for r, k in enumerate(keys):
            keys[r], sub = jax.random.split(k)
            row.append(np.asarray(jax.random.normal(sub, shape,
                                                    dtype=jnp.float64)))
        out.append(row)
    return torch.as_tensor(np.asarray(out))


def _close(x, ref, tol=1e-9):
    ref = np.asarray(ref)
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert x.shape == ref.shape
    assert np.abs(x - ref).max() <= tol * np.abs(ref).max()


def test_ensemble_window_matches_jax(sims):
    """One rebuild window of R = 2 replicas (vdW-compact WU pass) against
    JAX's vmapped ReplicaEnsemble, with JAX's noise: positions, velocities
    and energies within 1e-9."""
    jsim, tsim = sims
    jens = JaxReplicaEnsemble(jsim, R)
    states = jens.initial_states(jitter=1e-3, seed=SEED)
    (jpos, jvel, _), (je, *_) = jens.make_runner(
        dt=0.001, neighbor_every=STEPS)(states, STEPS)
    noise = _jax_noise(states[2], STEPS, jsim.positions.shape)
    ens = ReplicaEnsemble(tsim, R)
    pos0 = torch.as_tensor(np.asarray(states[0]))
    vel0 = torch.as_tensor(np.asarray(states[1]))
    (pos, vel, _), (e, counts, nbmax, sibs, wu, shake) = ens.make_runner(
        dt=0.001, neighbor_every=STEPS)((pos0, vel0, None), STEPS,
                                        noise=noise)
    assert e.shape == (R, STEPS) and counts.shape[0] == R
    assert shake is None  # no constraints
    assert not tsim._check_overflow(counts.amax(0), nbmax.amax(),
                                    sibs.amax(0), wu.amax(0))
    _close(e, je)
    _close(pos, jpos)
    _close(vel, jvel)


def test_remd_cycle_matches_jax(sims):
    """One T-REMD cycle on a two-rung ladder against JAX's, fed JAX's
    step noise and exchange uniforms: exchange energies, rungs, positions,
    velocities and per-step energies."""
    jsim, tsim = sims
    temps = geometric_ladder(300.0, 330.0, R)
    jremd = JaxTemperatureREMD(jsim, temps)
    states, xkey = jremd.initial_states(jitter=1e-3, seed=SEED)
    (jpos, jvel, _, jrung), _, jout = jremd.make_runner(
        dt=0.001, steps_per_cycle=STEPS, neighbor_every=STEPS)(states, xkey,
                                                                1)
    noise = _jax_noise(states[2], STEPS, jsim.positions.shape)
    _, sub = jax.random.split(xkey)
    u = torch.as_tensor(np.asarray(jax.random.uniform(
        sub, (R,), dtype=jnp.float64)))[None]
    remd = TemperatureREMD(tsim, temps)
    tstates = (torch.as_tensor(np.asarray(states[0])),
               torch.as_tensor(np.asarray(states[1])), None,
               torch.as_tensor(np.asarray(states[3])).long())
    (pos, vel, _, rung), out = remd.make_runner(
        dt=0.001, steps_per_cycle=STEPS, neighbor_every=STEPS)(
            tstates, None, 1, noise=noise, uniforms=u)
    np.testing.assert_array_equal(rung.numpy(), np.asarray(jrung))
    np.testing.assert_array_equal(out["accept"].numpy(),
                                  np.asarray(jout["accept"]))
    _close(out["U"], jout["U"])
    _close(out["energies"], jout["energies"])
    _close(pos, jpos)
    _close(vel, jvel)


def test_remd_equal_temps_is_the_ensemble_bitwise(sims):
    """All-equal ladder: every attempted pair swaps, the velocity rescale
    is 1 and no temperature changes, so two REMD cycles equal the ensemble
    over the same windows with the same generators, bit for bit."""
    _, tsim = sims
    remd = TemperatureREMD(tsim, [300.0] * R)
    states, xgen = remd.initial_states(jitter=1e-3, seed=SEED)
    pos0, vel0 = states[0].clone(), states[1].clone()
    (pos, vel, _, rung), out = remd.make_runner(
        dt=0.001, steps_per_cycle=STEPS // 2,
        neighbor_every=STEPS // 2)(states, xgen, 2)
    assert out["accept"][0].all() and not out["accept"][1].any()
    ens = ReplicaEnsemble(tsim, R)
    gens = ens.initial_states(seed=SEED)[2]
    (epos, evel, _), (e, *_) = ens.make_runner(
        dt=0.001, neighbor_every=STEPS // 2)((pos0, vel0, gens), STEPS)
    assert torch.equal(pos, epos)
    assert torch.equal(vel, evel)
    assert torch.equal(out["energies"], e)


@pytest.mark.parametrize("spc, every, builds", [(2, 2, 4), (3, 2, 6)],
                         ids=["no_remainder", "remainder"])
def test_remd_cycle_end_build_serves_the_next_cycle(sims, monkeypatch, spc,
                                                    every, builds):
    """Without a remainder window a cycle's exchange build, at its last
    positions, is the next cycle's first window build: three cycles build
    one tree at the start and one at each cycle's end.  With a remainder
    window the exchange takes that window's tree and every window builds
    its own."""
    _, tsim = sims
    calls = []
    build = tsim.window_build

    def counted(*args, **kw):
        calls.append(1)
        return build(*args, **kw)

    monkeypatch.setattr(tsim, "window_build", counted)
    remd = TemperatureREMD(tsim, geometric_ladder(300.0, 330.0, R))
    states, xgen = remd.initial_states(jitter=1e-3, seed=SEED)
    _, out = remd.make_runner(steps_per_cycle=spc, neighbor_every=every)(
        states, xgen, 3)
    assert len(calls) == builds
    assert out["energies"].shape == (R, 3 * spc)
    assert bool(torch.isfinite(out["U"]).all())


@pytest.mark.parametrize("version", [0, 1])
def test_one_replica_ensemble_is_the_simulation_runner(version):
    """R = 1 through the replica runner (the union tree of one replica, the
    kernels' replica axis of one) against the Simulation's own Langevin
    runner on the same generator: energies, positions and velocities
    within 1e-12 over two windows and a remainder, versions 0 and 1."""
    sim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                     **{**KW, "version": version})
    steps, every = 5, 2
    run = sim.make_langevin_runner(0.001, 300.0, 1.0, neighbor_every=every)
    pos, vel, e, diag = run(sim.positions, sim.velocities, steps,
                            generator=torch.Generator().manual_seed(9))
    assert not sim._check_overflow(*diag)
    ens = ReplicaEnsemble(sim, 1)
    gens = [torch.Generator().manual_seed(9)]
    (epos, evel, _), (ee, *_) = ens.make_runner(neighbor_every=every)(
        (sim.positions[None], sim.velocities[None], gens), steps)
    _close(ee[0], e.numpy(), 1e-12)
    _close(epos[0], pos.numpy(), 1e-12)
    _close(evel[0], vel.numpy(), 1e-12)
