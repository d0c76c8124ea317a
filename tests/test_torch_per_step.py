"""The per-step evaluation against the JAX package's, f64 on the CPU, on
trp-cage (272 atoms): ReplicaEnsemble.make_runner(neighbor_every=0) of
R = 2 replicas with SHAKE/RATTLE against JAX's per-step replica_run, and a
Simulation given its tree's candidate pairs (`pairs`) through the per-step
Langevin runner, each fed JAX's noise and held to 1e-9.  The candidate
pairs are the heavy-atom pairs within 0.8 nm at the DMS positions (i < j,
i-major), so the model's all-pairs list is replaced, not repeated.

Version 2 (AGBNP2): the per-step ensemble of R = 2 replicas (one batched
AGBNP2 evaluation a step, each replica's MS candidates found on the
device) against JAX's vmapped per-step runner fed the same noise, to
1e-9; JAX's windowed runner fails on version 2 and the port's windowed
runner and T-REMD refuse it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md.simulation import \
    Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.parallel.ensemble import \
    ReplicaEnsemble as JaxReplicaEnsemble
from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation, \
    TemperatureREMD, load_dms
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica
from test_torch_replica_md import (DMS, KW, R, SEED, STEPS, _close,
                                   _jax_noise, _sims, _states)

torch.set_num_threads(2)


def _pairs():
    """Heavy-atom candidate pairs (i < j) within 0.8 nm at the DMS
    positions, i-major."""
    d = load_dms(DMS)
    pos = np.asarray(d.positions)
    heavy = np.nonzero(np.asarray(d.ishydrogen) == 0)[0]
    i, j = np.triu_indices(len(heavy), 1)
    i, j = heavy[i], heavy[j]
    near = np.linalg.norm(pos[i] - pos[j], axis=1) < 0.8
    return i[near].astype(np.int32), j[near].astype(np.int32)


def test_per_step_ensemble_matches_jax():
    """ReplicaEnsemble.make_runner(neighbor_every=0): every step evaluates
    the full force on the model's own candidate pairs (the Simulation's
    `pairs`), with constraints, against JAX's per-step replica_run fed the
    same noise; the diagnostics are the steps' counts with zero neighbor,
    sibling and WU entries."""
    jsim, tsim = _sims("constraints", pairs=_pairs())
    jens = JaxReplicaEnsemble(jsim, R)
    states = jens.initial_states(jitter=1e-3, seed=SEED)
    (jpos, jvel, _), (je, *_) = jens.make_runner(
        dt=0.001, neighbor_every=0, scan_unroll=1)(states, STEPS)
    noise = _jax_noise(states[2], STEPS, jsim.positions.shape)
    ens = ReplicaEnsemble(tsim, R)
    (pos, vel, _), (e, counts, nbmax, sibs, wu, shake) = ens.make_runner(
        dt=0.001, neighbor_every=0)(_states(states), STEPS, noise=noise)
    assert counts.shape[0] == R and int(counts[:, 0].min()) > 0
    assert not (nbmax.any() or sibs.any() or wu.any())
    assert not tsim.overflow_report(counts.amax(0), nbmax.amax(),
                                    sibs.amax(0), wu.amax(0), shake.amax())
    _close(e, je)
    _close(pos, jpos)
    _close(vel, jvel)


def test_pairs_per_step_window_matches_jax():
    """Simulation(pairs=...) through the per-step Langevin runner
    (neighbor_every=0: every step builds the tree from the given pairs)
    against JAX's Simulation given the same pairs, fed JAX's noise."""
    from openmm_agbnp_plugin_tpu.md.simulation import \
        Simulation as JaxSimulation

    pairs = _pairs()
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         pair_tiles=False, pairs=pairs, **KW)
    caps = jsim.agbnp.caps
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(caps.caps, caps.offs), pairs=pairs,
                      **KW)
    assert tsim.agbnp.arrays["pairs_i"].shape[0] == len(pairs[0])
    key = jax.random.PRNGKey(5)
    jpos, jvel, _, je, _ = jsim.make_langevin_runner(
        0.001, 300.0, 1.0, neighbor_every=0, scan_unroll=1)(
            jsim.positions, jsim.velocities, key, 2)
    noise = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            sub, jsim.positions.shape, dtype=jnp.float64)))
    pos, vel, e, diag = tsim.make_langevin_runner(
        0.001, 300.0, 1.0, neighbor_every=0)(
            tsim.positions, tsim.velocities, 2,
            noise=torch.as_tensor(np.stack(noise)))
    assert not tsim._check_overflow(*diag)
    _close(e, je)
    _close(pos, jpos)
    _close(vel, jvel)


@pytest.fixture(scope="module")
def v2_sims():
    """JAX's and the port's Simulation(version=2) of trp-cage in f64, the
    port at JAX's atomic tree capacities."""
    jsim = JaxSimulation(jax_load_dms(DMS), version=2, dtype=np.float64)
    caps = jsim.agbnp2.caps
    tsim = Simulation(load_dms(DMS), device="cpu", version=2,
                      dtype=torch.float64,
                      caps=T.TreeCaps(tuple(caps.caps), tuple(caps.offs)))
    m, jm = tsim.agbnp2, jsim.agbnp2
    assert (m.cap_ms, m.ms_kmax, m.ms_sub_k, tsim.ms_kmax_list) == (
        jm.cap_ms, jm.ms_kmax, jm.ms_sub_k, jsim.ms_kmax_list)
    return jsim, tsim


def test_per_step_v2_ensemble_matches_jax(v2_sims):
    """Version 2 through ReplicaEnsemble.make_runner(neighbor_every=0), R
    = 2, 2 steps fed JAX's noise: energies, positions, velocities to 1e-9
    of JAX's vmapped per-step runner; the [R, 18] counts equal JAX's and
    clean."""
    jsim, tsim = v2_sims
    jens = JaxReplicaEnsemble(jsim, R)
    states = jens.initial_states(jitter=1e-3, seed=SEED)
    steps = 2
    (jpos, jvel, _), (je, jcounts, *_) = jens.make_runner(
        dt=0.001, neighbor_every=0, scan_unroll=1)(states, steps)
    noise = _jax_noise(states[2], steps, jsim.positions.shape)
    ens = ReplicaEnsemble(tsim, R)
    (pos, vel, _), (e, counts, nbmax, sibs, wu, shake) = ens.make_runner(
        dt=0.001, neighbor_every=0)(_states(states), steps, noise=noise)
    assert counts.shape == (R, 18) and shake is None
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert not tsim.overflow_report(*worst_replica(
        (counts, nbmax, sibs, wu, shake)))
    _close(e, je)
    _close(pos, jpos)
    _close(vel, jvel)


def test_windowed_v2_replicas_fail_in_jax_and_are_refused(v2_sims):
    """JAX's windowed replica runner fails on version 2 (its window hands
    the atomic tree to the v2 force function, which unpacks an AGBNP2
    topology); the port's windowed runner and T-REMD refuse version 2,
    naming the per-step path."""
    jsim, tsim = v2_sims
    jens = JaxReplicaEnsemble(jsim, R)
    with pytest.raises(ValueError, match="too many values to unpack"):
        jens.make_runner(dt=0.001, neighbor_every=4, scan_unroll=1)(
            jens.initial_states(jitter=1e-3, seed=SEED), 4)
    ens = ReplicaEnsemble(tsim, R)
    with pytest.raises(NotImplementedError, match="per-step path"):
        ens.make_runner(neighbor_every=4)
    with pytest.raises(NotImplementedError, match="per-step path"):
        TemperatureREMD(tsim, [300.0, 320.0])
