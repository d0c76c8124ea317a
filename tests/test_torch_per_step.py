"""The per-step evaluation against the JAX package's, f64 on the CPU, on
trp-cage (272 atoms): ReplicaEnsemble.make_runner(neighbor_every=0) of
R = 2 replicas with SHAKE/RATTLE against JAX's per-step replica_run, and a
Simulation given its tree's candidate pairs (`pairs`) through the per-step
Langevin runner, each fed JAX's noise and held to 1e-9.  The candidate
pairs are the heavy-atom pairs within 0.8 nm at the DMS positions (i < j,
i-major), so the model's all-pairs list is replaced, not repeated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.parallel.ensemble import \
    ReplicaEnsemble as JaxReplicaEnsemble
from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation, \
    load_dms
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
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
