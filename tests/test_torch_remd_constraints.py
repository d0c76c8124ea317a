"""The port's TemperatureREMD with constraints and with virtual sites
against the JAX package's, f64 on the CPU: trp-cage (272 atoms), R = 2,
one 4-step cycle on a two-rung ladder, fed JAX's own noise and exchange
uniforms, held to 1e-9 (the set-ups of tests/test_torch_replica_md.py,
which holds the ensemble windows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from openmm_agbnp_plugin_tpu.parallel.remd import \
    TemperatureREMD as JaxTemperatureREMD
from openmm_agbnp_plugin_tpu_torch import TemperatureREMD, geometric_ladder
from test_torch_replica_md import (  # noqa: F401  (the sims fixture)
    R, SEED, STEPS, _check_state, _close, _jax_noise, _states, sims)

torch.set_num_threads(2)


def test_remd_cycle_matches_jax(sims):
    """One T-REMD cycle on a two-rung ladder (the full WU pass) against
    JAX's, fed JAX's step noise and exchange uniforms: rungs,
    acceptances, exchange energies, per-step energies, positions and
    velocities; every replica's constraints held or sites on their axes."""
    kind, jsim, tsim = sims
    temps = geometric_ladder(300.0, 330.0, R)
    jremd = JaxTemperatureREMD(jsim, temps)
    states, xkey = jremd.initial_states(jitter=1e-3, seed=SEED)
    (jpos, jvel, _, jrung), _, jout = jremd.make_runner(
        dt=0.001, steps_per_cycle=STEPS, neighbor_every=STEPS,
        scan_unroll=1, vdw_compact=False)(states, xkey, 1)
    noise = _jax_noise(states[2], STEPS, jsim.positions.shape)
    _, sub = jax.random.split(xkey)
    u = torch.as_tensor(np.asarray(jax.random.uniform(
        sub, (R,), dtype=jnp.float64)))[None]
    remd = TemperatureREMD(tsim, temps)
    tstates = (*_states(states),
               torch.as_tensor(np.asarray(states[3])).long())
    (pos, vel, _, rung), out = remd.make_runner(
        dt=0.001, steps_per_cycle=STEPS, neighbor_every=STEPS,
        vdw_compact=False)(
            tstates, None, 1, noise=noise, uniforms=u)
    np.testing.assert_array_equal(rung.numpy(), np.asarray(jrung))
    np.testing.assert_array_equal(out["accept"].numpy(),
                                  np.asarray(jout["accept"]))
    _check_state(kind, tsim, pos, out["shake_residual"])
    _close(out["U"], jout["U"])
    _close(out["energies"], jout["energies"])
    _close(pos, jpos)
    _close(vel, jvel)
