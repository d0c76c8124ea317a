"""The port's ReplicaEnsemble with constraints and with virtual sites
against the JAX package's, f64 on the CPU.

On trp-cage (272 atoms), R = 2: one rebuild window with SHAKE/RATTLE X-H
constraints (128 per replica) and, apart, with two hydration sites
sharing a parent (the hydrogens of an NH2 group placed on the axes to
their hydrogen-bond acceptors), each fed JAX's own noise (replica r's key
PRNGKey(seed + r) split once a step) and held to 1e-9 against JAX's
vmapped ReplicaEnsemble (compiled with scan_unroll=1: one step body, the
same steps; the full WU pass, which keeps JAX's compile inside the file's
time).  The set-ups here also serve tests/test_torch_remd_constraints.py
(the T-REMD cycles) and tests/test_torch_per_step.py (the per-step path).
Both sides converge SHAKE to tol 1e-13 (JAX under its while_loop, the
port in 5 fixed Newton sweeps), as tests/test_torch_constraints.py does.
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
from openmm_agbnp_plugin_tpu.md.constraints import \
    Constraints as JaxConstraints
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.parallel.ensemble import \
    ReplicaEnsemble as JaxReplicaEnsemble
from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation, \
    load_dms
from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
from openmm_agbnp_plugin_tpu_torch.md.vsites import VirtualSites, \
    project_positions
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
R = 2
STEPS = 4     # one window / one cycle
SEED = 3
TOL = 1e-13   # both sides' SHAKE tolerance


def _sites():
    """Two hydration sites sharing a parent, as tests/test_torch_
    constraints.py::_sites builds them: trp-cage's hydrogens 212 and 213
    of the NH2 group on N 201 placed on the axes from N 201 to the
    acceptors of their hydrogen bonds (O 60 at 9.5 degrees off N-H212, N
    179 at 11.7 degrees off N-H213), at their own N-H distances, so the
    bonded terms stay near their minima and the dynamics stay finite."""
    hs = JaxHydrationSites()
    hs.add_hydrogen_bonding_site(212, heavy=201, hydrogen=60,
                                 distance=0.0370)
    hs.add_hydrogen_bonding_site(213, heavy=201, hydrogen=179,
                                 distance=0.0355)
    v = hs.virtual_sites()
    return v, VirtualSites(v.site, v.parent1, v.parent2, v.w1, v.w2)


def _sims(kind, **kw):
    jd, d = jax_load_dms(DMS), load_dms(DMS)
    jkw, tkw = dict(kw), dict(kw)
    if kind == "vsites":
        jkw["vsites"], tkw["vsites"] = _sites()
    jsim = JaxSimulation(jd, dtype=np.float64, pair_tiles=False, **jkw,
                         **KW)
    caps = jsim.agbnp.caps
    tsim = Simulation(d, device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(caps.caps, caps.offs), **tkw, **KW)
    if kind == "constraints":
        jsim.constraints = JaxConstraints.from_dms(jd, tol=TOL)
        tsim.constraints = Constraints.from_dms(d, device="cpu", tol=TOL)
        tsim.constraints.sweeps = 5
    return jsim, tsim


@pytest.fixture(scope="module", params=["constraints", "vsites"])
def sims(request):
    return request.param, *_sims(request.param)


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


def _states(states):
    """JAX's (pos, vel, ...) states as the port's, noise given."""
    return (torch.tensor(np.asarray(states[0])),
            torch.tensor(np.asarray(states[1])), None)


def _check_state(kind, tsim, pos, shake):
    """Constraints: every replica's residual within the tolerance and its
    bonds held; virtual sites: the sites the force sees on their parents'
    axis in every replica."""
    if kind == "constraints":
        assert shake.shape == (R,)
        assert float(shake.max()) <= TOL
        assert float(tsim.constraints.max_violation(pos).max()) <= 1e-12
    else:
        assert shake is None
        vs = tsim.vsites
        proj = project_positions(pos, vs)
        for r in range(R):
            assert torch.equal(proj[r], project_positions(pos[r], vs))
        want = (vs["w1"][:, None] * pos[:, vs["p1"]]
                + vs["w2"][:, None] * pos[:, vs["p2"]])
        assert torch.equal(proj[:, vs["site"]], want)


def test_ensemble_window_matches_jax(sims):
    """One rebuild window of R = 2 replicas (the full WU pass) against
    JAX's vmapped ReplicaEnsemble, with JAX's noise: positions, velocities
    and energies within 1e-9; the window's diagnostics clean."""
    kind, jsim, tsim = sims
    jens = JaxReplicaEnsemble(jsim, R)
    states = jens.initial_states(jitter=1e-3, seed=SEED)
    (jpos, jvel, _), (je, *_) = jens.make_runner(
        dt=0.001, neighbor_every=STEPS, vdw_compact=False,
        scan_unroll=1)(states, STEPS)
    noise = _jax_noise(states[2], STEPS, jsim.positions.shape)
    ens = ReplicaEnsemble(tsim, R)
    (pos, vel, _), (e, *diag) = ens.make_runner(
        dt=0.001, neighbor_every=STEPS, vdw_compact=False)(
            _states(states), STEPS, noise=noise)
    assert e.shape == (R, STEPS)
    assert not tsim.overflow_report(*worst_replica(diag))
    _check_state(kind, tsim, pos, diag[4])
    _close(e, je)
    _close(pos, jpos)
    _close(vel, jvel)


def test_replica_runners_refuse_version_2_only():
    """Constraints and virtual sites run (above); version 2 still raises,
    saying what it waits for."""
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        check_replica_sim

    class V2:
        agbnp2 = object()

    with pytest.raises(NotImplementedError, match="batched AGBNP2"):
        check_replica_sim(V2(), "ReplicaEnsemble")
