"""The port's other integrators against the JAX package, f64, on
trp-cage (272 atoms): velocity Verlet, r-RESPA Verlet and FIRE (the
all-pairs and per-step-build Langevin runners are in
tests/test_torch_run_md.py).

The JAX side runs `pair_tiles=False` (dense XLA pair phases on the CPU),
the port its kernel route (plain twins on the CPU), with the same tree
capacities.  The step-level comparisons drive both integrators with one
window's force function (neighbor list + tree topology built at the
window start), the form every MD runner uses between rebuilds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md import integrators as JI
from openmm_agbnp_plugin_tpu.md.minimize import \
    fire_minimize as jax_fire_minimize
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu.ops.neighbors import \
    half_neighbor_pairs as jax_half_neighbor_pairs
from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.md.integrators import (
    mts_verlet_step, velocity_verlet_step)
from openmm_agbnp_plugin_tpu_torch.md.minimize import fire_minimize, \
    make_fire_runner
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import half_neighbor_pairs

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
TOL = 1e-9


@pytest.fixture(scope="module")
def sims():
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         caps=JT.TreeCaps(*CAPS), pair_tiles=False, **KW)
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **KW)
    return jsim, tsim


@pytest.fixture(scope="module")
def window_fns(sims):
    """Each package's force_fn kwargs for one window (neighbor list and
    topology built at the initial positions)."""
    jsim, tsim = sims
    a = jsim.agbnp.arrays
    pos = jsim.positions
    jpairs = jax_half_neighbor_pairs(pos, jsim.heavy_mask, jsim.rcut_list,
                                     jsim.kmax)[:3]
    lvl1 = JT.make_level1(pos, jnp.asarray(a["radii_large"]),
                          jnp.asarray(a["vol_large"]),
                          jnp.asarray(a["gamma"]) / jsim.agbnp.params.roffset,
                          jnp.asarray(a["ishydrogen"]))
    build = jax.jit(JT.build_tree, static_argnames=("caps", "pair_rows"))
    levels, _ = build(lvl1, *jpairs[:2], jsim.agbnp.caps,
                      pairs_valid=jpairs[2], pair_rows=True)
    b = tsim.agbnp.arrays
    tpairs = half_neighbor_pairs(tsim.positions, tsim.heavy_mask,
                                 tsim.rcut_list, tsim.kmax)[:3]
    lvl1_t = T.make_level1(tsim.positions, b["radii_large"], b["vol_large"],
                           b["gamma"] / tsim.agbnp.params.roffset,
                           b["ishydrogen"])
    levels_t, _ = T.build_tree(lvl1_t, *tpairs[:2], tsim.agbnp.caps,
                               pairs_valid=tpairs[2], pair_rows=True)
    return (dict(pairs=jpairs, topology=JT.tree_topology(levels)),
            dict(pairs=tpairs, topology=T.tree_topology(levels_t)))


def _close(x, ref, tol=TOL, what=""):
    x = np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape, (what, x.shape, ref.shape)
    err = np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (what, err)


def test_verlet_and_mts_verlet_match_jax(sims, window_fns):
    """Three velocity-Verlet steps and two r-RESPA Verlet steps (two
    bonded substeps) from the same state."""
    jsim, tsim = sims
    jkw, tkw = window_fns
    dt = 0.0005
    fn_j = jsim.force_fn(**jkw)
    step_j = JI.velocity_verlet_step(fn_j, jsim.masses, dt)

    @jax.jit
    def run_j(pos, vel):
        state = (pos, vel, fn_j(pos)[1])
        state, (pe, ke, _) = jax.lax.scan(step_j, state, length=3)
        return state, pe, ke

    (pos_j, vel_j, _), pe_j, ke_j = run_j(jsim.positions, jsim.velocities)
    fn_t = tsim.force_fn(**tkw)
    step_t = velocity_verlet_step(fn_t, tsim.masses, dt)
    pos, vel, force = tsim.positions, tsim.velocities, fn_t(tsim.positions)[1]
    pe_t, ke_t = [], []
    for _ in range(3):
        pos, vel, force, pe, ke, _, shake = step_t(pos, vel, force)
        assert shake is None
        pe_t.append(pe)
        ke_t.append(ke)
    for name, x, y in (("pos", pos, pos_j), ("vel", vel, vel_j),
                       ("pe", torch.stack(pe_t), pe_j),
                       ("ke", torch.stack(ke_t), ke_j)):
        _close(x, y, TOL, name)

    slow_j, fast_j = jsim.force_fn(split=True, **jkw)
    mstep_j = JI.mts_verlet_step(slow_j, fast_j, jsim.masses, dt=dt, inner=2)

    @jax.jit
    def mrun_j(pos, vel):
        state = (pos, vel, slow_j(pos)[1], fast_j(pos)[1])
        return jax.lax.scan(mstep_j, state, length=2)

    state, (pe_j, ke_j, _) = mrun_j(jsim.positions, jsim.velocities)
    slow_t, fast_t = tsim.force_fn(split=True, **tkw)
    mstep_t = mts_verlet_step(slow_t, fast_t, tsim.masses, dt=dt, inner=2)
    st = (tsim.positions, tsim.velocities, slow_t(tsim.positions)[1],
          fast_t(tsim.positions)[1])
    for _ in range(2):
        *st, pe_t, ke_t, _, shake = mstep_t(*st)
        assert shake is None
    _close(st[0], state[0], TOL, "mts pos")
    _close(st[1], state[1], TOL, "mts vel")
    _close(pe_t, pe_j[-1], TOL, "mts pe")
    _close(ke_t, ke_j[-1], TOL, "mts ke")


def test_verlet_runner_conserves_energy(sims):
    """The port's make_verlet_runner (all-pairs evaluation every step):
    finite, clean, and total energy held over 4 steps at 0.5 fs."""
    _, tsim = sims
    pos, vel, pe, ke, diag = tsim.make_verlet_runner(dt=0.0005)(
        tsim.positions, tsim.velocities, 4)
    assert not tsim._check_overflow(*diag) and diag[4] is None
    tot = (pe + ke).numpy()
    assert np.isfinite(tot).all() and pe.shape == (4,)
    assert abs(tot[-1] - tot[0]) < 0.05 * abs(tot[0]) + 5.0


def test_fire_matches_jax(sims, window_fns):
    """FIRE at a fixed iteration count, and make_fire_runner against
    fire_minimize."""
    jsim, tsim = sims
    jkw, tkw = window_fns
    pos_j, e_j = jax_fire_minimize(jsim.force_fn(**jkw), jsim.positions,
                                   maxiter=6)
    fn_t = tsim.force_fn(**tkw)
    pos_t, e_t = fire_minimize(fn_t, tsim.positions, maxiter=6)
    _close(e_t, e_j, TOL, "energies")
    _close(pos_t, pos_j, TOL, "pos")
    assert float(e_t[-1]) < float(e_t[0])

    def dict_fn(pos):
        e, f, counts = fn_t(pos)
        return dict(energy=e, force=f, diag=dict(counts=counts))

    pos_r, e_r, diag = make_fire_runner(dict_fn, maxiter=3)(tsim.positions)
    pos_f, e_f = fire_minimize(fn_t, tsim.positions, maxiter=3)
    assert torch.equal(pos_r, pos_f) and torch.equal(e_r, e_f)
    assert not tsim._check_overflow(diag["counts"], 0, torch.zeros(7))
