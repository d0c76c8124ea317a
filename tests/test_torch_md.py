"""The port's MD slice against the JAX package's Simulation, f64, on
trp-cage (272 atoms): AGBNP1 + OPLS, 1 nm cutoff with the descreening
horizon at the cutoff, rebuild windows.

The JAX side runs `Simulation(..., pair_tiles=False)`, whose CPU default
takes the dense XLA pair phases with the MM nonbonded sum by autodiff; the
port runs its kernel route (plain twins on the CPU) with the MM sum fused
into the GB sweep.  Both get the same tree capacities, and the port's
Langevin step gets JAX's exact noise (the jax.random.split / normal stream
of md/integrators.py:78-79).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu.ops.neighbors import \
    half_neighbor_pairs as jax_half_neighbor_pairs
from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.md.forces import dense_nonbonded_energy
from openmm_agbnp_plugin_tpu_torch.md.integrators import (
    KB, kinetic_energy, maxwell_boltzmann_velocities, temperature)
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import energy_forces
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import half_neighbor_pairs

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")


@pytest.fixture(scope="module")
def sims():
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         caps=JT.TreeCaps(*CAPS), pair_tiles=False, **KW)
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **KW)
    assert tsim.kmax == jsim.kmax
    return jsim, tsim


def test_force_fn_with_rebuilt_topology_matches_jax(sims):
    """One window's force: neighbor list + tree topology built at the
    window start, evaluated at moved positions (fixed-topology rescan)."""
    jsim, tsim = sims
    pos0 = np.array(jsim.positions)
    pos1 = pos0 + np.random.default_rng(5).normal(0.0, 0.005, pos0.shape)

    a = jsim.agbnp.arrays
    pj0 = jnp.asarray(pos0)
    pairs_j = jax_half_neighbor_pairs(pj0, jsim.heavy_mask, jsim.rcut_list,
                                      jsim.kmax)[:3]
    gdr = jnp.asarray(a["gamma"]) / jsim.agbnp.params.roffset
    lvl1 = JT.make_level1(pj0, jnp.asarray(a["radii_large"]),
                          jnp.asarray(a["vol_large"]), gdr,
                          jnp.asarray(a["ishydrogen"]))
    build = jax.jit(JT.build_tree, static_argnames=("caps", "pair_rows"))
    levels, _ = build(lvl1, *pairs_j[:2], jsim.agbnp.caps,
                      pairs_valid=pairs_j[2], pair_rows=True)
    fn_j = jax.jit(jsim.force_fn(pairs=pairs_j,
                                 topology=JT.tree_topology(levels)))
    e_j, f_j, c_j = (np.asarray(x) for x in fn_j(jnp.asarray(pos1)))

    b = tsim.agbnp.arrays
    pt0 = torch.as_tensor(pos0)
    pairs_t = half_neighbor_pairs(pt0, tsim.heavy_mask, tsim.rcut_list,
                                  tsim.kmax)[:3]
    lvl1_t = T.make_level1(pt0, b["radii_large"], b["vol_large"],
                           b["gamma"] / tsim.agbnp.params.roffset,
                           b["ishydrogen"])
    levels_t, _ = T.build_tree(lvl1_t, *pairs_t[:2], tsim.agbnp.caps,
                               pairs_valid=pairs_t[2], pair_rows=True)
    fn_t = tsim.force_fn(pairs=pairs_t, topology=T.tree_topology(levels_t))
    e_t, f_t, c_t = fn_t(torch.as_tensor(pos1))

    # the port runs on tile lists (JAX here on its dense route): its counts
    # carry the Born and GB in-range tile counts after the tree levels
    np.testing.assert_array_equal(c_t.numpy()[:len(c_j)], c_j)
    assert c_t.shape == (len(c_j) + 2,)
    assert (c_t[len(c_j):].numpy() <= np.asarray(tsim.agbnp.pair_tiles)).all()
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_langevin_window_matches_jax_with_its_noise(sims):
    """10 steps, neighbor list and topology rebuilt every 5."""
    jsim, tsim = sims
    nsteps, every = 10, 5
    run_j = jsim.make_langevin_runner(0.001, 300.0, 1.0,
                                      neighbor_every=every,
                                      vdw_compact=False, wu_every=1)
    key = jax.random.PRNGKey(0)
    pos_j, vel_j, _, e_j, _ = run_j(jsim.positions, jsim.velocities, key,
                                    nsteps)
    noise = []
    for _ in range(nsteps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, jsim.positions.shape,
                                                  dtype=jnp.float64)))
    run_t = tsim.make_langevin_runner(0.001, 300.0, 1.0,
                                      neighbor_every=every)
    pos_t, vel_t, e_t, diag = run_t(tsim.positions, tsim.velocities, nsteps,
                                    noise=torch.as_tensor(np.stack(noise)))
    assert not tsim._check_overflow(*diag)
    e_j = np.asarray(e_j)
    assert e_t.shape == e_j.shape == (nsteps,)
    assert np.abs(e_t.numpy() - e_j).max() <= 1e-9 * np.abs(e_j).max()
    for name, x, y in (("pos", pos_t, pos_j), ("vel", vel_t, vel_j)):
        y = np.asarray(y)
        err = np.abs(x.numpy() - y).max() / np.abs(y).max()
        assert err <= 1e-9, (name, err)


def test_fused_mm_matches_dense_twin(sims):
    """The OPLS LJ + Coulomb sum riding the GB sweep (in-kernel exclusion
    lists, Morton row space) equals the dense all-pairs twin with an [N, N]
    exclusion mask: energy, and force as the difference of the pair
    force with and without the fused terms."""
    _, tsim = sims
    m = tsim.agbnp
    ff = tsim.ff_state()
    pos = tsim.positions
    mm_nb = dict(sigma=ff["mm"]["sigma"], epsq=ff["mm"]["epsq"],
                 excl_rows_perm=ff["excl_rows_perm"])
    kw = dict(caps=m.caps, version=1, roffset=m.params.roffset,
              ntypes_j=m.ntypes_j, cutoff=m.cutoff, pair_pad=m.pair_pad,
              descreen_horizon=m.descreen_horizon)
    with_mm = energy_forces(ff["a"], pos, mm_nb=mm_nb, **kw)
    without = energy_forces(ff["a"], pos, **kw)
    assert torch.equal(with_mm["energy"], without["energy"])
    x = pos.clone().requires_grad_(True)
    mm = ff["mm"]
    e_ref = dense_nonbonded_energy(x, mm["charge"], mm["sigma"],
                                   mm["epsilon"], cutoff=m.cutoff,
                                   excl_mask=torch.as_tensor(
                                       tsim.mm.excl_mask()))
    (g,) = torch.autograd.grad(e_ref, x)
    e_ref = e_ref.detach()
    e_mm = with_mm["details"]["e_mm_nb"]
    assert abs(float(e_mm) - float(e_ref)) <= 1e-10 * abs(float(e_ref))
    f_mm = with_mm["force"] - without["force"]
    assert float((f_mm + g).abs().max()) <= 1e-9 * float(g.abs().max())


def test_maxwell_boltzmann_velocities(sims):
    _, tsim = sims
    m = tsim.masses
    gen = torch.Generator().manual_seed(3)
    v = maxwell_boltzmann_velocities(m, 300.0, gen)
    v2 = maxwell_boltzmann_velocities(m, 300.0,
                                      torch.Generator().manual_seed(3))
    assert torch.equal(v, v2)
    assert float(torch.sum(m[:, None] * v, dim=0).abs().max()) < 1e-12
    ndof = 3 * m.shape[0] - 3
    assert float(kinetic_energy(v, m)) == pytest.approx(0.5 * ndof * KB * 300.0,
                                                        rel=1e-12)
    assert float(temperature(v, m)) == pytest.approx(300.0 * ndof / (ndof + 3),
                                                     rel=1e-12)


def test_overflow_regrows_tree_caps_and_kmax():
    """PanicButton: undersized tree capacities and neighbor width are
    detected at the end of the first window, regrown, and the rerun is
    clean."""
    small = ((512, 512, 512, 512, 128, 128, 128), (48, 32, 24, 16, 8, 4))
    sim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                     caps=T.TreeCaps(*small), kmax=16, **KW)
    run = sim.make_langevin_runner(neighbor_every=2)
    _, _, e, diag = run(sim.positions, sim.velocities, 4,
                        generator=torch.Generator().manual_seed(0))
    report = sim.overflow_report(*diag)
    assert "neighbor_kmax" in report and "tree_level1" in report
    assert e.shape == (2,)   # the run stopped after the overflowed window
    r = sim.benchmark_langevin(nsteps=4, neighbor_every=2, warmup=False,
                               max_regrow=8)
    assert r["regrows"] >= 1 and not r["overflow"]
    assert sim.kmax > 16 and sim.agbnp.caps.caps[0] > small[0][0]
    assert np.isfinite(r["energies"]).all() and r["energies"].shape == (4,)
