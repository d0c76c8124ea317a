"""The port's Simulation for AGBNP versions 0 and 2, f64, on the CPU, on
trp-cage (272 atoms).

Version 0 (GVolSA + OPLS, the MM force field by autograd) is held to the
JAX package's Simulation over one rebuild window fed JAX's noise.  Version 2
(AGBNP2) is held to its own model: the force function equals
AGBNP2Model + MM (the JAX package's test_agbnp2_md_smoke), the window's
rescan equals a fresh build at the window start, and runs stay finite;
the PanicButton regrows an undersized MS capacity.
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
from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import AGBNP2Model
from openmm_agbnp_plugin_tpu_torch.models.capacity import V2
from openmm_agbnp_plugin_tpu_torch.ops import tree as T

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))


@pytest.fixture(scope="module")
def sim_v2():
    return Simulation(load_dms(DMS), device="cpu", version=2,
                      dtype=torch.float64)


def test_v0_first_window_matches_jax():
    """8 Langevin steps, the neighbor list and tree rebuilt every 4, with
    JAX's noise: energies, positions and velocities to 1e-9."""
    kw = dict(version=0, cutoff=1.0, skin=0.25)
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         caps=JT.TreeCaps(*CAPS), **kw)
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **kw)
    assert tsim.kmax == jsim.kmax and tsim.agbnp.pair_pad == 0
    nsteps, every = 8, 4
    run_j = jsim.make_langevin_runner(0.001, 300.0, 1.0,
                                      neighbor_every=every)
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
    assert np.abs(e_t.numpy() - e_j).max() <= 1e-9 * np.abs(e_j).max()
    for x, y in ((pos_t, pos_j), (vel_t, vel_j)):
        y = np.asarray(y)
        assert np.abs(x.numpy() - y).max() <= 1e-9 * np.abs(y).max()


def test_v2_force_fn_is_the_model_plus_mm(sim_v2):
    """The strict force function (MS candidates found and both trees built
    per call) equals the one-shot AGBNP2Model + the MM force field by
    autograd, and its counts vector is clean."""
    sim = sim_v2
    e, f, counts = sim.force_fn()(sim.positions)
    m2 = AGBNP2Model(sim.agbnp2.params, device="cpu", dtype=torch.float64,
                     positions=sim.positions.numpy(), caps=sim.agbnp2.caps)
    e2, f2 = m2.energy_forces(sim.positions)
    ff = sim.ff_state()
    e_mm, f_mm = sim.mm.forces_of(sim.mm.energy, sim.positions, ff["mm"],
                                  ff["mm_excl_mask"])
    assert abs(float(e - (e2 + e_mm))) <= 1e-12 * abs(float(e))
    assert float((f - (f2 + f_mm)).abs().max()) <= 1e-12 * float(
        f.abs().max())
    assert counts.shape == (18,) and not sim.overflow_report(
        counts, 0, torch.zeros(7))
    assert int(counts[V2.MS_COUNT]) > 0  # MS particles made


def test_v2_window_rescan_and_runs(sim_v2):
    """A window's first step evaluates at the build positions, so the
    windowed run's first energy is the strict run's; multi-window Langevin
    and a short benchmark stay finite with no overflow."""
    sim = sim_v2
    ms_pairs, topo = sim._v2_build(sim.positions)
    e_w, f_w, c_w = sim.force_fn(pairs=ms_pairs, topology=topo)(
        sim.positions)
    e_s, f_s, c_s = sim.force_fn()(sim.positions)
    assert abs(float(e_w - e_s)) <= 1e-12 * abs(float(e_s))
    assert float((f_w - f_s).abs().max()) <= 1e-11 * float(f_s.abs().max())
    assert torch.equal(c_w, c_s)
    res_w = sim.run_md(6, dt=0.0005, neighbor_every=3)
    assert np.isfinite(res_w["energies"]).all()
    assert not res_w["overflow"] and res_w["regrows"] == 0
    res_s = sim.run_md(1, dt=0.0005, neighbor_every=0)
    assert res_w["energies"][0] == pytest.approx(
        float(res_s["energies"][0]), abs=1e-8)
    res = sim.benchmark_langevin(nsteps=4, dt=0.0005, warmup=False,
                                 neighbor_every=2)
    assert np.isfinite(res["energies"]).all() and res["steps_run"] == 4


def test_v2_regrows_an_undersized_ms_capacity():
    """cap_ms below the MS particle count: the window's counts report
    ms_count, and the regrow rebuilds the model past it."""
    sim = Simulation(load_dms(DMS), device="cpu", version=2,
                     dtype=torch.float64)
    m2 = sim.agbnp2
    sim.agbnp2 = sim.agbnp = AGBNP2Model(
        m2.params, device="cpu", dtype=torch.float64,
        positions=sim.positions.numpy(), caps=m2.caps, cap_ms=128)
    run = sim.make_langevin_runner(0.0005, neighbor_every=2)
    gen = torch.Generator().manual_seed(0)
    _, _, energies, diag = run(sim.positions, sim.velocities, 4,
                               generator=gen)
    rep = sim.overflow_report(*diag)
    assert "ms_count" in rep and rep["ms_count"][1] == 128
    assert energies.shape == (2,)  # the run stopped at its first window
    sim._regrow(*diag)
    assert sim.agbnp2.cap_ms >= rep["ms_count"][0] and sim.agbnp is sim.agbnp2
    run = sim.make_langevin_runner(0.0005, neighbor_every=2)
    _, _, energies, diag = run(sim.positions, sim.velocities, 4,
                               generator=gen)
    assert not sim.overflow_report(*diag) and energies.shape == (4,)


def test_refusals_kept_from_jax(sim_v2):
    """MTS and the WU impulse (wu_every > 1) are for versions 0/1 and 1;
    resize_caps_to_current for versions 0/1."""
    with pytest.raises(ValueError, match="MTS"):
        sim_v2.make_langevin_runner(0.001, mts_inner=2)(
            sim_v2.positions, sim_v2.velocities, 1,
            generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="wu_every"):
        sim_v2.make_langevin_runner(0.001, wu_every=4)
    with pytest.raises(ValueError, match="versions 0/1"):
        sim_v2.resize_caps_to_current()
    sim0 = Simulation(load_dms(DMS), device="cpu", version=0,
                      dtype=torch.float64, caps=T.TreeCaps(*CAPS))
    with pytest.raises(ValueError, match="wu_every"):
        sim0.make_langevin_runner(0.001, wu_every=4)
    with pytest.raises(ValueError, match="version"):
        Simulation(load_dms(DMS), device="cpu", version=3)


def test_v0_mts_split_adds_up_to_the_full_force():
    """Version 0 under r-RESPA: the slow class (GVolSA + the dense LJ and
    Coulomb sum by autograd) plus the fast class (bonded + 1-4) is the
    full force function, energy and force, and an MTS window runs."""
    sim = Simulation(load_dms(DMS), device="cpu", version=0,
                     dtype=torch.float64, caps=T.TreeCaps(*CAPS), cutoff=1.0)
    e, f, counts = sim.force_fn()(sim.positions)
    slow, fast = sim.force_fn(split=True)
    e_s, f_s, c_s = slow(sim.positions)
    e_f, f_f = fast(sim.positions)
    assert torch.equal(counts, c_s)
    assert abs(float(e_s + e_f - e)) <= 1e-12 * abs(float(e))
    assert float((f_s + f_f - f).abs().max()) <= 1e-12 * float(f.abs().max())
    run = sim.make_langevin_runner(0.002, neighbor_every=2, mts_inner=2)
    _, _, energies, diag = run(sim.positions, sim.velocities, 4,
                               generator=torch.Generator().manual_seed(1))
    assert not sim.overflow_report(*diag)
    assert np.isfinite(energies.numpy()).all()
