"""The port's runners, run_md and capacity management, f64 on the CPU,
on trp-cage (272 atoms): the all-pairs runner (neighbor_every <= 0) and
the per-step tree build (rebuild_topology=False) against the JAX package,
the PanicButton retry over every channel (tree caps, neighbor kmax,
WU-compact caps, SHAKE residual), exact resume from a checkpoint,
trajectory frames, and resize_caps_to_current against the degenerate
sibling windows of the JAX package's hazard (ROADMAP "Hazards").
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
from openmm_agbnp_plugin_tpu_torch.io.checkpoint import load_checkpoint, \
    restore_generator
from openmm_agbnp_plugin_tpu_torch.io.dcd import read_dcd, write_dcd
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import half_neighbor_pairs

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
DEGENERATE = T.TreeCaps(caps=CAPS[0], offs=(1,) * 6)


def _sim(**kw):
    kw = {"caps": T.TreeCaps(*CAPS), **kw}
    return Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      **KW, **kw)


@pytest.fixture(scope="module")
def reference_run():
    """A well-sized run: 12 steps, rebuilds every 3, segments of 6."""
    sim = _sim()
    return sim.run_md(12, neighbor_every=3, segment=6, seed=3)


@pytest.fixture(scope="module")
def jsim():
    return JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         caps=JT.TreeCaps(*CAPS), pair_tiles=False, **KW)


@pytest.mark.parametrize("kw", [dict(neighbor_every=0),
                                dict(neighbor_every=3,
                                     rebuild_topology=False)],
                         ids=["all_pairs", "build_every_step"])
def test_strict_runners_match_jax(jsim, kw):
    """The all-pairs runner (neighbor_every <= 0) and the per-step tree
    build (rebuild_topology=False) over 3 steps with JAX's noise."""
    tsim = _sim()
    nsteps = 3
    key = jax.random.PRNGKey(11)
    pos_j, vel_j, _, e_j, _ = jsim.make_langevin_runner(
        0.001, 300.0, 1.0, **kw)(jsim.positions, jsim.velocities, key,
                                 nsteps)
    noise = []
    for _ in range(nsteps):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            sub, jsim.positions.shape, dtype=jnp.float64)))
    pos_t, vel_t, e_t, diag = tsim.make_langevin_runner(
        0.001, 300.0, 1.0, **kw)(tsim.positions, tsim.velocities, nsteps,
                                 noise=torch.as_tensor(np.stack(noise)))
    assert not tsim._check_overflow(*diag)
    for name, x, y in (("energies", e_t, e_j), ("pos", pos_t, pos_j),
                       ("vel", vel_t, vel_j)):
        y = np.asarray(y)
        err = np.abs(x.numpy() - y).max() / np.abs(y).max()
        assert err <= 1e-9, (name, err)


def test_run_md_regrows_every_channel(reference_run):
    """Undersized tree caps, neighbor kmax and WU-compact caps are
    detected, regrown and the segment retried from its start (generator
    state included), landing on the well-sized trajectory."""
    sim = _sim(caps=T.TreeCaps(caps=(256, 256, 256, 256, 128, 128, 128),
                               offs=(8, 8, 8, 8, 4, 4)), kmax=16)
    sim._vdw_caps = (0.5, (8,) * 7)
    out = sim.run_md(12, neighbor_every=3, segment=6, seed=3)
    assert out["regrows"] >= 1 and reference_run["regrows"] == 0
    assert sim.kmax > 16 and sim.agbnp.caps.caps[0] > 256
    assert min(sim._vdw_caps[1][:3]) > 8
    np.testing.assert_allclose(out["final_pos"].numpy(),
                               reference_run["final_pos"].numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["energies"], reference_run["energies"],
                               rtol=1e-12)


def test_run_md_resume_from_checkpoint_is_bitwise(reference_run, tmp_path):
    """Stop at step 6 with a checkpoint, resume from it: positions,
    velocities and energies bitwise equal to the uninterrupted run."""
    kw = dict(neighbor_every=3, segment=6, seed=3)
    path = str(tmp_path / "md.ckpt.npz")
    part = _sim().run_md(6, checkpoint_path=path, **kw)
    ck = load_checkpoint(path)
    assert ck["step"] == 6 and ck["meta"]["segment"] == 6
    assert ck["generator_device"] == "cpu"
    np.testing.assert_array_equal(part["final_pos"].numpy(),
                                  ck["positions"])
    rest = _sim().run_md(6, pos=ck["positions"], vel=ck["velocities"],
                         generator=restore_generator(ck), **kw)
    assert torch.equal(rest["final_pos"], reference_run["final_pos"])
    assert torch.equal(rest["final_vel"], reference_run["final_vel"])
    np.testing.assert_array_equal(rest["energies"],
                                  reference_run["energies"][6:])


def test_run_md_frames_to_dcd(reference_run, tmp_path):
    seen = []
    out = _sim().run_md(12, neighbor_every=3, report_interval=6, seed=3,
                        reporter=lambda step, pos, vel: seen.append(step))
    assert seen == [6, 12] and out["frame_steps"].tolist() == [6, 12]
    assert torch.equal(out["final_pos"], reference_run["final_pos"])
    path = str(tmp_path / "traj.dcd")
    write_dcd(path, out["frames"], dt_ps=0.001, interval=6)
    frames, info = read_dcd(path)
    assert frames.shape == (2, 272, 3) and info["interval"] == 6
    np.testing.assert_allclose(frames[-1], out["final_pos"].numpy(),
                               atol=1e-6)


def test_shake_residual_channel_regrows_sweeps():
    """A window whose SHAKE misses tolerance (no Newton sweep at all) is
    refused like an overflow and retried with more sweeps."""
    sim = _sim(constraints=True)
    sim.constraints.sweeps = 0
    run = sim.make_langevin_runner(0.004, neighbor_every=2, mts_inner=2)
    _, _, e, diag = run(sim.positions, sim.velocities, 4,
                        generator=torch.Generator().manual_seed(0))
    assert e.shape == (2,)  # stopped after the refused window
    assert set(sim.overflow_report(*diag)) == {"shake_residual"}
    out = sim.run_md(4, dt=0.004, neighbor_every=2, mts_inner=2, seed=0)
    assert out["regrows"] >= 1
    assert sim.constraints.sweeps == 2 * out["regrows"]
    assert float(sim.constraints.max_violation(out["final_pos"])) <= 1e-8
    assert np.isfinite(out["energies"]).all()


def test_degenerate_sibling_windows_match_jax_and_regrow(jsim):
    """offs=(1, ...) capacities (the window the JAX package's
    resize_caps_to_current could produce) build the same node sets in both
    packages; a run from them regrows the windows instead of inheriting
    them, and resize_caps_to_current never sizes one below 4."""
    pos = jsim.positions
    a = jsim.agbnp.arrays
    jp = jax_half_neighbor_pairs(pos, jsim.heavy_mask, jsim.rcut_list,
                                 jsim.kmax)
    lvl1 = JT.make_level1(pos, jnp.asarray(a["radii_large"]),
                          jnp.asarray(a["vol_large"]),
                          jnp.asarray(a["gamma"]) / jsim.agbnp.params.roffset,
                          jnp.asarray(a["ishydrogen"]))
    build = jax.jit(JT.build_tree, static_argnames=("caps", "pair_rows"))
    jlev, jdiag = build(lvl1, jp[0], jp[1],
                        JT.TreeCaps(caps=CAPS[0], offs=(1,) * 6),
                        pairs_valid=jp[2], pair_rows=True)

    sim = _sim(caps=DEGENERATE)
    b = sim.agbnp.arrays
    tp = half_neighbor_pairs(sim.positions, sim.heavy_mask, sim.rcut_list,
                             sim.kmax)
    tl1 = T.make_level1(sim.positions, b["radii_large"], b["vol_large"],
                        b["gamma"] / sim.agbnp.params.roffset,
                        b["ishydrogen"])
    tlev, tdiag = T.build_tree(tl1, tp[0], tp[1], DEGENERATE,
                               pairs_valid=tp[2], pair_rows=True)
    for k in ("counts", "max_siblings"):
        np.testing.assert_array_equal(tdiag[k].numpy(),
                                      np.asarray(jdiag[k]))
    for t, j in zip(tlev, jlev):
        for k in ("valid", "atom", "parent"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert any(k.startswith("sibling_window") for k in sim.overflow_report(
        tdiag["counts"], 0, tdiag["max_siblings"]))

    out = sim.run_md(6, neighbor_every=3, seed=1)
    assert out["regrows"] >= 1 and min(sim.agbnp.caps.offs) > 1
    sim.resize_caps_to_current(out["final_pos"])
    assert min(sim.agbnp.caps.offs) >= 4
    assert torch.equal(sim.positions, out["final_pos"])
    again = sim.run_md(3, neighbor_every=3, seed=2)
    assert again["regrows"] == 0 and np.isfinite(again["energies"]).all()


def test_set_velocities_to_temperature():
    sim = _sim()
    v = sim.set_velocities_to_temperature(300.0, seed=4)
    assert torch.equal(v, sim.velocities)
    assert torch.equal(v, _sim().set_velocities_to_temperature(300.0, 4))
    assert float(torch.sum(sim.masses[:, None] * v, dim=0).abs().max()) \
        < 1e-12
