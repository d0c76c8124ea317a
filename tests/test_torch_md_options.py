"""The port's MD options against the JAX package's Simulation, f64, on
trp-cage (272 atoms): the vdW-compact WU topology (compact_topology, the
compacted WU pass, its caps and regrow), the WU pass as an r-RESPA impulse
(wu_mode split/skip, wu_every), and the r-RESPA MTS step
(tests/test_torch_constraints.py runs its window with SHAKE/RATTLE).

As in tests/test_torch_md.py the JAX side runs `pair_tiles=False` (its
dense XLA pair phases on the CPU) and the port its kernel route (plain
twins on the CPU, tile lists), both with the same tree capacities; every
Langevin window of the port gets JAX's exact noise stream (one
jax.random.split / normal draw per (sub)step, md/integrators.py:142-143).
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
from openmm_agbnp_plugin_tpu_torch.md.integrators import (
    langevin_middle_step, mts_langevin_step, wu_impulse_langevin_block)
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
def window(sims):
    """Both packages' window start: neighbor list, build topology, the vdW
    rescan and its compacted WU topology (full-size compact caps), and
    positions moved off the build point."""
    jsim, tsim = sims
    pos0 = np.array(jsim.positions)
    pos1 = pos0 + np.random.default_rng(5).normal(0.0, 0.003, pos0.shape)

    a = jsim.agbnp.arrays
    pj0 = jnp.asarray(pos0)
    jpairs = jax_half_neighbor_pairs(pj0, jsim.heavy_mask, jsim.rcut_list,
                                     jsim.kmax)[:3]
    gdr = jnp.asarray(a["gamma"]) / jsim.agbnp.params.roffset

    @jax.jit
    def jbuild(pos):
        lvl1 = JT.make_level1(pos, jnp.asarray(a["radii_large"]),
                              jnp.asarray(a["vol_large"]), gdr,
                              jnp.asarray(a["ishydrogen"]))
        levels, _ = JT.build_tree(lvl1, *jpairs[:2], jsim.agbnp.caps,
                                  pairs_valid=jpairs[2], pair_rows=True)
        topo = JT.tree_topology(levels)
        lvl1v = JT.make_level1(pos, jnp.asarray(a["radii_vdw"]),
                               jnp.asarray(a["vol_vdw"]), -gdr,
                               jnp.asarray(a["ishydrogen"]))
        lv = JT.rescan_volumes(topo, lvl1v)
        return topo, lv, JT.compact_topology(
            lv, [l["valid"].shape[0] for l in lv], relax=0.5)

    jtopo, jlv, (jvt, jcounts) = jbuild(pj0)

    b = tsim.agbnp.arrays
    pt0 = torch.as_tensor(pos0)
    tpairs = half_neighbor_pairs(pt0, tsim.heavy_mask, tsim.rcut_list,
                                 tsim.kmax)[:3]
    tg = b["gamma"] / tsim.agbnp.params.roffset
    lvl1 = T.make_level1(pt0, b["radii_large"], b["vol_large"], tg,
                         b["ishydrogen"])
    levels, _ = T.build_tree(lvl1, *tpairs[:2], tsim.agbnp.caps,
                             pairs_valid=tpairs[2], pair_rows=True)
    ttopo = T.tree_topology(levels)
    lvl1v = T.make_level1(pt0, b["radii_vdw"], b["vol_vdw"], -tg,
                          b["ishydrogen"])
    tlv = T.rescan_volumes(ttopo, lvl1v)
    tvt, tcounts = T.compact_topology(tlv, [l["valid"].shape[0]
                                            for l in tlv], relax=0.5)
    return dict(pos0=pos0, pos1=pos1, jpairs=jpairs, jtopo=jtopo, jlv=jlv,
                jvt=jvt, jcounts=jcounts, tpairs=tpairs, ttopo=ttopo,
                tlv=tlv, tvt=tvt, tcounts=tcounts, lvl1v=lvl1v)


def _close(x, ref, tol=TOL, what=""):
    x = np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape, (what, x.shape, ref.shape)
    err = np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)
    assert err <= tol, (what, err)


def _jax_noise(key, count, shape):
    out = []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape,
                                                dtype=jnp.float64)))
    return torch.as_tensor(np.stack(out))


def test_compact_topology_matches_jax(window):
    """Same kept rows, remapped parents and counts as JAX; pmono
    nondecreasing; the compacted tail rows zero, in the topology and in
    its rescanned data; the compaction really drops rows."""
    w = window
    np.testing.assert_array_equal(w["tcounts"].numpy(),
                                  np.asarray(w["jcounts"]))
    total_valid = sum(int(l["valid"].sum()) for l in w["tlv"])
    assert 0 < int(w["tcounts"].sum()) < total_valid
    rescanned = T.rescan_volumes(w["tvt"], w["lvl1v"])
    for li, (t, j) in enumerate(zip(w["tvt"], w["jvt"])):
        v = t["valid"].numpy()
        np.testing.assert_array_equal(v, np.asarray(j["valid"]))
        for k in ("atom", "parent"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        np.testing.assert_array_equal(t["bnd"]["pmono"].numpy(),
                                      np.asarray(j["bnd"]["pmono"]))
        assert (np.diff(t["bnd"]["pmono"].numpy()) >= 0).all()
        assert (t["_ints"][~t["valid"]] == 0).all()
        assert (rescanned[li]["_dat"][~t["valid"]] == 0).all()
        assert int(v.sum()) == int(w["tcounts"][li])


def test_compact_truncation_detected(window):
    """Kept counts past the compact capacity are reported as counts >
    cap, the compacted levels hold at most cap rows, and the truncated
    topology still rescans to finite values (its parents stay in range)."""
    w = window
    topo, counts = T.compact_topology(w["tlv"], [8] * 7, relax=0.5)
    assert int(counts[0]) > 8
    np.testing.assert_array_equal(counts.numpy(), w["tcounts"].numpy())
    for t in topo:
        assert int(t["valid"].sum()) <= 8 and t["valid"].shape == (8,)
        assert int(t["parent"].max()) < 8 or t is topo[0]
    red = T.reduce_tree(T.rescan_volumes(topo, w["lvl1v"]), w["lvl1v"],
                        with_selfvol=False)
    assert bool(torch.isfinite(red["dr"]).all())


def test_vdw_topology_force_matches_full_pass_and_jax(sims, window):
    """At the rebuild point the compacted WU pass equals the full one
    (1e-10), and the port's compacted evaluation equals JAX's."""
    jsim, tsim = sims
    w = window
    p0 = torch.as_tensor(w["pos0"])
    full = tsim.force_fn(pairs=w["tpairs"], topology=w["ttopo"])(p0)
    comp = tsim.force_fn(pairs=w["tpairs"], topology=w["ttopo"],
                         vdw_topology=w["tvt"])(p0)
    assert abs(float(comp[0]) - float(full[0])) <= 1e-10 * abs(float(full[0]))
    _close(comp[1], full[1].numpy(), 1e-10, "compact vs full")
    fn_j = jax.jit(jsim.force_fn(pairs=w["jpairs"], topology=w["jtopo"],
                                 vdw_topology=w["jvt"]))
    for pos in (w["pos0"], w["pos1"]):
        e_j, f_j, _ = fn_j(jnp.asarray(pos))
        e_t, f_t, _ = tsim.force_fn(pairs=w["tpairs"], topology=w["ttopo"],
                                    vdw_topology=w["tvt"])(
            torch.as_tensor(pos))
        assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
        _close(f_t, f_j, 1e-10, "compact vs JAX")


def test_split_and_skip_match_jax(sims, window):
    """wu_mode split/skip forces equal JAX's, and split + force_wu equals
    the fused force."""
    jsim, tsim = sims
    w = window
    pos = jnp.asarray(w["pos1"])
    pt = torch.as_tensor(w["pos1"])
    mk_j = dict(pairs=w["jpairs"], topology=w["jtopo"],
                vdw_topology=w["jvt"])
    mk_t = dict(pairs=w["tpairs"], topology=w["ttopo"],
                vdw_topology=w["tvt"])
    e_j, f_j, fwu_j, _ = jax.jit(jsim.force_fn(wu_mode="split", **mk_j))(pos)
    e_t, f_t, fwu_t, _ = tsim.force_fn(wu_mode="split", **mk_t)(pt)
    _close(f_t, f_j, 1e-10, "split force")
    _close(fwu_t, fwu_j, 1e-10, "force_wu")
    es_j, fs_j, _ = jax.jit(jsim.force_fn(wu_mode="skip", **mk_j))(pos)
    es_t, fs_t, _ = tsim.force_fn(wu_mode="skip", **mk_t)(pt)
    _close(fs_t, fs_j, 1e-10, "skip force")
    assert float(es_t) == float(e_t)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    e_f, f_f, _ = tsim.force_fn(**mk_t)(pt)
    assert float(e_f) == float(e_t)
    _close(f_t + fwu_t, f_f.numpy(), 1e-13, "split + force_wu vs fused")
    np.testing.assert_array_equal(fs_t.numpy(), f_t.numpy())


def test_ensure_vdw_caps_and_wu_regrow(sims):
    """The WU-compact sizing pass equals JAX's; a WU truncation is
    reported on its channel and _regrow grows past it."""
    jsim, _ = sims
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **KW)
    assert tsim._ensure_vdw_caps(0.5) == jsim._ensure_vdw_caps(0.5)
    tsim._vdw_caps = (0.5, (8,) * 7)
    counts = np.zeros(7, np.int64)
    sibs = np.zeros(7, np.int64)
    wu = np.array([100, 50, 8, 8, 8, 8, 8])
    rep = tsim.overflow_report(counts, 0, sibs, wu)
    assert set(rep) == {"wu_compact_level1", "wu_compact_level2"}
    tsim._regrow(counts, 0, sibs, wu=wu)
    new = tsim._vdw_caps[1]
    assert new[0] >= 104 and new[1] >= 56 and new[2] >= 8
    assert not tsim._check_overflow(counts, 0, sibs, wu)


def test_wu_block_k1_is_the_plain_step_bitwise(sims, window):
    _, tsim = sims
    w = window
    mk = dict(pairs=w["tpairs"], topology=w["ttopo"], vdw_topology=w["tvt"])
    noise = torch.as_tensor(np.random.default_rng(3).normal(
        size=(1,) + w["pos1"].shape))
    args = (tsim.masses, 0.001, 300.0, 1.0)
    plain = langevin_middle_step(tsim.force_fn(**mk), *args)
    block = wu_impulse_langevin_block(tsim.force_fn(wu_mode="split", **mk),
                                      tsim.force_fn(wu_mode="skip", **mk),
                                      *args, 1)
    pos, vel = torch.as_tensor(w["pos1"]), tsim.velocities
    p0, v0, e0, c0, _ = plain(pos, vel, noise[0])
    p1, v1, e1, c1, _ = block(pos, vel, noise)
    assert torch.equal(p0, p1) and torch.equal(v0, v1)
    assert torch.equal(e0, e1[0]) and torch.equal(c0, c1)


def test_mts_inner1_is_the_plain_step(sims, window):
    """inner=1: the same net kick at the same positions with the same
    noise as the plain step (to round-off: dt f_slow + dt f_fast against
    dt (f_slow + f_fast))."""
    _, tsim = sims
    w = window
    pairs, topo = w["tpairs"], w["ttopo"]
    noise = torch.as_tensor(np.random.default_rng(4).normal(
        size=(1,) + w["pos1"].shape))
    args = (tsim.masses, 0.001, 300.0, 1.0)
    plain = langevin_middle_step(tsim.force_fn(pairs=pairs, topology=topo),
                                 *args)
    slow, fast = tsim.force_fn(pairs=pairs, topology=topo, split=True)
    mts = mts_langevin_step(slow, fast, *args, 1)
    pos, vel = torch.as_tensor(w["pos1"]), tsim.velocities
    p0, v0, e0, _, _ = plain(pos, vel, noise[0])
    p1, v1, e1, _, _ = mts(pos, vel, noise)
    _close(p1, p0.numpy(), 1e-14, "pos")
    _close(v1, v0.numpy(), 1e-12, "vel")
    assert abs(float(e1) - float(e0)) <= 1e-12 * abs(float(e0))


def _langevin_vs_jax(jsim, tsim, nsteps, nsub, dt=0.001, **kw):
    key = jax.random.PRNGKey(11)
    run_j = jsim.make_langevin_runner(dt, 300.0, 1.0, **kw)
    pos_j, vel_j, _, e_j, diag_j = run_j(jsim.positions, jsim.velocities,
                                         key, nsteps)
    noise = _jax_noise(key, nsteps * nsub, jsim.positions.shape)
    run_t = tsim.make_langevin_runner(dt, 300.0, 1.0, **kw)
    pos_t, vel_t, e_t, diag_t = run_t(tsim.positions, tsim.velocities,
                                      nsteps, noise=noise)
    assert not tsim._check_overflow(*diag_t)
    assert e_t.shape == (nsteps,)
    _close(e_t, e_j, TOL, "energies")
    _close(pos_t, pos_j, TOL, "pos")
    _close(vel_t, vel_j, TOL, "vel")
    return diag_j, diag_t


def test_wu_every4_vdw_compact_window_matches_jax(sims):
    """bench.py's headline configuration (mts_wu4, vdW-compact WU) over
    two 4-step windows; the WU-compact counts agree."""
    jsim, tsim = sims
    diag_j, diag_t = _langevin_vs_jax(jsim, tsim, 8, 1, neighbor_every=4,
                                      vdw_compact=True, wu_every=4)
    np.testing.assert_array_equal(diag_t[3].numpy(), np.asarray(diag_j[3]))
    assert int(diag_t[3].sum()) > 0
