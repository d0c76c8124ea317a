"""The port's overlap tree against the JAX package's, f64, on the fixture.

With identical capacities both build paths (all-pairs `_compact` and the
neighbor-row `_build_pair_level`) must give the same node sets: equal
counts and equal atom/parent indices at every level.  The reductions and
rescans agree to 1e-12, and an undersized tree overflows and grows exactly
as in JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu.ops.neighbors import \
    half_neighbor_pairs as jax_half_neighbor_pairs
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import arrays_from_numpy
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import (
    half_neighbor_pairs, tree_pair_cutoff)

torch.set_num_threads(2)

TOL = 1e-12
CAPS = ((3840, 8192, 7296, 3712, 1408, 384, 256), (48, 32, 24, 16, 8, 4))

# the JAX side runs jitted (op-by-op eager dispatch of the build is ~10x
# slower on the CPU)
jax_build_tree = jax.jit(JT.build_tree, static_argnames=("caps", "pair_rows"))
jax_reduce_tree = jax.jit(JT.reduce_tree, static_argnames=("with_selfvol",))


@jax.jit
def jax_fixed_topology_pass(topo, l1_large, l1_vdw):
    return JT.reduce_tree2(*JT.rescan_volumes2(topo, l1_large, l1_vdw),
                           l1_large, l1_vdw)


@jax.jit
def jax_wu_pass(topo, l1_vdw, gamma):
    lw = {**l1_vdw, "gamma1i": gamma}
    return JT.reduce_tree(JT.rescan_gammas(JT.rescan_volumes(topo, l1_vdw),
                                           lw), lw, with_selfvol=False)


def rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


@pytest.fixture(scope="module")
def system(gaussvol_system):
    params, pos = gaussvol_system
    aj = jax_prepare_arrays(params, dtype=np.float64)
    at = arrays_from_numpy(aj, "cpu", torch.float64)
    return params, pos, aj, at


def level1_pair(aj, at, pos, roffset):
    """(JAX, port) level-1 tables for the large and the vdW radii."""
    pj, pt = jnp.asarray(pos), torch.as_tensor(pos)
    gj = jnp.asarray(aj["gamma"]) / roffset
    gt = at["gamma"] / roffset
    large = (JT.make_level1(pj, jnp.asarray(aj["radii_large"]),
                            jnp.asarray(aj["vol_large"]), gj,
                            jnp.asarray(aj["ishydrogen"])),
             T.make_level1(pt, at["radii_large"], at["vol_large"], gt,
                           at["ishydrogen"]))
    vdw = (JT.make_level1(pj, jnp.asarray(aj["radii_vdw"]),
                          jnp.asarray(aj["vol_vdw"]), -gj,
                          jnp.asarray(aj["ishydrogen"])),
           T.make_level1(pt, at["radii_vdw"], at["vol_vdw"], -gt,
                         at["ishydrogen"]))
    return large, vdw


def build_both(system, rows: bool, caps=CAPS):
    params, pos, aj, at = system
    (l1j, l1t), _ = level1_pair(aj, at, pos, params.roffset)
    jcaps, tcaps = JT.TreeCaps(*caps), T.TreeCaps(*caps)
    if rows:
        rcut = tree_pair_cutoff(params.radii_large) + 0.1
        heavy = np.asarray(params.ishydrogen) == 0
        pij = jax_half_neighbor_pairs(jnp.asarray(pos), jnp.asarray(heavy),
                                      rcut, 64)
        pit = half_neighbor_pairs(torch.as_tensor(pos),
                                  torch.as_tensor(heavy), rcut, 64)
        for x, y in zip(pij, pit):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
        out_j = jax_build_tree(l1j, pij[0], pij[1], jcaps,
                               pairs_valid=pij[2], pair_rows=True)
        out_t = T.build_tree(l1t, pit[0], pit[1], tcaps,
                             pairs_valid=pit[2], pair_rows=True)
    else:
        out_j = jax_build_tree(l1j, jnp.asarray(aj["pairs_i"]),
                               jnp.asarray(aj["pairs_j"]), jcaps,
                               pairs_valid=jnp.asarray(aj["pairs_valid"]))
        out_t = T.build_tree(l1t, at["pairs_i"], at["pairs_j"], tcaps,
                             pairs_valid=at["pairs_valid"])
    return out_j, out_t


@pytest.fixture(scope="module")
def all_pairs_build(system):
    return build_both(system, rows=False)


@pytest.mark.parametrize("rows", [False, True], ids=["all_pairs", "rows"])
def test_build_matches_jax(system, all_pairs_build, rows):
    (lev_j, diag_j), (lev_t, diag_t) = (build_both(system, rows) if rows
                                        else all_pairs_build)
    for key in ("counts", "max_siblings"):
        np.testing.assert_array_equal(np.asarray(diag_j[key]),
                                      diag_t[key].numpy())
    assert np.asarray(diag_j["counts"])[0] > 0
    for lj, lt in zip(lev_j, lev_t):
        valid = np.asarray(lj["valid"])
        np.testing.assert_array_equal(valid, lt["valid"].numpy())
        np.testing.assert_array_equal(np.asarray(lj["_ints"])[valid],
                                      lt["_ints"].numpy()[valid])
        np.testing.assert_array_equal(np.asarray(lj["bnd"]["pmono"])[valid],
                                      lt["bnd"]["pmono"].numpy()[valid])
        if valid.any():
            assert rel(lt["_dat"].numpy(), lj["_dat"]) <= TOL


def test_reductions_and_rescans_match_jax(system, all_pairs_build):
    params, pos, aj, at = system
    (lev_j, _), (lev_t, _) = all_pairs_build
    (l1j, l1t), (v1j, v1t) = level1_pair(aj, at, pos, params.roffset)

    rj = jax_reduce_tree(lev_j, l1j, with_selfvol=True)
    rt = T.reduce_tree(lev_t, l1t, with_selfvol=True)
    for k in ("energy", "dr", "self_volume"):
        assert rel(rt[k].numpy(), rj[k]) <= TOL, k

    # fixed-topology two-parameterization pass (the MD step's cavity term)
    topo_j, topo_t = JT.tree_topology(lev_j), T.tree_topology(lev_t)
    r1j, r2j = jax_fixed_topology_pass(topo_j, l1j, v1j)
    at2, bt2 = T.rescan_volumes2(topo_t, l1t, v1t)
    r1t, r2t = T.reduce_tree2(at2, bt2, l1t, v1t)
    for k in ("energy", "dr"):
        assert rel(r1t[k].numpy(), r1j[k]) <= TOL, k
    for k in ("energy", "dr", "self_volume"):
        assert rel(r2t[k].numpy(), r2j[k]) <= TOL, k

    # vdW rescan + the WU gamma pass with seeded per-atom gammas
    lvt = T.rescan_volumes(topo_t, v1t)
    gam = np.random.default_rng(3).normal(0.0, 10.0, params.n)
    wt = {**v1t, "gamma1i": torch.as_tensor(gam)}
    gj = jax_wu_pass(topo_j, v1j, jnp.asarray(gam))
    gt = T.reduce_tree(T.rescan_gammas(lvt, wt), wt, with_selfvol=False)
    for k in ("energy", "dr"):
        assert rel(gt[k].numpy(), gj[k]) <= TOL, k


def test_overflow_grows_like_jax(system):
    small = ((1024, 1024, 1024, 1024, 512, 128, 128), (48, 32, 24, 16, 8, 2))
    (_, diag_j), (_, diag_t) = build_both(system, rows=False, caps=small)
    ov_j = JT.check_overflow(diag_j)
    ov_t = T.check_overflow(diag_t)
    assert ov_t["any"] and ov_j["any"]
    for k in ("cap_overflow", "sib_overflow"):
        np.testing.assert_array_equal(ov_t[k], ov_j[k])
    grow = ([bool(c) for c in ov_t["cap_overflow"]],
            [bool(s) for s in ov_t["sib_overflow"][:-1]])
    gj = JT.TreeCaps(*small).grow(*grow)
    gt = T.TreeCaps(*small).grow(*grow)
    assert (gt.caps, gt.offs) == (gj.caps, gj.offs)
    assert gt.caps != small[0]


def test_for_natoms_matches_jax():
    for n in (264, 1310, 2000):
        a, b = JT.TreeCaps.for_natoms(n), T.TreeCaps.for_natoms(n)
        assert (a.caps, a.offs) == (b.caps, b.offs)
