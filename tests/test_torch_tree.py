"""The port's overlap tree against the JAX package's, f64, on the fixture.

With identical capacities both build paths (all-pairs `_compact` and the
neighbor-row `_build_pair_level`) must give the same node sets: equal
counts and equal atom/parent indices at every level.  The reductions and
rescans agree to 1e-12, and an undersized tree overflows and grows exactly
as in JAX.
"""

import os

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


def one_system(red):
    """A reduction of one system (a batch of one): its energy without the
    replica axis."""
    return {**red, "energy": red["energy"][0]}


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
        # one system: the diag's one replica row
        np.testing.assert_array_equal(np.asarray(diag_j[key]),
                                      diag_t[key][0].numpy())
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
    rt = one_system(T.reduce_tree(lev_t, l1t, with_selfvol=True))
    for k in ("energy", "dr", "self_volume"):
        assert rel(rt[k].numpy(), rj[k]) <= TOL, k

    # fixed-topology two-parameterization pass (the MD step's cavity term)
    topo_j, topo_t = JT.tree_topology(lev_j), T.tree_topology(lev_t)
    r1j, r2j = jax_fixed_topology_pass(topo_j, l1j, v1j)
    at2, bt2 = T.rescan_volumes2(topo_t, l1t, v1t)
    r1t, r2t = map(one_system, T.reduce_tree2(at2, bt2, l1t, v1t))
    for k in ("energy", "dr"):
        assert rel(r1t[k].numpy(), r1j[k]) <= TOL, k
    for k in ("energy", "dr", "self_volume"):
        assert rel(r2t[k].numpy(), r2j[k]) <= TOL, k

    # vdW rescan + the WU gamma pass with seeded per-atom gammas
    lvt = T.rescan_volumes(topo_t, v1t)
    gam = np.random.default_rng(3).normal(0.0, 10.0, params.n)
    wt = {**v1t, "gamma1i": torch.as_tensor(gam)}
    gj = jax_wu_pass(topo_j, v1j, jnp.asarray(gam))
    gt = one_system(T.reduce_tree(T.rescan_gammas(lvt, wt), wt,
                                  with_selfvol=False))
    for k in ("energy", "dr"):
        assert rel(gt[k].numpy(), gj[k]) <= TOL, k


def test_overflow_grows_like_jax(system):
    small = ((1024, 1024, 1024, 1024, 512, 128, 128), (48, 32, 24, 16, 8, 2))
    (_, diag_j), (_, diag_t) = build_both(system, rows=False, caps=small)
    ov_j = JT.check_overflow(diag_j)
    ov_t = T.check_overflow({k: v[0] for k, v in diag_t.items()})
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


# ---------------------------------------------------------------------------
# The row moves of the passes: take_rows and the valid-only segment sums
# ---------------------------------------------------------------------------

def _built_levels(name, system):
    """(levels, natoms) of a tree built by the port, f64 on the CPU: the
    fixture through both build paths, 1li2 through the model's own pass."""
    if name == "1li2":
        import os

        from openmm_agbnp_plugin_tpu_torch import (AGBNPModel, AGBNPParams,
                                                   load_dms)
        from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M

        d = load_dms(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks", "data",
            "1li2_agbnp1.dms"))
        p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                        alpha=d.agbnp_alpha, charge=d.charges,
                        ishydrogen=d.ishydrogen)
        m = AGBNPModel(p, device="cpu", dtype=torch.float64,
                       positions=d.positions)
        pos = torch.as_tensor(d.positions, dtype=torch.float64)
        a, pair_rows, _ = M.tree_candidates(m.arrays, pos, m.neighbor_rcut,
                                            m.neighbor_kmax, m.neighbor_grid)
        out = M.tree_passes(a, pos, m.caps, p.roffset, pair_rows=pair_rows)
        assert not T.check_overflow(out[5])["any"]
        return out[3], p.n
    levels, _ = build_both(system, rows=(name == "fixture_rows"))[1]
    return levels, system[0].n


@pytest.fixture(scope="module")
def built(system):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _built_levels(name, system)
        return cache[name]
    return get


@pytest.mark.parametrize("compacted", [False, True],
                         ids=["built", "compacted"])
@pytest.mark.parametrize("name", ["fixture_all_pairs", "fixture_rows",
                                  "1li2"])
def test_segment_sum_over_valid_rows_equals_the_full_count(built, name,
                                                           compacted):
    """Every level's valid rows come first and its lengths count them
    alone, so the sorted sum never reads the padding behind them, and it
    equals (torch.equal) the sum whose lengths count every row, on rows
    that are zero where invalid, as the passes make them."""
    levels, natoms = built(name)
    if compacted:
        # capacities that cut some levels short (an overflowed window) and
        # leave others room
        kept = T.compact_topology(levels, [l["valid"].shape[0]
                                           for l in levels])[1][0].tolist()
        caps = [c + 16 if i % 2 else c // 2 + 8 for i, c in enumerate(kept)]
        levels, (counts,) = T.compact_topology(levels, caps)
        assert counts.tolist() == kept
        assert any(int(c) > cap for c, cap in zip(counts, caps))
        assert any(int(c) < cap for c, cap in zip(counts, caps))
    rng = np.random.default_rng(9)
    nparents = natoms
    assert sum(int(l["valid"].sum()) for l in levels) > 0
    for lvl in levels:
        valid, bnd = lvl["valid"], lvl["bnd"]
        cap = valid.shape[0]
        nv = int(valid.sum())
        assert bool(valid[:nv].all()) and not bool(valid[nv:].any())
        assert bnd["lengths"].shape == (nparents,)
        assert int(bnd["lengths"].sum()) == nv
        assert bnd["pmono32"].dtype == torch.int32
        assert bnd["atom32"].dtype == torch.int32
        assert bnd["atom32"].is_contiguous()
        assert torch.equal(bnd["pmono32"].long(), bnd["pmono"])
        assert torch.equal(bnd["atom32"].long(), lvl["atom"])
        assert bool((bnd["pmono"][1:] >= bnd["pmono"][:-1]).all())
        assert torch.equal(bnd["pmono"][:nv], lvl["parent"][:nv])
        assert torch.equal(bnd["atom_dep"],
                           torch.where(valid, lvl["atom"], natoms))
        x = torch.as_tensor(rng.normal(size=(cap, 11))) * valid[:, None]
        full = T.segment_sum(x, bnd["pmono"], nparents, ids_sorted=True)
        lean = T._upward_segment_sum(x, lvl, nparents)
        assert torch.equal(lean, full)
        # the padding is not read: junk there changes nothing
        junk = torch.where(valid[:, None], x, float("nan"))
        assert torch.equal(T._upward_segment_sum(junk, lvl, nparents), full)
        # and the unsorted route agrees to roundoff (another grouping pass,
        # the same row order inside each segment)
        plain = T.segment_sum(x, lvl["parent"].where(valid, bnd["pmono"]),
                              nparents)
        assert rel(lean.numpy(), plain.numpy()) <= TOL
        nparents = cap


def test_interior_invalid_row_is_refused_by_the_sorted_sum():
    """Why the valid rows must come first: a sorted segment sum takes each
    segment's rows one after another, so lengths that skip an invalid row
    in the middle push every later row into the wrong segment.
    sorted_lengths refuses such a level instead of guessing."""
    ids = torch.tensor([0, 0, 1, 1, 2])
    x = torch.tensor([[1.0], [2.0], [100.0], [4.0], [8.0]])
    ok = torch.tensor([True, True, True, True, False])
    lengths = T.sorted_lengths(ids, ok, 3)
    assert lengths.tolist() == [2, 2, 0]
    assert T.sorted_segment_sum(x, lengths)[:, 0].tolist() == [3.0, 104.0,
                                                               0.0]
    interior = torch.tensor([True, True, False, True, True])
    right = T.segment_sum(x * interior[:, None], ids, 3, ids_sorted=True)
    assert right[:, 0].tolist() == [3.0, 4.0, 8.0]
    # counted blindly, the third row (invalid) is read as parent 1's only
    # row and the last valid row is never read
    blind = torch.zeros(3, dtype=torch.int64).index_add_(0, ids,
                                                         interior.long())
    wrong = T.sorted_segment_sum(x, blind)
    assert wrong[:, 0].tolist() == [3.0, 100.0, 4.0]
    with pytest.raises(ValueError, match="valid rows must come before"):
        T.sorted_lengths(ids, interior, 3)
    with pytest.raises(ValueError, match="valid rows must come before"):
        T.level_bounds(ids, ids, interior, 3, 3)
    # and so do ids that fall among the valid rows (the tail's are not read)
    with pytest.raises(ValueError, match="must not decrease"):
        T.sorted_lengths(torch.tensor([0, 1, 0, 2, 2]), ok, 3)
    assert T.sorted_lengths(torch.tensor([0, 0, 1, 1, 0]), ok,
                            3).tolist() == [2, 2, 0]
    # a row with the id num_segments is left out, sorted or not
    out = T.segment_sum(x, torch.tensor([0, 3, 1, 3, 2]), 3)
    assert out[:, 0].tolist() == [1.0, 100.0, 8.0]
    out = T.segment_sum(x, torch.tensor([0, 0, 1, 3, 3]), 3, ids_sorted=True)
    assert out[:, 0].tolist() == [3.0, 100.0, 0.0]
    # a level's bounds go with its own parents
    lvl = dict(bnd=dict(lengths=lengths))
    assert torch.equal(T._upward_segment_sum(x, lvl, 3),
                       T.sorted_segment_sum(x, lengths))
    with pytest.raises(ValueError, match="3 parents, expected 4"):
        T._upward_segment_sum(x, lvl, 4)


def test_parent_and_atom_gathers_reach_take_rows(system, all_pairs_build,
                                                 monkeypatch):
    """Every level of every pass gathers its parent rows and its atom rows
    through rows.take_rows, with the int32 ids its topology carries, at the
    widths 1, 6, 12, 13 and 26; the rows are those of the stock gather."""
    params, pos, aj, at = system
    (_, _), (lev_t, _) = all_pairs_build
    (_, l1t), (_, v1t) = level1_pair(aj, at, pos, params.roffset)
    topo = T.tree_topology(lev_t)
    calls = []

    def counted(table, ids):
        assert ids.dtype == torch.int32 and ids.is_contiguous()
        out = RW.take_rows(table, ids)
        assert torch.equal(out, table[ids.long()])
        calls.append(1 if table.dim() == 1 else table.shape[1])
        return out

    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW
    monkeypatch.setattr(T, "take_rows", counted)
    nl = T.NUM_TREE_LEVELS
    _, lb = T.rescan_volumes2(topo, l1t, v1t)
    assert calls == [12, 12] + [26, 12] * (nl - 1)
    calls.clear()
    lv = T.rescan_volumes(topo, v1t)
    assert calls == [6, 6] + [13, 6] * (nl - 1)
    calls.clear()
    T.rescan_gammas(lv, v1t)
    assert calls == [1, 1] * nl
    # the two-parameterization pass moves the same vdW rows (it leaves junk
    # on the padding, which the one-parameterization pass zeroes)
    for x, y in zip(lb, lv):
        valid = x["valid"]
        assert torch.equal(x["_dat"][valid], y["_dat"][valid])


def test_deposits_leave_out_the_padding_rows(system, all_pairs_build):
    """The atom deposits of a reduction sum every level's rows by atom.
    Invalid slots carry the id natoms, which the sum leaves out, instead of
    atom 0, whose segment they used to lengthen by every padding row of the
    tree: the results are those of the zero rows deposited on atom 0."""
    params, pos, aj, at = system
    (_, _), (lev_t, _) = all_pairs_build
    (_, l1t), _ = level1_pair(aj, at, pos, params.roffset)
    got = T.reduce_tree(lev_t, l1t, with_selfvol=True)
    padded = 0
    on_atom0 = []
    for lvl in lev_t:
        dep = lvl["bnd"]["atom_dep"]
        padded += int((dep == params.n).sum())
        assert torch.equal(dep == params.n, ~lvl["valid"])
        on_atom0.append({**lvl, "bnd": {**lvl["bnd"], "atom_dep": lvl["atom"]}})
    assert padded > 0
    ref = T.reduce_tree(tuple(on_atom0), l1t, with_selfvol=True)
    for k in ("energy", "dr", "self_volume"):
        assert torch.equal(got[k], ref[k]), k


# ---------------------------------------------------------------------------
# reduce_tree's free volumes (with_freevol): GaussVol's compute_volume
# ---------------------------------------------------------------------------

jax_reduce_freevol = jax.jit(JT.reduce_tree,
                             static_argnames=("with_selfvol", "with_freevol"))
REPLICA_JITTER = 0.005  # nm, the second replica's displacement (numpy seed)


def _replica_positions(pos, nrep):
    rng = np.random.default_rng(5)
    return [pos] + [pos + rng.normal(0.0, REPLICA_JITTER, pos.shape)
                    for _ in range(nrep - 1)]


def _jax_rows_build(params, aj, pos):
    """JAX's tree of one system on its neighbor rows (build_both's)."""
    (l1j, _), _ = level1_pair(aj, arrays_from_numpy(aj, "cpu", torch.float64),
                              pos, params.roffset)
    rcut = tree_pair_cutoff(params.radii_large) + 0.1
    heavy = np.asarray(params.ishydrogen) == 0
    pij = jax_half_neighbor_pairs(jnp.asarray(pos), jnp.asarray(heavy), rcut,
                                  64)
    levels, _ = jax_build_tree(l1j, pij[0], pij[1], JT.TreeCaps(*CAPS),
                               pairs_valid=pij[2], pair_rows=True)
    return levels, l1j


def _union_build(system, nrep):
    """The port's tree over nrep replicas' union (the fixture and jittered
    copies) on the batched neighbor rows, and the union's level-1 table."""
    params, pos, aj, at = system
    reps = _replica_positions(pos, nrep)
    p = torch.as_tensor(np.stack(reps))
    heavy = torch.as_tensor(np.asarray(params.ishydrogen) == 0)
    rcut = tree_pair_cutoff(params.radii_large) + 0.1
    pi, pj, pv, _ = half_neighbor_pairs(p, heavy, rcut, 64)
    l1 = T.make_level1(p.reshape(-1, 3), at["radii_large"].repeat(nrep),
                       at["vol_large"].repeat(nrep),
                       (at["gamma"] / params.roffset).repeat(nrep),
                       at["ishydrogen"].repeat(nrep))
    levels, diag = T.build_tree(l1, pi, pj, T.TreeCaps(*CAPS),
                                pairs_valid=pv, pair_rows=True, nrep=nrep)
    assert not T.check_overflow({k: v.max(0).values if v.dim() == 2 else v
                                 for k, v in diag.items()})["any"]
    return reps, levels, l1


@pytest.mark.parametrize("with_selfvol", [True, False],
                         ids=["selfvol", "no_selfvol"])
@pytest.mark.parametrize("nrep", [1, 2])
def test_free_volumes_match_jax(system, nrep, with_selfvol):
    """reduce_tree(with_freevol=True) on the fixture (and a jittered copy
    in a two-replica union tree) gives JAX's free_volume and volume for
    each replica to 1e-10, and leaves energy, dr and self_volume bitwise
    those of with_freevol=False."""
    params, pos, aj, at = system
    reps, levels, l1 = _union_build(system, nrep)
    n = params.n
    got = T.reduce_tree(levels, l1, with_selfvol=with_selfvol,
                        with_freevol=True, nrep=nrep)
    base = T.reduce_tree(levels, l1, with_selfvol=with_selfvol, nrep=nrep)
    assert got["volume"].shape == (nrep,)
    assert got["free_volume"].shape == (nrep * n,)
    for k in ("energy", "dr") + (("self_volume",) if with_selfvol else ()):
        assert torch.equal(got[k], base[k]), k
    assert sorted(got) == sorted(list(base) + ["free_volume", "volume"])
    for b, pb in enumerate(reps):
        lj, l1j = _jax_rows_build(params, aj, pb)
        rj = jax_reduce_freevol(lj, l1j, with_selfvol=with_selfvol,
                                with_freevol=True)
        rows = slice(b * n, (b + 1) * n)
        assert rel(got["free_volume"][rows].numpy(),
                   rj["free_volume"]) <= 1e-10
        assert abs(float(got["volume"][b]) - float(rj["volume"])) <= \
            1e-10 * abs(float(rj["volume"]))
        assert rel(got["dr"][rows].numpy(), rj["dr"]) <= 1e-10
        assert abs(float(got["energy"][b]) - float(rj["energy"])) <= \
            1e-10 * abs(float(rj["energy"]))


def test_free_volumes_match_the_oracle(system, all_pairs_build):
    """The port's free volumes and total volume on the fixture against its
    f64 oracle's GaussVol.compute_volume (models/oracle.py), at the JAX
    suite's oracle bars (tests/test_native.py: free volumes rtol 1e-9 +
    atol 1e-12, the volume rtol 1e-12)."""
    from openmm_agbnp_plugin_tpu_torch.models.constants import sphere_volume
    from openmm_agbnp_plugin_tpu_torch.models.oracle import GaussVol

    params, pos, aj, at = system
    lev_t = all_pairs_build[1][0]
    (_, l1t), _ = level1_pair(aj, at, pos, params.roffset)
    red = one_system(T.reduce_tree(lev_t, l1t, with_selfvol=True,
                                   with_freevol=True))
    radii = np.asarray(params.radii_large)
    gv = GaussVol(params.n, params.ishydrogen)
    gv.set_radii(radii)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0,
                            sphere_volume(radii)))
    gv.set_gammas(np.asarray(params.gamma / params.roffset))
    gv.compute_tree(pos)
    v_o, e_o, _, _, fv_o, sv_o = gv.compute_volume(pos)
    np.testing.assert_allclose(red["free_volume"].numpy(), fv_o, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(float(red["volume"][0]), v_o, rtol=1e-12)
    np.testing.assert_allclose(red["self_volume"].numpy(), sv_o, rtol=1e-9,
                               atol=1e-12)
    assert fv_o.sum() > 0 and (fv_o >= -1e-12).all()


# ---------------------------------------------------------------------------
# The per-level kernels' prep of a fixed topology, and the CPU's twin
# ---------------------------------------------------------------------------

KERNEL_PREP = ("starts", "dep_order", "dep_starts")
TRPCAGE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")


def _has_prep(topo) -> bool:
    return all(k in topo[0]["bnd"] for k in KERNEL_PREP)


def _prepared(name, system, built):
    """(a prepared topology, its atom count): 1li2's tree, a two-replica
    union of the fixture, 1li2's tree compacted."""
    if name == "union2":
        _, levels, _ = _union_build(system, 2)
        return T.kernel_prep(T.tree_topology(levels)), 2 * system[0].n
    levels, natoms = built("1li2")
    if name == "compact":
        return T.kernel_prep(T.compact_topology(
            levels, [l["valid"].shape[0] for l in levels])[0]), natoms
    return T.kernel_prep(T.tree_topology(levels)), natoms


@pytest.mark.parametrize("name", ["1li2", "union2", "compact"])
def test_kernel_prep_starts_and_deposit_list(system, built, name):
    """What kernel_prep adds to a topology for the per-level kernels (a
    tree_topology or compact_topology result): each level's starts are the exclusive cumsum of its lengths,
    then their total; the deposit list names every valid row once, and
    applied in plain torch (atom i sums the rows dep_order[dep_starts[i]:
    dep_starts[i + 1]] in that order) it gives _deposits' result bit for
    bit."""
    topo, natoms = _prepared(name, system, built)
    for lvl in topo:
        lengths, starts = lvl["bnd"]["lengths"], lvl["bnd"]["starts"]
        assert starts.dtype == torch.int32
        assert starts.shape == (lengths.shape[0] + 1,)
        assert torch.equal(starts[:-1].long(),
                           torch.cumsum(lengths, 0) - lengths)
        assert int(starts[-1]) == int(lvl["valid"].sum())
    bnd = topo[0]["bnd"]
    order, dstarts = bnd["dep_order"], bnd["dep_starts"]
    assert order.dtype == dstarts.dtype == torch.int32
    assert dstarts.shape == (natoms + 1,)
    deepest_first = topo[::-1]
    valid = torch.cat([lvl["valid"] for lvl in deepest_first])
    nvalid = int(valid.sum())
    assert nvalid > 0 and int(dstarts[-1]) == nvalid
    assert order.shape == valid.shape
    assert bool(valid[order[:nvalid].long()].all())
    assert torch.equal(torch.sort(order[:nvalid].long()).values,
                       torch.nonzero(valid)[:, 0])
    rng = np.random.default_rng(4)
    rows = [torch.as_tensor(rng.normal(size=(lvl["valid"].shape[0], 7)))
            * lvl["valid"][:, None] for lvl in deepest_first]
    want = T._deposits(rows, [lvl["bnd"]["atom_dep"]
                              for lvl in deepest_first], natoms, None)
    got = T.sorted_segment_sum(torch.cat(rows)[order.long()],
                               (dstarts[1:] - dstarts[:-1]).long())
    assert torch.equal(got, want)


@pytest.mark.parametrize("nrep", [1, 2])
def test_prepared_topology_runs_the_twin_on_the_cpu(system, nrep):
    """On the CPU a prepared topology (kernel_prep, as an MD window's
    build gives it) still runs the torch passes: the fixed-topology cavity
    pass and the compacted WU pass give energies, forces and self volumes
    bitwise those of the same topologies without the prep, no tree kernel
    is counted and the recorder holds no tree.kernel counter."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    params, pos, aj, at = system
    reps, levels, _ = _union_build(system, nrep)
    a = M.union_arrays(at, nrep, pairs=False)
    p = torch.as_tensor(np.stack(reps)).reshape(-1, 3)
    topo = T.tree_topology(levels)
    gam = torch.as_tensor(np.random.default_rng(8).normal(0.0, 10.0,
                                                          p.shape[0]))

    def passes(tp, prep):
        out = M.tree_passes(a, p, T.TreeCaps(*CAPS), params.roffset,
                            topology=prep(tp), nrep=nrep)
        v1 = out[4]
        vt, counts = T.compact_topology(T.rescan_volumes(prep(tp), v1),
                                        [l["valid"].shape[0] // nrep
                                         for l in tp], nrep=nrep)
        wu = {**v1, "gamma1i": gam}
        red = T.reduce_tree(T.rescan_volumes(prep(vt), wu), wu,
                            with_selfvol=False, nrep=nrep)
        return [out[0], out[1], out[2], out[6]["energy"], out[7]["dr"],
                red["energy"], red["dr"], counts]

    before = PK.launch_counts()
    with profiling.record():
        profiling.reset()
        got = passes(topo, T.kernel_prep)
        kinds = {c["name"] for c in profiling.recorded()["counts"]}
    assert "tree.kernel" not in kinds
    after = PK.launch_counts()
    assert all(after[k] == before[k]
               for k in ("tree_rescan", "tree_reduce", "tree_deposit"))
    want = passes(topo, lambda tp: tp)
    assert got[0].shape == (nrep,)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_only_an_md_window_prepares_its_topology(system, built):
    """The per-level kernels' prep is made at an MD window's build alone:
    Simulation.window_build gives its topology and its compacted WU
    topology kernel_prep (so on the card an MD window's tree passes take
    the kernel route), while tree_topology and compact_topology give none,
    nor does AGBNP2's build (its atomic and MS trees keep the torch
    passes on the card, as every tree built in a call does)."""
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
    from openmm_agbnp_plugin_tpu_torch.models import agbnp2_torch as P2

    sim = Simulation(load_dms(TRPCAGE), device="cpu", dtype=torch.float64,
                     version=1, cutoff=1.0, skin=0.25,
                     descreen_horizon="cutoff")
    _, topo, vt, _ = sim.window_build(sim.positions[None], sim.ff_state(),
                                      sim._ensure_vdw_caps())
    assert _has_prep(topo) and _has_prep(vt)
    levels, _ = built("1li2")
    assert not _has_prep(T.tree_topology(levels))
    assert not _has_prep(T.compact_topology(
        levels, [l["valid"].shape[0] for l in levels])[0])
    params, pos = system[0], system[1]
    n = 40
    p40 = type(params)(radius=params.radius[:n], gamma=params.gamma[:n],
                       alpha=params.alpha[:n], charge=params.charge[:n],
                       ishydrogen=params.ishydrogen[:n])
    tm = P2.AGBNP2Model(p40, device="cpu", positions=pos[:n])
    _, topo2 = P2.agbnp2_energy(tm.arrays, torch.as_tensor(pos[:n]),
                                ms_pi=tm.ms_pi, ms_pj=tm.ms_pj,
                                ms_pv=tm.ms_pv, **tm.energy_kwargs(),
                                build_only=True)
    assert not _has_prep(topo2["atoms"]) and not _has_prep(topo2["ms"])
