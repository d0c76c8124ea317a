"""Replicas as a batch axis: the port's batched evaluation against the JAX
package's vmapped one, f64 on the CPU.

B conformations of the 64-atom fixture go through the port's
batched_energy_forces (one overlap tree over the replicas' disjoint union,
the pair sweeps' plain twins with a replica axis) and through JAX's
AGBNPModel.batched_energy_forces (jax.vmap over its XLA path).  The port
is also held against its own per-conformer evaluation, its batched
diagnostics against the per-conformer ones, its regrow from tiny
capacities against a healthy model, and the twins', lists' and neighbor
lists' replica axis against their unbatched calls.
"""

import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    AGBNPModel as JaxAGBNPModel
from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    batched_diag_max as jax_batched_diag_max
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu_torch import (AGBNPModel, AGBNPParams,
                                           batched_diag_max,
                                           load_gaussvol_dat)
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import CellGrid, \
    cell_neighbor_pairs, half_neighbor_pairs

torch.set_num_threads(2)

N = 64
B = 3
DETAILS = ("e_cav", "e_vol1", "e_vol2", "gb_self", "gb_pair", "e_vdw")


@pytest.fixture(scope="module")
def system():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(os.path.dirname(__file__), "fixtures", "gaussvol.dat"))
    params = AGBNPParams(radius=radius[:N], gamma=gamma[:N], alpha=alpha[:N],
                         charge=charge[:N], ishydrogen=ish[:N])
    rng = np.random.default_rng(7)
    batch = pos[None, :N] + 0.01 * rng.standard_normal((B, N, 3))
    return params, pos[:N], batch


def _rel(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-300))


@pytest.fixture(scope="module")
def jax_batches(system):
    """JAX's vmapped evaluation, versions 0 and 1, and its capacities."""
    params, pos, batch = system
    out = {}
    for version in (0, 1):
        jm = JaxAGBNPModel(params, version=version, dtype=np.float64,
                           positions=pos, pair_kernel=False)
        out[version] = (jm.caps, jm.batched_energy_forces(batch))
    return out


@pytest.mark.parametrize("version,pair_tiles", [(0, None), (1, None),
                                                (1, False)])
def test_batched_energy_forces_matches_jax(system, jax_batches, version,
                                           pair_tiles):
    """Energy, forces and the detail terms of each conformer within 1e-10
    of JAX's vmapped evaluation (the port on its kernel route: tile lists
    for the Born and descreening sweeps, or the dense grid)."""
    params, pos, batch = system
    caps, ref = jax_batches[version]
    m = AGBNPModel(params, device="cpu", version=version, positions=pos,
                   caps=T.TreeCaps(caps.caps, caps.offs),
                   pair_tiles=pair_tiles)
    out = m.batched_energy_forces(batch)
    assert out["energy"].shape == (B,)
    assert out["force"].shape == (B, N, 3)
    assert _rel(out["energy"], ref["energy"]) <= 1e-10
    assert _rel(out["force"], ref["force"]) <= 1e-10
    for k in DETAILS[:3] + (DETAILS[3:] if version else ()):
        assert out["details"][k].shape == (B,)
        assert _rel(out["details"][k], ref["details"][k]) <= 1e-10, k
    # the worst replica's counts, as JAX's batched_diag_max gives them
    dm = batched_diag_max(out["diag"])
    jdm = jax_batched_diag_max(ref["diag"])
    np.testing.assert_array_equal(dm["counts"], jdm["counts"])
    np.testing.assert_array_equal(dm["max_siblings"], jdm["max_siblings"])


@pytest.mark.parametrize("version,pair_tiles", [(0, None), (1, None),
                                                (1, False)])
def test_batched_matches_each_conformer(system, version, pair_tiles):
    """Replica b of the batch equals the model's own evaluation of
    conformer b within 1e-12, and its diag row equals that evaluation's
    diag."""
    params, pos, batch = system
    m = AGBNPModel(params, device="cpu", version=version, positions=pos,
                   pair_tiles=pair_tiles, cutoff=1.0 if pair_tiles is None
                   else None)
    out = m.batched_energy_forces(batch)
    for b in range(B):
        e, f, one = m.energy_forces(batch[b], with_details=True)
        assert abs(float(out["energy"][b]) - float(e)) <= 1e-12 * abs(
            float(e))
        assert _rel(out["force"][b], f) <= 1e-12
        for k, v in one["details"].items():
            assert _rel(out["details"][k][b], v) <= 1e-12, k
        for k in ("counts", "max_siblings", "caps", "offs"):
            assert torch.equal(out["diag"][k][b], one["diag"][k]), k
        if "pair_tile_counts" in one["diag"]:
            assert torch.equal(out["diag"]["pair_tile_counts"][b],
                               one["diag"]["pair_tile_counts"])
    dm = batched_diag_max(out["diag"])
    assert dm["counts"].shape == (7,)
    np.testing.assert_array_equal(
        dm["counts"], out["diag"]["counts"].numpy().max(axis=0))


def test_regrow_from_tiny_capacities(system):
    """Undersized capacities: the PanicButton loop on the batch's worst
    replica grows them until no replica overflows, and the batch then
    equals a healthy model's."""
    params, pos, batch = system
    tiny = T.TreeCaps(caps=(128,) * 7, offs=(4,) * 6)
    m = AGBNPModel(params, device="cpu", positions=pos, caps=tiny)
    for tries in range(8):
        out = m.batched_energy_forces(batch)
        if not m.check_and_grow(batched_diag_max(out["diag"])):
            break
    assert tries > 0
    ok = AGBNPModel(params, device="cpu", positions=pos)
    ref = ok.batched_energy_forces(batch)
    assert _rel(out["energy"], ref["energy"]) <= 1e-12
    assert _rel(out["force"], ref["force"]) <= 1e-12
    assert not JT.check_overflow(
        {k: np.asarray(v) for k, v in batched_diag_max(out["diag"]).items()
         if k in ("counts", "caps", "max_siblings", "offs")})["any"]


def _layouts(system):
    """The sweeps' batched layouts of the fixture's conformers (kernel
    route arrays, f64) and a model's spline arguments."""
    params, pos, batch = system
    m = AGBNPModel(params, device="cpu", positions=pos, pair_tiles=False)
    a = m.arrays
    n, npad = N, m.pair_pad
    p = torch.as_tensor(batch)
    pos_pad = torch.nn.functional.pad(p[:, a["rperm"]], (0, 0, 0, npad - n)) \
        .transpose(1, 2).contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    pos_h = (p[:, hids.clamp(min=0)] * hvalid[:, None]).transpose(1, 2) \
        .contiguous()
    rng = np.random.default_rng(3)
    s_h = torch.where(hvalid, torch.as_tensor(
        rng.uniform(0.3, 1.0, (B, hids.shape[0]))), 0.0)
    born = torch.as_tensor(rng.uniform(0.15, 0.4, (B, npad)))
    brw = torch.as_tensor(rng.normal(size=(B, npad)))
    bru = torch.as_tensor(rng.normal(size=(B, npad)))
    spline = PK.SplineArgs(a["hids_perm_pad"], a["type_rows_pad"],
                           a["type_cols_hpad"], a["ytab"], a["y2tab"], n, 1.0)
    valid = (torch.arange(npad) < n, hvalid)
    return (pos_pad, pos_h, s_h, born, brw, bru), a, spline, valid


def _same(x, refs):
    if isinstance(x, torch.Tensor):
        for b, r in enumerate(refs):
            assert torch.equal(x[b], r)
        return
    for k, v in enumerate(x):
        _same(v, [r[k] for r in refs])


def test_twins_replica_axis_is_bitwise_their_unbatched_calls(system):
    """Every sweep's twin, given a batch, equals its unbatched call on
    each replica bit for bit (dense, lists, MM fused, reload and
    recompute), and the batched lists equal each replica's own."""
    (pos_pad, pos_h, s_h, born, brw, bru), a, sp, (rv, hv) = \
        _layouts(system)
    n, tables = N, (sp.hids_perm, sp.type_rows, sp.type_cols, sp.yval,
                    sp.y2val)
    one = range(B)
    out = PK.born_sums(pos_pad, pos_h, *tables, s_h, n, horizon=1.0,
                       save_qd=True)
    _same(out, [PK.born_sums(pos_pad[b], pos_h[b], *tables, s_h[b], n,
                             horizon=1.0, save_qd=True) for b in one])
    _same(PK.descreening(pos_pad, pos_h, s_h, brw, bru, out[1:]),
          [PK.descreening(pos_pad[b], pos_h[b], s_h[b], brw[b], bru[b],
                          (out[1][b], out[2][b])) for b in one])
    _same(PK.descreening(pos_pad, pos_h, s_h, brw, bru, None, spline=sp),
          [PK.descreening(pos_pad[b], pos_h[b], s_h[b], brw[b], bru[b], None,
                          spline=sp) for b in one])
    _same(PK.subtile_columns(pos_pad, pos_h, sp.hids_perm, n, horizon=1.0),
          [PK.subtile_columns(pos_pad[b], pos_h[b], sp.hids_perm, n,
                              horizon=1.0) for b in one])
    charge = a["charge_pad"]
    mm = dict(sig_pad=torch.full_like(charge, 0.3),
              epsq_pad=torch.full_like(charge, 0.5),
              excl_rows_pad=torch.full((charge.shape[0], 8), -1,
                                       dtype=torch.int32))
    _same(PK.gb_pair(pos_pad, charge, born, n, cutoff=1.0, **mm),
          [PK.gb_pair(pos_pad[b], charge, born[b], n, cutoff=1.0, **mm)
           for b in one])
    tile = PK.pick_tile(n)
    rb = TL.tile_bounds(pos_pad, rv, tile)
    cb = TL.tile_bounds(pos_h, hv, tile)
    tl, nv, cnt = TL.build_tile_list(*rb, *cb, 1.0, 4)
    lists = [TL.build_tile_list(*TL.tile_bounds(pos_pad[b], rv, tile),
                                *TL.tile_bounds(pos_h[b], hv, tile), 1.0, 4)
             for b in one]
    _same((tl, nv, cnt), lists)
    out = TL.born_sums_tiles(nv, tl, pos_pad, pos_h, *tables, s_h, n, tile,
                             horizon=1.0, save_qd=True)
    _same(out, [TL.born_sums_tiles(nv[b], tl[b], pos_pad[b], pos_h[b],
                                   *tables, s_h[b], n, tile, horizon=1.0,
                                   save_qd=True) for b in one])
    _same(TL.descreening_tiles(nv, tl, pos_pad, pos_h, s_h, brw, bru, out[1:],
                               tile, spline=sp),
          [TL.descreening_tiles(nv[b], tl[b], pos_pad[b], pos_h[b], s_h[b],
                                brw[b], bru[b], (out[1][b], out[2][b]), tile,
                                spline=sp) for b in one])
    tlg, nvg, _ = TL.build_tile_list(*rb, *rb, 1.0, 4, triangular=True)
    _same(TL.gb_pair_tiles(nvg, tlg, pos_pad, charge, born, n, tile,
                           cutoff=1.0, **mm),
          [TL.gb_pair_tiles(nvg[b], tlg[b], pos_pad[b], charge, born[b], n,
                            tile, cutoff=1.0, **mm) for b in one])


def test_neighbor_lists_and_union_tree_per_replica(system):
    """The batched half list and cell grid are each replica's list with
    ids offset by b N, max_neighbors per replica; the union tree's
    per-replica counts and sibling maxima are the replicas' own builds'."""
    params, pos, batch = system
    p = torch.as_tensor(batch)
    heavy = torch.as_tensor(np.asarray(params.ishydrogen) == 0)
    grid = CellGrid(pos, 0.6, heavy_mask=heavy.numpy())
    for fn in (half_neighbor_pairs,
               lambda *a: cell_neighbor_pairs(*a, grid=grid)):
        pi, pj, pv, nbmax = fn(p, heavy, 0.6, 32)
        assert nbmax.shape == (B,)
        k = pi.shape[0] // (B * N)
        for b in range(B):
            qi, qj, qv, qmax = fn(p[b], heavy, 0.6, 32)
            s = slice(b * N * k, (b + 1) * N * k)
            assert torch.equal(pi[s], qi + b * N)
            assert torch.equal(pj[s], qj + b * N)
            assert torch.equal(pv[s], qv)
            assert int(nbmax[b]) == int(qmax)
    m = AGBNPModel(params, device="cpu", positions=pos)
    a = m.arrays
    pi, pj, pv, _ = half_neighbor_pairs(p, heavy, 0.6, 32)
    union = {k: a[k].repeat(B) for k in ("radii_large", "vol_large", "gamma",
                                         "ishydrogen")}
    lvl1 = T.make_level1(p.reshape(-1, 3), union["radii_large"],
                         union["vol_large"], union["gamma"],
                         union["ishydrogen"])
    levels, diag = T.build_tree(lvl1, pi, pj, m.caps, pairs_valid=pv,
                                pair_rows=True, nrep=B)
    assert diag["counts"].shape == (B, 7)
    for b in range(B):
        qi, qj, qv, _ = half_neighbor_pairs(p[b], heavy, 0.6, 32)
        l1 = T.make_level1(p[b], a["radii_large"], a["vol_large"], a["gamma"],
                           a["ishydrogen"])
        lv, d1 = T.build_tree(l1, qi, qj, m.caps, pairs_valid=qv,
                              pair_rows=True)
        assert torch.equal(diag["counts"][b], d1["counts"][0])
        assert torch.equal(diag["max_siblings"][b], d1["max_siblings"][0])
        assert torch.equal(T.replica_counts(T.tree_topology(levels), B,
                                            N)[b], d1["counts"][0])
