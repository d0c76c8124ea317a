"""The port's interacting-tile lists and list sweeps against the JAX
package, f64, inputs from seeded numpy.

The fixture is a 600-atom rod (18 nm along x, tile 128; built like
tests/test_jax_pipeline.py:281-292) on which the lists do drop tiles.  The
lists and counts must equal JAX's exactly (the tile radii to 1 ulp); the
sweeps' plain twins must match the Pallas kernels run in interpret mode to
1e-12 of the largest output entry (only the summation order differs); the
model on lists must match JAX within 1e-10 and the port's own dense route
within 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JaxModel
from openmm_agbnp_plugin_tpu.models.agbnp_jax import _pair_phases_pallas
from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.models.oracle import AGBNPParams as JaxParams
from openmm_agbnp_plugin_tpu.ops.pallas import pairs as JPK
from openmm_agbnp_plugin_tpu.ops.tree import TreeCaps as JaxCaps
from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, TreeCaps
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
    _pair_phases_kernel, arrays_from_numpy)
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

torch.set_num_threads(2)

TOL = 1e-12
TILE = 128
N = 600
BOXES = {
    "nobox": None,
    "ortho": (7.0, 3.0, 3.1),
    "triclinic": ((7.0, 0.0, 0.0), (0.5, 3.0, 0.0), (0.3, -0.2, 3.1)),
}
MODEL_KW = dict(version=1, cutoff=1.0, descreen_horizon="cutoff")
# the rod's tree fits TreeCaps.for_natoms(600) once level 6 and its sibling
# window are doubled (one check_and_grow)
CAPS = ((7296, 16896, 15616, 8448, 3072, 1280, 384), (48, 32, 24, 16, 8, 8))


def rod():
    """(positions, AGBNPParams keyword arguments) of the seeded rod."""
    rng = np.random.default_rng(1)
    pos = np.stack([0.03 * np.arange(N), 0.2 * rng.standard_normal(N),
                    0.2 * rng.standard_normal(N)], 1)
    ish = (np.arange(N) % 3 == 2).astype(np.int64)
    return pos, dict(radius=np.where(ish > 0, 0.12, 0.165),
                     gamma=np.where(ish > 0, 0.0, 48.9528),
                     alpha=np.where(ish > 0, -20.0, -60.0),
                     charge=rng.uniform(-0.3, 0.3, N), ishydrogen=ish)


def t(x):
    return torch.as_tensor(np.array(x))


def j(x):
    return jnp.asarray(np.asarray(x))


def box_args(box):
    """The box as the JAX kernels take it (flat tuple) and as the port's
    (tensor)."""
    if box is None:
        return None, None
    return (tuple(np.ravel(box).tolist()),
            torch.tensor(box, dtype=torch.float64))


def assert_close(port, ref, what, tol=TOL):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"{what}: {err:.3e}"


@pytest.fixture(scope="module")
def layouts():
    """Shared sweep inputs in both packages' layouts (seeded numpy)."""
    pos, pkw = rod()
    npad = JPK.pad_to(N, TILE)
    aj = jax_prepare_arrays(JaxParams(**pkw), dtype=np.float64,
                            pair_pad=npad, positions=pos)
    at = arrays_from_numpy(aj, "cpu", torch.float64)
    rng = np.random.default_rng(7)
    rperm, hids = aj["rperm"], aj["hids_pad"]
    nhpad = hids.shape[0]
    hvalid = hids >= 0
    pos_pad = np.zeros((3, npad))
    pos_pad[:, :N] = pos[rperm].T
    pos_h = np.zeros((3, nhpad))
    pos_h[:, hvalid] = pos[hids[hvalid]].T

    def rows(lo, hi):
        x = np.zeros(npad)
        x[:N] = rng.uniform(lo, hi, N)
        return x

    # symmetric exclusion lists between nearby permuted rows (which Morton
    # order keeps spatially close, so excluded pairs land in listed tiles)
    e_max = 24
    lists = [set() for _ in range(N)]
    for i in range(N):
        for k in rng.integers(-8, 9, 6):
            jj = int(i + k)
            if (0 <= jj < N and jj != i and len(lists[i]) < e_max
                    and len(lists[jj]) < e_max):
                lists[i].add(jj)
                lists[jj].add(i)
    excl = np.full((npad, e_max), -1, np.int32)
    for i, l in enumerate(lists):
        excl[i, :len(l)] = sorted(l)
    brw = np.zeros(npad)
    brw[:N] = rng.normal(0.0, 5.0, N)
    bru = np.zeros(npad)
    bru[:N] = rng.normal(0.0, 50.0, N)
    return dict(aj=aj, at=at, pos_pad=pos_pad, pos_h=pos_h,
                rvalid=np.arange(npad) < N, hvalid=hvalid,
                s_h=np.where(hvalid, rng.uniform(0.3, 1.0, nhpad), 0.0),
                born=rows(0.12, 0.45), sig=rows(0.2, 0.4),
                epsq=rows(0.1, 0.9), excl=excl, brw=brw, bru=bru)


def jax_list(L, rng_dist, lmax, triangular=False, box=None):
    """A JAX-built list over the rod's row and (heavy or row) packings."""
    rp = (j(L["pos_pad"]), j(L["rvalid"]))
    cp = rp if triangular else (j(L["pos_h"]), j(L["hvalid"]))
    ci, ri = JPK.tile_bounds(*rp, TILE)
    cj, rj = JPK.tile_bounds(*cp, TILE)
    return JPK.build_tile_list(ci, ri, cj, rj, rng_dist, lmax,
                               triangular=triangular, box=box)


@pytest.mark.parametrize("box", list(BOXES), ids=list(BOXES))
def test_tile_helpers_equal_jax(layouts, box):
    L = layouts
    box_j, box_t = box_args(BOXES[box])
    for pos_c, valid_c, triangular in (
            (L["pos_h"], L["hvalid"], False),
            (L["pos_pad"], L["rvalid"], True)):
        bj = [JPK.tile_bounds(j(L["pos_pad"]), j(L["rvalid"]), TILE),
              JPK.tile_bounds(j(pos_c), j(valid_c), TILE)]
        bt = [TL.tile_bounds(t(L["pos_pad"]), t(L["rvalid"]), TILE),
              TL.tile_bounds(t(pos_c), t(valid_c), TILE)]
        for (cj_, rj_), (ct, rt) in zip(bj, bt):
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj_))
            # torch's vectorised CPU sqrt is not correctly rounded (1 ulp
            # off on ~1% of inputs; XLA's is): the radius is held to 1 ulp,
            # the lists built from it exactly
            np.testing.assert_array_max_ulp(rt.numpy(), np.asarray(rj_), 1)
        ntot = bt[0][1].shape[0] * bt[1][1].shape[0]
        if triangular:
            ntot = bt[0][1].shape[0] * (bt[0][1].shape[0] + 1) // 2
        for rng_dist in (2.0, 1.0):
            count = TL.host_tile_count(L["pos_pad"], L["rvalid"], pos_c,
                                       valid_c, TILE, rng_dist,
                                       triangular=triangular, box=box_j)
            assert count == JPK.host_tile_count(
                L["pos_pad"], L["rvalid"], pos_c, valid_c, TILE, rng_dist,
                triangular=triangular, box=box_j)
            # a budget that overflows, one with headroom, one past ntot
            for lmax in (max(1, count - 3), count + 2, ntot + 5):
                out_j = JPK.build_tile_list(*bj[0], *bj[1], rng_dist, lmax,
                                            triangular=triangular, box=box_j)
                out_t = TL.build_tile_list(*bt[0], *bt[1], rng_dist, lmax,
                                           triangular=triangular, box=box_t)
                for x, y in zip(out_t, out_j):
                    assert x.dtype == torch.int32
                    np.testing.assert_array_equal(x.numpy(), np.asarray(y))
                assert int(out_t[2]) == count
        # on the rod the lists drop tiles at 1 nm (the boxes wrap it)
        assert count < ntot or box != "nobox"


@pytest.mark.parametrize("horizon,box", [(None, "nobox"), (1.0, "triclinic")])
def test_born_and_descreening_tiles_match_pallas(layouts, horizon, box):
    L = layouts
    aj, at = L["aj"], L["at"]
    box_j, box_t = box_args(BOXES[box])
    heff = 2.0 if horizon is None else horizon
    count = int(jax_list(L, heff, 1, box=box_j)[2])
    tl_j, nv_j, _ = jax_list(L, heff, count + 3, box=box_j)
    assert int(nv_j[0]) < tl_j.shape[1]     # entries past nv are exercised
    raw_j, q_j, dq_j = JPK.born_sums_tiles(
        nv_j, tl_j, j(L["pos_pad"]), j(L["pos_h"]), j(aj["hids_perm_pad"]),
        j(aj["rowY_pad"]), j(aj["cols_oh_hpad"]), j(L["s_h"]), N, TILE,
        box=box_j, interpret=True, horizon=horizon, save_qd=True)
    nv, tl = t(nv_j), t(tl_j)
    spline = PK.SplineArgs(at["hids_perm_pad"], at["type_rows_pad"],
                           at["type_cols_hpad"], at["ytab"], at["y2tab"], N,
                           horizon)
    raw, q, dq = TL.born_sums_tiles(nv, tl, t(L["pos_pad"]), t(L["pos_h"]),
                                    *spline[:5], t(L["s_h"]), N, TILE,
                                    box=box_t, horizon=horizon, save_qd=True)
    assert_close(raw, raw_j, "raw")
    assert_close(q, q_j, "Q")
    assert_close(dq, dq_j, "dQ")
    assert not q[int(nv[0]):].any() and not dq[int(nv[0]):].any()
    assert PK.launch_counts()["born_sums_tiles"] == 0

    common_j = (nv_j, tl_j, j(L["pos_pad"]), j(L["pos_h"]),
                j(aj["hids_perm_pad"]), j(aj["rowY_pad"]),
                j(aj["cols_oh_hpad"]), j(L["s_h"]), j(L["brw"]),
                j(L["bru"]), N, TILE)
    args_t = (nv, tl, t(L["pos_pad"]), t(L["pos_h"]), t(L["s_h"]),
              t(L["brw"]), t(L["bru"]))
    for label, qd_j, qd_t in (("reload", (q_j, dq_j), (q, dq)),
                              ("recompute", None, None)):
        out_j = JPK.descreening_tiles(*common_j, box=box_j, interpret=True,
                                      horizon=horizon, qd=qd_j)
        out_t = TL.descreening_tiles(*args_t, qd_t, TILE, box=box_t,
                                     spline=None if qd_t else spline)
        for name, x, y in zip(("W", "U", "f_rows", "f_cols"), out_t, out_j):
            assert_close(x, y, f"{label} {name}")


@pytest.mark.parametrize("cutoff,with_mm", [(None, False), (1.0, False),
                                            (1.0, True), (None, True)])
def test_gb_pair_tiles_matches_pallas(layouts, cutoff, with_mm):
    L = layouts
    aj = L["aj"]
    tl_j, nv_j, count = jax_list(L, 1.0, 16, triangular=True)
    assert int(count) < 15 and int(nv_j[0]) < 16
    mm_j, mm_t = {}, {}
    if with_mm:
        mm_j = dict(sig_pad=j(L["sig"]), epsq_pad=j(L["epsq"]),
                    excl_rows_pad=j(L["excl"]))
        mm_t = dict(sig_pad=t(L["sig"]), epsq_pad=t(L["epsq"]),
                    excl_rows_pad=t(L["excl"]))
    out_j = JPK.gb_pair_tiles(nv_j, tl_j, j(L["pos_pad"]),
                              j(aj["charge_pad"]), j(L["born"]), N, TILE,
                              cutoff=cutoff, interpret=True, **mm_j)
    out = TL.gb_pair_tiles(t(nv_j), t(tl_j), t(L["pos_pad"]),
                           t(aj["charge_pad"]), t(L["born"]), N, TILE,
                           cutoff=cutoff, **mm_t)
    for name, x, y in zip(("erow", "yrow", "force"), out[:3], out_j[:3]):
        assert_close(x, y, name)
    if with_mm:
        assert_close(out[3], out_j[3], "mmrow")
    else:
        assert out[3] is None and out_j[3] is None
    assert PK.launch_counts()["gb_pair_tiles"] == 0


@pytest.mark.parametrize("horizon", [None, 1.0])
def test_dense_recomputing_descreening_matches_pallas(layouts, horizon):
    L = layouts
    aj, at = L["aj"], L["at"]
    out_j = JPK.descreening(j(L["pos_pad"]), j(L["pos_h"]),
                            j(aj["hids_perm_pad"]), j(aj["rowY_pad"]),
                            j(aj["cols_oh_hpad"]), j(L["s_h"]), j(L["brw"]),
                            j(L["bru"]), N, TILE, interpret=True,
                            horizon=horizon, qd=None)
    spline = PK.SplineArgs(at["hids_perm_pad"], at["type_rows_pad"],
                           at["type_cols_hpad"], at["ytab"], at["y2tab"], N,
                           horizon)
    out = PK.descreening(t(L["pos_pad"]), t(L["pos_h"]), t(L["s_h"]),
                         t(L["brw"]), t(L["bru"]), None, spline=spline)
    for name, x, y in zip(("W", "U", "f_rows", "f_cols"), out, out_j):
        assert_close(x, y, name)
    with pytest.raises(ValueError):
        PK.descreening(t(L["pos_pad"]), t(L["pos_h"]), t(L["s_h"]),
                       t(L["brw"]), t(L["bru"]), None)
    assert PK.launch_counts()["descreening_recompute"] == 0


@pytest.fixture(scope="module")
def rod_models():
    """The rod in both packages with the same tree capacities: JAX on its
    list route (Pallas in interpret mode), the port on lists and dense."""
    pos, pkw = rod()
    caps = TreeCaps(*CAPS)
    jm = JaxModel(JaxParams(**pkw), caps=JaxCaps(*CAPS),
                  dtype=np.float64, positions=pos, pair_kernel=True,
                  **MODEL_KW)
    tm = {route: AGBNPModel(AGBNPParams(**pkw), device="cpu", caps=caps,
                            positions=pos,
                            pair_tiles=None if route == "lists" else False,
                            **MODEL_KW)
          for route in ("lists", "dense")}
    return pos, pkw, caps, jm, tm


def test_model_on_lists_matches_jax_and_dense(rod_models):
    pos, _, _, jm, tm = rod_models
    assert tm["lists"].pair_tiles == jm.pair_tiles
    assert tm["dense"].pair_tiles is None
    e_j, f_j, out_j = jm.energy_forces(pos, with_details=True)
    e_t, f_t, out_t = tm["lists"].energy_forces(pos, with_details=True)
    assert not tm["lists"].check_and_grow(out_t["diag"])
    np.testing.assert_array_equal(out_t["diag"]["pair_tile_counts"].numpy(),
                                  np.asarray(out_j["diag"]["pair_tile_counts"]))
    cb, cg = out_t["diag"]["pair_tile_counts"].tolist()
    assert cb < 5 * 4 and cg < 5 * 6 // 2     # tiles were dropped
    e_j, f_j = float(e_j), np.asarray(f_j)
    assert abs(float(e_t) - e_j) <= 1e-10 * abs(e_j)
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    e_d, f_d = tm["dense"].energy_forces(pos)
    assert abs(float(e_t) - float(e_d)) <= TOL * abs(float(e_d))
    assert_close(f_t, f_d, "force lists vs dense")


def test_tile_budget_overflow_regrows(rod_models):
    pos, pkw, caps, _, tm = rod_models
    m = AGBNPModel(AGBNPParams(**pkw), device="cpu", caps=caps,
                   positions=pos, pair_tiles=(8, 8), **MODEL_KW)
    _, _, out = m.energy_forces(pos, with_details=True)
    cb, cg = out["diag"]["pair_tile_counts"].tolist()
    assert cb > 8 and cg > 8
    assert out["diag"]["pair_tile_budgets"].tolist() == [8, 8]
    assert m.check_and_grow(out["diag"])
    assert m.pair_tiles[0] >= cb and m.pair_tiles[1] >= cg
    e, f, out = m.energy_forces(pos, with_details=True)
    assert not m.check_and_grow(out["diag"])
    e_d, f_d = tm["dense"].energy_forces(pos)
    assert abs(float(e) - float(e_d)) <= TOL * abs(float(e_d))
    assert_close(f, f_d, "regrown lists vs dense")


def test_sharing_off_matches_sharing_on(rod_models, monkeypatch):
    """Q/dQ sharing off (descreening recomputes the spline) against on:
    the port's model on both routes, and the port's list-route pair phases
    against JAX's with its AGBNP_TILES_NO_QD switch, which it reads when it
    traces them."""
    pos, pkw, caps, jm, tm = rod_models
    for route, m_on in tm.items():
        m_off = AGBNPModel(AGBNPParams(**pkw), device="cpu", caps=caps,
                           positions=pos, share_qd=False,
                           pair_tiles=m_on.pair_tiles or False, **MODEL_KW)
        e_on, f_on = m_on.energy_forces(pos)
        e_off, f_off = m_off.energy_forces(pos)
        assert abs(float(e_off) - float(e_on)) <= TOL * abs(float(e_on))
        assert_close(f_off, f_on, f"{route}: sharing off vs on")
    s_factor = np.random.default_rng(3).uniform(0.3, 1.0, N)
    monkeypatch.setenv("AGBNP_TILES_NO_QD", "1")
    out_j = _pair_phases_pallas(jm.arrays, j(pos), 1.0, None, jm.pair_pad,
                                True, horizon=1.0,
                                pair_tiles=jm.pair_tiles)(j(s_factor))
    m = tm["lists"]
    out_t = _pair_phases_kernel(m.arrays, t(pos), t(s_factor), 1.0, None,
                                m.pair_pad, horizon=1.0,
                                pair_tiles=m.pair_tiles, share_qd=False)
    assert set(out_t) == set(out_j)
    np.testing.assert_array_equal(out_t.pop("tile_counts").numpy(),
                                  np.asarray(out_j.pop("tile_counts")))
    for k, v in out_t.items():
        assert_close(v, out_j[k], k, tol=1e-10)
