"""The sub-tile pruning and exclusion bit masks of the GB and descreening
list kernels, through their torch mirrors, in f32 (the kernels' type).

The kernels visit only the 32x32 sub-tile pairs of a list entry that
tiles.subtile_live keeps, and test exclusions as bits of the masks that
tiles.exclusion_bits mirrors.  On the rod of tests/test_torch_tiles.py and
on 1li2 (real positions, types and exclusion lists), with no box, an
orthorhombic and a triclinic box, for the Born/descreening list at horizons
1 and 2 nm and the GB list at cutoff 1 nm, built as the model builds them:

  * subtile_live never drops a pair that the twin's own mask accepts;
  * the twin restricted to the kept sub-tile pairs equals the twin bit for
    bit, and the Born twin's Q/dQ are zero outside them (the Born kernel
    writes Q/dQ only inside);
  * the exclusion bits hold the same excluded set as the E-wide scan;
  * column_groups splits a short list into enough warps for the card;
  * on the sparse layout of tests/test_torch_cuda.py, where the kernels'
    own pruning is checked on the card, dropping any one live sub-tile
    pair moves the twin's outputs far beyond the kernels' tolerance.
"""

import os

import numpy as np
import pytest
import torch
from test_torch_tiles import BOXES as ROD_BOXES
from test_torch_cuda import SPARSE_BOXES, sparse_layout
from test_torch_tiles import layouts, rod_models  # noqa: F401  (fixtures)

from openmm_agbnp_plugin_tpu_torch import AGBNPParams, load_dms
from openmm_agbnp_plugin_tpu_torch.md.forces import MMForceField
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
    arrays_from_numpy, prepare_arrays)
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

torch.set_num_threads(2)

F32 = torch.float32
LI2 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "1li2_agbnp1.dms")
LI2_BOXES = {"nobox": None, "ortho": (4.0, 4.2, 4.4),
             "triclinic": ((4.0, 0.0, 0.0), (0.6, 4.2, 0.0),
                           (0.4, -0.3, 4.4))}
# (list, range): the Born/descreening list at horizon 1 and 2 nm (None:
# the 2 nm table horizon), the triangular GB list at cutoff 1 nm
SWEEPS = {"born_h1": ("born", 1.0), "born_h2": ("born", None),
          "gb_c1": ("gb", 1.0)}


def f32(x):
    return torch.as_tensor(np.asarray(x)).to(F32)


@pytest.fixture(scope="module")
def rod(layouts):  # noqa: F811
    L = layouts
    at = L["at"]
    return dict(
        n=int(L["rvalid"].sum()), tile=128, boxes=ROD_BOXES,
        pos_pad=f32(L["pos_pad"]), pos_h=f32(L["pos_h"]),
        rvalid=torch.as_tensor(L["rvalid"]),
        hvalid=torch.as_tensor(L["hvalid"]), s_h=f32(L["s_h"]),
        charge=f32(L["aj"]["charge_pad"]), born=f32(L["born"]),
        mm=dict(sig_pad=f32(L["sig"]), epsq_pad=f32(L["epsq"]),
                excl_rows_pad=torch.as_tensor(L["excl"])),
        brw=f32(L["brw"]), bru=f32(L["bru"]),
        spline=(at["hids_perm_pad"], at["type_rows_pad"],
                at["type_cols_hpad"], at["ytab"].to(F32),
                at["y2tab"].to(F32)))


@pytest.fixture(scope="module")
def li2():
    """1li2 in the list kernels' layouts (as chip_smoke.py builds them):
    real positions, types, tables and OPLS exclusion rows; screening
    factors, Born radii and chain factors from a seed."""
    d = load_dms(LI2)
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    n = p.n
    tile = PK.pick_tile(n)
    npad = PK.pad_to(n, tile)
    an = prepare_arrays(p, dtype=np.float32, pair_pad=npad,
                        positions=d.positions,
                        pairs=(np.zeros(1, np.int32),) * 2)
    a = arrays_from_numpy(an, "cpu", F32)
    rng = np.random.default_rng(3)
    pos = f32(d.positions)
    pos_pad = torch.nn.functional.pad(pos[a["rperm"]],
                                      (0, 0, 0, npad - n)).T.contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    pos_h = (pos[hids.clamp(min=0)] * hvalid[:, None]).T.contiguous()
    er = MMForceField.from_dms(d, dtype=np.float32).excl_rows()
    rinv = an["rinv"]
    excl = np.full((npad, er.shape[1]), -1, np.int32)
    excl[:n] = np.where(er >= 0, rinv[np.clip(er, 0, None)], -1)[an["rperm"]]
    rvalid = torch.arange(npad) < n

    def rand(lo, hi, mask):
        return torch.where(mask, f32(rng.uniform(lo, hi, mask.shape[0])),
                           0.0)

    return dict(
        n=n, tile=tile, boxes=LI2_BOXES, pos_pad=pos_pad, pos_h=pos_h,
        rvalid=rvalid, hvalid=hvalid, s_h=rand(0.3, 1.0, hvalid),
        charge=a["charge_pad"], born=rand(0.12, 0.45, rvalid),
        mm=dict(sig_pad=rand(0.2, 0.4, rvalid),
                epsq_pad=rand(0.1, 0.9, rvalid),
                excl_rows_pad=torch.as_tensor(excl)),
        brw=rand(-5.0, 5.0, rvalid), bru=rand(-50.0, 50.0, rvalid),
        spline=(a["hids_perm_pad"], a["type_rows_pad"], a["type_cols_hpad"],
                a["ytab"], a["y2tab"]))


def model_list(C, kind, rng_dist, box):
    """The list as _pair_phases_kernel builds it (budget = count + 3, so
    entries past nv are there too), and its subtile_live flags."""
    tile = C["tile"]
    rb = TL.tile_bounds(C["pos_pad"], C["rvalid"], tile)
    if kind == "gb":
        cols = (C["pos_pad"], C["rvalid"])
        args = (*rb, *rb, rng_dist)
    else:
        cols = (C["pos_h"], C["hvalid"])
        args = (*rb, *TL.tile_bounds(*cols, tile), PK._horizon(rng_dist))
    tri = kind == "gb"
    count = int(TL.build_tile_list(*args, 1, triangular=tri, box=box)[2])
    tl, nv, _ = TL.build_tile_list(*args, count + 3, triangular=tri, box=box)
    keep = TL.subtile_live(nv, tl, C["pos_pad"], C["rvalid"], *cols, tile,
                           args[-1], box=box, triangular=tri)
    return nv, tl, keep


def twin_mask(C, kind, rng_dist, box, nv, tl):
    """The pair mask of the sweep's twin over every list entry: GB's
    gi < gj < n within the cutoff, the Born sweep's (where it writes the
    Q/dQ that descreening reloads) for Born and descreening."""
    rows, cols, live = TL._entries(nv, tl, C["tile"])
    gi, gj = rows[:, :, None], cols[:, None, :]
    if kind == "gb":
        _, _, _, d2 = PK._pair_geom(C["pos_pad"][:, rows],
                                    C["pos_pad"][:, cols], box)
        return (gi < gj) & (gj < C["n"]) & live & (d2 < rng_dist ** 2)
    _, _, _, d2 = PK._pair_geom(C["pos_pad"][:, rows], C["pos_h"][:, cols],
                                box)
    hids, trow, tcol, yv, y2v = C["spline"]
    _, _, mask = PK._born_qdq(torch.sqrt(d2), gi, hids.long()[cols][:, None],
                              C["n"], rng_dist, trow.long()[rows][:, :, None],
                              tcol.long()[cols][:, None, :], yv, y2v)
    return mask & live


def box_of(C, name):
    box = C["boxes"][name]
    return None if box is None else torch.tensor(box, dtype=F32)


def cases():
    return [pytest.param(sys_, box, sweep, id=f"{sys_}-{box}-{sweep}")
            for sys_ in ("rod", "li2") for box in ("nobox", "ortho",
                                                   "triclinic")
            for sweep in SWEEPS]


@pytest.mark.parametrize("system,box,sweep", cases())
def test_subtile_live_keeps_every_live_pair(request, system, box, sweep):
    C = request.getfixturevalue(system)
    kind, rng_dist = SWEEPS[sweep]
    box = box_of(C, box)
    nv, tl, keep = model_list(C, kind, rng_dist, box)
    s = C["tile"] // TL.SUB
    assert keep.shape == (tl.shape[1], s, s) and not keep[int(nv[0]):].any()
    mask = twin_mask(C, kind, rng_dist, box, nv, tl)
    dropped = mask & ~TL._expand_subtiles(keep)
    assert not dropped.any(), f"{int(dropped.sum())} live pairs dropped"
    # the pruning does drop sub-tile pairs of listed entries
    assert int(keep.sum()) < int(nv[0]) * s * s


@pytest.mark.parametrize("system,box,sweep", cases())
def test_pruned_twin_equals_twin_bitwise(request, system, box, sweep):
    C = request.getfixturevalue(system)
    kind, rng_dist = SWEEPS[sweep]
    box = box_of(C, box)
    nv, tl, keep = model_list(C, kind, rng_dist, box)
    tile = C["tile"]
    if kind == "gb":
        args = (nv, tl, C["pos_pad"], C["charge"], C["born"], C["n"], tile)
        outs = [TL.gb_pair_tiles_reference(*args, box=box, cutoff=rng_dist,
                                           keep=k, **C["mm"])
                for k in (None, keep)]
    else:
        sp = PK.SplineArgs(*C["spline"], C["n"], rng_dist)
        _, q, dq = TL.born_sums_tiles_reference(
            nv, tl, C["pos_pad"], C["pos_h"], *C["spline"], C["s_h"],
            C["n"], tile, box=box, horizon=rng_dist, save_qd=True)
        args = (nv, tl, C["pos_pad"], C["pos_h"], C["s_h"], C["brw"],
                C["bru"])
        outs = [TL.descreening_tiles_reference(*args, qd, tile, box=box,
                                               spline=spl, keep=k)
                for qd, spl in (((q, dq), None), (None, sp))
                for k in (None, keep)]
    for full, pruned in zip(outs[::2], outs[1::2]):
        for x, y in zip(full, pruned):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


def born_cases():
    return [pytest.param(sys_, box, horizon,
                         id=f"{sys_}-{box}-h{horizon or 2.0:g}")
            for sys_ in ("rod", "li2") for box in ("nobox", "ortho",
                                                   "triclinic")
            for horizon in (1.0, None)]


@pytest.mark.parametrize("system,box,horizon", born_cases())
def test_pruned_born_twin_equals_twin_bitwise(request, system, box,
                                              horizon):
    """The Born kernel writes Q/dQ only inside the sub-tile pairs it keeps
    (subtile_live at the horizon, the list's range): the twin restricted to
    them gives the same raw sums and the same Q/dQ there, bit for bit, and
    the unrestricted twin's Q/dQ are exactly zero everywhere else."""
    C = request.getfixturevalue(system)
    box = box_of(C, box)
    nv, tl, keep = model_list(C, "born", horizon, box)
    s = C["tile"] // TL.SUB
    assert int(keep.sum()) < int(nv[0]) * s * s
    args = (nv, tl, C["pos_pad"], C["pos_h"], *C["spline"], C["s_h"],
            C["n"], C["tile"])
    kw = dict(box=box, horizon=horizon, save_qd=True)
    raw, q, dq = TL.born_sums_tiles_reference(*args, **kw)
    raw_k, q_k, dq_k = TL.born_sums_tiles_reference(*args, keep=keep, **kw)
    kept = TL._expand_subtiles(keep)
    assert torch.equal(raw_k, raw)
    for full, pruned in ((q, q_k), (dq, dq_k)):
        assert torch.equal(pruned[kept], full[kept])
        assert not full[~kept].any() and not pruned[~kept].any()
    assert q[kept].any()


@pytest.mark.parametrize("ng", [1, 2, 4, 8])
def test_keep_flags_read_the_kernel_layout(li2, ng):
    """keep_flags decodes the keep bits the list kernels write (bit b of
    keep[l, a, g], g the column group of b) into subtile_live's flags, and
    ignores whatever lies past nv."""
    nv, tl, live = model_list(li2, "born", 1.0, None)
    lmax, s, _ = live.shape
    b = torch.arange(s)
    bits = live.long() << b
    keep = torch.stack([bits[:, :, b // (s // ng) == g].sum(dim=2)
                        for g in range(ng)], dim=2).to(torch.int32)
    keep[int(nv[0]):] = -1
    assert torch.equal(TL.keep_flags(keep, nv), live)


@pytest.mark.parametrize("system", ["rod", "li2"])
def test_exclusion_bits_match_the_scan(request, system):
    C = request.getfixturevalue(system)
    tile = C["tile"]
    nv, tl, _ = model_list(C, "gb", 1.0, None)
    excl = C["mm"]["excl_rows_pad"]
    bits = TL.exclusion_bits(excl, tl, tile)
    s = tile // TL.SUB
    assert bits.shape == (tl.shape[1], tile, s)
    c = torch.arange(tile)
    got = ((bits[:, :, c // TL.SUB] >> (c % TL.SUB)) & 1).bool()
    rows, cols, _ = TL._entries(nv, tl, tile)
    ex = excl.long()[rows]
    want = torch.zeros_like(got)
    for e in range(ex.shape[2]):
        want |= ex[:, :, e:e + 1] == cols[:, None, :]
    assert torch.equal(got, want)
    assert int(want.sum()) > 0


def test_model_lists_keep_every_live_pair(rod_models):  # noqa: F811
    """At the rod model's own budgets and ranges (horizon and cutoff
    1 nm), on its arrays, both lists keep every live pair."""
    pos, _, _, _, tm = rod_models
    m = tm["lists"]
    a, n, npad = m.arrays, m.params.n, m.pair_pad
    p = f32(pos)
    hv = a["hids_pad"] >= 0
    C = dict(n=n, tile=PK.pick_tile(n),
             pos_pad=torch.nn.functional.pad(
                 p[a["rperm"]], (0, 0, 0, npad - n)).T.contiguous(),
             pos_h=(p[a["hids_pad"].clamp(min=0)] * hv[:, None]).T
             .contiguous(),
             rvalid=torch.arange(npad) < n, hvalid=hv,
             spline=(a["hids_perm_pad"], a["type_rows_pad"],
                     a["type_cols_hpad"], a["ytab"].to(F32),
                     a["y2tab"].to(F32)))
    for kind, budget in zip(("born", "gb"), m.pair_tiles):
        nv, tl, keep = model_list(C, kind, 1.0, None)
        assert int(nv[0]) <= budget
        mask = twin_mask(C, kind, 1.0, None, nv, tl)
        assert mask.any()
        assert not (mask & ~TL._expand_subtiles(keep)).any()


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("lmax", [1, 8, 18, 21, 64, 300, 1000, 5000])
def test_column_groups_fill_the_card(monkeypatch, tile, lmax):
    """The least power of two, at most T / 32, that gives every SM the
    descreening kernel's warps: 1li2's short list is cut into single
    sub-tiles."""
    sms = 132  # an H100 SXM
    monkeypatch.setattr(TL, "_sm_count", lambda dev: sms)
    s = tile // TL.SUB
    ng = TL.column_groups(lmax, tile, "cuda")
    want = TL.DS_WARPS_PER_SM * sms
    assert ng & (ng - 1) == 0 and 1 <= ng <= s
    assert ng == s or lmax * s * ng >= want
    assert ng == 1 or lmax * s * (ng // 2) < want
    if lmax <= 21 and tile == 256:
        assert ng == s


@pytest.mark.parametrize("box", list(SPARSE_BOXES))
@pytest.mark.parametrize("kind", ["gb", "born"])
def test_sparse_layout_shows_any_dropped_pair(li2, kind, box):
    """The layout on which test_torch_cuda.py holds the kernels' own
    pruning against the unpruned twins: its live pairs are the constructed
    ones, each within 1e-3 nm of the range and across two sub-tiles;
    subtile_live keeps them; and dropping any one kept sub-tile pair that
    holds one moves the twin's outputs by over 100x the kernels' 1e-5."""
    L = sparse_layout(kind, box, *li2["spline"][3:])
    C = dict(L, spline=tuple(L["spline"][:5]))
    box = box_of(dict(boxes=SPARSE_BOXES), box)
    rng_dist, tile = L["range"], L["tile"]
    nv, tl, keep = model_list(C, kind, rng_dist, box)
    mask = twin_mask(C, kind, rng_dist, box, nv, tl)
    rows, cols, _ = TL._entries(nv, tl, tile)
    l, r, c = mask.nonzero(as_tuple=True)
    live = torch.stack([rows[l, r], cols[l, c]], 1)
    assert sorted(live.tolist()) == sorted(L["pairs"].tolist())
    d2 = PK._pair_geom(L["pos_pad"][:, live[:, 0]],
                       L["pos_h"][:, live[:, 1]], box)[3]
    d = torch.sqrt(torch.diagonal(d2))
    assert bool(((d > rng_dist - 1e-3) & (d < rng_dist)).all())
    if kind == "gb":
        assert bool((live[:, 0] // TL.SUB != live[:, 1] // TL.SUB).all())
    assert not (mask & ~TL._expand_subtiles(keep)).any()

    if kind == "gb":
        args = (nv, tl, L["pos_pad"], L["charge"], L["born"], L["n"], tile)

        def twin(k):
            return TL.gb_pair_tiles_reference(*args, box=box,
                                              cutoff=rng_dist, keep=k,
                                              **L["mm"])
    else:
        _, q, dq = TL.born_sums_tiles_reference(
            nv, tl, L["pos_pad"], L["pos_h"], *C["spline"], L["s_h"],
            L["n"], tile, box=box, horizon=rng_dist, save_qd=True)
        dargs = (nv, tl, L["pos_pad"], L["pos_h"], L["s_h"], L["brw"],
                 L["bru"])

        def twin(k):
            return TL.descreening_tiles_reference(*dargs, (q, dq), tile,
                                                  box=box, keep=k)
    full = twin(keep)
    for (li, ri, ci) in zip(l.tolist(), r.tolist(), c.tolist()):
        dropped = keep.clone()
        dropped[li, ri // TL.SUB, ci // TL.SUB] = False
        moved = max(float((x - y).abs().max() / y.abs().max())
                    for x, y in zip(twin(dropped), full) if y is not None)
        assert moved > 100 * 1e-5
