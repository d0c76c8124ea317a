"""The port's three pair sweeps (plain twins on the CPU) against the JAX
package's Pallas kernels run in interpret mode, f64, on the 264-atom fixture.

The JAX side takes the non-split f64 spline tables of its prepare_arrays;
the port takes the same dict through arrays_from_numpy, which derives its
radius-type ids and [Ti, Tj, NA] tables from it.  Only the summation order
differs, so the bar is 1e-12 relative to the largest output entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.ops.pallas import pairs as JPK
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import arrays_from_numpy
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

torch.set_num_threads(2)

TOL = 1e-12
TILE = 128


def assert_close(port, ref, what):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(port - ref).max() / scale
    assert err <= TOL, f"{what}: {err:.3e}"


@pytest.fixture(scope="module")
def layouts(gaussvol_system):
    """Shared inputs in both packages' pair layouts (seeded numpy)."""
    params, pos = gaussvol_system
    n = params.n
    npad = JPK.pad_to(n, TILE)
    aj = jax_prepare_arrays(params, dtype=np.float64, pair_pad=npad,
                            positions=pos)
    at = arrays_from_numpy(aj, "cpu", torch.float64)
    rng = np.random.default_rng(7)
    rperm, hids = aj["rperm"], aj["hids_pad"]
    nhpad = hids.shape[0]
    hvalid = hids >= 0
    pos_pad = np.zeros((3, npad))
    pos_pad[:, :n] = pos[rperm].T
    pos_h = np.zeros((3, nhpad))
    pos_h[:, hvalid] = pos[hids[hvalid]].T
    s_h = np.where(hvalid, rng.uniform(0.3, 1.0, nhpad), 0.0)
    born = np.zeros(npad)
    born[:n] = rng.uniform(0.12, 0.45, n)
    sig = np.zeros(npad)
    sig[:n] = rng.uniform(0.2, 0.4, n)
    epsq = np.zeros(npad)
    epsq[:n] = rng.uniform(0.1, 0.9, n)
    # symmetric random exclusion lists (permuted-row ids, -1 padded)
    e_max = 24
    lists = [set() for _ in range(n)]
    for i in range(n):
        for j in rng.choice(n, 6, replace=False):
            if j != i and len(lists[i]) < e_max and len(lists[j]) < e_max:
                lists[i].add(int(j))
                lists[j].add(i)
    excl = np.full((npad, e_max), -1, np.int32)
    for i, l in enumerate(lists):
        excl[i, :len(l)] = sorted(l)
    brw = np.zeros(npad)
    brw[:n] = rng.normal(0.0, 5.0, n)
    bru = np.zeros(npad)
    bru[:n] = rng.normal(0.0, 50.0, n)
    return dict(n=n, aj=aj, at=at, pos_pad=pos_pad, pos_h=pos_h, s_h=s_h,
                born=born, sig=sig, epsq=epsq, excl=excl, brw=brw, bru=bru)


def t(x):
    return torch.as_tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


@pytest.mark.parametrize("box", [
    None, (3.1, 2.9, 3.3), ((3.1, 0.0, 0.0), (0.4, 2.9, 0.0), (0.3, -0.2, 3.3))],
    ids=["nobox", "ortho", "triclinic"])
@pytest.mark.parametrize("horizon", [None, 1.0])
def test_born_sums_and_descreening_match_pallas(layouts, horizon, box):
    L = layouts
    aj, at, n = L["aj"], L["at"], L["n"]
    box_j = None if box is None else tuple(np.ravel(box).tolist())
    raw_j, q_j, dq_j = JPK.born_sums(
        j(L["pos_pad"]), j(L["pos_h"]), j(aj["hids_perm_pad"]),
        j(aj["rowY_pad"]), j(aj["cols_oh_hpad"]), j(L["s_h"]), n, TILE,
        box=box_j, interpret=True, horizon=horizon, save_qd=True)
    box_t = None if box is None else torch.tensor(box, dtype=torch.float64)
    args = (t(L["pos_pad"]), t(L["pos_h"]), at["hids_perm_pad"],
            at["type_rows_pad"], at["type_cols_hpad"], at["ytab"],
            at["y2tab"], t(L["s_h"]), n)
    raw, q, dq = PK.born_sums(*args, box=box_t, horizon=horizon,
                              save_qd=True)
    assert_close(raw, raw_j, "raw")
    assert_close(q, q_j, "Q")
    assert_close(dq, dq_j, "dQ")
    # on CPU tensors the wrapper is the plain twin, and launches nothing
    ref = PK.born_sums_reference(*args, box=box_t, horizon=horizon,
                                 save_qd=True)
    assert all(torch.equal(x, y) for x, y in zip((raw, q, dq), ref))
    assert PK.launch_counts()["born_sums"] == 0

    w_j, u_j, fr_j, fc_j = JPK.descreening(
        j(L["pos_pad"]), j(L["pos_h"]), j(aj["hids_perm_pad"]),
        j(aj["rowY_pad"]), j(aj["cols_oh_hpad"]), j(L["s_h"]),
        j(L["brw"]), j(L["bru"]), n, TILE, box=box_j, interpret=True,
        horizon=horizon, qd=(q_j, dq_j))
    w, u, fr, fc = PK.descreening(t(L["pos_pad"]), t(L["pos_h"]),
                                  t(L["s_h"]), t(L["brw"]), t(L["bru"]),
                                  (q, dq), box=box_t)
    for name, x, y in (("W", w, w_j), ("U", u, u_j), ("f_rows", fr, fr_j),
                       ("f_cols", fc, fc_j)):
        assert_close(x, y, name)
    assert PK.launch_counts()["descreening"] == 0


@pytest.mark.parametrize("cutoff,with_mm", [(None, False), (1.0, False),
                                            (1.0, True), (None, True)])
def test_gb_pair_matches_pallas(layouts, cutoff, with_mm):
    L = layouts
    aj, n = L["aj"], L["n"]
    mm_j = {}
    mm_t = {}
    if with_mm:
        mm_j = dict(sig_pad=j(L["sig"]), epsq_pad=j(L["epsq"]),
                    excl_rows_pad=j(L["excl"]))
        mm_t = dict(sig_pad=t(L["sig"]), epsq_pad=t(L["epsq"]),
                    excl_rows_pad=t(L["excl"]))
    out_j = JPK.gb_pair(j(L["pos_pad"]), j(aj["charge_pad"]), j(L["born"]),
                        n, TILE, cutoff=cutoff, interpret=True, **mm_j)
    out = PK.gb_pair(t(L["pos_pad"]), t(aj["charge_pad"]), t(L["born"]), n,
                     cutoff=cutoff, **mm_t)
    for name, x, y in zip(("erow", "yrow", "force"), out[:3], out_j[:3]):
        assert_close(x, y, name)
    if with_mm:
        assert_close(out[3], out_j[3], "mmrow")
    else:
        assert out[3] is None and out_j[3] is None
    assert PK.launch_counts()["gb_pair"] == 0
    # what gb_pair launches on a card: the list sweep over every tile pair
    # ti <= tj; its twin against the same Pallas kernel
    npad = L["pos_pad"].shape[1]
    tl, nv = TL.triangular_grid_list(npad // TILE, torch.device("cpu"))
    out_l = TL.gb_pair_tiles_reference(
        nv, tl, t(L["pos_pad"]), t(aj["charge_pad"]), t(L["born"]), n, TILE,
        cutoff=cutoff, **mm_t)
    for name, x, y in zip(("erow", "yrow", "force", "mmrow"), out_l, out_j):
        if y is not None:
            assert_close(x, y, f"list {name}")


def _gb_layout(name, gaussvol_system):
    """GB sweep inputs in f64 from numpy seeds: (pos_pad, charge, born, sig,
    epsq, excl, n, tile) at NP 256 (the fixture's first 250 atoms, two
    tiles of 128), NP 384 (the fixture) and NP 1536 (1li2, six tiles of
    256)."""
    import os

    from openmm_agbnp_plugin_tpu_torch import load_dms

    if name == "1li2":
        pos = load_dms(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "benchmarks", "data",
            "1li2_agbnp1.dms")).positions
    else:
        pos = gaussvol_system[1][:250 if name == "np256" else None]
    n = pos.shape[0]
    tile = PK.pick_tile(n)
    npad = PK.pad_to(n, tile)
    rng = np.random.default_rng(17)

    def rows(lo, hi):
        x = np.zeros(npad)
        x[:n] = rng.uniform(lo, hi, n)
        return x

    pos_pad = np.zeros((3, npad))
    pos_pad[:, :n] = np.asarray(pos, np.float64).T
    # chain neighbours excluded, as a bonded topology would
    excl = np.full((npad, 8), -1, np.int32)
    for k in range(1, 5):
        excl[:n - k, 2 * k - 2] = np.arange(k, n)
        excl[k:n, 2 * k - 1] = np.arange(n - k)
    return (t(pos_pad), t(rows(-0.8, 0.8)), t(rows(0.12, 0.45)),
            t(rows(0.2, 0.4)), t(rows(0.1, 0.9)), t(excl), n, tile)


GB_BOXES = {"nobox": None, "ortho": (4.0, 4.2, 4.4),
            "triclinic": ((4.0, 0.0, 0.0), (0.6, 4.2, 0.0),
                          (0.4, -0.3, 4.4))}


@pytest.mark.parametrize("box,with_mm", [
    ("nobox", True), ("nobox", False), ("ortho", True), ("triclinic", True)],
    ids=["nobox-mm", "nobox-no_mm", "ortho-mm", "triclinic-mm"])
@pytest.mark.parametrize("cutoff", [None, 1.0], ids=["nocutoff", "1nm"])
@pytest.mark.parametrize("name", ["np256", "np384", "1li2"])
def test_dense_gb_pair_is_the_list_sweep_over_every_tile_pair(
        gaussvol_system, name, cutoff, box, with_mm):
    """The dense GB sweep on a card runs the list kernel over
    triangular_grid_list: that list through the list sweep's twin (each
    unordered pair once, deposited on both sides) against gb_pair's twin
    (the full square, row sums), f64, 1e-12 of the largest entry: the same
    pairs in another summation order.  Also with the kernel's own sub-tile
    pruning (subtile_live at the cutoff): it drops nothing the mask
    accepts."""
    pos_pad, charge, born, sig, epsq, excl, n, tile = _gb_layout(
        name, gaussvol_system)
    npad = pos_pad.shape[1]
    kw = dict(cutoff=cutoff,
              box=None if GB_BOXES[box] is None else torch.tensor(
                  GB_BOXES[box], dtype=torch.float64))
    if with_mm:
        kw.update(sig_pad=sig, epsq_pad=epsq, excl_rows_pad=excl)
    ref = PK.gb_pair_reference(pos_pad, charge, born, n, **kw)
    tl, nv = TL.triangular_grid_list(npad // tile, torch.device("cpu"))
    nt = npad // tile
    assert tuple(tl.shape) == (2, nt * (nt + 1) // 2) and int(nv[0]) == \
        tl.shape[1]
    assert bool((tl[0] <= tl[1]).all())
    assert len({(int(a), int(b)) for a, b in tl.T}) == tl.shape[1]
    valid = torch.arange(npad) < n
    keep = TL.subtile_live(nv, tl, pos_pad, valid, pos_pad, valid, tile,
                           cutoff, box=kw["box"], triangular=True)
    if cutoff is None:
        # nothing is pruned but what holds no pair at all
        s = tile // TL.SUB
        assert int(keep.sum()) >= tl.shape[1] * s * (s - 1) // 2 - 2 * s * nt
    for kp in (None, keep):
        out = TL.gb_pair_tiles_reference(nv, tl, pos_pad, charge, born, n,
                                         tile, keep=kp, **kw)
        for what, x, y in zip(("erow", "yrow", "force", "mmrow"), out, ref):
            if y is None:
                assert x is None
            else:
                assert_close(x, y, f"{what} keep={kp is not None}")
    assert PK.launch_counts()["gb_pair"] == 0
