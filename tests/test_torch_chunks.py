"""The dense Born and descreening sweeps' chunk list and chunk walks
(ops/kernels/pairs.py: subtile_columns, born_sums_chunks_reference,
descreening_chunks_reference) against the dense twins and the JAX
package's Pallas kernels in interpret mode.

On the card the dense sweeps walk, for each 32-row sub-tile, only the heavy
columns its chunk list names, in chunks of 32, and keep Q/dQ in the chunk
layout [NP / 32, NHP, 32].  The torch mirrors of those walks are checked
here on the 264-atom fixture (NP 384), its first 250 atoms (NP 256) and
1li2 (NP 1536, NHP 768), at horizons 1 and 2 nm, with no box, an
orthorhombic and a triclinic one:

  * the chunk list (f32, the kernels' type) lists every pair the Born mask
    accepts, in ascending order, and its bits name the same columns;
  * the chunk walks equal the dense twins in f64 within 1e-12 of the
    largest entry (another summation order), and the dense twin's Q/dQ are
    zero off the list;
  * the chunk walks match the Pallas kernels born_sums and descreening
    (reloading and with qd=None) run in interpret mode, within 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import (  # noqa: F401  (fixtures)
    SPARSE_BOXES, fixture_system, sparse_layout, spline_tables)
from test_torch_kernels import GB_BOXES

from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.models.oracle import AGBNPParams as JaxParams
from openmm_agbnp_plugin_tpu.ops.pallas import pairs as JPK
from openmm_agbnp_plugin_tpu_torch import load_dms
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import arrays_from_numpy
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

torch.set_num_threads(2)

TOL = 1e-12
LI2 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "1li2_agbnp1.dms")
HORIZONS = [1.0, None]


def assert_close(port, ref, what, tol=TOL):
    port = np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    err = np.abs(port - ref).max() / scale
    assert err <= tol, f"{what}: {err:.3e}"


def t(x):
    return torch.as_tensor(np.asarray(x))


def j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(scope="module", params=["np256", "np384", "1li2"])
def layout(request, gaussvol_system):
    """Born and descreening inputs in both packages' layouts, f64: real
    positions, radius types and tables (the JAX package's prepare_arrays,
    through arrays_from_numpy for the port), screening factors and chain
    factors from a numpy seed.  np256: the fixture's first 250 atoms (two
    tiles of 128); np384: the fixture; 1li2: six tiles of 256."""
    if request.param == "1li2":
        d = load_dms(LI2)
        params = JaxParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                           alpha=d.agbnp_alpha, charge=d.charges,
                           ishydrogen=d.ishydrogen)
        pos = np.asarray(d.positions, np.float64)
    else:
        p, pos = gaussvol_system
        k = 250 if request.param == "np256" else p.n
        params = JaxParams(radius=p.radius[:k], gamma=p.gamma[:k],
                           alpha=p.alpha[:k], charge=p.charge[:k],
                           ishydrogen=p.ishydrogen[:k])
        pos = np.asarray(pos[:k], np.float64)
    n = params.n
    tile = PK.pick_tile(n)
    npad = PK.pad_to(n, tile)
    aj = jax_prepare_arrays(params, dtype=np.float64, pair_pad=npad,
                            positions=pos)
    at = arrays_from_numpy(aj, "cpu", torch.float64)
    rng = np.random.default_rng(23)
    hids = aj["hids_pad"]
    nhpad = hids.shape[0]
    hvalid = hids >= 0
    pos_pad = np.zeros((3, npad))
    pos_pad[:, :n] = pos[aj["rperm"]].T
    pos_h = np.zeros((3, nhpad))
    pos_h[:, hvalid] = pos[hids[hvalid]].T

    def rows(scale):
        x = np.zeros(npad)
        x[:n] = rng.normal(0.0, scale, n)
        return x

    return dict(name=request.param, n=n, tile=tile, aj=aj, at=at,
                pos_pad=pos_pad, pos_h=pos_h,
                s_h=np.where(hvalid, rng.uniform(0.3, 1.0, nhpad), 0.0),
                brw=rows(5.0), bru=rows(50.0))


def port_args(L, dtype=torch.float64):
    """born_sums' arguments in the port's layouts (as dtype) and a box
    maker."""
    at = L["at"]

    def f(x):
        return t(x).to(dtype)

    born = (f(L["pos_pad"]), f(L["pos_h"]), at["hids_perm_pad"],
            at["type_rows_pad"], at["type_cols_hpad"], at["ytab"].to(dtype),
            at["y2tab"].to(dtype), f(L["s_h"]), L["n"])
    desc = (f(L["pos_pad"]), f(L["pos_h"]), f(L["s_h"]), f(L["brw"]),
            f(L["bru"]))
    return born, desc


def box_of(name, dtype=torch.float64):
    box = GB_BOXES[name]
    return None if box is None else torch.tensor(box, dtype=dtype)


def listed(chunks, npad):
    """The chunk list as dense [NP, NHP] flags: (i, j) listed iff j is on
    the list of i's sub-tile."""
    cols, ncols = chunks.cols.long(), chunks.ncols.long()
    nsub, nhpad = cols.shape
    k = torch.arange(nhpad)
    on = k[None, :] < ncols[:, None]
    flags = torch.zeros((nsub, nhpad + 1), dtype=torch.bool)
    flags.scatter_(1, torch.where(on, cols, nhpad), on)
    return flags[:, :nhpad].repeat_interleave(PK.SUB, 0)[:npad]


def check_list(chunks, mask):
    """The chunk list's own invariants, and every pair of mask listed."""
    cols, ncols, bits = chunks
    nsub, nhpad = cols.shape
    assert cols.dtype == ncols.dtype == bits.dtype == torch.int32
    assert bits.shape == (nsub, nhpad // PK.SUB)
    for a in range(nsub):
        c = cols[a].tolist()
        m = int(ncols[a])
        assert c[:m] == sorted(set(c[:m])) and all(x >= 0 for x in c[:m])
        assert c[m:] == [-1] * (nhpad - m)
        word = [int(w) & 0xffffffff for w in bits[a]]
        assert sorted(c[:m]) == [jj for jj in range(nhpad)
                                 if word[jj // 32] >> (jj % 32) & 1]
    lst = listed(chunks, mask.shape[0])
    assert not bool((mask & ~lst).any()), "a live pair is off the list"
    return lst


@pytest.mark.parametrize("box", list(GB_BOXES))
@pytest.mark.parametrize("horizon", HORIZONS)
def test_chunk_list_keeps_every_born_pair(layout, horizon, box):
    """f32, the kernels' type: every pair the Born mask accepts is listed
    for its row's sub-tile; at 1 nm on 1li2 the list leaves columns out."""
    born, _ = port_args(layout, torch.float32)
    box = box_of(box, torch.float32)
    chunks = PK.subtile_columns(*born[:3], layout["n"], box=box,
                                horizon=horizon)
    mask = PK._born_qdq(
        torch.sqrt(PK._pair_geom(born[0], born[1], box)[3]),
        torch.arange(born[0].shape[1])[:, None], born[2].long()[None, :],
        layout["n"], horizon, born[3].long()[:, None],
        born[4].long()[None, :], born[5], born[6])[2]
    assert bool(mask.any())
    lst = check_list(chunks, mask)
    if layout["name"] == "1li2" and horizon == 1.0 and box == "nobox":
        assert int(lst.sum()) < 0.6 * lst.numel()
    assert PK.launch_counts()["subtile_columns"] == 0


@pytest.mark.parametrize("box", list(GB_BOXES))
@pytest.mark.parametrize("horizon", HORIZONS)
def test_chunk_walks_equal_the_dense_twins(layout, horizon, box):
    """f64: the Born walk's raw sums and chunk-layout Q/dQ, the reload from
    them and the recompute over the chunks against the dense twins; the
    CPU wrappers run the dense twins and read no list."""
    born, desc = port_args(layout)
    box = box_of(box)
    n = layout["n"]
    sp = PK.SplineArgs(*born[2:7], n, horizon)
    chunks = PK.subtile_columns(*born[:3], n, box=box, horizon=horizon)
    raw, q, dq = PK.born_sums_reference(*born, box=box, horizon=horizon,
                                        save_qd=True)
    check_list(chunks, q != 0)
    raw_c, q_c, dq_c = PK.born_sums_chunks_reference(chunks, *born, box=box,
                                                     horizon=horizon)
    assert_close(raw_c, raw, "raw")
    assert torch.equal(q_c, PK.chunk_layout(q, chunks))
    assert torch.equal(dq_c, PK.chunk_layout(dq, chunks))
    # off the walked chunks the walk holds nothing
    assert not bool(q_c[~PK.chunk_slots(chunks)].any())
    ref = PK.descreening_reference(*desc, (q, dq), box=box)
    for how, out in (
            ("reload", PK.descreening_chunks_reference(
                chunks, *desc, (q_c, dq_c), box=box)),
            ("recompute", PK.descreening_chunks_reference(
                chunks, *desc, None, box=box, spline=sp))):
        for name, x, y in zip(("W", "U", "f_rows", "f_cols"), out, ref):
            assert_close(x, y, f"{how} {name}")
    # the dense recompute (what the CPU wrapper runs) gives the same
    for name, x, y in zip(("W", "U", "f_rows", "f_cols"),
                          PK.descreening(*desc, None, box=box, spline=sp,
                                         chunks=chunks), ref):
        assert_close(x, y, f"dense recompute {name}")
    counts = PK.launch_counts()
    assert counts["born_sums"] == counts["descreening"] == \
        counts["descreening_recompute"] == counts["subtile_columns"] == 0


@pytest.mark.parametrize("box", list(GB_BOXES))
@pytest.mark.parametrize("horizon", HORIZONS)
def test_chunk_walks_match_pallas(layout, horizon, box):
    """The chunk walks against the JAX package's dense Born and
    descreening kernels (both variants) in interpret mode, f64."""
    L = layout
    aj, n, tile = L["aj"], L["n"], L["tile"]
    box_j = None if GB_BOXES[box] is None else tuple(
        np.ravel(GB_BOXES[box]).tolist())
    common = (j(L["pos_pad"]), j(L["pos_h"]), j(aj["hids_perm_pad"]),
              j(aj["rowY_pad"]), j(aj["cols_oh_hpad"]), j(L["s_h"]))
    raw_j, q_j, dq_j = JPK.born_sums(*common, n, tile, box=box_j,
                                     interpret=True, horizon=horizon,
                                     save_qd=True)
    born, desc = port_args(L)
    box_t = box_of(box)
    chunks = PK.subtile_columns(*born[:3], n, box=box_t, horizon=horizon)
    raw_c, q_c, dq_c = PK.born_sums_chunks_reference(
        chunks, *born, box=box_t, horizon=horizon)
    assert_close(raw_c, raw_j, "raw")
    assert_close(q_c, PK.chunk_layout(t(q_j), chunks), "Q")
    assert_close(dq_c, PK.chunk_layout(t(dq_j), chunks), "dQ")
    sp = PK.SplineArgs(*born[2:7], n, horizon)
    for how, qd_j, out in (
            ("reload", (q_j, dq_j), PK.descreening_chunks_reference(
                chunks, *desc, (q_c, dq_c), box=box_t)),
            ("recompute", None, PK.descreening_chunks_reference(
                chunks, *desc, None, box=box_t, spline=sp))):
        out_j = JPK.descreening(*common, j(L["brw"]), j(L["bru"]), n, tile,
                                box=box_j, interpret=True, horizon=horizon,
                                qd=qd_j)
        for name, x, y in zip(("W", "U", "f_rows", "f_cols"), out, out_j):
            assert_close(x, y, f"{how} {name}")


@pytest.mark.parametrize("box", list(SPARSE_BOXES))
def test_chunk_list_keeps_the_pairs_at_the_range(spline_tables, box):
    """f32 on the sparse layout of tests/test_torch_cuda.py: each live pair
    lies 2e-4 to 9e-4 nm inside 1 nm, joins two sub-tiles whose atoms lie
    on one line with it, and is its atoms' only pair, so the row sub-tile's
    box is exactly as far from the column as the pair's distance; with 100
    nm boxes (an ulp of 7.6e-6 nm) and pairs across the x and the
    triclinic c faces.  Every pair is listed, and the chunk walks equal
    the dense twins."""
    L = sparse_layout("born", box, *spline_tables)
    box = None if SPARSE_BOXES[box] is None else torch.tensor(
        SPARSE_BOXES[box], dtype=torch.float32)
    sp = L["spline"]
    born = (L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], L["n"])
    chunks = PK.subtile_columns(*born[:3], L["n"], box=box,
                                horizon=L["range"])
    raw, q, dq = PK.born_sums_reference(*born, box=box, horizon=L["range"],
                                        save_qd=True)
    lst = check_list(chunks, q != 0)
    assert bool(lst[L["pairs"][:, 0], L["pairs"][:, 1]].all())
    assert int((q != 0).sum()) == L["pairs"].shape[0]
    raw_c, q_c, _ = PK.born_sums_chunks_reference(
        chunks, *born, box=box, horizon=L["range"])
    assert torch.equal(q_c, PK.chunk_layout(q, chunks))
    assert_close(raw_c, raw, "raw", tol=1e-6)


@pytest.mark.parametrize("nhpad,warps", [
    (768, 16), (3328, 16), (256, 8), (128, 4), (32, 1), (96, 2)])
def test_chunk_warps(nhpad, warps):
    """A dense sweep's block takes the most warps it can use: a power of
    two, at most MAX_CHUNK_WARPS and the chunks a sub-tile can hold."""
    assert PK.chunk_warps(nhpad) == warps


@pytest.mark.parametrize("nhpad,parts", [
    (768, 2), (3328, 4), (384, 2), (256, 1), (32, 1), (96, 2)])
def test_chunk_parts(nhpad, parts):
    """A dense descreening sweep splits a sub-tile's chunks over as many
    blocks as its most chunks fill at chunk_warps warps a block, at most
    MAX_CHUNK_PARTS."""
    assert PK.chunk_parts(nhpad) == parts
    g = PK.chunk_warps(nhpad)
    assert parts == PK.MAX_CHUNK_PARTS or parts * g >= nhpad // PK.SUB
