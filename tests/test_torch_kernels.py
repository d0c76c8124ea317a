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
    assert PK.born_sums.launches == 0

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
    assert PK.descreening.launches == 0


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
    assert PK.gb_pair.launches == 0
