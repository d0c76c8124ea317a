"""The port's batched AGBNP2 evaluation against the JAX package's vmapped
version 2 scorer, f64 on the CPU.

B = 3 poses (0.005 nm, numpy seed) of the fixture's first 40 atoms and of
trp-cage (272 atoms) through the port's ConformerScorer (one batched
evaluation: each pose's MS candidates found on the device, both overlap
trees over the poses' unions) and JAX's (api/scoring.py's vmapped
agbnp2_energy): energy, forces and the 7 detail terms to 1e-10 relative,
the [B, 18] overflow counts equal.  The batch also equals the port's own
per-pose evaluation (host MS candidates, a batch of one) to 1e-12, also
with the neighbor-bounded MS subtraction (ms_sub_k > 0), which equals the
dense one.  The row-blocked half neighbor list is bitwise the one-block
list, and the scorer's version 2 regrow is JAX's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu import AGBNPForce as JaxAGBNPForce
from openmm_agbnp_plugin_tpu.api.scoring import \
    ConformerScorer as JaxConformerScorer
from openmm_agbnp_plugin_tpu_torch import (AGBNPForce, AGBNPParams,
                                           ConformerScorer, load_dms,
                                           load_gaussvol_dat)
from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import \
    ms_candidate_pairs
from openmm_agbnp_plugin_tpu_torch.models.capacity import V2, v2_counts
from openmm_agbnp_plugin_tpu_torch.ops import neighbors as NB_MODULE
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import half_neighbor_pairs

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DMS = os.path.join(os.path.dirname(HERE), "benchmarks", "data",
                   "trpcage_agbnp1.dms")
NB = 3
JITTER = 0.005  # nm
PARITY = 1e-10  # relative, port vs JAX
SELF = 1e-12    # relative, the batch vs the port's per-pose evaluation
DETAILS = ("e_vol1", "e_vol2", "gb_self", "gb_pair", "e_vdw", "e_ms_vdw",
           "e_ms_large")
CASES = ("fixture40", "trpcage")


def _params(name):
    if name == "fixture40":
        pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
            os.path.join(HERE, "fixtures", "gaussvol.dat"))
        n = 40
        return AGBNPParams(radius=radius[:n], gamma=gamma[:n],
                           alpha=alpha[:n], charge=charge[:n],
                           ishydrogen=ish[:n]), pos[:n]
    d = load_dms(DMS)
    return AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                       alpha=d.agbnp_alpha, charge=d.charges,
                       ishydrogen=d.ishydrogen), np.asarray(d.positions)


def _force(params, cls):
    force = cls()
    force.setVersion(2)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


def rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module", params=CASES)
def scored(request):
    """Both scorers on the same poses: (name, params, poses, port scorer,
    port result, port counts [B, 18], JAX scorer, JAX result, JAX
    counts)."""
    name = request.param
    params, pos = _params(name)
    poses = pos[None] + JITTER * np.random.default_rng(12).standard_normal(
        (NB,) + pos.shape)
    jsc = JaxConformerScorer(_force(params, JaxAGBNPForce), pos,
                             dtype=np.float64)
    tsc = ConformerScorer(_force(params, AGBNPForce), pos,
                          dtype=torch.float64, device="cpu")
    jres = jsc.score(poses, forces=True, details=True)
    jout = jsc._v2_jit({k: jnp.asarray(v) for k, v in
                        jsc._model.arrays.items()},
                       jnp.asarray(poses, np.float64))
    tres = tsc.score(poses, forces=True, details=True)
    pairs = ms_candidate_pairs(torch.as_tensor(poses), tsc._heavy,
                               tsc._ms_rcut, tsc._ms_kmax_list)
    out = tsc.model.batched_energy_forces(poses, ms_pairs=pairs[:3])
    tcounts = v2_counts(out["diags"], pairs[3])
    return (name, params, poses, tsc, tres, tcounts, jsc, jres,
            np.asarray(jout["counts"]))


def test_batched_v2_matches_jax_scorer(scored):
    """Energy, forces and the 7 detail terms of every pose to 1e-10
    relative; the [B, 18] counts equal; the scorers' capacities equal."""
    name, params, poses, tsc, tres, tcounts, jsc, jres, jcounts = scored
    assert tres["energy"].shape == (NB,)
    assert tres["force"].shape == (NB, params.n, 3)
    assert rel(tres["energy"].numpy(), jres["energy"]) <= PARITY
    assert rel(tres["force"].numpy(), jres["force"]) <= PARITY
    for k in DETAILS:
        assert rel(tres[k].numpy(), jres[k]) <= PARITY, k
    np.testing.assert_array_equal(tcounts.numpy(), jcounts)
    assert tcounts.shape == (NB, 18) and int(tcounts[:, 14].min()) > 0
    m, jm = tsc.model, jsc._model
    assert (m.caps.caps, m.caps_ms.caps) == (tuple(jm.caps.caps),
                                            tuple(jm.caps_ms.caps))
    assert (m.cap_ms, m.ms_kmax, m.ms_sub_k, tsc._ms_kmax_list) == (
        jm.cap_ms, jm.ms_kmax, jm.ms_sub_k, jsc._ms_kmax_list)


def test_batch_equals_the_per_pose_evaluation(scored):
    """Each pose of the batch against the port's own evaluation of that
    pose alone (host MS candidates picked at it, a batch of one) at the
    scorer's capacities, to 1e-12: energy, forces, details."""
    name, params, poses, tsc, tres, *_ = scored
    m = tsc.model
    for b in range(NB):
        m.set_positions(poses[b])
        e, f, out = m.energy_forces(poses[b], with_details=True)
        assert abs(float(tres["energy"][b]) - float(e)) <= SELF * abs(
            float(e))
        assert rel(tres["force"][b].numpy(), f.numpy()) <= SELF
        for k in DETAILS:
            assert abs(float(tres[k][b]) - float(out["details"][k])) <= \
                SELF * max(abs(float(out["details"][k])), 1e-30), k


def test_bounded_ms_subtraction_batch():
    """ms_sub_k > 0 (the neighbor-bounded MS subtraction, as wide as the
    heavy atoms): the batched score equals the dense form's and each
    pose's own bounded evaluation to 1e-12; its subtraction lists report
    their widths in counts[:, 17]."""
    params, pos = _params("fixture40")
    poses = pos[None] + JITTER * np.random.default_rng(13).standard_normal(
        (NB,) + pos.shape)
    dense, bounded = (ConformerScorer(_force(params, AGBNPForce), pos,
                                      dtype=torch.float64, device="cpu")
                      for _ in range(2))
    nheavy = int((np.asarray(params.ishydrogen) == 0).sum())
    bounded.model.ms_sub_k = nheavy
    assert dense.model.ms_sub_k == 0
    rd = dense.score(poses, forces=True, details=True)
    rb = bounded.score(poses, forces=True, details=True)
    assert bounded.model.ms_sub_k == nheavy
    assert rel(rb["energy"].numpy(), rd["energy"].numpy()) <= SELF
    assert rel(rb["force"].numpy(), rd["force"].numpy()) <= SELF
    for k in DETAILS:
        assert rel(rb[k].numpy(), rd[k].numpy()) <= SELF, k
    pairs = ms_candidate_pairs(torch.as_tensor(poses), bounded._heavy,
                               bounded._ms_rcut, bounded._ms_kmax_list)
    out = bounded.model.batched_energy_forces(poses, ms_pairs=pairs[:3])
    counts = v2_counts(out["diags"], pairs[3])
    assert 0 < int(counts[:, V2.MS_SUBTRACTION_K].min()) <= nheavy
    m = bounded.model
    for b in range(NB):
        m.set_positions(poses[b])
        e, f = m.energy_forces(poses[b])
        assert abs(float(rb["energy"][b]) - float(e)) <= SELF * abs(float(e))
        assert rel(rb["force"][b].numpy(), f.numpy()) <= SELF


def _dense_half_list(pos, heavy, rcut, kmax):
    """The one-block half list of positions [B, n, 3] (mask [n] or [B,
    n]), written out as the list was built before row blocks."""
    nb, n = pos.shape[:2]
    heavy = heavy if heavy.dim() == 2 else heavy[None]
    dist = pos[:, None, :, :] - pos[:, :, None, :]
    d2 = torch.sum(dist * dist, dim=-1)
    jj = torch.arange(n)
    ok = ((jj[None, :] > jj[:, None]) & (d2 < rcut * rcut)
          & heavy[:, :, None] & heavy[:, None, :])
    pj = torch.sort(torch.where(ok, jj[None, :], n), dim=-1).values[
        ..., :kmax]
    valid = pj < n
    pi = jj[:, None].expand(n, pj.shape[-1])
    pj = torch.where(valid, pj, pi)
    off = n * torch.arange(nb)[:, None, None]
    return ((pi + off).reshape(-1), (pj + off).reshape(-1),
            valid.reshape(-1), torch.amax(torch.sum(ok, dim=-1), dim=-1))


@pytest.mark.parametrize("mask", ["shared", "per_replica"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row_blocked_half_list_is_bitwise_the_dense_one(mask, dtype,
                                                        monkeypatch):
    """half_neighbor_pairs in blocks of 1, 7, 64 and 150 rows (its
    HALF_LIST_BLOCK set to that many rows of the batch) against the
    one-block list: ids, validity, order, padding and max_neighbors
    bitwise, for a shared [n] and a per-replica [B, n] heavy mask, batched
    and one system (blocks of 5 rows); kmax below and above the widest
    row."""
    rng = np.random.default_rng(4)
    nb, n = 3, 150
    pos = torch.as_tensor(rng.uniform(0.0, 1.6, (nb, n, 3)), dtype=dtype)
    heavy = torch.as_tensor(rng.random((nb, n) if mask == "per_replica"
                                       else n) < 0.7)
    for kmax in (8, 200):
        want = _dense_half_list(pos, heavy, 0.45, kmax)
        assert int(want[3].max()) > 8  # the narrow list overflows
        for rows in (1, 7, 64, n):
            monkeypatch.setattr(NB_MODULE, "HALF_LIST_BLOCK", rows * nb * n)
            got = half_neighbor_pairs(pos, heavy, 0.45, kmax)
            for x, y in zip(got, want):
                assert x.dtype == y.dtype and torch.equal(x, y), rows
        if mask == "shared":
            monkeypatch.setattr(NB_MODULE, "HALF_LIST_BLOCK", 5 * n)
            one = half_neighbor_pairs(pos[1], heavy, 0.45, kmax)
            ref = _dense_half_list(pos[1:2], heavy, 0.45, kmax)
            for x, y in zip(one[:3], ref[:3]):
                assert torch.equal(x, y)
            assert one[3].dim() == 0 and int(one[3]) == int(ref[3][0])


def test_regrow_v2_is_jax_rule():
    """The scorer's version 2 PanicButton on a bumped 18-entry counts
    vector grows every capacity as JAX's _regrow_v2 does (both trees'
    levels, cap_ms, the MS tree's and the candidate lists' widths); an
    unbumped vector grows nothing."""
    params, pos = _params("fixture40")
    jsc = JaxConformerScorer(_force(params, JaxAGBNPForce), pos,
                             dtype=np.float64)
    tsc = ConformerScorer(_force(params, AGBNPForce), pos,
                          dtype=torch.float64, device="cpu")
    jm, tm = jsc._model, tsc.model
    assert tuple(jm.caps.caps) == tm.caps.caps
    assert tuple(jm.caps_ms.caps) == tm.caps_ms.caps
    assert (jm.cap_ms, jm.ms_kmax, jm.ms_sub_k, jsc._ms_kmax_list) == (
        tm.cap_ms, tm.ms_kmax, tm.ms_sub_k, tsc._ms_kmax_list)
    quiet = np.zeros(18, np.int64)
    assert not tsc._regrow_v2(quiet) and not jsc._regrow_v2(quiet)
    c = np.zeros(18, np.int64)
    c[V2.TREE] = np.asarray(tm.caps.caps) // 2
    c[1] = tm.caps.caps[1] + 5          # an overflowed atomic level
    c[V2.MS_TREE] = np.asarray(tm.caps_ms.caps) // 3
    c[9] = tm.caps_ms.caps[2] * 3       # an MS level far past its cap
    c[V2.MS_COUNT] = tm.cap_ms + 300
    c[V2.MS_TREE_KMAX] = tm.ms_kmax + 7
    c[V2.MS_CANDIDATE_KMAX] = tsc._ms_kmax_list + 9
    assert tsc._regrow_v2(c) and jsc._regrow_v2(c)
    jm, tm = jsc._model, tsc.model
    assert tm.caps.caps == tuple(jm.caps.caps)
    assert tm.caps.offs == tuple(jm.caps.offs)
    assert tm.caps_ms.caps == tuple(jm.caps_ms.caps)
    assert (tm.cap_ms, tm.ms_kmax, tm.ms_sub_k, tsc._ms_kmax_list) == (
        jm.cap_ms, jm.ms_kmax, jm.ms_sub_k, jsc._ms_kmax_list)
    assert tm.cap_ms > c[V2.MS_COUNT] and tm.ms_kmax > c[V2.MS_TREE_KMAX]
    assert tsc._ms_kmax_list > c[V2.MS_CANDIDATE_KMAX]
