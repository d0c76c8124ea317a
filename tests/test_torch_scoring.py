"""The port's batched conformer scorer (api/scoring.py), f64 on the CPU.

Mirrors the JAX package's tests/test_scoring.py (all but its mesh case):
per-conformer semantics equal the single-evaluation Context; versions 0
and 1 also equal JAX's ConformerScorer within 1e-10; version 2 equals the
AGBNP2 model conformer by conformer; the tiny-capacity regrow, parameter
updates, FIRE refinement and the rejected periodic method behave as in
JAX.
"""

import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu import AGBNPForce as JaxAGBNPForce
from openmm_agbnp_plugin_tpu.api.scoring import \
    ConformerScorer as JaxConformerScorer
from openmm_agbnp_plugin_tpu_torch import (AGBNP2Model, AGBNPForce,
                                           AGBNPParams, ConformerScorer,
                                           Context, NonbondedMethod,
                                           TreeCaps, load_gaussvol_dat)

torch.set_num_threads(2)

F64 = torch.float64


def _build_force(params, version=1, cls=AGBNPForce):
    force = cls()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


def _conformers(pos, nb=4, scale=0.01, seed=7):
    rng = np.random.default_rng(seed)
    return pos[None] + scale * rng.standard_normal((nb, *pos.shape))


def _sub(params, n):
    return AGBNPParams(radius=params.radius[:n], gamma=params.gamma[:n],
                       alpha=params.alpha[:n], charge=params.charge[:n],
                       ishydrogen=params.ishydrogen[:n])


@pytest.fixture(scope="module")
def small_system():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(os.path.dirname(__file__), "fixtures", "gaussvol.dat"))
    params = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                         charge=charge, ishydrogen=ish)
    return _sub(params, 64), pos[:64]


def _scorer(force, pos, **kw):
    return ConformerScorer(force, pos, dtype=F64, device="cpu", **kw)


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("method", ["NoCutoff", "CutoffNonPeriodic"])
def test_batch_matches_context_and_jax(small_system, version, method):
    params, pos = small_system
    force = _build_force(params, version=version)
    force.setNonbondedMethod(getattr(NonbondedMethod, method))
    batch = _conformers(pos, nb=4)
    scorer = _scorer(force, pos)
    res = scorer.score(batch, forces=True, details=True)
    assert res["energy"].shape == (4,)
    assert res["force"].shape == (4, params.n, 3)
    for b in range(4):
        ctx = Context(force, dtype=F64, device="cpu")
        ctx.setPositions(batch[b])
        e, f = ctx.getEnergyForces()
        assert abs(float(res["energy"][b]) - e) <= 1e-10 * abs(e)
        np.testing.assert_allclose(res["force"][b].numpy(), f.numpy(),
                                   rtol=1e-8, atol=1e-10)
    if version == 1:
        total = res["e_cav"] + res["gb_self"] + res["gb_pair"] + res["e_vdw"]
        np.testing.assert_allclose(total.numpy(), res["energy"].numpy(),
                                   rtol=1e-12)
    jforce = _build_force(params, version=version, cls=JaxAGBNPForce)
    jforce.setNonbondedMethod(int(getattr(NonbondedMethod, method)))
    ref = JaxConformerScorer(jforce, pos, dtype=np.float64).score(
        batch, forces=True, details=True)
    e_ref = np.asarray(ref["energy"])
    assert np.max(np.abs(res["energy"].numpy() - e_ref)) <= 1e-10 * np.max(
        np.abs(e_ref))
    f_ref = np.asarray(ref["force"])
    assert np.max(np.abs(res["force"].numpy() - f_ref)) <= 1e-10 * np.max(
        np.abs(f_ref))
    for k in ("e_cav", "e_vol1", "e_vol2") + (
            ("gb_self", "gb_pair", "e_vdw") if version else ()):
        np.testing.assert_allclose(res[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def v2_system(small_system):
    params, pos = small_system
    return _sub(params, 40), pos[:40]


def test_batch_v2_matches_model(v2_system):
    """AGBNP2 batch scoring equals the AGBNP2 model's evaluation of each
    conformer (energy and autograd forces); refine refuses version 2."""
    p40, pos = v2_system
    force = _build_force(p40, version=2)
    batch = _conformers(pos, nb=3, scale=0.005)
    scorer = _scorer(force, pos)
    res = scorer.score(batch, forces=True, details=True)
    assert res["energy"].shape == (3,)
    assert "e_ms_vdw" in res
    for b in range(3):
        m = AGBNP2Model(p40, device="cpu", dtype=F64, positions=batch[b])
        e, f = m.energy_forces(batch[b])
        assert abs(float(res["energy"][b]) - float(e)) <= 1e-8 * abs(
            float(e))
        np.testing.assert_allclose(res["force"][b].numpy(), f.numpy(),
                                   rtol=1e-6, atol=1e-8)
    with pytest.raises(ValueError, match="refine"):
        scorer.refine(batch)


def test_single_conformer_and_shapes(small_system):
    params, pos = small_system
    scorer = _scorer(_build_force(params), pos)
    res = scorer.score(pos)  # [N, 3] treated as B=1
    assert res["energy"].shape == (1,)
    with pytest.raises(ValueError, match="expected positions"):
        scorer.score(pos[:, :2])


def test_regrow_from_tiny_caps(small_system):
    """Undersized capacities: the PanicButton loop regrows from the worst
    conformer of the batch and then matches the healthy scorer."""
    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=3)
    tiny = TreeCaps(caps=(128,) * 7, offs=(4, 4, 4, 4, 4, 4))
    scorer = _scorer(force, pos, caps=tiny)
    ok = _scorer(force, pos)
    np.testing.assert_allclose(scorer.score(batch)["energy"].numpy(),
                               ok.score(batch)["energy"].numpy(), rtol=1e-10)
    assert scorer.model.caps != tiny


def test_update_parameters_batch(small_system):
    """updateParametersInContext: a gamma change reaches the scores without
    rebuilding the scorer."""
    params, pos = small_system
    force = _build_force(params)
    batch = _conformers(pos, nb=2)
    scorer = _scorer(force, pos)
    e0 = scorer.score(batch)["energy"]
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g * 1.5, a, q, h)
    scorer.updateParametersInContext(force)
    e1 = scorer.score(batch)["energy"]
    assert not np.allclose(e0.numpy(), e1.numpy())
    np.testing.assert_allclose(e1.numpy(),
                               _scorer(force, pos).score(batch)["energy"]
                               .numpy(), rtol=1e-10)


def test_update_parameters_batch_v2(v2_system):
    """Version 2: a parameter update rebuilds the model from the new force
    (keeping its capacities), and a later growth keeps the new
    parameters."""
    p40, pos = v2_system
    force = _build_force(p40, version=2)
    batch = _conformers(pos, nb=2, scale=0.005)
    scorer = _scorer(force, pos)
    e0 = scorer.score(batch)["energy"]
    for i in range(p40.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g * 2.0, a, q, h)
    scorer.updateParametersInContext(force)
    e1 = scorer.score(batch)["energy"]
    assert not np.allclose(e0.numpy(), e1.numpy())
    np.testing.assert_allclose(e1.numpy(),
                               _scorer(force, pos).score(batch)["energy"]
                               .numpy(), rtol=1e-10)
    m2 = scorer.model
    m2.caps = TreeCaps(caps=tuple(c * 2 for c in m2.caps.caps),
                       offs=m2.caps.offs)
    np.testing.assert_allclose(scorer.score(batch)["energy"].numpy(),
                               e1.numpy(), rtol=1e-10)


def test_refine_lowers_energy(small_system):
    """Batched FIRE refinement: every pose's energy drops, the refined
    scores equal a fresh scoring of the refined coordinates, and each pose
    follows JAX's vmapped FIRE (its own step size, mixing and uphill
    counter): positions and energy trace within 1e-8."""
    params, pos = small_system
    scorer = _scorer(_build_force(params), pos)
    batch = _conformers(pos, nb=2, scale=0.02)
    e0 = scorer.score(batch)["energy"]
    res = scorer.refine(batch, maxiter=40)
    assert res["positions"].shape == batch.shape
    assert res["energy_trace"].shape == (2, 40)
    assert (res["energy"] < e0).all()
    np.testing.assert_allclose(
        res["energy"].numpy(),
        scorer.score(res["positions"])["energy"].numpy(), rtol=1e-12)
    ref = JaxConformerScorer(_build_force(params, cls=JaxAGBNPForce), pos,
                             dtype=np.float64).refine(batch, maxiter=40)
    for k in ("positions", "energy_trace", "energy"):
        r = np.asarray(ref[k])
        assert np.abs(res[k].numpy() - r).max() <= 1e-8 * np.abs(r).max(), k


def test_version2_accepted_periodic_rejected(small_system):
    params, pos = small_system
    assert _scorer(_build_force(params, version=2), pos)._is_v2
    force1 = _build_force(params, version=1)
    force1.setNonbondedMethod(NonbondedMethod.CutoffPeriodic)
    with pytest.raises(ValueError, match="CutoffPeriodic"):
        _scorer(force1, pos)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ConformerScorer(_build_force(params), pos)
