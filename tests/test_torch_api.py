"""The port's AGBNPForce/Context surface against the JAX package's.

The version 0/1 cases of tests/test_api.py, mirrored on
`openmm_agbnp_plugin_tpu_torch.Context(device="cpu", dtype=torch.float64)`;
every case that evaluates also runs the same particle table through the JAX
package's Context (f64, CPU) and holds energy and forces to 1e-10 relative.
Plus the model surface the Context rests on (update_params, energy_only),
version 2 through the Context, and AGBNPHtable.
"""

import warnings

import numpy as np
import pytest
import torch

import openmm_agbnp_plugin_tpu as J
import openmm_agbnp_plugin_tpu_torch as P

PARITY = 1e-10  # relative, torch f64 vs JAX f64 on the CPU


def _fill(force, params, n=None, version=1):
    force.setVersion(version)
    for i in range(params.n if n is None else n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


def _contexts(force_t, force_j, box=None):
    return (P.Context(force_t, dtype=torch.float64, device="cpu", box=box),
            J.Context(force_j, dtype=np.float64, box=box))


def _parity(ctx_t, ctx_j, pos):
    """Evaluate both Contexts at pos; hold the port to the JAX package.
    Returns the port's (energy, forces as numpy)."""
    ctx_t.setPositions(pos)
    ctx_j.setPositions(pos)
    e, f = ctx_t.getEnergyForces()
    e_j, f_j = ctx_j.getEnergyForces()
    f = f.numpy()
    f_j = np.asarray(f_j)
    assert isinstance(e, float)
    assert abs(e - float(e_j)) <= PARITY * abs(float(e_j))
    assert np.abs(f - f_j).max() <= PARITY * np.abs(f_j).max()
    return e, f


def _cluster_forces(pkg, box=None, n=7):
    f = pkg.AGBNPForce()
    f.setVersion(1)
    for i in range(n):
        f.addParticle(0.165, 48.9528, -60.0, (-1.0) ** i * 0.2, False)
    f.setNonbondedMethod(pkg.NonbondedMethod.CutoffNonPeriodic
                         if box is None
                         else pkg.NonbondedMethod.CutoffPeriodic)
    f.setCutoffDistance(1.2)
    return f


def test_defaults():
    f = P.AGBNPForce()
    assert f.getVersion() == 1
    assert f.getNonbondedMethod() == P.NonbondedMethod.NoCutoff
    assert f.getCutoffDistance() == 1.0
    assert f.getSolventRadius() == J.AGBNPForce().getSolventRadius()


def test_version_validation():
    f = P.AGBNPForce()
    with pytest.raises(ValueError):
        f.setVersion(3)
    f.setVersion(0)
    f.setVersion(2)


def test_common_gamma_validation():
    f = P.AGBNPForce()
    f.addParticle(0.16, 40.0, -60.0, 0.0, False)
    f.addParticle(0.16, 41.0, -60.0, 0.0, False)
    with pytest.raises(ValueError, match="multiple gamma"):
        f.to_params()
    # hydrogens may carry any gamma; it is zeroed
    f2 = P.AGBNPForce()
    f2.addParticle(0.16, 40.0, -60.0, 0.0, False)
    f2.addParticle(0.12, 99.0, -20.0, 0.0, True)
    p = f2.to_params()
    assert p.gamma[1] == 0.0
    assert isinstance(p, P.AGBNPParams)


def test_particle_roundtrip():
    f = P.AGBNPForce()
    i = f.addParticle(0.165, 48.95, -73.4, 0.25, False)
    assert i == 0
    assert f.getNumParticles() == 1
    r, g, a, q, h = f.getParticleParameters(0)
    assert (r, g, a, q, h) == (0.165, 48.95, -73.4, 0.25, False)
    f.setParticleParameters(0, 0.17, 48.95, -70.0, 0.1, False)
    assert f.getParticleParameters(0)[0] == 0.17


@pytest.mark.parametrize("version,anchor", [(0, 872.514), (1, -2476.66)])
def test_context_energy_golden(gaussvol_system, version, anchor):
    """End-to-end through the public API, float64: the golden anchors."""
    params, pos = gaussvol_system
    ctx_t, ctx_j = _contexts(_fill(P.AGBNPForce(), params, version=version),
                             _fill(J.AGBNPForce(), params, version=version))
    e, f = _parity(ctx_t, ctx_j, pos)
    assert e == pytest.approx(anchor, abs=0.01)
    assert f.shape == (params.n, 3)


def test_context_v2_not_ported(gaussvol_system):
    """Version 2, which this Context once refused, now evaluates (through
    AGBNP2Model, built at the first evaluation): the in-repo V2 anchor on
    the 40-atom subset (tests/test_agbnp2.py::V2_GOLDEN), and an existing
    version 1 Context switched to version 2 by updateParametersInContext
    evaluates version 2.  tests/test_torch_agbnp2.py holds it to JAX."""
    params, pos = gaussvol_system
    f2 = _fill(P.AGBNPForce(), params, n=40, version=2)
    ctx2 = P.Context(f2, dtype=torch.float64, device="cpu")
    ctx2.setPositions(pos[:40])
    e2, f = ctx2.getEnergyForces()
    assert e2 == pytest.approx(-505.76495633268286, rel=1e-9)
    assert tuple(f.shape) == (40, 3) and bool(torch.isfinite(f).all())
    f1 = _fill(P.AGBNPForce(), params, n=40, version=1)
    ctx = P.Context(f1, dtype=torch.float64, device="cpu")
    ctx.setPositions(pos[:40])
    e1 = ctx.getEnergyForces()[0]
    f1.setVersion(2)
    f1.updateParametersInContext(ctx)
    assert ctx.getEnergyForces()[0] == e2 != e1


def test_context_v2_refuses_a_periodic_box(gaussvol_system):
    """Version 2 runs its MS stage and pair phases without a box: a
    CutoffPeriodic v2 force is refused, at the Context and when a live
    Context's force switches to it."""
    params, pos = gaussvol_system
    box = ((7.0, 0, 0), (0, 7.0, 0), (0, 0, 7.0))
    f2 = _fill(P.AGBNPForce(), params, n=40, version=2)
    f2.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    with pytest.raises(NotImplementedError, match="periodic"):
        P.Context(f2, dtype=torch.float64, device="cpu", box=box)
    f1 = _fill(P.AGBNPForce(), params, n=40, version=1)
    f1.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    ctx = P.Context(f1, dtype=torch.float64, device="cpu", box=box)
    f1.setVersion(2)
    with pytest.raises(NotImplementedError, match="periodic"):
        f1.updateParametersInContext(ctx)


def test_context_without_a_card_raises(gaussvol_system):
    """device=None means the card: no quiet CPU fallback."""
    params, pos = gaussvol_system
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.Context(_fill(P.AGBNPForce(), params, n=8))


def test_force_group_roundtrip():
    f = P.AGBNPForce()
    assert f.getForceGroup() == 0
    f.setForceGroup(5)
    assert f.getForceGroup() == 5
    with pytest.raises(ValueError):
        f.setForceGroup(32)
    with pytest.raises(ValueError):
        f.setForceGroup(-1)


def test_calc_forces_and_energy_flags(gaussvol_system):
    """Flagged evaluation semantics of AGBNPForceImpl::calcForcesAndEnergy:
    the group mask gates the whole evaluation; includeEnergy/includeForces
    gate the outputs; the energy-only path (which skips the WU force pass)
    returns exactly the full evaluation's energy."""
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params)
    force.setForceGroup(3)
    force_j = _fill(J.AGBNPForce(), params)
    force_j.setForceGroup(3)
    ctx, ctx_j = _contexts(force, force_j)
    e_full, f_full = _parity(ctx, ctx_j, pos)

    # group excluded from mask: no contribution at all
    e, f = ctx.calcForcesAndEnergy(groups=1 << 2)
    assert e == 0.0 and not f.any()
    assert f.dtype == torch.float64 and f.device.type == "cpu"
    assert tuple(f.shape) == (params.n, 3)

    # group included: full value
    e, f = ctx.calcForcesAndEnergy(groups=1 << 3)
    assert e == e_full
    np.testing.assert_array_equal(f.numpy(), f_full)
    e, f = ctx.calcForcesAndEnergy()  # default mask -1 includes every group
    assert e == e_full

    # energy-only: bitwise the same energy (the WU pass carries force only)
    e, f = ctx.calcForcesAndEnergy(includeForces=False)
    assert e == e_full
    assert not f.any()
    assert ctx.getEnergy() == e_full
    assert ctx.getEnergy() == pytest.approx(float(ctx_j.getEnergy()),
                                            rel=PARITY)

    # forces-only: zero energy, full forces
    e, f = ctx.calcForcesAndEnergy(includeEnergy=False)
    assert e == 0.0
    np.testing.assert_array_equal(f.numpy(), f_full)
    np.testing.assert_array_equal(ctx.getForces().numpy(), f_full)

    e, f = ctx.calcForcesAndEnergy(includeForces=False, includeEnergy=False)
    assert e == 0.0 and not f.any()


def test_update_parameters_in_context(gaussvol_system):
    """updateParametersInContext: edited particle parameters reach a live
    Context without a new model when the shapes are unchanged, and the
    result is that of a fresh Context."""
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params)
    force_j = _fill(J.AGBNPForce(), params)
    ctx, ctx_j = _contexts(force, force_j)
    e0, f0 = _parity(ctx, ctx_j, pos)
    model = ctx._model
    caps = model.caps

    def edit(scale_q=1.0, scale_g=1.0):
        for frc in (force, force_j):
            for i in range(params.n):
                r, g, a, q, h = frc.getParticleParameters(i)
                frc.setParticleParameters(i, r, scale_g * g, a, scale_q * q,
                                          h)
        force.updateParametersInContext(ctx)
        force_j.updateParametersInContext(ctx_j)
        assert ctx._model is model, "model was rebuilt for a param-only update"
        assert model.caps == caps

    # scale every charge: GB terms change, cavity term does not
    edit(scale_q=0.5)
    e1, f1 = _parity(ctx, ctx_j, pos)
    assert abs(e1 - e0) > 1.0
    fresh = P.Context(force, dtype=torch.float64, device="cpu")
    fresh.setPositions(pos)
    e_fresh, f_fresh = fresh.getEnergyForces()
    assert e1 == e_fresh
    np.testing.assert_array_equal(f1, f_fresh.numpy())

    # restoring the parameters restores the energy exactly
    edit(scale_q=2.0)
    e2, f2 = _parity(ctx, ctx_j, pos)
    assert e2 == pytest.approx(e0, rel=1e-12)
    np.testing.assert_allclose(f2, f0, rtol=1e-12)

    # changing gamma flows through the cavity/rescan chain too
    edit(scale_g=1.1)
    e3, _ = _parity(ctx, ctx_j, pos)
    assert abs(e3 - e0) > 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_update_keeps_the_model_in_a_periodic_box(gaussvol_system, dtype):
    """The reuse test compares the box as it was given, not as the model
    holds it: box lengths that float32 cannot hold exactly must not cost a
    new model."""
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params, n=40)
    force.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    box = ((6.1, 0, 0), (0.8, 6.2, 0), (-0.5, 0.7, 6.3))
    ctx = P.Context(force, dtype=dtype, device="cpu", box=box)
    model = ctx._model
    r, g, a, q, h = force.getParticleParameters(0)
    force.setParticleParameters(0, r, g, a, q + 0.1, h)
    force.updateParametersInContext(ctx)
    assert ctx._model is model
    assert float(model.arrays["charge"][0]) == pytest.approx(q + 0.1)
    # another box is another model
    ctx.setPeriodicBoxVectors((7.0, 0, 0), (0, 7.0, 0), (0, 0, 7.0))
    assert ctx._model is not model


def test_update_params_keeps_the_model_on_a_charge_edit(gaussvol_system):
    """AGBNPModel.update_params: True on a charge-only edit (every shape
    kept), the device arrays swapped, capacities and row order kept; False
    when the radius-type table changes its dimensions."""
    params, pos = gaussvol_system
    m = P.AGBNPModel(params, device="cpu", dtype=torch.float64)
    e0, _ = m.energy_forces(pos)
    caps, rperm = m.caps, m.arrays["rperm"].clone()
    halved = P.AGBNPParams(radius=params.radius, gamma=params.gamma,
                           alpha=params.alpha, charge=0.5 * params.charge,
                           ishydrogen=params.ishydrogen)
    assert m.update_params(halved) is True
    assert m.params is halved and m.caps == caps
    assert torch.equal(m.arrays["rperm"], rperm)
    e1, f1 = m.energy_forces(pos)
    fresh = P.AGBNPModel(halved, device="cpu", dtype=torch.float64)
    e_f, f_f = fresh.energy_forces(pos)
    assert torch.equal(e1, e_f) and torch.equal(f1, f_f)
    assert abs(float(e1) - float(e0)) > 1.0

    # one new radius: one more radius type, other table dimensions
    radius = params.radius.copy()
    radius[np.nonzero(params.ishydrogen == 0)[0][0]] += 0.0123
    other = P.AGBNPParams(radius=radius, gamma=params.gamma,
                          alpha=params.alpha, charge=params.charge,
                          ishydrogen=params.ishydrogen)
    assert m.update_params(other) is False
    e2, f2 = m.energy_forces(pos)
    e_o, f_o = P.AGBNPModel(other, device="cpu",
                            dtype=torch.float64).energy_forces(pos)
    assert torch.equal(e2, e_o) and torch.equal(f2, f_o)


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("pair_kernel", [True, False])
def test_energy_only_is_bitwise_the_full_energy(gaussvol_system, version,
                                                pair_kernel):
    params, pos = gaussvol_system
    m = P.AGBNPModel(params, device="cpu", dtype=torch.float64,
                     version=version, pair_kernel=pair_kernel)
    e_full, _, out = m.energy_forces(pos, with_details=True)
    e_only, out_only = m.energy_only(pos, with_details=True)
    assert torch.equal(e_only, e_full)
    assert torch.equal(m.energy_only(pos), e_full)
    assert torch.equal(out_only["diag"]["counts"], out["diag"]["counts"])


def test_explicit_pairs_reach_the_tree(gaussvol_system):
    """pairs= hands the tree its 2-body candidates: a list that holds every
    overlapping pair gives the all-pairs result; the JAX model agrees."""
    from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JModel

    params, pos = gaussvol_system
    full = P.AGBNPModel(params, device="cpu", dtype=torch.float64)
    e0, f0 = full.energy_forces(pos)
    i, j = np.triu_indices(params.n, 1)
    near = np.linalg.norm(pos[i] - pos[j], axis=1) < 1.2
    pairs = (i[near], j[near])
    m = P.AGBNPModel(params, device="cpu", dtype=torch.float64, pairs=pairs)
    assert m.arrays["pairs_i"].shape[0] == int(near.sum()) < i.shape[0]
    e1, f1 = m.energy_forces(pos)
    assert float(e1) == pytest.approx(float(e0), rel=1e-12)
    np.testing.assert_allclose(f1.numpy(), f0.numpy(), rtol=1e-9, atol=1e-9)
    e_j, f_j = JModel(params, dtype=np.float64, pairs=pairs,
                      pair_kernel=False).energy_forces(pos)
    assert abs(float(e1) - float(e_j)) <= PARITY * abs(float(e_j))
    assert np.abs(f1.numpy() - np.asarray(f_j)).max() \
        <= PARITY * np.abs(np.asarray(f_j)).max()


def test_cutoff_periodic_large_box_matches_nonperiodic(gaussvol_system):
    """With a box much larger than the system, CutoffPeriodic ==
    CutoffNonPeriodic."""
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params)
    force_j = _fill(J.AGBNPForce(), params)
    for frc, pkg in ((force, P), (force_j, J)):
        frc.setNonbondedMethod(pkg.NonbondedMethod.CutoffNonPeriodic)
        frc.setCutoffDistance(1.2)
    e_np, f_np = _parity(*_contexts(force, force_j), pos)

    box = ((50.0, 0, 0), (0, 50.0, 0), (0, 0, 50.0))
    force.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    force_j.setNonbondedMethod(J.NonbondedMethod.CutoffPeriodic)
    ctx2, ctx2_j = _contexts(force, force_j, box=box)
    e_p, f_p = _parity(ctx2, ctx2_j, pos)
    assert e_p == pytest.approx(e_np, rel=1e-12)
    np.testing.assert_allclose(f_p, f_np, rtol=1e-12, atol=1e-12)
    # the compact [3] form inside, the three vectors outside
    assert ctx2._box.shape == (3,)
    np.testing.assert_array_equal(ctx2.getPeriodicBoxVectors(),
                                  np.asarray(box, dtype=np.float64))


def test_cutoff_periodic_requires_box(gaussvol_system):
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params)
    force.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    kw = dict(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="box"):
        P.Context(force, **kw)
    # a is not (ax, 0, 0): not in reduced form
    with pytest.raises(ValueError, match="reduced form"):
        P.Context(force, box=((5.0, 0.1, 0), (0, 5.0, 0), (0, 0, 5.0)), **kw)
    # tilt exceeding the ax/2 reduction bound
    with pytest.raises(ValueError, match="reduced form"):
        P.Context(force, box=((5.0, 0, 0), (3.0, 5.0, 0), (0, 0, 5.0)), **kw)
    with pytest.raises(ValueError, match="positive"):
        P.Context(force, box=((5.0, 0, 0), (0, -5.0, 0), (0, 0, 5.0)), **kw)


def test_min_image_triclinic_matches_image_search():
    """The sequential c/b/a wrap equals brute-force 27-image minimum
    distances for random reduced triclinic cells (within the half-width
    validity bound), and the JAX package's wrap."""
    from openmm_agbnp_plugin_tpu.ops.born import min_image as min_image_j
    from openmm_agbnp_plugin_tpu_torch.ops.born import min_image

    rng = np.random.default_rng(11)
    box = np.array([[4.0, 0.0, 0.0],
                    [1.7, 3.6, 0.0],
                    [-1.9, 1.5, 3.3]])
    pts = rng.uniform(-6.0, 6.0, size=(40, 3))
    delta = pts[None, :, :] - pts[:, None, :]
    wrapped = min_image(torch.as_tensor(delta), torch.as_tensor(box)).numpy()
    np.testing.assert_allclose(wrapped, np.asarray(min_image_j(delta, box)),
                               atol=1e-12)
    d_wrap = np.linalg.norm(wrapped, axis=-1)
    shifts = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                       for k in (-1, 0, 1)], dtype=np.float64) @ box
    d_img = np.min(np.linalg.norm(
        delta[:, :, None, :] + shifts[None, None, :, :], axis=-1), axis=-1)
    half = 0.5 * min(box[0, 0], box[1, 1], box[2, 2])
    m = d_img < half
    np.testing.assert_allclose(d_wrap[m], d_img[m], atol=1e-12)


def _lattice_case(box, lone, seed):
    rng = np.random.default_rng(seed)
    pos = np.vstack([0.30 * rng.standard_normal((6, 3)), lone])
    ctx, ctx_j = _contexts(_cluster_forces(P, box), _cluster_forces(J, box),
                           box=box)
    return pos, ctx, ctx_j


def test_cutoff_periodic_triclinic_lattice_invariance():
    """Translating an isolated atom by a TRICLINIC lattice vector leaves
    the periodic energy and forces unchanged."""
    box = ((3.2, 0.0, 0.0), (0.9, 3.1, 0.0), (-0.8, 1.1, 3.4))
    pos, ctx, ctx_j = _lattice_case(box, np.array([[1.4, 0.4, 0.3]]), 5)
    assert ctx._box.shape == (3, 3)
    e0, f0 = _parity(ctx, ctx_j, pos)
    for vec in np.asarray(box):
        pos_shift = pos.copy()
        pos_shift[-1] += vec
        e1, f1 = _parity(ctx, ctx_j, pos_shift)
        assert e1 == pytest.approx(e0, rel=1e-12)
        np.testing.assert_allclose(f1, f0, rtol=1e-10, atol=1e-10)


def test_cutoff_periodic_warns_on_straddling_extent(gaussvol_system):
    """Coordinates whose extent approaches the box (i.e. likely wrapped)
    trigger the cavity-term guard warning; well-contained ones don't."""
    params, pos = gaussvol_system
    force = _fill(P.AGBNPForce(), params)
    force.setNonbondedMethod(P.NonbondedMethod.CutoffPeriodic)
    force.setCutoffDistance(1.0)
    extent = float((pos.max(axis=0) - pos.min(axis=0)).max())
    tight = extent / 0.8  # extent = 0.8 * box > 0.75 * box on one axis
    kw = dict(dtype=torch.float64, device="cpu")
    ctx = P.Context(force, box=((tight, 0, 0), (0, tight, 0), (0, 0, tight)),
                    **kw)
    with pytest.warns(RuntimeWarning, match="wrapped"):
        ctx.setPositions(pos)

    roomy = 4.0 * extent
    ctx2 = P.Context(force, box=((roomy, 0, 0), (0, roomy, 0), (0, 0, roomy)),
                     **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ctx2.setPositions(pos)


def test_cutoff_periodic_min_image_invariance():
    """Translating an isolated atom by a lattice vector leaves the periodic
    energy unchanged, while the non-periodic energy changes."""
    box = ((3.0, 0, 0), (0, 3.0, 0), (0, 0, 3.0))
    pos, ctx, ctx_j = _lattice_case(box, np.array([[2.0, 0.0, 0.0]]), 3)
    pos_shift = pos.copy()
    pos_shift[-1, 0] += 3.0  # one lattice vector; raw distance now 5 nm
    e0, f0 = _parity(ctx, ctx_j, pos)
    e1, f1 = _parity(ctx, ctx_j, pos_shift)
    assert e1 == pytest.approx(e0, rel=1e-12)
    np.testing.assert_allclose(f1, f0, rtol=1e-10, atol=1e-10)

    # sanity: without the box the shift decouples the lone atom
    ctx_np, ctx_np_j = _contexts(_cluster_forces(P), _cluster_forces(J))
    e_np0, _ = _parity(ctx_np, ctx_np_j, pos)
    e_np1, _ = _parity(ctx_np, ctx_np_j, pos_shift)
    assert abs(e_np1 - e_np0) > 1e-6
    # and the periodic energy actually sees the wrapped 1 nm image
    assert abs(e0 - e_np0) > 1e-6


def test_get_energy_needs_positions(gaussvol_system):
    params, _ = gaussvol_system
    ctx = P.Context(_fill(P.AGBNPForce(), params, n=8), dtype=torch.float64,
                    device="cpu")
    with pytest.raises(ValueError, match="setPositions"):
        ctx.getEnergyForces()
    with pytest.raises(ValueError, match="setPositions"):
        ctx.getEnergy()


def test_panic_button_grows_context_capacities(gaussvol_system):
    """Capacities too small for the fixture: the Context's retry loop grows
    them and returns the golden energy."""
    params, pos = gaussvol_system
    caps = P.TreeCaps(caps=(1024,) * 7, offs=(16, 16, 8, 8, 4, 4))
    ctx = P.Context(_fill(P.AGBNPForce(), params), dtype=torch.float64,
                    device="cpu", caps=caps)
    ctx.setPositions(pos)
    assert ctx.getEnergy() == pytest.approx(-2476.66, abs=0.01)
    assert ctx._model.caps != caps


def test_hashtable_parity():
    from openmm_agbnp_plugin_tpu.utils.hashtable import AGBNPHtable as JTable
    from openmm_agbnp_plugin_tpu_torch.utils.hashtable import AGBNPHtable

    t, tj = AGBNPHtable(10), JTable(10)
    assert t.size() == tj.size() == 16
    values = (5, 21, 37, 8)  # 5, 21, 37 collide mod 16
    slots = [t.h_enter(v) for v in values]
    assert slots == [tj.h_enter(v) for v in values]
    assert len(set(slots)) == 4
    for v in values:
        assert t.values[t.h_find(v)] == v
        assert t.h_find(v) == tj.h_find(v)
    assert t.h_find(99) == tj.h_find(99) == -1
    np.testing.assert_array_equal(t.values, tj.values)


def test_profiling_helpers(gaussvol_system, tmp_path):
    """energy_breakdown and tree_stats against the JAX package's on the same
    evaluation; trace() profiles a block and writes its program spans
    beside the trace, on the trace's time base."""
    import json

    from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JModel
    from openmm_agbnp_plugin_tpu.utils import profiling as JP
    from openmm_agbnp_plugin_tpu_torch.utils import profiling as TP

    params, pos = gaussvol_system
    m = P.AGBNPModel(params, device="cpu", dtype=torch.float64)
    with TP.trace(str(tmp_path)) as prof:
        _, _, out = m.energy_forces(pos, with_details=True)
    assert len(prof.key_averages()) > 0
    with open(tmp_path / "program_spans.json") as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] > 0
    names = [e["name"] for e in spans["traceEvents"] if e["ph"] == "X"]
    assert names.count("eval.tree") == names.count("eval.pairs") == 1
    _, _, out_j = JModel(params, dtype=np.float64, pair_kernel=False,
                         caps=m.caps).energy_forces(pos, with_details=True)
    terms, terms_j = (TP.energy_breakdown(out["details"]),
                      JP.energy_breakdown(out_j["details"]))
    assert set(terms) == set(terms_j) == {"e_vol1", "e_vol2", "e_cav",
                                          "gb_self", "gb_pair", "e_vdw"}
    for k, v in terms.items():
        assert v == pytest.approx(terms_j[k], rel=PARITY)
    stats, stats_j = TP.tree_stats(out["diag"]), JP.tree_stats(out_j["diag"])
    for k in ("counts", "caps", "max_siblings"):
        np.testing.assert_array_equal(stats[k], stats_j[k])
    np.testing.assert_allclose(stats["occupancy"], stats_j["occupancy"])
