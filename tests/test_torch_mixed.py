"""The port's `mixed=True` (f32 pair math with f64 sums on the plain pair
route) against the JAX package's, on the CPU.

JAX ops/born.py::_sum1/_sum_all widen the plain route's pair sums to
float64 at a float32 working dtype (models/agbnp_jax.py:446); the tree
passes, the MM force field and the integrator stay float32.  Checked here:
the widened sums themselves (bitwise), the three pair phases against
JAX's on identical f32 inputs, mixed at f64 being the plain evaluation
bit for bit (energy, forces, a Langevin run), 1li2 at NoCutoff (mixed
lands closer to f64 than plain f32, and on JAX's mixed), mixed surviving
every model rebuild and reaching the replica runners, the scorer and the
parameter gradients under mixed, and the refusals where the JAX package
would drop mixed without a word.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu import AGBNPForce as JaxAGBNPForce
from openmm_agbnp_plugin_tpu.api.fitting import \
    ParameterGradients as JaxParameterGradients
from openmm_agbnp_plugin_tpu.api.scoring import \
    ConformerScorer as JaxConformerScorer
from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JaxModel
from openmm_agbnp_plugin_tpu.models.oracle import AGBNPParams as JaxParams
from openmm_agbnp_plugin_tpu.ops import born as JB
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu_torch import (AGBNPForce, AGBNPModel,
                                           AGBNPParams, ConformerScorer,
                                           ParameterGradients, Simulation,
                                           load_dms, load_gaussvol_dat)
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
    energy_forces, prepare_arrays
from openmm_agbnp_plugin_tpu_torch.ops import born as B
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.parallel import sharding as S

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(os.path.dirname(HERE), "benchmarks", "data")
LI2 = os.path.join(DATA, "1li2_agbnp1.dms")
TRPCAGE = os.path.join(DATA, "trpcage_agbnp1.dms")
MD_KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
MD_CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))


def _rel(x, ref):
    return abs(float(x) - float(ref)) / abs(float(ref))


def _fmax(f, ref):
    f, ref = np.asarray(f, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(f - ref).max() / np.abs(ref).max())


def _jcaps(caps):
    return JT.TreeCaps(caps=tuple(caps.caps), offs=tuple(caps.offs))


def _jparams(p):
    return JaxParams(radius=p.radius, gamma=p.gamma, alpha=p.alpha,
                     charge=p.charge, ishydrogen=p.ishydrogen)


def _dms_params(d):
    return AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                       alpha=d.agbnp_alpha, charge=d.charges,
                       ishydrogen=d.ishydrogen)


def _build_force(params, version=1, cls=AGBNPForce):
    force = cls()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    return force


@pytest.fixture(scope="module")
def fixture_system():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "fixtures", "gaussvol.dat"))
    return AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                       charge=charge, ishydrogen=ish), pos


@pytest.fixture(scope="module")
def small_system(fixture_system):
    params, pos = fixture_system
    n = 64
    return AGBNPParams(radius=params.radius[:n], gamma=params.gamma[:n],
                       alpha=params.alpha[:n], charge=params.charge[:n],
                       ishydrogen=params.ishydrogen[:n]), pos[:n]


# (a) the widened sums


def test_widened_sums_are_the_f64_sum_of_the_f32_terms():
    """_sum1 and _sum_all with an f64 accumulator on f32 terms equal
    x.double().sum().float() bit for bit, on terms whose f32 sum differs
    (a large term and many small ones)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((7, 4096)).astype(np.float32)
    x[:, 0] = 3.0e4
    t = torch.as_tensor(x)
    for dim in (0, 1):
        wide = B._sum1(t, F64, dim=dim)
        assert wide.dtype == F32
        assert torch.equal(wide, t.double().sum(dim=dim).float())
        assert torch.equal(B._sum1(t, None, dim=dim), t.sum(dim=dim))
    assert not torch.equal(t.sum(dim=1), t.double().sum(dim=1).float())
    assert torch.equal(B._sum_all(t, F64), t.double().sum().float())
    assert t.sum() != t.double().sum().float()
    assert torch.equal(B._sum_all(t, None), t.sum())


# (b) the three pair phases with accum_dtype=float64, port vs JAX, f32


def test_pair_phases_widened_match_jax(fixture_system):
    """born_radii, gb_energy and descreening_sweep with accum_dtype=float64
    on the same f32 fixture inputs as JAX's, within 2e-6 of each output's
    largest magnitude (f32 elementwise roundoff: the sums themselves are
    f64 on both sides)."""
    params, pos = fixture_system
    a = prepare_arrays(params, dtype=np.float32)
    n = params.n
    ntypes_j = int(np.max(a["type_j"]) + 1)
    rng = np.random.default_rng(5)
    s_factor = rng.uniform(0.3, 1.0, n).astype(np.float32)
    pos32 = np.asarray(pos, np.float32)
    names = ("radii_vdw", "ishydrogen", "type_i", "type_j", "yflat",
             "y2flat")
    t = {k: torch.as_tensor(a[k]) for k in names}
    j = {k: jnp.asarray(a[k]) for k in names}

    def check(got, want, what):
        got = np.asarray(got, np.float64)
        want = np.asarray(want, np.float64)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 2e-6 * scale, what

    tg = B.born_radii(torch.as_tensor(pos32), t["radii_vdw"],
                      torch.as_tensor(s_factor), t["ishydrogen"],
                      t["type_i"], t["type_j"], t["yflat"], t["y2flat"],
                      ntypes_j, accum_dtype=F64)
    jg = JB.born_radii(jnp.asarray(pos32), j["radii_vdw"],
                       jnp.asarray(s_factor), j["ishydrogen"], j["type_i"],
                       j["type_j"], j["yflat"], j["y2flat"], ntypes_j,
                       accum_dtype=jnp.float64)
    assert tg["inv_br"].dtype == F32
    for k in ("inv_br", "born_radius"):
        check(tg[k].numpy(), jg[k], k)

    br = np.asarray(tg["born_radius"].numpy(), np.float32)
    charge = np.asarray(params.charge, np.float32)
    tgb = B.gb_energy(torch.as_tensor(pos32), torch.as_tensor(charge),
                      torch.as_tensor(br), tg, accum_dtype=F64)
    jgb = JB.gb_energy(jnp.asarray(pos32), jnp.asarray(charge),
                       jnp.asarray(br), jg, accum_dtype=jnp.float64)
    for k in ("gb_self", "gb_pair", "force", "egb_der_Y"):
        check(tgb[k].numpy(), jgb[k], k)

    brw = rng.uniform(-1.0, 0.0, n).astype(np.float32)
    bru = rng.uniform(-50.0, 0.0, n).astype(np.float32)
    tsw = B.descreening_sweep(tg, torch.as_tensor(s_factor),
                              torch.as_tensor(brw), torch.as_tensor(bru),
                              accum_dtype=F64)
    jsw = JB.descreening_sweep(jg, jnp.asarray(s_factor), jnp.asarray(brw),
                               jnp.asarray(bru), accum_dtype=jnp.float64)
    for k in ("evdw_der_W", "egb_der_U", "force"):
        check(tsw[k].numpy(), jsw[k], k)


# (c) mixed at f64 is the plain evaluation


def test_mixed_at_f64_is_the_plain_route_bitwise(fixture_system):
    """JAX's rule: the accumulator widens only below f64, so a mixed f64
    model is the plain route's evaluation bit for bit."""
    params, pos = fixture_system
    plain = AGBNPModel(params, device="cpu", dtype=F64, pair_kernel=False)
    mixed = AGBNPModel(params, device="cpu", dtype=F64, mixed=True,
                       caps=plain.caps)
    assert mixed.mixed and mixed.pair_pad == 0 and not mixed.pair_kernel
    e0, f0 = plain.energy_forces(pos)
    e1, f1 = mixed.energy_forces(pos)
    assert torch.equal(e0, e1) and torch.equal(f0, f1)
    assert torch.equal(mixed.energy_only(pos), e0)


def test_mixed_f64_langevin_is_the_plain_run_bitwise():
    """20 f64 Langevin steps of trp-cage (two rebuild windows): mixed and
    the plain route give the same positions, velocities and energies."""
    d = load_dms(TRPCAGE)
    outs = []
    for kw in (dict(pair_kernel=False), dict(mixed=True)):
        sim = Simulation(d, device="cpu", dtype=F64,
                         caps=T.TreeCaps(*MD_CAPS), **MD_KW, **kw)
        run = sim.make_langevin_runner(neighbor_every=10)
        gen = torch.Generator().manual_seed(4)
        outs.append(run(sim.positions, sim.velocities, 20, generator=gen))
    assert outs[1][2].shape == (20,)
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# (d) 1li2 at NoCutoff


@pytest.fixture(scope="module")
def li2():
    d = load_dms(LI2)
    params = _dms_params(d)
    pos = np.asarray(d.positions, np.float64)
    m64 = AGBNPModel(params, device="cpu", dtype=F64, pair_kernel=False,
                     positions=pos)
    return params, pos, m64


def test_li2_mixed_is_closer_to_f64_and_matches_jax(li2):
    """1li2 (1310 atoms) at NoCutoff, over its DMS pose and 15 poses
    jittered by 0.02 nm: the f32 mixed energy lands closer to f64 than the
    plain f32 energy on average, each within 2e-6 relative; the port's
    mixed f32 agrees with JAX's mixed f32 at the DMS pose to 2e-6 in energy
    and 1e-5 of max|f|.

    One pose alone does not show it: torch's f32 sums are blocked, so the
    plain energy's error is already at the terms' own f32 roundoff (~1e-6)
    and at a single pose the two modes often round to the same f32 energy
    (at the DMS pose with two CPU threads they tie).  The mixed energy is
    also the same at any thread count; the plain one is not."""
    params, pos, m64 = li2
    plain = AGBNPModel(params, device="cpu", dtype=F32, pair_kernel=False,
                       caps=m64.caps)
    mixed = AGBNPModel(params, device="cpu", dtype=F32, mixed=True,
                       caps=m64.caps)
    rng = np.random.default_rng(3)
    poses = [pos] + [pos + 0.02 * rng.standard_normal(pos.shape)
                     for _ in range(15)]
    err_p, err_m = [], []
    for x in poses:
        e64 = m64.energy_only(x)
        err_p.append(_rel(plain.energy_only(x), e64))
        err_m.append(_rel(mixed.energy_only(x), e64))
    assert np.mean(err_m) < np.mean(err_p), (err_m, err_p)
    assert max(err_m) <= 2e-6 and max(err_p) <= 1e-5
    e_m, f_m = mixed.energy_forces(pos)
    jm = JaxModel(_jparams(params), caps=_jcaps(m64.caps), version=1,
                  dtype=np.float32, mixed=True)
    assert jm.pair_pad == 0
    je, jf = jm.energy_forces(pos)
    assert _rel(e_m, je) <= 2e-6
    assert _fmax(f_m.numpy(), jf) <= 1e-5


# (e) mixed through the Simulation's rebuilds


def test_mixed_survives_regrow_and_resize():
    """Undersized capacities make run_md regrow (a rebuild of the model);
    resize_caps_to_current rebuilds it again: both keep mixed and the
    plain route, and the regrown run lands on the well-sized mixed run."""
    d = load_dms(TRPCAGE)
    ref = Simulation(d, device="cpu", dtype=F32, mixed=True,
                     caps=T.TreeCaps(*MD_CAPS), **MD_KW)
    want = ref.run_md(6, neighbor_every=3, segment=6, seed=3)
    assert want["regrows"] == 0
    sim = Simulation(d, device="cpu", dtype=F32, mixed=True, kmax=16,
                     caps=T.TreeCaps(caps=(256, 256, 256, 256, 128, 128, 128),
                                     offs=(8, 8, 8, 8, 4, 4)), **MD_KW)
    out = sim.run_md(6, neighbor_every=3, segment=6, seed=3)
    assert out["regrows"] >= 1 and sim.agbnp.caps.caps[0] > 256
    assert sim.agbnp.mixed and sim.agbnp.pair_pad == 0
    np.testing.assert_allclose(out["energies"], want["energies"], rtol=1e-5)
    sim.resize_caps_to_current(out["final_pos"])
    assert sim.agbnp.mixed and sim.agbnp.pair_pad == 0
    again = sim.run_md(3, neighbor_every=3, seed=2)
    assert again["regrows"] == 0 and np.isfinite(again["energies"]).all()


def test_replica_runners_evaluate_mixed(monkeypatch):
    """A mixed f32 Simulation through ReplicaEnsemble (windowed and
    per-step) and TemperatureREMD: every pair sum of their batched
    evaluations is widened to f64 (the replica paths evaluate through the
    Simulation's model, as JAX's vmapped runners do)."""
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.parallel.remd import \
        TemperatureREMD

    seen = []
    real = B._sum1

    def spy(x, accum_dtype, dim=1):
        seen.append((x.dtype, accum_dtype))
        return real(x, accum_dtype, dim=dim)

    monkeypatch.setattr(B, "_sum1", spy)
    sim = Simulation(load_dms(TRPCAGE), device="cpu", dtype=F32, mixed=True,
                     caps=T.TreeCaps(*MD_CAPS), **MD_KW)
    ens = ReplicaEnsemble(sim, 2)
    for every in (2, 0):
        _, (energies, *_) = ens.make_runner(neighbor_every=every)(
            ens.initial_states(jitter=1e-3), 3)
        assert energies.shape == (2, 3) and torch.isfinite(energies).all()
    remd = TemperatureREMD(sim, [300.0, 330.0])
    states, xgen = remd.initial_states(jitter=1e-3)
    _, out = remd.make_runner(steps_per_cycle=2, neighbor_every=2)(
        states, xgen, 2)
    assert torch.isfinite(torch.as_tensor(out["energies"])).all()
    assert len(seen) > 0
    assert all(d == F32 and acc == F64 for d, acc in seen), set(seen)


# (f) the scorer


def test_mixed_scorer_matches_jax_and_refines(small_system):
    """ConformerScorer(mixed=True) takes the plain route and scores as
    JAX's f32 mixed scorer does (1e-5 relative); refine runs under mixed;
    version 2 with mixed raises, as in JAX."""
    params, pos = small_system
    force = _build_force(params)
    rng = np.random.default_rng(7)
    batch = pos[None] + 0.01 * rng.standard_normal((3, *pos.shape))
    scorer = ConformerScorer(force, pos, dtype=F32, device="cpu", mixed=True)
    assert scorer.model.mixed and scorer.model.pair_pad == 0
    got = scorer.score(batch)["energy"].numpy()
    jscorer = JaxConformerScorer(_build_force(params, cls=JaxAGBNPForce),
                                 pos, dtype=np.float32, mixed=True)
    want = np.asarray(jscorer.score(batch)["energy"])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    res = scorer.refine(batch, maxiter=5)
    assert res["energy_trace"].shape == (3, 5)
    assert torch.isfinite(res["energy"]).all()
    assert (res["energy"] <= torch.as_tensor(got) + 1e-3).all()
    assert scorer.model.mixed
    with pytest.raises(ValueError, match="version-0/1 option"):
        ConformerScorer(_build_force(params, version=2), pos, dtype=F32,
                        device="cpu", mixed=True)


# (g) parameter gradients


def test_mixed_parameter_gradients(small_system):
    """ParameterGradients on a mixed model: at f64 bit for bit the plain
    model's; at f32 within 1e-4 of max|g| of JAX's mixed gradients."""
    params, pos = small_system
    rng = np.random.default_rng(3)
    poses = pos[None] + 0.005 * rng.standard_normal((2, *pos.shape))
    keys = ("alpha", "gamma")
    plain = AGBNPModel(params, device="cpu", dtype=F64, pair_kernel=False,
                       positions=pos)
    mixed64 = AGBNPModel(params, device="cpu", dtype=F64, mixed=True,
                         caps=plain.caps)
    g0 = ParameterGradients(plain).energy_grads(
        ParameterGradients(plain).initial_theta(keys), poses)
    g1 = ParameterGradients(mixed64).energy_grads(
        ParameterGradients(mixed64).initial_theta(keys), poses)
    for k in (*keys, "energy"):
        assert torch.equal(g0[k], g1[k]), k

    mixed32 = AGBNPModel(params, device="cpu", dtype=F32, mixed=True,
                         caps=plain.caps)
    pg = ParameterGradients(mixed32)
    got = pg.energy_grads(pg.initial_theta(keys), poses)
    jm = JaxModel(_jparams(params), caps=_jcaps(plain.caps), version=1,
                  dtype=np.float32, mixed=True)
    jpg = JaxParameterGradients(jm)
    want = jpg.energy_grads(jpg.initial_theta(keys), poses)
    for k in keys:
        g, w = got[k].numpy(), np.asarray(want[k], np.float64)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), k


# (h) the refusals


def test_mixed_refusals(fixture_system):
    """Where the JAX package drops mixed without a word, the port raises:
    an explicit pair_kernel=True (JAX's Pallas branch comes first,
    agbnp_jax.py:420), a version 2 Simulation (JAX hands mixed to the v1
    model only), and an atoms mesh (JAX's pair_shard branch comes first,
    agbnp_jax.py:437)."""
    params, pos = fixture_system
    with pytest.raises(ValueError, match="plain pair route"):
        AGBNPModel(params, device="cpu", dtype=F32, pair_kernel=True,
                   mixed=True)
    d = load_dms(TRPCAGE)
    with pytest.raises(ValueError, match="version-0/1 option"):
        Simulation(d, device="cpu", dtype=F32, version=2, mixed=True)
    sim = Simulation(d, device="cpu", dtype=F32, mixed=True,
                     caps=T.TreeCaps(*MD_CAPS), **MD_KW)
    mesh = S.Mesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                  axis="atoms")
    with pytest.raises(ValueError, match="mixed=True runs unsharded"):
        sim.force_fn(mesh=mesh, topology=())
    with pytest.raises(ValueError, match="mixed=True runs unsharded"):
        sim.make_langevin_runner(mesh=mesh)
    # the functional entry point refuses the kernel route and pair_shard
    m = AGBNPModel(params, device="cpu", dtype=F32)
    x = torch.as_tensor(pos, dtype=F32)
    kw = dict(caps=m.caps, version=1, roffset=params.roffset,
              ntypes_j=m.ntypes_j, mixed=True)
    with pytest.raises(ValueError, match="widens the plain route"):
        energy_forces(m.arrays, x, pair_pad=m.pair_pad, **kw)
    with pytest.raises(ValueError, match="widens the plain route"):
        energy_forces(m.arrays, x, pair_shard=lambda p, s: {}, **kw)
