"""The port's sharding over torch.distributed, on gloo ranks on the CPU.

Mirrors the JAX package's tests/test_parallel.py (its virtual 8-device CPU
mesh) with the port's counterpart, ranks started by
parallel/sharding.py::run_ranks (spawned processes, a file:// rendezvous
under tmp_path, one thread each, a timeout that kills them):

  * pair_phases_rows over the full row block with identity hooks equals the
    port's dense pair phases to 1e-12;
  * on the 264-atom fixture and 4 ranks, sharded_pair_phases (through
    energy_forces' pair_shard) and sharded_energy_forces equal JAX's
    unsharded energy_forces to 1e-10 and the port's to 1e-12, every rank
    with the same bits, and the comm log of one evaluation equals JAX's on
    atom_mesh(4) entry by entry (the entries where JAX moves its 8-lane
    TPU layout carry the port's unpadded columns);
  * make_langevin_runner(mesh=) on 4 ranks equals the plain runner to
    rtol 1e-12 (trp-cage f64, 12 steps in windows of 6);
  * ReplicaEnsemble, TemperatureREMD and ConformerScorer over a 2-rank
    replica mesh equal their mesh=None results bit for bit;
  * the refusals, and run_ranks failing (not hanging) on a lost rank.

The functions the ranks run live in this module and import only the port
(the ranks import this module, never the JAX package).
"""

import os
import time

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch.parallel import sharding as S

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "gaussvol.dat")
TRPCAGE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data",
                       "trpcage_agbnp1.dms")
RANK_TIMEOUT = 240.0


def _ranks(tmp_path, fn, world, args=()):
    return S.run_ranks(fn, world, args=args, device="cpu", threads=1,
                       timeout=RANK_TIMEOUT, init_file=tmp_path / "rdv")


def fixture_system():
    """The 264-atom fixture on the port: (params, arrays, pos, caps,
    topology of one all-pairs build, ntypes_j)."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPParams, load_gaussvol_dat
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
        arrays_from_numpy, prepare_arrays)
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(FIXTURE)
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    a = arrays_from_numpy(prepare_arrays(p), "cpu", torch.float64)
    pos = torch.as_tensor(pos, dtype=torch.float64)
    caps = T.TreeCaps.for_natoms(p.n)
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                         a["gamma"] / p.roffset, a["ishydrogen"])
    levels, _ = T.build_tree(lvl1, a["pairs_i"], a["pairs_j"], caps,
                             pairs_valid=a["pairs_valid"])
    return p, a, pos, caps, T.tree_topology(levels), \
        int(a["type_j"].max()) + 1


def rank_fixture_evaluation():
    """One rank's sharded evaluations of the fixture on the atoms mesh:
    sharded_energy_forces (its comm log recorded) and energy_forces with
    sharded_pair_phases."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
        energy_forces
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    p, a, pos, caps, topo, ntj = fixture_system()
    mesh = S.atom_mesh()
    fn = S.sharded_energy_forces(mesh, a, p.roffset, ntj)
    log = T.start_comm_log()
    try:
        out = fn(pos, topo)
    finally:
        T.stop_comm_log()
    pp = energy_forces(a, pos, caps=caps, version=1, roffset=p.roffset,
                       ntypes_j=ntj,
                       pair_shard=S.sharded_pair_phases(mesh, a, ntj))
    return dict(tree=out, log=log,
                pair=dict(energy=pp["energy"], force=pp["force"],
                          born_radius=pp["details"]["born_radius"]))


@pytest.fixture(scope="module")
def fixture_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory.mktemp("atoms"), rank_fixture_evaluation,
                  4)


@pytest.fixture(scope="module")
def port_reference():
    """The port's unsharded evaluations: on the build's topology, and all
    pairs from scratch (the reference of the pair_shard path)."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
        energy_forces

    p, a, pos, caps, topo, ntj = fixture_system()
    kw = dict(caps=caps, version=1, roffset=p.roffset, ntypes_j=ntj)
    return dict(topo=energy_forces(a, pos, topology=topo, **kw),
                full=energy_forces(a, pos, **kw))


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.max(np.abs(x - ref)) / max(np.max(np.abs(ref)), 1e-300))


def test_pair_phases_rows_full_block_is_the_dense_path():
    """With identity hooks and every row in one block, pair_phases_rows
    gives the dense ops/born.py phases (born_radii, gb_energy,
    descreening_sweep) to 1e-12, with and without a cutoff and a box."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
        _pair_phases_plain
    from openmm_agbnp_plugin_tpu_torch.ops.born import pair_phases_rows

    p, a, pos, caps, topo, ntj = fixture_system()
    n = p.n
    rng = np.random.default_rng(3)
    s_factor = torch.as_tensor(rng.uniform(0.3, 1.0, n))
    for cutoff, box in ((None, None), (1.0, None), (1.0, (3.0, 3.2, 3.4))):
        boxt = None if box is None else torch.as_tensor(box)
        ref = _pair_phases_plain(a, pos, s_factor, cutoff, boxt, ntj)
        out = pair_phases_rows(
            pos, torch.arange(n), pos, a["radii_vdw"], s_factor,
            a["ishydrogen"], a["type_i"], a["type_j"], a["yflat"],
            a["y2flat"], ntj, a["charge"], a["charge"], a["alpha"],
            cutoff=cutoff, box=boxt)
        for k in ("gb_self", "gb_pair", "e_vdw"):
            assert abs(float(out[k]) - float(ref[k])) <= 1e-12 * abs(
                float(ref[k])), k
        for k in ("born_radius", "evdw_der_W", "egb_der_U"):
            assert _rel(out[k], ref[k]) <= 1e-12, k
        assert torch.equal(out["born_radius"], out["born_radius_all"])
        assert _rel(out["row_force"] + out["col_force"],
                    ref["pair_force"]) <= 1e-12


def test_sharded_evaluations_match_the_port(fixture_ranks, port_reference):
    """sharded_energy_forces and the pair_shard path on 4 ranks equal the
    port's unsharded evaluations to 1e-12, and every rank holds the same
    bits."""
    ref, full = port_reference["topo"], port_reference["full"]
    for r in fixture_ranks:
        out, pp = r["tree"], r["pair"]
        assert abs(float(out["energy"]) - float(ref["energy"])) <= 1e-12 * \
            abs(float(ref["energy"]))
        assert _rel(out["force"], ref["force"]) <= 1e-12
        assert _rel(out["self_volume"], ref["details"]["self_volume"]) \
            <= 1e-12
        assert _rel(out["born_radius"], ref["details"]["born_radius"]) \
            <= 1e-12
        assert abs(float(pp["energy"]) - float(full["energy"])) <= 1e-12 * \
            abs(float(full["energy"]))
        assert _rel(pp["force"], full["force"]) <= 1e-12
        assert _rel(pp["born_radius"], full["details"]["born_radius"]) \
            <= 1e-12
    first = fixture_ranks[0]
    for r in fixture_ranks[1:]:
        for part in ("tree", "pair"):
            for k, v in first[part].items():
                assert np.array_equal(r[part][k], v), (part, k)


@pytest.fixture(scope="module")
def jax_fixture(gaussvol_system):
    """JAX's unsharded energy_forces of the fixture (all pairs, and on its
    own build's topology) and the comm log of its sharded_energy_forces on
    atom_mesh(4)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from openmm_agbnp_plugin_tpu.models.agbnp_jax import (
        energy_forces, prepare_arrays)
    from openmm_agbnp_plugin_tpu.ops import tree as T
    from openmm_agbnp_plugin_tpu.parallel.sharding import (
        atom_mesh, sharded_energy_forces)

    params, pos = gaussvol_system
    arrays = prepare_arrays(params, dtype=np.float64)
    caps = T.TreeCaps.for_natoms(params.n)
    ntj = int(np.max(np.asarray(arrays["type_j"])) + 1)
    pos = jnp.asarray(pos)
    lvl1 = T.make_level1(pos, jnp.asarray(arrays["radii_large"]),
                         jnp.asarray(arrays["vol_large"]),
                         jnp.asarray(arrays["gamma"]) / params.roffset,
                         jnp.asarray(arrays["ishydrogen"]))
    levels, _ = jax.jit(lambda: T.build_tree(
        lvl1, arrays["pairs_i"], arrays["pairs_j"], caps,
        pairs_valid=arrays["pairs_valid"]))()
    topo = T.tree_topology(levels)
    kw = dict(caps=caps, version=1, roffset=params.roffset, ntypes_j=ntj)
    full = jax.jit(partial(energy_forces, **kw))(arrays, pos)
    ref = jax.jit(partial(energy_forces, topology=topo, **kw))(arrays, pos)
    fn = jax.jit(sharded_energy_forces(atom_mesh(4), arrays, params.roffset,
                                       ntj))
    log = T.start_comm_log()
    try:
        jax.block_until_ready(fn(pos, topo))
    finally:
        T.stop_comm_log()
    return dict(full=full, topo=ref, log=log)


def test_sharded_evaluations_match_jax(fixture_ranks, jax_fixture):
    """The port's sharded evaluations on 4 ranks equal JAX's unsharded
    energy_forces to 1e-10 relative in energy and forces."""
    for name, part in (("topo", "tree"), ("full", "pair")):
        ref = jax_fixture[name]
        out = fixture_ranks[0][part]
        assert abs(float(out["energy"]) - float(ref["energy"])) <= 1e-10 * \
            abs(float(ref["energy"])), name
        assert _rel(out["force"], ref["force"]) <= 1e-10, name
        assert _rel(out["born_radius"],
                    ref["details"]["born_radius"]) <= 1e-10, name


def test_comm_log_matches_jax_entry_by_entry(fixture_ranks, jax_fixture):
    """The port's collectives for one sharded_energy_forces evaluation are
    JAX's, in order: the same kinds, dtypes and rows, and the same columns
    and bytes except where JAX moves its TPU layout: the W/U gamma rescan
    gathers 8-lane rows (gamma in lane 0; the port gathers the gamma
    column) and the deposits' psums carry columns zero-padded to 8 (the
    port sums its 7 and 3 deposit columns)."""
    port, jx = fixture_ranks[0]["log"], jax_fixture["log"]
    assert len(port) == len(jx) == 38
    lane8 = 0
    for e, j in zip(port, jx):
        assert (e["kind"], e["dtype"], e["ndev"]) == \
            (j["kind"], j["dtype"], j["ndev"])
        assert e["shape"][:1] == j["shape"][:1]
        if e["shape"] == j["shape"]:
            assert e["bytes"] == j["bytes"]
            continue
        lane8 += 1
        assert j["shape"][1:] == (8,)
        cols = e["shape"][1] if len(e["shape"]) == 2 else 1
        assert cols < 8
        assert e["bytes"] == j["bytes"] // 8 * cols
    # 7 gamma gathers (one a level) and the two deposit psums
    assert lane8 == 9
    gam = [e for e, j in zip(port, jx) if len(e["shape"]) == 1
           and j["shape"][1:] == (8,)]
    assert len(gam) == 7 and all(e["kind"] == "all_gather" for e in gam)


def _trpcage_sim():
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    return Simulation(load_dms(TRPCAGE), version=1, dtype=torch.float64,
                      device="cpu")


def rank_sharded_md(nsteps, every, seed):
    sim = _trpcage_sim()
    run = sim.make_langevin_runner(dt=0.001, neighbor_every=every,
                                   mesh=S.atom_mesh())
    gen = torch.Generator().manual_seed(seed)
    pos, vel, energies, diag = run(sim.positions, sim.velocities, nsteps,
                                   generator=gen)
    return dict(pos=pos, vel=vel, energies=energies,
                overflow=sim._check_overflow(*diag))


def _plain_md(nsteps, every, seed):
    sim = _trpcage_sim()
    run = sim.make_langevin_runner(dt=0.001, neighbor_every=every)
    gen = torch.Generator().manual_seed(seed)
    pos, vel, energies, diag = run(sim.positions, sim.velocities, nsteps,
                                   generator=gen)
    assert not sim._check_overflow(*diag)
    return pos.numpy(), energies.numpy()


def _check_md(outs, nsteps, every, seed):
    pos_p, e_p = _plain_md(nsteps, every, seed)
    first = outs[0]
    assert not first["overflow"]
    np.testing.assert_allclose(first["energies"], e_p, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(first["pos"], pos_p, rtol=0, atol=1e-12)
    for r in outs[1:]:
        for k in ("pos", "vel", "energies"):
            assert np.array_equal(r[k], first[k]), k


def test_sharded_md_runner_matches_plain(tmp_path):
    """make_langevin_runner(mesh=) on a 4-rank atoms mesh reproduces the
    plain runner's trajectory (the same noise) to f64 roundoff, and the
    ranks hold the same bits (JAX test_parallel.py:144-164)."""
    _check_md(_ranks(tmp_path, rank_sharded_md, 4, (12, 6, 7)), 12, 6, 7)


@pytest.mark.slow
def test_sharded_md_runner_eight_ranks(tmp_path):
    """The same on 8 ranks, the JAX test's device count."""
    _check_md(_ranks(tmp_path, rank_sharded_md, 8, (12, 6, 7)), 12, 6, 7)


def _poses(n):
    from openmm_agbnp_plugin_tpu_torch import load_dms

    dms = load_dms(TRPCAGE)
    rng = np.random.default_rng(0)
    return dms, dms.positions[None] + 0.004 * rng.standard_normal(
        (n,) + dms.positions.shape)


def replica_workloads(mesh):
    """A 4-replica ensemble (two windows of 3 and a remainder of 1), a
    2-cycle T-REMD over 4 rungs and a 7-pose score with forces (padded to
    8 over 2 ranks), on trp-cage in f64; every output whole."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, ConformerScorer
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        ReplicaEnsemble
    from openmm_agbnp_plugin_tpu_torch.parallel.remd import (
        TemperatureREMD, geometric_ladder)

    sim = _trpcage_sim()
    ens = ReplicaEnsemble(sim, 4, mesh=mesh)
    states, (energies, *diag) = ens.make_runner(neighbor_every=3)(
        ens.initial_states(jitter=1e-3), 7)
    remd = TemperatureREMD(sim, geometric_ladder(300.0, 400.0, 4), mesh=mesh)
    rstates, xgen = remd.initial_states(jitter=1e-3)
    _, rout = remd.make_runner(steps_per_cycle=4, neighbor_every=2)(
        rstates, xgen, 2)
    dms, poses = _poses(7)
    force = AGBNPForce()
    force.setVersion(1)
    for i in range(dms.n):
        force.addParticle(dms.agbnp_radius[i], dms.agbnp_gamma[i],
                          dms.agbnp_alpha[i], dms.charges[i],
                          bool(dms.ishydrogen[i]))
    scorer = ConformerScorer(force, dms.positions, dtype=torch.float64,
                             device="cpu", mesh=mesh)
    score = scorer.score(poses, forces=True, details=True)
    return dict(ens=dict(energies=energies, counts=diag[0]),
                ens_pos=states[0],
                remd={k: v for k, v in rout.items() if v is not None},
                score=score)


def rank_replica_workloads():
    return replica_workloads(S.replica_mesh())


@pytest.fixture(scope="module")
def replica_runs(tmp_path_factory):
    ranks = _ranks(tmp_path_factory.mktemp("replica"),
                   rank_replica_workloads, 2)
    torch.set_num_threads(1)
    single = S._to_host(replica_workloads(None))
    return ranks, single


@pytest.mark.parametrize("part", ["ens", "remd", "score"])
def test_replica_mesh_matches_one_process(replica_runs, part):
    """ReplicaEnsemble, TemperatureREMD and ConformerScorer over a 2-rank
    replica mesh give every rank the results of mesh=None bit for bit (the
    same batched path on each block, replica r's generator seeded seed + r
    on whichever rank holds it)."""
    ranks, single = replica_runs
    for r in ranks:
        assert set(r[part]) == set(single[part])
        for k, v in single[part].items():
            assert np.array_equal(r[part][k], v), (part, k)
    if part == "ens":
        # the states stay on their rank: each holds its block
        assert np.array_equal(ranks[0]["ens_pos"], single["ens_pos"][:2])
        assert np.array_equal(ranks[1]["ens_pos"], single["ens_pos"][2:])


def _double_and_shift(state):
    pos, vel = state
    return pos * 2.0 + 1.0, vel - pos


def rank_replica_step():
    mesh = S.replica_mesh(device="cpu")
    states = (torch.arange(24.0).reshape(4, 2, 3),
              torch.ones(4, 2, 3))
    run = S.make_replica_ensemble_step(_double_and_shift, mesh)
    return run(states), mesh.block(4)


def test_make_replica_ensemble_step(tmp_path):
    """A per-replica step over a 2-rank replica mesh: each rank steps its
    block and every rank gets every replica's new state (JAX
    sharding.py:35-54)."""
    out = _ranks(tmp_path, rank_replica_step, 2)
    states = (torch.arange(24.0).reshape(4, 2, 3), torch.ones(4, 2, 3))
    want = [_double_and_shift((states[0][r], states[1][r]))
            for r in range(4)]
    for (got, blk), rank in zip(out, range(2)):
        assert (blk.start, blk.stop) == (2 * rank, 2 * rank + 2)
        for i in range(2):
            assert np.array_equal(
                got[i], torch.stack([w[i] for w in want]).numpy())


def test_mesh_refusals():
    """A mesh needs an initialised process group, version 1 and rebuild
    windows, and takes no MTS, WU impulse or MTS split; a replica mesh
    needs equal blocks (JAX md/simulation.py:280-294, 542-551)."""
    with pytest.raises(RuntimeError, match="not initialised"):
        S.atom_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="not initialised"):
        S.replica_mesh(device="cpu")
    mesh = S.Mesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                  axis="atoms")
    sim = _trpcage_sim()
    for kw in (dict(neighbor_every=0), dict(rebuild_topology=False)):
        with pytest.raises(ValueError, match="topology-rebuild windows"):
            sim.make_langevin_runner(mesh=mesh, **kw)
    for kw in (dict(mts_inner=2), dict(wu_every=4)):
        with pytest.raises(ValueError, match="no MTS"):
            sim.make_langevin_runner(mesh=mesh, **kw)
    with pytest.raises(ValueError, match="prebuilt topology"):
        sim.force_fn(mesh=mesh)
    with pytest.raises(ValueError, match="no MTS split"):
        sim.force_fn(mesh=mesh, topology=(), split=True)
    sim.agbnp2 = object()  # a version 2 Simulation's marker
    with pytest.raises(ValueError, match="requires version 1"):
        sim.make_langevin_runner(mesh=mesh)
    with pytest.raises(ValueError, match="requires version 1"):
        sim.force_fn(mesh=mesh, topology=())
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import \
        ReplicaEnsemble

    with pytest.raises(ValueError, match="equal blocks"):
        ReplicaEnsemble(_trpcage_sim(), 3,
                        mesh=S.Mesh(None, 0, 2, torch.device("cpu"),
                                    "replica"))


def rank_lost_collective():
    """Rank 1 fails; rank 0 waits in a collective it never completes."""
    if S.atom_mesh(device="cpu").rank == 1:
        raise ValueError("rank 1 lost")
    S.atom_mesh(device="cpu").gather(torch.zeros(2))
    return "never"


def rank_sleep(seconds):
    time.sleep(seconds)
    return seconds


def test_run_ranks_fails_instead_of_hanging(tmp_path):
    """A rank that raises ends the run with its traceback; a run past the
    timeout ends with TimeoutError; either way no rank is left running."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 lost"):
        S.run_ranks(rank_lost_collective, 2, device="cpu", threads=1,
                    timeout=60.0, init_file=tmp_path / "a")
    with pytest.raises(TimeoutError):
        S.run_ranks(rank_sleep, 2, args=(120.0,), device="cpu", threads=1,
                    timeout=4.0, init_file=tmp_path / "b")
    assert time.monotonic() - t0 < 45.0
    assert S.run_ranks(rank_sleep, 2, args=(0.0,), device="cpu", threads=1,
                       timeout=60.0, init_file=tmp_path / "c") == [0.0, 0.0]
