"""The port's cell-grid neighbor build, its on-device candidate path and the
large-system set-up against the JAX package, f64, plus the tile-list
overflow channel of the port's MD runner.

The neighbor lists are integer results and must equal JAX's exactly; the
energy and forces with on-device candidates match JAX within 1e-10.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JaxModel
from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    energy_forces as jax_energy_forces
from openmm_agbnp_plugin_tpu.models.oracle import AGBNPParams as JaxParams
from openmm_agbnp_plugin_tpu.ops import neighbors as JN
from openmm_agbnp_plugin_tpu.ops.tree import TreeCaps as JaxCaps
from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
    Simulation, TreeCaps, load_dms
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import energy_forces
from openmm_agbnp_plugin_tpu_torch.ops import neighbors as N

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data")
# the 264-atom fixture's tree capacities (tests/test_torch_model.py)
CAPS = ((3840, 8192, 7296, 3712, 1408, 384, 256), (48, 32, 24, 16, 8, 4))


def dms_params(path, params_cls):
    d = load_dms(path)
    return d, params_cls(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                         alpha=d.agbnp_alpha, charge=d.charges,
                         ishydrogen=d.ishydrogen)


@pytest.fixture(scope="module")
def li2():
    d, p = dms_params(os.path.join(DATA, "1li2_agbnp1.dms"), AGBNPParams)
    heavy = np.asarray(p.ishydrogen) == 0
    rcut = N.tree_pair_cutoff(p.radii_large) + 0.25
    return np.asarray(d.positions, np.float64), heavy, rcut


def grid_fields(g):
    return (g.rcut, g.margin, g.ccap, g.ncells, np.asarray(g.origin),
            np.asarray(g.dims), np.asarray(g.stencil))


def assert_same_grid(gt, gj):
    for x, y in zip(grid_fields(gt), grid_fields(gj)):
        np.testing.assert_array_equal(x, y)


def test_cell_grid_and_pairs_equal_jax(li2):
    pos, heavy, rcut = li2
    gj = JN.CellGrid(pos, rcut, heavy_mask=heavy)
    gt = N.CellGrid(pos, rcut, heavy_mask=heavy)
    assert_same_grid(gt, gj)
    assert_same_grid(gt.grown(), gj.grown())
    assert gt.grown().ccap == 2 * gt.ccap
    kmax = N.host_max_neighbors(pos, heavy, rcut) + 8
    # move the solute off the sizing configuration: the origin follows it
    moved = pos + np.array([0.3, -0.2, 0.1])
    out_j = JN.cell_neighbor_pairs(jnp.asarray(moved), jnp.asarray(heavy),
                                   rcut, kmax, grid=gj)
    out_t = N.cell_neighbor_pairs(torch.as_tensor(moved),
                                  torch.as_tensor(heavy), rcut, kmax, grid=gt)
    for x, y in zip(out_t, out_j):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(out_t[3]) <= kmax
    # the cell list holds the same pairs as the all-pairs half list
    dense = N.half_neighbor_pairs(torch.as_tensor(moved),
                                  torch.as_tensor(heavy), rcut, kmax)
    for x, y in zip(out_t, dense):
        assert torch.equal(x, y)
    # a small cell capacity overflows and reports kmax + 1 in both (JAX
    # needs 27 ccap >= kmax to build its [N, kmax] list at all)
    ccap = -(-kmax // 27)
    assert ccap < gt.ccap // 2
    tj = JN.CellGrid(pos, rcut, heavy_mask=heavy, ccap=ccap)
    tt = N.CellGrid(pos, rcut, heavy_mask=heavy, ccap=ccap)
    assert_same_grid(tt, tj)
    nb_j = JN.cell_neighbor_pairs(jnp.asarray(pos), jnp.asarray(heavy), rcut,
                                  kmax, grid=tj)[3]
    nb_t = N.cell_neighbor_pairs(torch.as_tensor(pos), torch.as_tensor(heavy),
                                 rcut, kmax, grid=tt)[3]
    assert int(nb_t) == int(nb_j) == kmax + 1


def test_energy_forces_with_device_candidates_matches_jax(gaussvol_system):
    """The cell-grid candidate path of energy_forces on the 264-atom
    fixture: port (kernel route, plain twins) against JAX's dense XLA
    phases."""
    params, pos = gaussvol_system
    heavy = np.asarray(params.ishydrogen) == 0
    rcut = N.tree_pair_cutoff(params.radii_large) + 0.05
    kmax = int(np.ceil(N.host_max_neighbors(pos, heavy, rcut) * 1.5 / 16) * 16)
    kw = dict(neighbor_rcut=rcut, neighbor_kmax=kmax, cutoff=1.0,
              descreen_horizon=1.0)
    jm = JaxModel(params, caps=JaxCaps(*CAPS), version=1, cutoff=1.0,
                  positions=pos, pair_kernel=False)
    out_j = jax.jit(lambda a, x: jax_energy_forces(
        a, x, caps=JaxCaps(*CAPS), version=1, roffset=params.roffset,
        ntypes_j=jm.ntypes_j, neighbor_grid=JN.CellGrid(
            pos, rcut, heavy_mask=heavy), **kw))(jm.arrays, jnp.asarray(pos))
    tp = AGBNPParams(radius=params.radius, gamma=params.gamma,
                     alpha=params.alpha, charge=params.charge,
                     ishydrogen=params.ishydrogen)
    tm = AGBNPModel(tp, device="cpu", caps=TreeCaps(*CAPS), cutoff=1.0,
                    positions=pos)
    out_t = energy_forces(tm.arrays, torch.as_tensor(pos),
                          caps=TreeCaps(*CAPS), version=1,
                          roffset=tp.roffset, ntypes_j=tm.ntypes_j,
                          pair_pad=tm.pair_pad, pair_tiles=tm.pair_tiles,
                          neighbor_grid=N.CellGrid(pos, rcut,
                                                   heavy_mask=heavy), **kw)
    assert int(out_t["diag"]["neighbor_max"]) == int(
        out_j["diag"]["neighbor_max"]) <= kmax
    assert int(out_t["diag"]["neighbor_kmax"]) == kmax
    np.testing.assert_array_equal(out_t["diag"]["counts"].numpy(),
                                  np.asarray(out_j["diag"]["counts"]))
    e_j, f_j = float(out_j["energy"]), np.asarray(out_j["force"])
    assert abs(float(out_t["energy"]) - e_j) <= 1e-10 * abs(e_j)
    assert (np.abs(out_t["force"].numpy() - f_j).max()
            <= 1e-10 * np.abs(f_j).max())


def test_2clr_model_setup_matches_jax():
    """5,983 atoms: both packages size the same on-device candidate path
    (neighbor width, cell grid) and the same tile-list budgets, without
    evaluating anything."""
    path = os.path.join(DATA, "2clr_agbnp1.dms")
    kw = dict(version=1, cutoff=1.0, descreen_horizon="cutoff")
    caps = TreeCaps.for_natoms(5983)
    d, tp = dms_params(path, AGBNPParams)
    dj = jax_load_dms(path)
    jp = JaxParams(radius=dj.agbnp_radius, gamma=dj.agbnp_gamma,
                   alpha=dj.agbnp_alpha, charge=dj.charges,
                   ishydrogen=dj.ishydrogen)
    jm = JaxModel(jp, caps=JaxCaps(caps.caps, caps.offs), dtype=np.float32,
                  positions=dj.positions, pair_kernel=True, **kw)
    tm = AGBNPModel(tp, device="cpu", dtype=torch.float32, caps=caps,
                    positions=d.positions, **kw)
    assert tm.neighbor_kmax == jm.neighbor_kmax > 0
    assert tm.neighbor_rcut == jm.neighbor_rcut
    assert_same_grid(tm.neighbor_grid, jm.neighbor_grid)
    assert tm.pair_tiles == jm.pair_tiles == (312, 300)
    assert tm.arrays["pairs_i"].shape == (1,)    # no all-pairs list


def test_tile_list_overflow_regrows_in_md():
    """PanicButton on the tile lists: trp-cage with (1, 1) budgets reports
    tile_list_born (and tile_list_gb) after the first window, regrows, and
    the rerun is clean."""
    d = load_dms(os.path.join(DATA, "trpcage_agbnp1.dms"))
    sim = Simulation(d, device="cpu", dtype=torch.float64, cutoff=1.0,
                     skin=0.25, descreen_horizon="cutoff", pair_tiles=(1, 1),
                     caps=TreeCaps((3840, 8192, 7424, 3840, 1408, 384, 256),
                                   (48, 32, 24, 16, 8, 4)))
    run = sim.make_langevin_runner(neighbor_every=2)
    _, _, e, diag = run(sim.positions, sim.velocities, 4,
                        generator=torch.Generator().manual_seed(0))
    report = sim.overflow_report(*diag)
    assert set(report) == {"tile_list_born", "tile_list_gb"}
    assert report["tile_list_born"][1] == 1 and e.shape == (2,)
    r = sim.benchmark_langevin(nsteps=4, neighbor_every=2, warmup=False,
                               max_regrow=2)
    assert r["regrows"] == 1 and not r["overflow"]
    lb, lg = sim.agbnp.pair_tiles
    assert lb >= report["tile_list_born"][0] and lg >= report["tile_list_gb"][0]
    assert np.isfinite(r["energies"]).all() and r["energies"].shape == (4,)
