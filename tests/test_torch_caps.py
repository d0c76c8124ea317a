"""Capacity sizing and what the MD benchmark reports, on the port.

The port sizes its tree capacities at construction by one tree build on the
model's device, with the headroom rules of the JAX package's native
pre-pass; MD runs leaner (caps_boost 1.10) than the one-shot model (1.6).
Also here: benchmark_langevin reports the steps that ran, and the shipped
systems that no other CPU test evaluates against their stored f64 results.
"""

import inspect
import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JSimulation
from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JModel
from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
    Simulation, TreeCaps, load_dms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")
CACHE = os.path.join(ROOT, "benchmarks", ".parity_cache")


def _system(name):
    d = load_dms(os.path.join(DATA, f"{name}_agbnp1.dms"))
    return d, AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                          alpha=d.agbnp_alpha, charge=d.charges,
                          ishydrogen=d.ishydrogen)


def _native_caps(params, pos, boost):
    from openmm_agbnp_plugin_tpu.runtime import native

    if native._load() is None:
        pytest.skip("the JAX package's native library did not build here")
    return native.size_tree_caps(params, np.asarray(pos), boost=boost)


@pytest.mark.parametrize("name", ["trpcage", "1li2"])
@pytest.mark.parametrize("boost", [1.10, 1.6])
def test_construction_caps_equal_the_native_prepass(name, boost):
    """Level by level and window by window, the port's construction-time
    capacities are the JAX package's size_tree_caps: both count the overlap
    tree at the large radii."""
    d, p = _system(name)
    m = AGBNPModel(p, device="cpu", dtype=torch.float64,
                   positions=d.positions, caps_boost=boost)
    ref = _native_caps(p, d.positions, boost)
    assert tuple(m.caps.caps) == tuple(ref.caps)
    assert tuple(m.caps.offs) == tuple(ref.offs)
    assert min(m.caps.offs) >= 4
    # leaner than the position-free heuristic, and clean on these positions
    heur = TreeCaps.for_natoms(p.n)
    assert sum(m.caps.caps) < sum(heur.caps)
    _, _, out = m.energy_forces(d.positions, with_details=True)
    assert not m.check_and_grow(out["diag"])


def test_caps_boost_defaults_and_the_position_free_heuristic():
    """Simulation defaults to 1.10 and AGBNPModel to 1.6, as in the JAX
    package; without positions the model keeps TreeCaps.for_natoms(n,
    boost / 1.6), and explicit caps are taken as given."""
    def default(fn, name="caps_boost"):
        return inspect.signature(fn).parameters[name].default

    assert default(Simulation.__init__) == default(JSimulation.__init__) \
        == 1.10
    assert default(AGBNPModel.__init__) == default(JModel.__init__) == 1.6
    d, p = _system("trpcage")
    kw = dict(device="cpu", dtype=torch.float64)
    assert AGBNPModel(p, **kw).caps == TreeCaps.for_natoms(p.n)
    assert AGBNPModel(p, caps_boost=3.2, **kw).caps \
        == TreeCaps.for_natoms(p.n, boost=2.0)
    assert AGBNPModel(p, caps_boost=1.1, **kw).caps \
        == TreeCaps.for_natoms(p.n)
    given = TreeCaps.for_natoms(p.n, boost=1.25)
    assert AGBNPModel(p, caps=given, positions=d.positions, **kw).caps \
        is given


def test_simulation_sizes_lean_and_resize_reuses_the_model_rule():
    d, p = _system("trpcage")
    sim = Simulation(d, device="cpu", dtype=torch.float64, cutoff=1.0)
    lean = AGBNPModel(p, device="cpu", dtype=torch.float64,
                      positions=d.positions, caps_boost=1.10).caps
    assert sim.agbnp.caps == lean
    roomy = Simulation(d, device="cpu", dtype=torch.float64, cutoff=1.0,
                       caps_boost=1.6).agbnp.caps
    assert all(a <= b for a, b in zip(lean.caps, roomy.caps))
    assert sum(lean.caps) < sum(roomy.caps)
    sim.resize_caps_to_current(caps_boost=1.3)
    assert sim.agbnp.caps == AGBNPModel(
        p, device="cpu", dtype=torch.float64, positions=d.positions,
        caps_boost=1.3).caps


def test_benchmark_langevin_reports_the_steps_that_ran():
    """Tile budgets of one entry overflow in the first window; with no
    regrow allowed the result says so and its rate counts the steps that
    ran, not the steps asked for."""
    d, _ = _system("trpcage")
    kw = dict(device="cpu", dtype=torch.float64, cutoff=1.0,
              descreen_horizon="cutoff")
    sim = Simulation(d, pair_tiles=(1, 1), **kw)
    r = sim.benchmark_langevin(nsteps=12, neighbor_every=4, warmup=False,
                               max_regrow=0)
    assert r["overflow"] is True and r["regrows"] == 0
    assert r["steps_run"] == 4 < 12
    assert r["energies"].shape == (r["steps_run"],)
    assert r["steps_per_s"] == r["steps_run"] / r["elapsed_s"]
    assert r["ns_day"] == r["steps_run"] * 0.001 * 1e-3 / r["elapsed_s"] \
        * 86400.0
    rep = sim.overflow_report(torch.as_tensor(r["tree_counts_max"]),
                              r["neighbor_max"], torch.zeros(7))
    assert "tile_list_born" in rep or "tile_list_gb" in rep

    # a clean run: every step ran, and the same fields
    clean = Simulation(d, **kw).benchmark_langevin(
        nsteps=8, neighbor_every=4, warmup=False)
    assert clean["overflow"] is False
    assert clean["steps_run"] == 8 == clean["energies"].shape[0]
    assert clean["steps_per_s"] == 8 / clean["elapsed_s"]
    assert np.isfinite(clean["energies"]).all()


@pytest.mark.parametrize("name,route", [("trpcage", "pairs"),
                                        ("rnaseh", "half_list"),
                                        ("1dwc", "cell_grid")])
def test_shipped_systems_against_their_f64_records(name, route):
    """AGBNP1 (no cutoff, 2 nm horizon) in f64 on the CPU against the JAX
    package's stored f64 results.  rnaseh (2,057 atoms) is the one shipped
    system whose tree candidates come from half_neighbor_pairs on the
    device without a cell grid; 1dwc takes the cell grid."""
    d, p = _system(name)
    m = AGBNPModel(p, device="cpu", dtype=torch.float64,
                   positions=d.positions)
    assert {"pairs": m.neighbor_kmax == 0,
            "half_list": m.neighbor_kmax > 0 and m.neighbor_grid is None,
            "cell_grid": m.neighbor_kmax > 0
            and m.neighbor_grid is not None}[route]
    e, f, out = m.energy_forces(d.positions, with_details=True)
    assert not m.check_and_grow(out["diag"])
    ref = np.load(os.path.join(CACHE, f"{name}_agbnp1_f64.npz"))
    assert abs(float(e) - float(ref["e"])) <= 1e-10 * abs(float(ref["e"]))
    assert np.abs(f.numpy() - ref["f"]).max() \
        <= 1e-10 * np.abs(ref["f"]).max()
