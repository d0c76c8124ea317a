"""The Simulation options the port takes from the JAX package, against
the JAX package, f64 on the CPU, on trp-cage (272 atoms): include_mm=False
(the AGBNP part alone), pair_kernel=False (the dense ops/born.py pair
phases; JAX's own route on the CPU at f64) and
make_langevin_runner(topology_relax=0.5) (birth-margin rows in each
window's tree, ops/tree.py::build_tree's relax), each a 2-step rebuild
window fed JAX's noise and held to 1e-9; and build_tree(relax=None)
against the build without it.  (`pairs` is held in
tests/test_torch_per_step.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from test_torch_replica_md import DMS, KW, _close

torch.set_num_threads(2)

STEPS = 2
RELAX = 0.5
# room for the relaxed build's birth-margin rows (JAX's sizing leaves none)
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))


def _window(jkw, tkw, runner_kw):
    """A STEPS-step rebuild window of JAX's Simulation(**jkw) and the
    port's Simulation(**tkw) (JAX's capacities), the port fed JAX's noise;
    returns the port's Simulation and both results."""
    jsim = JaxSimulation(jax_load_dms(DMS), dtype=np.float64,
                         pair_tiles=False, **jkw, **KW)
    caps = jsim.agbnp.caps
    tsim = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(caps.caps, caps.offs), **tkw, **KW)
    key = jax.random.PRNGKey(7)
    jout = jsim.make_langevin_runner(
        0.001, 300.0, 1.0, neighbor_every=STEPS, scan_unroll=1,
        **runner_kw)(jsim.positions, jsim.velocities, key, STEPS)
    noise = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            sub, jsim.positions.shape, dtype=jnp.float64)))
    return tsim, jout, torch.as_tensor(np.stack(noise))


def _held(tsim, jout, noise, runner_kw, **ports):
    """The port's window on each port Simulation against JAX's result."""
    jpos, jvel, _, je, _ = jout
    for sim in (tsim, *ports.values()):
        pos, vel, e, diag = sim.make_langevin_runner(
            0.001, 300.0, 1.0, neighbor_every=STEPS, **runner_kw)(
                sim.positions, sim.velocities, STEPS, noise=noise)
        assert not sim._check_overflow(*diag)
        _close(e, je)
        _close(pos, jpos)
        _close(vel, jvel)


def test_include_mm_false_window_matches_jax():
    """Without the OPLS force field: the window's forces are the AGBNP part
    alone, on the kernel route's twins and on the plain route; MTS, which
    needs the bonded class, raises as in JAX."""
    kw = dict(include_mm=False)
    tsim, jout, noise = _window(kw, kw, {})
    assert tsim.mm is None and set(tsim.ff_state()) == {"a"}
    caps = tsim.agbnp.caps
    plain = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                       caps=caps, include_mm=False, pair_kernel=False, **KW)
    _held(tsim, jout, noise, {}, plain=plain)
    e_sim = tsim.force_fn()(tsim.positions)[0]
    e_model = tsim.agbnp.energy_forces(tsim.positions)[0]
    assert float(abs(e_sim - e_model)) <= 1e-12 * float(abs(e_model))
    with pytest.raises(ValueError, match="MTS needs an MM force field"):
        tsim.force_fn(split=True)


def test_pair_kernel_false_and_topology_relax_windows_match_jax():
    """make_langevin_runner(topology_relax=0.5) on the kernel route's twins
    and with pair_kernel=False (the dense ops/born.py phases, which the
    model then runs: pair_pad 0) against JAX's relaxed window on its own
    dense route."""
    tsim, jout, noise = _window(
        dict(pair_kernel=False, caps=JT.TreeCaps(*CAPS)), {},
        dict(topology_relax=RELAX))
    plain = Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                       caps=tsim.agbnp.caps, pair_kernel=False, **KW)
    assert plain.agbnp.pair_pad == 0 and tsim.agbnp.pair_pad > 0
    _held(tsim, jout, noise, dict(topology_relax=RELAX), plain=plain)


def test_build_tree_relax_none_is_the_plain_build():
    """build_tree(relax=None) is bitwise the build without the argument;
    relax=0.5 keeps more rows at every level whose switched volumes are 0,
    so the cavity energy moves by less than 1e-7 relative (JAX's relaxed
    build gives the same energy; the window above holds the relaxed build
    against JAX's)."""
    d = load_dms(DMS)
    sim = Simulation(d, device="cpu", dtype=torch.float64, **KW)
    a = sim.agbnp.arrays
    pos = sim.positions
    pi, pj, pv, _ = sim.neighbor_fn(pos, sim.heavy_mask, sim.rcut_list,
                                    sim.kmax)
    gdr = a["gamma"] / sim.agbnp.params.roffset
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"], gdr,
                         a["ishydrogen"])
    caps = T.TreeCaps(*CAPS)

    def build(**kw):
        return T.build_tree(lvl1, pi, pj, caps, pairs_valid=pv,
                            pair_rows=True, **kw)

    base, dbase = build()
    same, dsame = build(relax=None)
    for la, lb in zip(base, same):
        for k in ("_dat", "_ints", "valid"):
            assert torch.equal(la[k], lb[k])
    for k in dbase:
        assert torch.equal(torch.as_tensor(dbase[k]),
                           torch.as_tensor(dsame[k]))
    relaxed, drel = build(relax=RELAX)
    assert (drel["counts"] >= dbase["counts"]).all()
    assert int(drel["counts"].sum()) > int(dbase["counts"].sum())
    e0 = T.reduce_tree(base, lvl1, with_selfvol=False)["energy"]
    e1 = T.reduce_tree(relaxed, lvl1, with_selfvol=False)["energy"]
    assert float(abs(e1 - e0)) <= 1e-7 * float(abs(e0))
