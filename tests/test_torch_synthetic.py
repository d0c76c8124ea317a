"""The port's synthetic protein-like ball (utils/synthetic.py) against the
JAX package's generator (benchmarks/synthetic_scale.py), f64 on the CPU.

The generator's arrays are bitwise the reference's at 600 and 3,200
atoms; the port's Simulation of the 600-atom bonded ball (AGBNP1 + the MM
force field, 1 nm cutoff) gives JAX's energy and forces to 1e-10; and
run_md drives it through benchmark_langevin with finite energies.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu_torch import Simulation
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REF = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "synthetic_scale.py")


@pytest.fixture(scope="module")
def ref():
    """The reference generator module (its import sets JAX's compile
    cache directory, which is put back)."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("synthetic_scale_ref", REF)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def _same(x, y, what):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape, what
    assert np.array_equal(x, y), what


@pytest.mark.parametrize("natoms", [600, 3200])
def test_generator_is_bitwise_the_reference(ref, natoms):
    for i, (x, y) in enumerate(zip(synthetic.synthetic_system(natoms),
                                   ref.synthetic_system(natoms))):
        _same(x, y, i)
    ns, rs = synthetic.synthetic_dms(natoms), ref.synthetic_dms(natoms)
    assert sorted(vars(ns)) == sorted(vars(rs))
    for k, v in vars(rs).items():
        if k == "n":
            assert ns.n == v == natoms
        else:
            _same(getattr(ns, k), v, k)


def test_simulation_force_on_the_ball_matches_jax(ref):
    """The all-pairs force (AGBNP1 + the MM force field, 1 nm cutoff) of the
    port's Simulation built from the duck-typed ball against JAX's
    Simulation of the reference's ball, at JAX's tree capacities."""
    jsim = JaxSimulation(ref.synthetic_dms(600), version=1, cutoff=1.0,
                         dtype=np.float64, pair_tiles=False)
    caps = jsim.agbnp.caps
    tsim = Simulation(synthetic.synthetic_dms(600), device="cpu", version=1,
                      cutoff=1.0, dtype=torch.float64,
                      caps=T.TreeCaps(tuple(caps.caps), tuple(caps.offs)))
    assert tsim.kmax == jsim.kmax
    e_j, f_j, c_j = (np.asarray(x) for x in
                     jax.jit(jsim.force_fn())(jsim.positions))
    e_t, f_t, c_t = tsim.force_fn()(tsim.positions)
    np.testing.assert_array_equal(c_t.numpy()[:7], c_j[:7])
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_run_md_on_the_cpu():
    """run_md at 600 atoms on the CPU: 4 timed steps after 4, rebuilds
    every 2, finite energies, no overflow left, the windows counted."""
    res = synthetic.run_md(600, nsteps=4, device="cpu", neighbor_every=2)
    assert res["sim"].dtype == torch.float64
    assert res["steps_run"] == 4 and res["windows"] == 2
    assert not res["overflow"] and np.isfinite(res["energies"]).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.run_md(600, nsteps=1)
