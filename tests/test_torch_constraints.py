"""The port's SHAKE/RATTLE, virtual sites and trajectory IO against the
JAX package, f64: constraint tables of trp-cage (a star forest of X-H
clusters), the Jacobi fallback on a non-star table, bench.py's 4 fs MTS
window with SHAKE/RATTLE, the synthetic hydration-site set of
tests/test_md.py, and DCD bytes.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.api.hydration import HydrationSites
from openmm_agbnp_plugin_tpu.io.dcd import write_dcd as jax_write_dcd
from openmm_agbnp_plugin_tpu.io.dms import load_dms as jax_load_dms
from openmm_agbnp_plugin_tpu.md import vsites as JV
from openmm_agbnp_plugin_tpu.md.constraints import \
    Constraints as JaxConstraints
from openmm_agbnp_plugin_tpu.md.simulation import Simulation as JaxSimulation
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.io.dcd import read_dcd, write_dcd
from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
from openmm_agbnp_plugin_tpu_torch.md.vsites import VirtualSites, \
    project_positions, spread_forces
from openmm_agbnp_plugin_tpu_torch.ops import tree as T

torch.set_num_threads(2)

DMS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")


@pytest.fixture(scope="module")
def dms():
    return load_dms(DMS), jax_load_dms(DMS)


def _pair(dms, tol, jacobi=False, sweeps=4):
    d, jd = dms
    t = Constraints.from_dms(d, device="cpu", tol=tol)
    t.sweeps = sweeps
    j = JaxConstraints.from_dms(jd, tol=tol)
    if jacobi:
        t.clusters = None
        j.clusters = None
    return t, j


def _noisy(d, seed, scale=0.003):
    rng = np.random.default_rng(seed)
    pos = np.asarray(d.positions, np.float64)
    return pos, pos + scale * rng.normal(size=pos.shape), \
        rng.normal(size=pos.shape)


def test_constraint_tables_load_equal(dms):
    t, j = _pair(dms, 1e-8)
    assert t.n_constraints == j.n_constraints == 128
    for k in ("a", "b", "d", "inv_ma", "inv_mb"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)))
    assert t.clusters is not None and j.clusters is not None
    for k in ("cx", "ch", "cd", "cmask", "cimx", "cimh"):
        np.testing.assert_array_equal(t.clusters[k].numpy(),
                                      np.asarray(j.clusters[k]))
    # the float32 floor: JAX's 30 eps, or the coordinate grid's spacing at
    # the system's extent relative to the shortest constraint
    eps = float(np.finfo(np.float32).eps)
    extent = float(np.abs(dms[0].positions).max()) + 1.0
    assert t.extent == extent
    assert t.tolerance(torch.float32) == pytest.approx(max(
        30 * eps, eps * extent * 3 ** 0.5 / dms[0].constraint_d.min()))
    assert t.tolerance(torch.float64) == 1e-8


@pytest.mark.parametrize("jacobi", [False, True], ids=["star", "jacobi"])
def test_shake_rattle_match_jax(dms, jacobi):
    """Both sides converged to tol 1e-13: JAX under its while_loop, the
    port in 5 fixed Newton sweeps (star) or its host-checked Jacobi loop;
    positions and velocities agree to 1e-12 nm and 1e-10 nm/ps."""
    t, j = _pair(dms, 1e-13, jacobi=jacobi, sweeps=5)
    pos, noisy, vel = _noisy(dms[0], 7)
    xt, resid = t.shake(torch.as_tensor(noisy), torch.as_tensor(pos))
    xj = j.positions(jnp.asarray(noisy), jnp.asarray(pos))
    assert float(resid) <= 1e-13
    assert float(t.max_violation(xt)) < 1e-12
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12
    assert torch.equal(t.positions(torch.as_tensor(noisy),
                                   torch.as_tensor(pos)), xt)
    vt = t.velocities(xt, torch.as_tensor(vel))
    vj = j.velocities(jnp.asarray(xt.numpy()), jnp.asarray(vel))
    assert np.abs(vt.numpy() - np.asarray(vj)).max() < 1e-10
    r = xt[t.a] - xt[t.b]
    rate = torch.abs(torch.sum(r * (vt[t.a] - vt[t.b]), dim=-1))
    assert float(torch.max(rate / t.d ** 2)) < 1e-9


def test_non_star_table_falls_back_to_jacobi():
    """The chain of tests/test_constraints.py (atom 1 on both sides)."""
    idx = np.array([[0, 1], [1, 2]])
    d = np.array([0.1, 0.1])
    masses = np.array([12.0, 12.0, 1.0])
    t = Constraints(idx, d, masses, device="cpu", tol=1e-10)
    j = JaxConstraints(idx, d, masses, tol=1e-10)
    assert t.clusters is None and j.clusters is None
    x = np.array([[0.0, 0.0, 0.0], [0.11, 0.0, 0.0], [0.11, 0.105, 0.0]])
    ref = np.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.1, 0.1, 0.0]])
    xt, resid = t.shake(torch.as_tensor(x), torch.as_tensor(ref))
    xj = j.positions(jnp.asarray(x), jnp.asarray(ref))
    assert float(t.max_violation(xt)) < 1e-8 and float(resid) <= 1e-10
    assert np.abs(xt.numpy() - np.asarray(xj)).max() < 1e-12


def test_too_few_sweeps_leave_a_residual_over_tolerance(dms):
    """One Newton sweep from a 0.01 nm perturbation does not reach 1e-10:
    the residual says so (the MD runner refuses such a window)."""
    t, _ = _pair(dms, 1e-10, sweeps=1)
    pos, noisy, _ = _noisy(dms[0], 2, scale=0.01)
    _, resid = t.shake(torch.as_tensor(noisy), torch.as_tensor(pos))
    assert float(resid) > t.tolerance(torch.float64)
    t.sweeps = 6
    _, resid = t.shake(torch.as_tensor(noisy), torch.as_tensor(pos))
    assert float(resid) <= t.tolerance(torch.float64)


def test_mts_constraints_window_matches_jax(dms):
    """bench.py's mts4fs_constraints configuration (dt 4 fs, two bonded
    substeps, SHAKE/RATTLE) over two 2-step windows, the port fed JAX's
    noise (one draw per substep).  Both sides converge SHAKE to tol 1e-13
    (JAX under its while_loop, the port in 5 fixed Newton sweeps), so the
    windows agree to 1e-9."""
    d, jd = dms
    jsim = JaxSimulation(jd, dtype=np.float64, caps=JT.TreeCaps(*CAPS),
                         pair_tiles=False, **KW)
    tsim = Simulation(d, device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **KW)
    jsim.constraints = JaxConstraints.from_dms(jd, tol=1e-13)
    tsim.constraints = Constraints.from_dms(d, device="cpu", tol=1e-13)
    tsim.constraints.sweeps = 5
    nsteps, nsub = 4, 2
    kw = dict(neighbor_every=2, mts_inner=nsub)
    key = jax.random.PRNGKey(11)
    pos_j, vel_j, _, e_j, _ = jsim.make_langevin_runner(
        0.004, 300.0, 1.0, **kw)(jsim.positions, jsim.velocities, key,
                                 nsteps)
    noise = []
    for _ in range(nsteps * nsub):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(
            sub, jsim.positions.shape, dtype=jnp.float64)))
    pos_t, vel_t, e_t, diag = tsim.make_langevin_runner(
        0.004, 300.0, 1.0, **kw)(tsim.positions, tsim.velocities, nsteps,
                                 noise=torch.as_tensor(np.stack(noise)))
    assert not tsim._check_overflow(*diag) and float(diag[4]) <= 1e-13
    for name, x, y in (("energies", e_t, e_j), ("pos", pos_t, pos_j),
                       ("vel", vel_t, vel_j)):
        y = np.asarray(y)
        err = np.abs(x.numpy() - y).max() / np.abs(y).max()
        assert err <= 1e-9, (name, err)
    assert float(tsim.constraints.max_violation(pos_t)) <= 1e-12


def _sites():
    """tests/test_md.py's site on atoms (0, 1) plus a second site sharing
    parent 0, so the spread adds two rows into one atom."""
    hs = HydrationSites()
    hs.add_hydrogen_bonding_site(3, heavy=0, hydrogen=1, distance=0.03)
    hs.add_hydrogen_bonding_site(4, heavy=0, hydrogen=2, distance=0.05)
    v = hs.virtual_sites()
    return v, VirtualSites(v.site, v.parent1, v.parent2, v.w1, v.w2)


def test_virtual_sites_match_jax():
    jvs, tvs = _sites()
    ja = jvs.arrays(np.float64)
    ta = tvs.arrays(torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    pos = np.array([[0.0, 0, 0], [0.1, 0, 0], [0.0, 0.1, 0], [5.0, 5, 5],
                    [9.0, 9, 9]])
    pt = project_positions(torch.as_tensor(pos), ta)
    pj = JV.project_positions(jnp.asarray(pos), ja)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-15)
    np.testing.assert_allclose(pt[3].numpy(), [0.03, 0.0, 0.0], atol=1e-12)
    force = rng.normal(size=pos.shape)
    ft = spread_forces(torch.as_tensor(force), ta)
    fj = JV.spread_forces(jnp.asarray(force), ja)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-15)
    assert (ft[3:] == 0).all()
    np.testing.assert_allclose(ft.sum(0).numpy(), force.sum(0), atol=1e-12)
    assert VirtualSites.empty().count == 0


def test_dcd_bytes_equal_jax(tmp_path):
    frames = np.random.default_rng(1).normal(size=(3, 7, 3))
    box = np.array([3.0, 3.5, 4.0])
    for kw in (dict(), dict(box=box, dt_ps=0.002, first_step=10,
                            interval=5, title="port")):
        pt, pj = tmp_path / "t.dcd", tmp_path / "j.dcd"
        write_dcd(str(pt), frames, **kw)
        jax_write_dcd(str(pj), frames, **kw)
        assert pt.read_bytes() == pj.read_bytes()
        back, info = read_dcd(str(pt))
        np.testing.assert_allclose(back, frames, atol=1e-6)
        assert info["interval"] == kw.get("interval", 1)


def test_every_port_module_imports_without_jax():
    """Each module of the port imports with neither jax nor the JAX
    package pulled in: a CUDA deployment of the port needs no jax."""
    code = (
        "import importlib, pkgutil, sys, openmm_agbnp_plugin_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "[importlib.import_module(m) for m in mods]\n"
        "print(len(mods), 'jax' in sys.modules, "
        "'openmm_agbnp_plugin_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    n, has_jax, has_ref = out.stdout.split()
    assert int(n) >= 20 and (has_jax, has_ref) == ("False", "False"), \
        out.stdout + out.stderr


@pytest.mark.parametrize("jacobi", [False, True], ids=["star", "jacobi"])
def test_batched_shake_rattle_equal_single_calls(dms, jacobi):
    """SHAKE and RATTLE on [R, N, 3] (the replica runners) against R single
    [N, 3] calls: bitwise on the star path's fixed sweeps; the Jacobi path
    freezes a converged replica while another iterates, so replica r comes
    out as it would alone (within 1e-14; bitwise here).  The residual and
    the violation are per replica, [R]."""
    t, _ = _pair(dms, 1e-13, jacobi=jacobi, sweeps=5)
    pos = np.asarray(dms[0].positions, np.float64)
    rng = np.random.default_rng(21)
    # replica 1 drifts ten times as far, so the Jacobi replicas converge
    # after different sweep counts
    scale = np.array([0.001, 0.01, 0.003])[:, None, None]
    x = torch.as_tensor(pos[None] + scale * rng.normal(size=(3,) + pos.shape))
    ref = torch.as_tensor(np.broadcast_to(pos, x.shape).copy())
    v = torch.as_tensor(rng.normal(size=x.shape))
    xb, rb = t.shake(x, ref)
    vb = t.velocities(xb, v)
    assert rb.shape == (3,) and t.max_violation(xb).shape == (3,)
    for r in range(3):
        xs, rs = t.shake(x[r], ref[r])
        vs = t.velocities(xs, v[r])
        if jacobi:
            assert float((xs - xb[r]).abs().max()) <= 1e-14
            assert float((vs - vb[r]).abs().max()) <= 1e-14
        else:
            assert torch.equal(xs, xb[r]) and torch.equal(vs, vb[r])
        assert torch.equal(rs, rb[r])
        assert torch.equal(t.max_violation(xs), t.max_violation(xb)[r])
    assert float(rb.max()) <= 1e-13


def test_batched_virtual_sites_equal_single_calls():
    """project_positions and spread_forces on [R, N, 3] against R single
    calls, bit for bit (the spread's segment sum per replica), and against
    JAX's vmapped functions."""
    jvs, tvs = _sites()
    ta = tvs.arrays(torch.float64, device="cpu")
    ja = jvs.arrays(np.float64)
    rng = np.random.default_rng(4)
    pos = rng.normal(size=(3, 5, 3))
    force = rng.normal(size=(3, 5, 3))
    pb = project_positions(torch.as_tensor(pos), ta)
    fb = spread_forces(torch.as_tensor(force), ta)
    for r in range(3):
        assert torch.equal(pb[r], project_positions(torch.as_tensor(pos[r]),
                                                    ta))
        assert torch.equal(fb[r], spread_forces(torch.as_tensor(force[r]),
                                                ta))
    pj = jax.vmap(lambda p: JV.project_positions(p, ja))(jnp.asarray(pos))
    fj = jax.vmap(lambda f: JV.spread_forces(f, ja))(jnp.asarray(force))
    np.testing.assert_allclose(pb.numpy(), np.asarray(pj), atol=1e-15)
    np.testing.assert_allclose(fb.numpy(), np.asarray(fj), atol=1e-15)
