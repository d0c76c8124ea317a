"""The port's f64 NumPy oracles (models/oracle.py, models/oracle_agbnp2.py)
against the JAX package's, against the reference goldens, and as the
golden of the port's own f64 models, on the CPU.

The oracles are the port's own copies of the JAX package's (numpy and the
port's models/constants.py, i4_tables.py and params.py only), so every
result is held to JAX's bit for bit; the goldens are those of JAX's
tests/test_oracle.py and tests/test_agbnp2.py:62-88.  The port's f64
AGBNPModel and AGBNP2Model are held to the port's oracle as JAX's models
are to JAX's (tests/test_jax_pipeline.py:34-50, test_agbnp2.py:172-191).
"""

import ast
import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models import oracle as JO
from openmm_agbnp_plugin_tpu.models import oracle_agbnp2 as JO2
from openmm_agbnp_plugin_tpu_torch import AGBNP2Model, AGBNPModel, \
    load_gaussvol_dat
from openmm_agbnp_plugin_tpu_torch.models import oracle as O
from openmm_agbnp_plugin_tpu_torch.models import oracle_agbnp2 as O2
from openmm_agbnp_plugin_tpu_torch.models.constants import \
    AGBNP2_RADIUS_INCREMENT, sphere_volume

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_MODELS = os.path.join(os.path.dirname(HERE),
                           "openmm_agbnp_plugin_tpu_torch", "models")

# JAX tests/test_agbnp2.py:62-82: the v2 anchors on the fixture's first 40
# atoms
V2_GOLDEN = dict(
    energy=-505.76495633268286,
    e_vol1=1296.819385880833,
    e_vol2=-1148.76359737392,
    e_ms1=27.57599932202746,
    e_vdw=-279.30181003341033,
    gb_pair=1114.5651675110894,
    gb_self=-1476.1241599496998,
    num_ms=28,
)
V2_GOLDEN_FORCES = {
    0: (2.7244478045, -22.2829483825, -34.7403199228),
    17: (-116.3420644047, 8.9736090847, -130.7872966600),
    39: (12.2302176390, 25.9733147403, -30.5733421377),
}


def _sub(params, n, cls=O.AGBNPParams, **kw):
    return cls(radius=params.radius[:n], gamma=params.gamma[:n],
               alpha=params.alpha[:n], charge=params.charge[:n],
               ishydrogen=params.ishydrogen[:n], **kw)


@pytest.fixture(scope="module")
def system():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(HERE, "fixtures", "gaussvol.dat"))
    params = O.AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                           charge=charge, ishydrogen=ish)
    return params, np.asarray(pos, np.float64)


@pytest.fixture(scope="module")
def runs(system):
    """Each oracle evaluation once, the port's and JAX's, on the same
    inputs: v0 and v1 on the fixture, v2 on its first 40 atoms and on all
    264 (with details)."""
    params, pos = system
    jparams = _sub(params, params.n, cls=JO.AGBNPParams)
    out = {}
    out["v0"] = (O.gvolsa_energy_forces(params, pos),
                 JO.gvolsa_energy_forces(jparams, pos))
    out["v1"] = (O.agbnp1_energy_forces(params, pos, return_details=True),
                 JO.agbnp1_energy_forces(jparams, pos, return_details=True))
    for n in (40, params.n):
        out[f"v2_{n}"] = (
            O2.agbnp2_energy_forces(_sub(params, n), pos[:n],
                                    return_details=True),
            JO2.agbnp2_energy_forces(_sub(params, n, cls=JO.AGBNPParams),
                                     pos[:n], return_details=True))
    return out


def _same(a, b, what):
    """Equal bit for bit (and so within 1e-12 relative): scalars, arrays
    and details dicts alike."""
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
        return
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
        return
    assert np.array_equal(np.asarray(a), np.asarray(b)), what


@pytest.mark.parametrize("key", ["v0", "v1", "v2_40", "v2_264"])
def test_port_oracle_is_jax_oracle_bitwise(runs, key):
    """Energy, forces and every detail of the port's oracle equal JAX's
    oracle's bit for bit."""
    port, jax = runs[key]
    _same(port, jax, key)


def test_gaussvol_api_matches_jax(system):
    """The L0 GaussVol API (compute_tree, compute_volume,
    rescan_tree_volumes, rescan_tree_gammas, getstat; reference
    gaussvol.h:208-310) on the fixture's first 96 atoms: the port's and
    JAX's give the same bits at every stage."""
    params, pos = system
    n = 96
    p = _sub(params, n)
    x = pos[:n]
    heavy = p.ishydrogen == 0
    gammas = np.where(heavy, np.random.default_rng(2).uniform(0.5, 1.5, n),
                      0.0)
    stages = []
    for mod in (O, JO):
        gv = mod.GaussVol(n, p.ishydrogen)
        gv.set_radii(p.radii_large)
        gv.set_volumes(np.where(heavy, sphere_volume(p.radii_large), 0.0))
        gv.set_gammas(p.gamma / p.roffset)
        gv.compute_tree(x)
        got = [gv.compute_volume(x), gv.getstat()]
        gv.set_radii(p.radii_vdw)
        gv.set_volumes(np.where(heavy, sphere_volume(p.radii_vdw), 0.0))
        gv.rescan_tree_volumes(x)
        got.append(gv.compute_volume(x))
        gv.set_gammas(gammas)
        gv.rescan_tree_gammas()
        got += [gv.compute_volume(x), gv.getstat()]
        stages.append(got)
    assert stages[0][1].sum() > n  # the tree has overlap nodes
    _same(stages[0], stages[1], "gaussvol")


def test_v0_golden(runs):
    """v0.reference:2-7 (JAX tests/test_oracle.py:17-23)."""
    e, _, (e1, e2) = runs["v0"][0]
    assert e1 == pytest.approx(2287.78, abs=0.01)
    assert e2 == pytest.approx(-1415.27, abs=0.01)
    assert e == pytest.approx(872.514, abs=0.001)


def test_v0_force_fd(system):
    """The analytic cavity forces against finite differences at three
    heavy atoms (JAX tests/test_oracle.py:26-38), on the fixture's first
    64 atoms to keep the serial oracle quick."""
    params, pos = system
    n = 64
    p, x = _sub(params, n), pos[:n]
    e0, force, _ = O.gvolsa_energy_forces(p, x)
    rng = np.random.default_rng(0)
    heavy = np.flatnonzero(p.ishydrogen == 0)
    for atom in rng.choice(heavy, size=3, replace=False):
        d = rng.uniform(-2e-4, 2e-4, size=3)
        x2 = x.copy()
        x2[atom] += d
        e1, _, _ = O.gvolsa_energy_forces(p, x2)
        assert e1 - e0 == pytest.approx(-np.dot(force[atom], d), rel=0.05,
                                        abs=1e-6)


def test_v1_golden_and_displacement(system, runs):
    """v1.reference:2-5: E = -2476.66; atom 121 displaced +0.002 nm in y
    gives dE = 0.0874992 and the gradient's prediction 0.0886249 (JAX
    tests/test_oracle.py:41-62)."""
    params, pos = system
    e1, force, _ = runs["v1"][0]
    assert e1 == pytest.approx(-2476.66, abs=0.01)
    pos2 = pos.copy()
    pos2[121, 1] += 0.002
    e2, _ = O.agbnp1_energy_forces(params, pos2)
    assert e2 == pytest.approx(-2476.58, abs=0.01)
    assert e2 - e1 == pytest.approx(0.0874992, abs=1e-6)
    assert -force[121, 1] * 0.002 == pytest.approx(0.0886249, abs=1e-6)


def test_v2_golden(system, runs):
    """JAX tests/test_agbnp2.py:62-88 and :30-53: the 40-atom anchors
    (energy, terms, MS count, three forces of the hand chain), finite
    values, and MS particles on heavy parents."""
    e, f, det = runs["v2_40"][0]
    assert e == pytest.approx(V2_GOLDEN["energy"], rel=1e-10)
    for k in ("e_vol1", "e_vol2", "e_ms1", "e_vdw", "gb_pair", "gb_self"):
        assert det[k] == pytest.approx(V2_GOLDEN[k], rel=1e-9), k
    assert det["num_ms"] == V2_GOLDEN["num_ms"]
    for i, ref in V2_GOLDEN_FORCES.items():
        np.testing.assert_allclose(f[i], ref, rtol=1e-8)
    assert np.isfinite(f).all() and det["e_ms1"] != 0.0
    params, pos = system
    p2 = _sub(params, 40, roffset=AGBNP2_RADIUS_INCREMENT)
    msps = O2._make_ms_particles(p2, pos[:40])
    assert len(msps) > 0
    for m in msps[:5]:
        assert p2.ishydrogen[m.parent1] == 0 and p2.ishydrogen[m.parent2] == 0
        assert m.vol0 > 0


@pytest.mark.parametrize("version", [0, 1])
def test_port_model_matches_port_oracle(system, runs, version):
    """The port's f64 AGBNPModel (plain route and kernel twins) against the
    port's oracle: energy to 1e-8, forces to 1e-9 (JAX
    tests/test_jax_pipeline.py:34-50)."""
    params, pos = system
    res = runs[f"v{version}"][0]
    e_o, f_o = res[0], res[1]
    for pair_kernel in (False, True):
        m = AGBNPModel(params, device="cpu", dtype=torch.float64,
                       version=version, pair_kernel=pair_kernel)
        e, f = m.energy_forces(pos)
        assert float(e) == pytest.approx(e_o, abs=1e-8)
        np.testing.assert_allclose(f.numpy(), f_o, rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [40, 264])
def test_port_agbnp2_matches_port_oracle(system, runs, n):
    """The port's f64 AGBNP2Model energy against the port's oracle to 1e-9
    (JAX tests/test_agbnp2.py:172-191), grown until its capacities hold.
    Forces are not compared: the oracle's v2 force chain is the
    reference's knowingly incomplete hand chain."""
    params, pos = system
    e_o = runs[f"v2_{n}"][0][0]
    m = AGBNP2Model(_sub(params, n), device="cpu", dtype=torch.float64,
                    positions=pos[:n])
    for _ in range(8):
        e, _, out = m.energy_forces(pos[:n], with_details=True)
        if not m.check_and_grow(out["diags"]):
            break
    assert float(e) == pytest.approx(e_o, abs=1e-9)


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." * node.level + (node.module or ""))
    return names


def test_oracles_import_numpy_and_the_port_models_only():
    """The two oracles and the modules they import read numpy and the
    port's own models/ modules: no torch, no jax, nothing of the JAX
    package (so they run on any host as the golden)."""
    allowed = {"__future__", "dataclasses", "math", "numpy", ".constants",
               ".i4_tables", ".params", ".oracle"}
    for name in ("oracle", "oracle_agbnp2", "constants", "i4_tables",
                 "params"):
        got = _imports(os.path.join(PORT_MODELS, f"{name}.py"))
        assert got <= allowed, (name, got - allowed)
    assert O.AGBNPParams is __import__(
        "openmm_agbnp_plugin_tpu_torch.models.params",
        fromlist=["AGBNPParams"]).AGBNPParams
