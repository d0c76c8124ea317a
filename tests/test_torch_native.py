"""The port's native f64 GaussVol engine (runtime/native.py, a copy of the
JAX package's over the same C++ source) on the 264-atom fixture: the JAX
package's four tests/test_native.py cases, with the port's tree and model
where JAX's appear.

The library builds at first use into the port's _build/ directory with the
host's make and g++; available() must hold (both hosts the port runs on
have g++, which nvcc needs too), so a missing build fails here.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch.runtime import native


def test_native_available():
    """make + g++ produce a loadable library under the package's _build/,
    not in the source directory."""
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent.parent.name == "_build"
    assert not (so.parent.parent.parent / "runtime" /
                "libgaussvol_native.so").exists()


@pytest.fixture(scope="module")
def oracle_run(gaussvol_system):
    from openmm_agbnp_plugin_tpu.models.constants import sphere_volume
    from openmm_agbnp_plugin_tpu.models.oracle import GaussVol

    params, pos = gaussvol_system
    radii = np.asarray(params.radii_large)
    volumes = np.where(params.ishydrogen > 0, 0.0, sphere_volume(radii))
    gammas = np.asarray(params.gamma / params.roffset)
    gv = GaussVol(params.n, params.ishydrogen)
    gv.set_radii(radii)
    gv.set_volumes(volumes)
    gv.set_gammas(gammas)
    gv.compute_tree(pos)
    out = gv.compute_volume(pos)
    return params, pos, radii, volumes, gammas, gv, out


def test_native_tree_matches_oracle(oracle_run):
    """The native tree against the JAX package's f64 Python oracle: energy,
    volume, forces, self and free volumes, and node counts level by
    level."""
    params, pos, radii, volumes, gammas, gv, oracle_out = oracle_run
    ng = native.NativeGaussVol(params.n, params.ishydrogen)
    ng.compute_tree(pos, radii, volumes, gammas)
    energy, volume, force, dv, fv, sv = ng.compute_volume()

    v_o, e_o, f_o, dv_o, fv_o, sv_o = oracle_out
    np.testing.assert_allclose(energy, e_o, rtol=1e-12)
    np.testing.assert_allclose(volume, v_o, rtol=1e-12)
    np.testing.assert_allclose(force, f_o, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(sv, sv_o, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(fv, fv_o, rtol=1e-9, atol=1e-12)

    counts, _sibs = ng.level_stats()
    lev = Counter(node.level for node in gv.tree.nodes[1:])
    for k in range(2, 9):
        assert counts[k] == lev.get(k, 0), f"level {k} count mismatch"
    assert ng.total_nodes() == sum(counts[1:]) + 1


def test_size_tree_caps_covers_the_port_build(oracle_run):
    """size_tree_caps gives the port's TreeCaps, and they cover the port's
    own all-pairs tree build (the property the PanicButton relies on at
    start-up), whose level counts equal the native ones."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    params, pos, radii, volumes, gammas, gv, _ = oracle_run
    caps = native.size_tree_caps(params, pos, boost=1.2)
    assert isinstance(caps, T.TreeCaps)

    f64 = torch.float64
    lvl1 = T.make_level1(torch.as_tensor(pos, dtype=f64),
                         torch.as_tensor(radii, dtype=f64),
                         torch.as_tensor(volumes, dtype=f64),
                         torch.as_tensor(gammas, dtype=f64),
                         torch.as_tensor(np.asarray(params.ishydrogen)))
    pi, pj = np.triu_indices(params.n, 1)
    levels, diag = T.build_tree(lvl1, torch.as_tensor(pi),
                                torch.as_tensor(pj), caps)
    counts = diag["counts"][0].numpy()
    sibs = diag["max_siblings"][0].numpy()
    assert (counts <= np.asarray(caps.caps)).all(), (counts, caps.caps)
    assert (sibs[:-1] - 1 <= np.asarray(caps.offs)).all(), (sibs, caps.offs)
    gvn = native.NativeGaussVol(params.n, params.ishydrogen)
    gvn.compute_tree(pos, radii, volumes, gammas)
    nat_counts, _ = gvn.level_stats()
    np.testing.assert_array_equal(counts, nat_counts[2:9])


def test_native_agbnp1_full_pipeline(gaussvol_system):
    """The native AGBNP1 evaluation hits the golden anchors (-2476.66,
    E_cav 872.514, the displacement check 0.0874992 / 0.0886249) and
    equals the port's f64 dense model to 1e-9 (the JAX test's bar; the two
    share no code)."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import AGBNPModel

    params, pos = gaussvol_system
    nat = native.NativeAGBNP1(params)
    out = nat.energy_forces(pos)

    assert out["energy"] == pytest.approx(-2476.66, abs=1e-2)
    assert out["e_cav"] == pytest.approx(872.514, abs=1e-3)
    pos2 = np.array(pos)
    pos2[121, 1] += 0.002
    out2 = nat.energy_forces(pos2)
    assert out2["energy"] - out["energy"] == pytest.approx(0.0874992,
                                                           abs=1e-6)
    assert out["force"][121][1] * -0.002 == pytest.approx(0.0886249,
                                                          abs=1e-6)

    m = AGBNPModel(params, device="cpu", version=1, dtype=torch.float64,
                   pair_kernel=False)
    e, f, det = m.energy_forces(torch.as_tensor(pos), with_details=True)
    assert not m.check_and_grow(det["diag"])
    f = f.numpy()
    assert abs(out["energy"] - float(e)) <= 1e-9 * abs(float(e))
    assert np.abs(out["force"] - f).max() <= 1e-9 * max(1.0,
                                                        np.abs(f).max())
    np.testing.assert_allclose(out["born_radius"],
                               det["details"]["born_radius"].numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(out["self_volume"],
                               det["details"]["self_volume"].numpy(),
                               rtol=1e-9, atol=1e-12)
