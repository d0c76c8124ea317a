"""The port's AGBNPModel: the reference goldens, and f64 parity with the JAX
package's AGBNPModel on the 264-atom fixture.

Both routes of the port (the kernel route with its plain twins, which the
GPU path shares, and the dense ops/born.py route) are held against JAX's
dense XLA pair phases (`pair_kernel=False`) with the same tree capacities,
to 1e-10 relative in energy and in force max-error/max|f|.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JaxModel
from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.ops.tree import TreeCaps as JaxCaps
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
    AGBNPModel, arrays_from_numpy, prepare_arrays)
from openmm_agbnp_plugin_tpu_torch.models.constants import AGBNP_I4LOOKUP_NA
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.tree import TreeCaps

torch.set_num_threads(2)

CAPS = ((3840, 8192, 7296, 3712, 1408, 384, 256), (48, 32, 24, 16, 8, 4))


@pytest.fixture(scope="module")
def models_v1(gaussvol_system):
    params, pos = gaussvol_system
    return {route: AGBNPModel(params, device="cpu", version=1,
                              positions=pos, pair_kernel=(route == "kernel"))
            for route in ("kernel", "plain")}


def test_golden_gvolsa(gaussvol_system):
    params, pos = gaussvol_system
    m = AGBNPModel(params, device="cpu", version=0, positions=pos)
    e, f, out = m.energy_forces(pos, with_details=True)
    assert not m.check_and_grow(out["diag"])
    assert float(e) == pytest.approx(872.514, abs=1e-2)
    assert float(out["details"]["e_vol1"]) == pytest.approx(2287.78, abs=1e-2)
    assert float(out["details"]["e_vol2"]) == pytest.approx(-1415.27,
                                                           abs=1e-2)


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_golden_agbnp1_and_displacement(gaussvol_system, models_v1, route):
    """v1.reference:2-5 (TestReferenceAGBNPForce.cpp:118-128): E, and atom
    121 moved +0.002 nm in y gives dE = 0.0874992 against the gradient
    prediction 0.0886249."""
    params, pos = gaussvol_system
    m = models_v1[route]
    e, f = m.energy_forces(pos)
    assert float(e) == pytest.approx(-2476.66, abs=1e-2)
    pos2 = pos.copy()
    pos2[121, 1] += 0.002
    e2, _ = m.energy_forces(pos2)
    assert float(e2 - e) == pytest.approx(0.0874992, abs=1e-6)
    assert float(-f[121, 1] * 0.002) == pytest.approx(0.0886249, abs=1e-6)


@pytest.mark.parametrize("cutoff,horizon,box", [
    (None, None, None), (1.0, "cutoff", None), (1.0, "cutoff", (3.5, 3.2, 3.8))],
    ids=["2nm_horizon", "cutoff_1nm", "cutoff_1nm_box"])
@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_f64_parity_with_jax(gaussvol_system, route, cutoff, horizon, box):
    params, pos = gaussvol_system
    jm = JaxModel(params, caps=JaxCaps(*CAPS), version=1, cutoff=cutoff,
                  positions=pos, pair_kernel=False, descreen_horizon=horizon,
                  box=None if box is None else np.asarray(box))
    tm = AGBNPModel(params, device="cpu", caps=TreeCaps(*CAPS), version=1,
                    cutoff=cutoff, positions=pos,
                    pair_kernel=(route == "kernel"), descreen_horizon=horizon,
                    box=box)
    e_j, f_j = (np.asarray(x) for x in jm.energy_forces(pos))
    e_t, f_t = tm.energy_forces(pos)
    assert abs(float(e_t) - float(e_j)) <= 1e-10 * abs(float(e_j))
    f_t = f_t.numpy()
    assert np.abs(f_t - f_j).max() <= 1e-10 * np.abs(f_j).max()


def test_prepare_arrays_bit_equal_to_jax(gaussvol_system):
    params, pos = gaussvol_system
    n = params.n
    npad = PK.pad_to(n, PK.pick_tile(n))
    aj = jax_prepare_arrays(params, dtype=np.float64, pair_pad=npad,
                            positions=pos)
    at = prepare_arrays(params, dtype=np.float64, pair_pad=npad,
                        positions=pos)
    assert set(aj) - set(at) == {"rowY_pad", "cols_oh_hpad"}
    assert set(at) <= set(aj)
    for k, v in at.items():
        assert v.dtype == aj[k].dtype, k
        np.testing.assert_array_equal(v, aj[k], err_msg=k)
    # the kernel route's type ids + [Ti, Tj, NA] tables select exactly the
    # spline nodes of the TPU's row-contracted tables and column one-hots
    t = arrays_from_numpy(at, "cpu", torch.float64)
    ytab, y2tab = t["ytab"].numpy(), t["y2tab"].numpy()
    rows = t["type_rows_pad"].numpy()[:n]
    na, ntj = AGBNP_I4LOOKUP_NA, ytab.shape[1]
    rowy = np.concatenate([ytab[rows], y2tab[rows]], axis=2)  # [n, Tj, 2NA]
    np.testing.assert_array_equal(
        rowy.transpose(0, 2, 1),
        aj["rowY_pad"][:n].reshape(n, 2 * na, ntj))
    hv = at["hids_pad"] >= 0
    onehot = (t["type_cols_hpad"].numpy()[:, None] == np.arange(ntj)) & \
        hv[:, None]
    np.testing.assert_array_equal(onehot.astype(np.float64),
                                  aj["cols_oh_hpad"])


def test_port_never_imports_jax():
    code = ("import sys, openmm_agbnp_plugin_tpu_torch.md.simulation, "
            "openmm_agbnp_plugin_tpu_torch.ops.kernels.pairs; "
            "print('jax' in sys.modules, "
            "'openmm_agbnp_plugin_tpu' in sys.modules)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True, cwd=root)
    assert out.stdout.split() == ["False", "False"], out.stdout + out.stderr
