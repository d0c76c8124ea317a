"""The port's WU split and WU impulse MD against the benchmark's plain
reference (portbench/reference/agbnp_wu.py), float64, on the CPU.

The reference is written apart from the port and imports nothing of it:
AGBNP1 + OPLS by autograd (reference/agbnp.py), the WU force taken apart
as the self volumes' share of the gradient where they enter the Born
radii's screening factors, and the Langevin middle step with the WU force
as a k-step r-RESPA impulse.  The port is `Simulation.force_fn(wu_mode=
"split" | "skip")` (the analytic gamma rescan) and `Simulation.run_md(
wu_every=4)`.  Held on a 250-atom slice of 1li2 at seeded jittered
positions (1 nm cut-off, MM), and over 8 steps of one rebuild window fed
the reference's noise.  The reference in bfloat16, the benchmark's
control, must read far outside every tolerance.
"""

import os
import sys

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.utils import profiling as PR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from reference.agbnp_wu import WUSystem, wu_impulse_langevin  # noqa: E402
from reference.dms import read_dms  # noqa: E402
from test_torch_agbnp2_reference import _cut_dms, _cut_sysd, rel  # noqa: E402

torch.set_num_threads(2)

DMS = os.path.join(ROOT, "portbench", "data", "1li2_agbnp1.dms")
SLICE = 250
# relative energy: the same float64 terms summed in other orders (seen:
# 2.0e-15)
ENERGY = 1e-10
# of max|f| (of max|f_wu| for the WU force): the port's analytic rescans
# against the reference's autograd, in float64 (seen: 1.0e-15 and 3.9e-15)
FORCE = 1e-9
DT, TEMPERATURE, FRICTION, K, STEPS = 0.001, 300.0, 1.0, 4, 8


@pytest.fixture(scope="module")
def systems():
    sysd = _cut_sysd(read_dms(DMS), SLICE)
    ref = WUSystem(sysd, "cpu", torch.float64, 1.0, 1.0, True)
    sim = Simulation(_cut_dms(load_dms(DMS), SLICE), device="cpu",
                     version=1, cutoff=1.0, dtype=torch.float64, skin=0.25,
                     descreen_horizon="cutoff")
    return sysd, ref, sim


def _jittered(sysd, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(sysd["positions"]
                           + rng.normal(0.0, 0.005, (sysd["n"], 3)))


@pytest.mark.parametrize("seed", [0, 1])
def test_split_and_skip_forces(systems, seed):
    """force_fn(wu_mode="split") gives the reference's WU force and force
    without WU, wu_mode="skip" the same force without WU, and the fused
    force is the two added up."""
    sysd, ref, sim = systems
    x = _jittered(sysd, seed)
    e_ref, f_ref, fwu_ref = ref.energy_forces_split(x)
    e, f, f_wu, _ = sim.force_fn(wu_mode="split")(x)
    e_skip, f_skip, _ = sim.force_fn(wu_mode="skip")(x)
    e_fused, f_fused, _ = sim.force_fn()(x)
    assert rel(float(e), float(e_ref)) <= ENERGY
    assert rel(f, f_ref) <= FORCE and rel(f_skip, f_ref) <= FORCE
    assert rel(f_wu, fwu_ref) <= FORCE
    # a WU force worth splitting: a few percent of the whole
    assert 1e-3 < float(fwu_ref.abs().max()) / float(f_ref.abs().max()) < 1
    assert torch.equal(e_skip, e) and torch.equal(e_fused, e)
    assert torch.equal(f_skip, f)
    assert torch.equal(f_fused, f + f_wu)
    # the reference's two parts make its whole force
    assert rel(f_ref + fwu_ref, ref.energy_forces(x)[1]) <= FORCE


def test_wu4_window_fed_the_reference_noise(systems):
    """run_md(wu_every=4) over one 8-step window against the reference's
    impulse integrator on the same draws.  The port holds the window's
    tree and compacted WU topology from its start while the reference
    builds its tree afresh each step; what that leaves out in 8 fs (seen:
    2.1e-9 nm, 3.1e-7 relative in velocity, 3.5e-9 in energy; 2.5e-15 at
    the window's start) bounds the gap."""
    sysd, ref, sim = systems
    x0 = torch.as_tensor(sysd["positions"])
    v0 = torch.as_tensor(sysd["velocities"])
    gen = torch.Generator().manual_seed(5)
    noise = [torch.randn((SLICE, 3), generator=gen, dtype=torch.float64)
             for _ in range(STEPS)]
    xr, vr, er = wu_impulse_langevin(ref, x0, v0, sysd["masses"], noise, DT,
                                     TEMPERATURE, FRICTION, K)
    PR.reset()
    with PR.record():
        out = sim.run_md(STEPS, dt=DT, temperature=TEMPERATURE,
                         friction=FRICTION, neighbor_every=STEPS,
                         wu_every=K, pos=x0, vel=v0,
                         generator=torch.Generator().manual_seed(5))
    rec = PR.recorded()
    PR.reset()
    assert sum(c["n"] for c in rec["counts"]
               if c["name"] == "md.wu_impulse") == STEPS // K
    assert sum(s["name"] == "md.step" for s in rec["spans"]) == STEPS
    assert rel(out["energies"][0], er[0]) <= ENERGY
    assert rel(out["energies"], np.asarray(er)) <= 1e-7
    assert float(torch.abs(out["final_pos"] - xr).max()) <= 1e-7
    assert rel(out["final_vel"], vr) <= 1e-5
    # the impulse weighs k: the strict trajectory is far off
    xs, vs, _ = wu_impulse_langevin(ref, x0, v0, sysd["masses"], noise, DT,
                                    TEMPERATURE, FRICTION, 1)
    assert rel(vs, vr) > 1e3 * rel(out["final_vel"], vr)


def test_bfloat16_reference_reads_far_off(systems):
    """The benchmark's control, the reference in bfloat16, is far outside
    the tolerances the port meets, the WU force too."""
    sysd, ref, _ = systems
    control = WUSystem(sysd, "cpu", torch.bfloat16, 1.0, 1.0, True)
    x = _jittered(sysd, 0)
    e_ref, f_ref, fwu_ref = ref.energy_forces_split(x)
    e, f, f_wu = control.energy_forces_split(x)
    assert rel(float(e), float(e_ref)) > 1e4 * ENERGY
    assert rel(f.double(), f_ref) > 1e4 * FORCE
    assert rel(f_wu.double(), fwu_ref) > 1e4 * FORCE
