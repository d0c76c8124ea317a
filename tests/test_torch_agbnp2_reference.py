"""The port's AGBNP2 + OPLS against the benchmark's plain reference
(portbench/reference/agbnp2.py), float64, on the CPU.

The reference is written apart from the port and imports nothing of it:
AGBNP2 from the published model in plain PyTorch, MS particles and both
trees made afresh at every evaluation, forces by autograd.  The port is
`AGBNP2Model` (analytic reverse rules) and `Simulation(version=2)` with
the OPLS terms.  Held on the first 40 atoms of tests/fixtures/gaussvol.dat
(no cut-off, no MM), on a 250-atom slice of 1li2 at seeded jittered
positions (1 nm cut-off, MM), and over 5 Langevin steps of the port's
rebuild windows fed the reference's noise.  The reference in bfloat16,
the benchmark's control, must read far outside every tolerance.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.io.gaussvol_dat import load_gaussvol_dat
from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import AGBNP2Model
from openmm_agbnp_plugin_tpu_torch.models.capacity import V2
from openmm_agbnp_plugin_tpu_torch.models.params import AGBNPParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "portbench"))

from reference.agbnp2 import AGBNP2System  # noqa: E402
from reference.dms import read_dms  # noqa: E402
from reference.langevin import langevin  # noqa: E402

torch.set_num_threads(2)

DMS = os.path.join(ROOT, "portbench", "data", "1li2_agbnp1.dms")
SLICE = 250
# relative energy: the same float64 terms summed in other orders and
# trees (seen: 2.4e-14 at the slice, 4.5e-16 at the anchor)
ENERGY = 1e-10
# of max|f|: the port's analytic reverse rules against the reference's
# autograd, in float64 (seen: 3e-15)
FORCE = 1e-9
# the JAX package's float64 AGBNP2 oracle on the first 40 atoms of
# gaussvol.dat (its tests/test_agbnp2.py anchor)
ANCHOR_ENERGY = -505.76495633268286
DT, TEMPERATURE, FRICTION, STEPS = 0.001, 300.0, 1.0, 5


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def anchor():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(
        os.path.join(ROOT, "tests", "fixtures", "gaussvol.dat"))
    n = 40
    sysd = dict(n=n, hydrogen=np.asarray(ish[:n]) > 0, radius=radius[:n],
                gamma=gamma[:n], alpha=alpha[:n], charge=charge[:n])
    params = AGBNPParams(radius=radius[:n], gamma=gamma[:n],
                         alpha=alpha[:n], charge=charge[:n],
                         ishydrogen=ish[:n])
    return sysd, params, np.asarray(pos[:n], np.float64)


@pytest.mark.parametrize("pair_kernel", [False, True])
def test_gaussvol_anchor(anchor, pair_kernel):
    """40 atoms, no cut-off, no MM: the reference gives the JAX oracle's
    energy, and the port (plain pair phases, or the CUDA kernels' CPU
    twins) gives the reference's energy and forces."""
    sysd, params, pos = anchor
    e_ref, f_ref = AGBNP2System(sysd, "cpu", torch.float64, None,
                                include_mm=False).energy_forces(
        torch.as_tensor(pos))
    assert rel(float(e_ref), ANCHOR_ENERGY) <= ENERGY
    m = AGBNP2Model(params, device="cpu", dtype=torch.float64,
                    positions=pos, pair_kernel=pair_kernel)
    e, f = m.energy_forces(torch.as_tensor(pos))
    assert rel(float(e), float(e_ref)) <= ENERGY
    assert rel(f, f_ref) <= FORCE


def _cut_sysd(s, n):
    """read_dms's dict of the first n atoms: the terms among them."""
    out = {k: (v[:n] if isinstance(v, np.ndarray) and v.shape[:1] == (s["n"],)
               else v) for k, v in s.items()}
    out["n"] = n
    for pre in ("bond", "angle", "dihedral", "pair"):
        keep = (s[pre + "_idx"] < n).all(axis=1)
        for k in s:
            if k.startswith(pre + "_"):
                out[k] = s[k][keep]
    out["exclusions"] = s["exclusions"][(s["exclusions"] < n).all(axis=1)]
    return out


def _cut_dms(d, n):
    """load_dms's system of the first n atoms: the terms among them."""
    kw = {}
    for f in dataclasses.fields(d):
        v = getattr(d, f.name)
        if not f.name.endswith("_idx") and v.shape[:1] == (d.n,):
            kw[f.name] = v[:n]
    for pre in ("bond", "angle", "dihedral", "pair", "constraint"):
        keep = (getattr(d, pre + "_idx") < n).all(axis=1)
        for f in dataclasses.fields(d):
            if f.name.startswith(pre + "_"):
                kw[f.name] = getattr(d, f.name)[keep]
    kw["exclusions"] = d.exclusions[(d.exclusions < n).all(axis=1)]
    return dataclasses.replace(d, **kw)


@pytest.fixture(scope="module")
def slice_systems():
    """The port's Simulation and the reference of 1li2's first SLICE
    atoms, the port's MS capacities grown on a window at the DMS state."""
    sysd = _cut_sysd(read_dms(DMS), SLICE)
    ref = AGBNP2System(sysd, "cpu", torch.float64, 1.0)
    sim = Simulation(_cut_dms(load_dms(DMS), SLICE), device="cpu",
                     version=2, cutoff=1.0, dtype=torch.float64)
    run = sim.make_langevin_runner(DT, TEMPERATURE, FRICTION,
                                   neighbor_every=1)
    diag = run(sim.positions, sim.velocities, 1,
               generator=torch.Generator().manual_seed(0))[3]
    if sim._check_overflow(*diag):
        sim._regrow(*diag)
    return sysd, ref, sim


def _jittered(sysd, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(sysd["positions"]
                           + rng.normal(0.0, 0.005, (sysd["n"], 3)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_1li2_slice(slice_systems, seed):
    """AGBNP2 + OPLS at 0.005 nm jittered positions: the port's force
    function (MS candidates found and both trees built in the call)
    against the reference."""
    sysd, ref, sim = slice_systems
    x = _jittered(sysd, seed)
    e_ref, f_ref = ref.energy_forces(x)
    e, f, counts = sim.force_fn()(x)
    assert not sim.overflow_report(counts, None, None)
    n_ms = ref.ms_particles(x)["vol"].shape[0]
    assert int(counts[V2.MS_COUNT]) == n_ms > 1000
    assert rel(float(e), float(e_ref)) <= ENERGY
    assert rel(f, f_ref) <= FORCE


def _noise(sysd, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((sysd["n"], 3), generator=gen, dtype=torch.float64)
            for _ in range(STEPS)]


@pytest.mark.parametrize("every,steps", [(1, 2), (STEPS, STEPS)])
def test_langevin_window(slice_systems, every, steps):
    """The port's runner fed the reference's noise from the DMS state.
    Rebuilt every step (windows of 1; 2 steps, for the suite's time) it
    is the model the reference defines, step for step.  In one 5-step
    window the MS compaction and both trees are held from the window's
    start, while the reference makes them afresh each step: the gap is
    what the held set leaves out in 5 fs (seen: 2.1e-9 nm, 2.0e-9 in
    energy, 1.2e-6 in velocity), which bounds it."""
    sysd, ref, sim = slice_systems
    x0 = torch.as_tensor(sysd["positions"])
    v0 = torch.as_tensor(sysd["velocities"])
    noise = _noise(sysd, 3)[:steps]
    xr, vr, er = langevin(ref, x0, v0, sysd["masses"], noise, DT,
                          TEMPERATURE, FRICTION)
    run = sim.make_langevin_runner(DT, TEMPERATURE, FRICTION,
                                   neighbor_every=every)
    x, v, e, diag = run(x0, v0, steps, noise=torch.stack(noise))
    assert not sim._check_overflow(*diag)
    assert rel(float(e[0]), er[0]) <= ENERGY
    if every == 1:
        # a rounding gap grows over the steps: 100x the evaluation's
        assert rel(e.numpy(), np.asarray(er)) <= 100 * ENERGY
        assert float(torch.abs(x - xr).max()) <= 1e-12
        assert rel(v, vr) <= 100 * ENERGY
    else:
        assert rel(e.numpy(), np.asarray(er)) <= 1e-7
        assert float(torch.abs(x - xr).max()) <= 1e-7
        assert rel(v, vr) <= 1e-5


def test_bfloat16_reference_reads_far_off(slice_systems):
    """The benchmark's control, the reference in bfloat16, is far outside
    the tolerances the port meets."""
    sysd, ref, _ = slice_systems
    control = AGBNP2System(sysd, "cpu", torch.bfloat16, 1.0)
    x = _jittered(sysd, 0)
    e_ref, f_ref = ref.energy_forces(x)
    e, f = control.energy_forces(x)
    assert rel(float(e), float(e_ref)) > 1e4 * ENERGY
    assert rel(f.double(), f_ref) > 1e4 * FORCE
