"""The port on an NVIDIA GPU: each CUDA kernel against its plain twin, the
model in f32 on the card against f64 on the CPU, bitwise repeatability,
and the wrappers' input checks.

Marked `cuda`; every test skips without a CUDA device.  On a machine with
one (which need not have JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, \
    load_gaussvol_dat
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
    _pair_phases_kernel
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "gaussvol.dat")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def fixture_system():
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(FIXTURE)
    return AGBNPParams(radius=radius, gamma=gamma, alpha=alpha,
                       charge=charge, ishydrogen=ish), pos


def rel(x, ref):
    x, ref = x.double().cpu(), ref.double().cpu()
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def test_model_f32_on_card_matches_cpu_f64(cuda, fixture_system):
    params, pos = fixture_system
    for version in (0, 1):
        ref = AGBNPModel(params, device="cpu", version=version, positions=pos)
        m = AGBNPModel(params, device=cuda, dtype=torch.float32,
                       version=version, positions=pos)
        e0, f0 = ref.energy_forces(pos)
        e1, f1 = m.energy_forces(pos)
        assert abs(float(e1) - float(e0)) <= 1e-5 * abs(float(e0))
        assert rel(f1, f0) <= 1e-5
        e2, f2 = m.energy_forces(pos)
        assert torch.equal(e1, e2) and torch.equal(f1, f2)


@pytest.mark.parametrize("horizon,cutoff", [(None, None), (1.0, 1.0)])
def test_kernels_match_twins(cuda, fixture_system, horizon, cutoff):
    params, pos = fixture_system
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos, cutoff=cutoff, descreen_horizon=horizon)
    a = m.arrays
    n = params.n
    rng = np.random.default_rng(11)
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    pos_pad = torch.nn.functional.pad(p[a["rperm"]],
                                      (0, 0, 0, m.pair_pad - n)).T.contiguous()
    hv = a["hids_pad"] >= 0
    pos_h = (p[a["hids_pad"].clamp(min=0)] * hv[:, None]).T.contiguous()

    def rand(lo, hi, size, mask=None):
        x = torch.as_tensor(rng.uniform(lo, hi, size), dtype=torch.float32,
                            device=cuda)
        return x if mask is None else torch.where(mask, x, 0.0)

    s_h = rand(0.3, 1.0, hv.shape[0], hv)
    rows = torch.arange(m.pair_pad, device=cuda) < n
    born = rand(0.12, 0.45, m.pair_pad, rows)
    args = (pos_pad, pos_h, a["hids_perm_pad"], a["type_rows_pad"],
            a["type_cols_hpad"], a["ytab"], a["y2tab"], s_h, n)
    before = PK.launch_counts()
    out = PK.born_sums(*args, horizon=horizon, save_qd=True)
    ref = PK.born_sums_reference(*args, horizon=horizon, save_qd=True)
    for x, y in zip(out, ref):
        assert rel(x, y) <= 1e-5
    excl = torch.full((m.pair_pad, 8), -1, dtype=torch.int32, device=cuda)
    excl[:n - 1, 0] = torch.arange(1, n, dtype=torch.int32, device=cuda)
    excl[1:n, 1] = torch.arange(0, n - 1, dtype=torch.int32, device=cuda)
    mm = dict(sig_pad=rand(0.2, 0.4, m.pair_pad, rows),
              epsq_pad=rand(0.1, 0.9, m.pair_pad, rows), excl_rows_pad=excl)
    for kw in ({}, mm):
        gout = PK.gb_pair(pos_pad, a["charge_pad"], born, n, cutoff=cutoff,
                          **kw)
        gref = PK.gb_pair_reference(pos_pad, a["charge_pad"], born, n,
                                    cutoff=cutoff, **kw)
        for x, y in zip(gout, gref):
            if y is None:
                assert x is None
            else:
                assert rel(x, y) <= 1e-5
    brw = rand(-5.0, 5.0, m.pair_pad, rows)
    bru = rand(-50.0, 50.0, m.pair_pad, rows)
    dout = PK.descreening(pos_pad, pos_h, s_h, brw, bru, out[1:])
    dref = PK.descreening_reference(pos_pad, pos_h, s_h, brw, bru, ref[1:])
    for x, y in zip(dout, dref):
        assert rel(x, y) <= 1e-5
    after = PK.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        born_sums=1, gb_pair=2, descreening=1)


def test_pair_phases_route_through_kernels(cuda, fixture_system):
    params, pos = fixture_system
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos)
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    before = PK.launch_counts()
    _pair_phases_kernel(m.arrays, p, torch.ones(params.n, device=cuda),
                        None, None, m.pair_pad)
    after = PK.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)


def test_wrappers_reject_bad_inputs(cuda, fixture_system):
    params, pos = fixture_system
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos)
    npad = m.pair_pad
    pos_pad = torch.zeros((3, npad), device=cuda)
    q = torch.zeros(npad, device=cuda)
    with pytest.raises(TypeError):
        PK.gb_pair(pos_pad.double(), q, q, params.n)
    with pytest.raises(ValueError):
        PK.gb_pair(pos_pad, q[:-1], q, params.n)
    with pytest.raises(ValueError):
        PK.gb_pair(torch.zeros((npad, 3), device=cuda).T, q, q, params.n)
    with pytest.raises(ValueError):
        PK.gb_pair(pos_pad, q.cpu(), q, params.n)


def test_md_window_bitwise_repeatable(cuda):
    """Two runs of the same MD window on the card (same positions, same
    noise) give bitwise equal trajectories: no float atomics anywhere in
    the step, the autograd MM forces included."""
    from openmm_agbnp_plugin_tpu_torch import Simulation, load_dms

    dms = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "benchmarks", "data", "trpcage_agbnp1.dms")
    sim = Simulation(load_dms(dms), device=cuda, dtype=torch.float32,
                     cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
    run = sim.make_langevin_runner(neighbor_every=5)
    outs = [run(sim.positions, sim.velocities, 10,
                generator=torch.Generator(device=cuda).manual_seed(1))
            for _ in range(2)]
    for x, y in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(outs[0][2]).all())
