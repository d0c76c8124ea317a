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
    TreeCaps, load_dms, load_gaussvol_dat
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import \
    _pair_phases_kernel
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.ops.kernels import tiles as TL

pytestmark = pytest.mark.cuda

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "gaussvol.dat")
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmarks", "data")


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
    assert_dense_born(out, ref)
    assert_list_is_twin(out[3], args, horizon=horizon)
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
        dict.fromkeys(after, 0), born_sums=1, gb_pair=2, descreening=1)


@pytest.mark.parametrize("route", ["dense", "lists"])
@pytest.mark.parametrize("share_qd", [True, False])
def test_pair_phases_route_through_kernels(cuda, fixture_system, route,
                                           share_qd):
    params, pos = fixture_system
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos, cutoff=1.0)
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    tiles = m.pair_tiles if route == "lists" else None
    before = PK.launch_counts()
    _pair_phases_kernel(m.arrays, p, torch.ones(params.n, device=cuda),
                        1.0, None, m.pair_pad, pair_tiles=tiles,
                        share_qd=share_qd)
    after = PK.launch_counts()
    sfx = "" if route == "dense" else "_tiles"
    desc = "descreening" + sfx + ("" if share_qd else "_recompute")
    want = {"born_sums" + sfx, "gb_pair" + sfx, desc}
    if route == "dense" and not share_qd:
        # the recompute's list; with Q/dQ shared the Born kernel builds it
        want.add("subtile_columns")
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in want) for k in after}


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
    # the dense Born and descreening sweeps and their chunk list
    a, n = m.arrays, params.n
    nh = a["hids_pad"].shape[0]
    pos_h = torch.zeros((3, nh), device=cuda)
    s_h = torch.zeros(nh, device=cuda)
    args = (pos_pad, pos_h, a["hids_perm_pad"], a["type_rows_pad"],
            a["type_cols_hpad"], a["ytab"], a["y2tab"], s_h, n)
    with pytest.raises(TypeError):
        PK.subtile_columns(pos_pad.double(), pos_h, a["hids_perm_pad"], n)
    with pytest.raises(ValueError):   # not a whole number of sub-tiles
        PK.subtile_columns(pos_pad[:, :-1].contiguous(), pos_h,
                           a["hids_perm_pad"], n)
    chunks = PK.subtile_columns(pos_pad, pos_h, a["hids_perm_pad"], n)
    with pytest.raises(TypeError):
        PK.born_sums(*args, chunks=tuple(chunks)[:2])
    with pytest.raises(ValueError):
        PK.born_sums(*args, chunks=chunks._replace(
            cols=chunks.cols[:, :-32].contiguous()))
    with pytest.raises(TypeError):
        PK.born_sums(*args, chunks=chunks._replace(
            ncols=chunks.ncols.long()))
    _, qq, dqq, ch = PK.born_sums(*args, save_qd=True, chunks=chunks)
    with pytest.raises(ValueError):
        PK.born_sums(*args, save_qd=True, qd_out=(qq[:1], dqq))
    desc = (pos_pad, pos_h, s_h, q, q)
    with pytest.raises(ValueError):   # a dense (Q, dQ) on the card
        PK.descreening(*desc, (qq, dqq))
    with pytest.raises(ValueError):
        PK.descreening(*desc, (qq[:, :-1].contiguous(), dqq, ch))
    odd = torch.empty(qq.numel() + 1, device=cuda)[1:].view(qq.shape)
    with pytest.raises(ValueError):   # read as 16-byte vectors
        PK.descreening(*desc, (odd, dqq, ch))
    with pytest.raises(ValueError):   # qd=None needs the spline
        PK.descreening(*desc, None)
    with pytest.raises(TypeError):
        PK.descreening(*desc, (qq, dqq, tuple(ch)))


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
    before = PK.launch_counts()
    outs = [run(sim.positions, sim.velocities, 10,
                generator=torch.Generator(device=cuda).manual_seed(1))
            for _ in range(2)]
    for x, y in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(x, y)
    assert bool(torch.isfinite(outs[0][2]).all())
    # the fixed-topology tree passes ran as the per-level kernels
    after = PK.launch_counts()
    for k in ("tree_rescan", "tree_reduce", "tree_deposit"):
        assert after[k] > before[k], k


def sweep_inputs(params, pos, dev, cutoff):
    """Sweep inputs in the model's layouts: real positions, types and
    tables, seeded screening factors, Born radii, chain factors, LJ
    parameters and chain-neighbor exclusions."""
    m = AGBNPModel(params, device=dev, dtype=torch.float32, version=1,
                   positions=pos, cutoff=cutoff, pair_tiles=False,
                   caps=TreeCaps.for_natoms(params.n))
    a, n, npad = m.arrays, params.n, m.pair_pad
    rng = np.random.default_rng(5)
    p = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    pos_pad = torch.nn.functional.pad(p[a["rperm"]],
                                      (0, 0, 0, npad - n)).T.contiguous()
    hv = a["hids_pad"] >= 0
    pos_h = (p[a["hids_pad"].clamp(min=0)] * hv[:, None]).T.contiguous()
    rows = torch.arange(npad, device=dev) < n

    def rand(lo, hi, mask):
        x = torch.as_tensor(rng.uniform(lo, hi, mask.shape[0]),
                            dtype=torch.float32, device=dev)
        return torch.where(mask, x, 0.0)

    excl = torch.full((npad, 24), -1, dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    for k in range(1, 13):
        excl[:n - k, 2 * k - 2] = ids[k:]
        excl[k:n, 2 * k - 1] = ids[:n - k]
    spline = PK.SplineArgs(a["hids_perm_pad"], a["type_rows_pad"],
                           a["type_cols_hpad"], a["ytab"], a["y2tab"], n, 1.0)
    return dict(n=n, tile=PK.pick_tile(n), pos_pad=pos_pad, pos_h=pos_h,
                rvalid=rows, hvalid=hv, s_h=rand(0.3, 1.0, hv),
                born=rand(0.12, 0.45, rows), charge=a["charge_pad"],
                brw=rand(-5.0, 5.0, rows), bru=rand(-50.0, 50.0, rows),
                mm=dict(sig_pad=rand(0.2, 0.4, rows),
                        epsq_pad=rand(0.1, 0.9, rows), excl_rows_pad=excl),
                spline=spline)


BOXES = {"nobox": None, "ortho": (4.0, 4.2, 4.4),
         "triclinic": ((4.0, 0.0, 0.0), (0.6, 4.2, 0.0), (0.4, -0.3, 4.4))}


def box_tensor(name, dev, boxes=BOXES):
    box = boxes[name]
    return None if box is None else torch.tensor(box, device=dev)


def headroom_list(L, rng_dist, triangular=False, box=None):
    """A list built on the card with 8 entries of budget headroom, so
    entries past nv are exercised."""
    tile = L["tile"]
    rb = TL.tile_bounds(L["pos_pad"], L["rvalid"], tile)
    cb = rb if triangular else TL.tile_bounds(L["pos_h"], L["hvalid"], tile)
    count = int(TL.build_tile_list(*rb, *cb, rng_dist, 1,
                                   triangular=triangular, box=box)[2])
    tl, nv, _ = TL.build_tile_list(*rb, *cb, rng_dist, count + 8,
                                   triangular=triangular, box=box)
    assert int(nv[0]) == count < tl.shape[1]
    return tl, nv


@pytest.fixture(scope="module", params=["fixture", "1li2", "2clr"])
def shapes(request, cuda, fixture_system):
    """Sweep inputs at the fixture's shapes, at 1li2's list shapes (T 256,
    6 row and 3 column tiles: mts_wu4's route) and at 2clr's."""
    if request.param == "fixture":
        params, pos = fixture_system
    else:
        d = load_dms(os.path.join(DATA, f"{request.param}_agbnp1.dms"))
        params = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                             alpha=d.agbnp_alpha, charge=d.charges,
                             ishydrogen=d.ishydrogen)
        pos = d.positions
    return sweep_inputs(params, pos, cuda, 1.0)


def _system(name, fixture_system):
    """(AGBNPParams, positions) of the fixture or a shipped system."""
    if name == "fixture":
        return fixture_system
    d = load_dms(os.path.join(DATA, f"{name}_agbnp1.dms"))
    return AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                       alpha=d.agbnp_alpha, charge=d.charges,
                       ishydrogen=d.ishydrogen), d.positions


def assert_dense_born(out, ref):
    """The dense Born kernel's (raw, Q, dQ, chunks) against its twin's
    (raw, Q, dQ): raw in full, Q/dQ in the chunk layout on the slots of the
    chunks the kernel walks (undefined elsewhere on the card)."""
    assert len(out) == 4 and len(ref) == 3
    chunks = out[3]
    slots = PK.chunk_slots(chunks)
    assert_outputs(out[:1], ref[:1])
    for x, y in zip(out[1:3], ref[1:]):
        yc = PK.chunk_layout(y, chunks)
        assert x.shape == yc.shape and rel(x[slots], yc[slots]) <= 1e-5


def assert_list_is_twin(chunks, bargs, box=None, horizon=None):
    """A chunk list from the card (the Born kernel's own, or
    subtile_columns') bitwise subtile_columns_reference's."""
    twin = PK.subtile_columns_reference(*bargs[:3], bargs[-1], box=box,
                                        horizon=horizon)
    for x, y in zip(chunks, twin):
        assert x.dtype == y.dtype and torch.equal(x, y)


def assert_outputs(outs, refs):
    for x, y in zip(outs, refs):
        if y is None:
            assert x is None
        else:
            assert x.shape == y.shape and rel(x, y) <= 1e-5


def born_kept(L, nv, tl, rng_dist, box):
    """The sub-tile pairs the Born list kernel must keep: subtile_live at
    its range, rows below n, screener columns."""
    return TL.subtile_live(nv, tl, L["pos_pad"], L["rvalid"], L["pos_h"],
                           L["hvalid"], L["tile"], rng_dist, box=box)


def assert_born(out, ref, nv, live):
    """The Born list kernel's (raw, Q, dQ, keep) against its twin: keep
    bits equal to subtile_live's mirror, raw in full, and Q/dQ on the kept
    sub-tile pairs, outside which they are undefined on the card and the
    twin's are zero."""
    assert len(out) == 4 and len(ref) == 3
    assert torch.equal(TL.keep_flags(out[3], nv), live)
    kept = TL._expand_subtiles(live)
    assert_outputs(out[:1], ref[:1])
    for x, y in zip(out[1:3], ref[1:]):
        assert x.shape == y.shape and rel(x[kept], y[kept]) <= 1e-5
        assert not y[~kept].any()


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("horizon", [1.0, None])
def test_list_born_and_descreening_match_twins(cuda, shapes, horizon, box):
    L = shapes
    n, tile = L["n"], L["tile"]
    box = box_tensor(box, cuda)
    sp = L["spline"]._replace(horizon=horizon)
    rng_dist = 1.0 if horizon else 2.0
    tl, nv = headroom_list(L, rng_dist, box=box)
    args = (nv, tl, L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], n, tile)
    before = PK.launch_counts()
    out = TL.born_sums_tiles(*args, box=box, horizon=horizon, save_qd=True)
    ref = TL.born_sums_tiles_reference(*args, box=box, horizon=horizon,
                                       save_qd=True)
    assert_born(out, ref, nv, born_kept(L, nv, tl, rng_dist, box))
    dargs = (nv, tl, L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"])
    for qd_k, qd_r, spl in ((out[1:], ref[1:], None), (ref[1:], ref[1:], sp),
                            (None, None, sp)):
        assert_outputs(TL.descreening_tiles(*dargs, qd_k, tile, box=box,
                                            spline=spl),
                       TL.descreening_tiles_reference(*dargs, qd_r, tile,
                                                      box=box, spline=spl))
    dense = (L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"], None)
    assert_outputs(PK.descreening(*dense, box=box, spline=sp),
                   PK.descreening_reference(*dense, box=box, spline=sp))
    after = PK.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), born_sums_tiles=1, descreening_tiles=2,
        descreening_tiles_recompute=1, descreening_recompute=1,
        subtile_columns=1)


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("horizon", [1.0, None])
def test_dense_reload_descreening_matches_twin(cuda, shapes, horizon, box):
    """The dense reloading descreening (the chunk kernel, reading the dense
    Born kernel's chunk-layout Q/dQ on the chunks it wrote) against its
    twin on the twin's dense Q/dQ, with and without a spline (which the
    reload does not read); launched twice, bitwise equal."""
    L = shapes
    box = box_tensor(box, cuda)
    sp = L["spline"]._replace(horizon=horizon)
    before = PK.launch_counts()
    bargs = (L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], L["n"])
    born = PK.born_sums(*bargs, box=box, horizon=horizon, save_qd=True)
    ref = PK.born_sums_reference(*bargs, box=box, horizon=horizon,
                                 save_qd=True)
    assert_dense_born(born, ref)
    assert_list_is_twin(born[3], bargs, box=box, horizon=horizon)
    desc = (L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"])
    for spl in (sp, None):
        out = PK.descreening(*desc, born[1:], box=box, spline=spl)
        assert_outputs(out, PK.descreening_reference(*desc, ref[1:],
                                                     box=box))
        again = PK.descreening(*desc, born[1:], box=box, spline=spl)
        assert all(torch.equal(x, y) for x, y in zip(out, again))
    after = PK.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), born_sums=1, descreening=4)


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("horizon", [1.0, None])
def test_dense_chunk_kernels_match_twins(cuda, shapes, horizon, box):
    """The chunk list kernel bitwise its twin; the dense Born kernel and
    the recomputing descreening over it against their dense twins (1e-5 of
    max|ref|), the Born kernel's Q/dQ on the chunk slots it walks; the Born
    kernel given no list builds one bitwise the twin's and walks it as the
    given one, bit for bit; every kernel launched twice, bitwise equal."""
    L = shapes
    box = box_tensor(box, cuda)
    n = L["n"]
    sp = L["spline"]._replace(horizon=horizon)
    bargs = (L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], n)
    chunks = PK.subtile_columns(*bargs[:3], n, box=box, horizon=horizon)
    assert_list_is_twin(chunks, bargs, box=box, horizon=horizon)
    assert torch.equal(PK.subtile_columns(*bargs[:3], n, box=box,
                                          horizon=horizon).cols, chunks.cols)
    kw = dict(box=box, horizon=horizon, save_qd=True, chunks=chunks)
    born, again = (PK.born_sums(*bargs, **kw) for _ in range(2))
    assert_dense_born(born, PK.born_sums_reference(
        *bargs, box=box, horizon=horizon, save_qd=True))
    built = PK.born_sums(*bargs, box=box, horizon=horizon, save_qd=True)
    assert_list_is_twin(built[3], bargs, box=box, horizon=horizon)
    slots = PK.chunk_slots(chunks)
    for other in (again, built):
        assert torch.equal(born[0], other[0])
        for x, y in zip(born[1:3], other[1:3]):
            assert torch.equal(x[slots], y[slots])
    desc = (L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"], None)
    out = PK.descreening(*desc, box=box, spline=sp, chunks=chunks)
    assert_outputs(out, PK.descreening_reference(*desc, box=box, spline=sp))
    for x, y in zip(out, PK.descreening(*desc, box=box, spline=sp,
                                        chunks=chunks)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("system", ["fixture", "1li2", "2clr"])
def test_dense_reload_reads_only_what_the_born_kernel_wrote(
        cuda, fixture_system, monkeypatch, system):
    """The model's dense pair phases with the Born kernel's chunk-layout
    Q/dQ buffers filled with NaN beforehand: the slots of the chunks it
    does not walk stay NaN, and every result is finite and bitwise the run
    on zero-filled buffers, since the reload walks only those chunks."""
    params, pos = _system(system, fixture_system)
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos, cutoff=1.0, descreen_horizon="cutoff",
                   pair_tiles=False, caps=TreeCaps.for_natoms(params.n))
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    s_factor = torch.as_tensor(
        np.random.default_rng(4).uniform(0.3, 1.0, params.n),
        dtype=torch.float32, device=cuda)
    born = PK.born_sums
    buffers = []

    def run(fill):
        def prefilled(*args, **kw):
            shape = (args[0].shape[1] // PK.SUB, args[1].shape[1], PK.SUB)
            bufs = tuple(torch.full(shape, fill, device=cuda)
                         for _ in range(2))
            buffers.append(bufs)
            return born(*args, qd_out=bufs, **kw)

        monkeypatch.setattr(PK, "born_sums", prefilled)
        return _pair_phases_kernel(m.arrays, p, s_factor, 1.0, None,
                                   m.pair_pad, horizon=m.descreen_horizon,
                                   pair_tiles=None)

    nan, zero = run(float("nan")), run(0.0)
    assert len(buffers) == 2 and torch.isnan(buffers[0][0]).any()
    assert set(nan) == set(zero)
    for k, v in zero.items():
        assert bool(torch.isfinite(nan[k]).all()), k
        assert torch.equal(nan[k], v), k


@pytest.mark.parametrize("system", ["fixture", "1li2", "2clr"])
def test_reload_reads_only_what_the_born_kernel_wrote(cuda, fixture_system,
                                                      monkeypatch, system):
    """The model's pair phases on the lists with the Born kernel's Q/dQ
    buffers filled with NaN beforehand: the sub-tile pairs it does not keep
    stay NaN, and every result is finite and bitwise the run on zero-filled
    buffers, since the reload visits only what the Born kernel wrote."""
    params, pos = _system(system, fixture_system)
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos, cutoff=1.0, descreen_horizon="cutoff",
                   caps=TreeCaps.for_natoms(params.n))
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    s_factor = torch.as_tensor(
        np.random.default_rng(4).uniform(0.3, 1.0, params.n),
        dtype=torch.float32, device=cuda)
    born = TL.born_sums_tiles
    buffers = []

    def run(fill):
        def prefilled(*args, **kw):
            shape = (args[1].shape[1], args[-1], args[-1])
            bufs = tuple(torch.full(shape, fill, device=cuda)
                         for _ in range(2))
            buffers.append(bufs)
            return born(*args, qd_out=bufs, **kw)

        monkeypatch.setattr(TL, "born_sums_tiles", prefilled)
        return _pair_phases_kernel(m.arrays, p, s_factor, 1.0, None,
                                   m.pair_pad, horizon=m.descreen_horizon,
                                   pair_tiles=m.pair_tiles)

    nan, zero = run(float("nan")), run(0.0)
    assert len(buffers) == 2 and torch.isnan(buffers[0][0]).any()
    assert set(nan) == set(zero)
    for k, v in zero.items():
        assert bool(torch.isfinite(nan[k]).all()), k
        assert torch.equal(nan[k], v), k


@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("with_mm", [False, True])
def test_list_gb_pair_matches_twin(cuda, shapes, with_mm, box):
    L = shapes
    box = box_tensor(box, cuda)
    tl, nv = headroom_list(L, 1.0, triangular=True, box=box)
    args = (nv, tl, L["pos_pad"], L["charge"], L["born"], L["n"], L["tile"])
    kw = dict(cutoff=1.0, box=box, **(L["mm"] if with_mm else {}))
    assert_outputs(TL.gb_pair_tiles(*args, **kw),
                   TL.gb_pair_tiles_reference(*args, **kw))


def test_lists_match_dense_on_card(cuda, fixture_system):
    """The model on lists, with and without Q/dQ sharing, against the
    dense grid, f32 on the card; repeatable bit for bit."""
    params, pos = fixture_system
    kw = dict(device=cuda, dtype=torch.float32, version=1, positions=pos,
              cutoff=1.0, descreen_horizon="cutoff")
    e0, f0 = AGBNPModel(params, pair_tiles=False, **kw).energy_forces(pos)
    for share in (True, False):
        m = AGBNPModel(params, share_qd=share, **kw)
        assert m.pair_tiles is not None
        e1, f1 = m.energy_forces(pos)
        assert abs(float(e1) - float(e0)) <= 1e-5 * abs(float(e0))
        assert rel(f1, f0) <= 1e-5
        e2, f2 = m.energy_forces(pos)
        assert torch.equal(e1, e2) and torch.equal(f1, f2)


SPARSE_RANGE = 1.0    # nm: the GB cutoff and the Born/descreening horizon
SPARSE_STEP = 1.1     # nm between neighbours on a line, above the range
SPARSE_BOXES = {"nobox": None, "ortho": (100.0, 104.0, 108.0),
                "triclinic": ((100.0, 0.0, 0.0), (6.0, 104.0, 0.0),
                              (4.0, -3.0, 108.0))}


def sparse_layout(kind, box_name, ytab, y2tab, dev="cpu", seed=13):
    """Sweep inputs at T 256 (NP 512, n 500; NHP 512 with 480 screeners,
    eight of them missing mid-tile) in which every live pair of the list
    sweep lies 2e-4 to 9e-4 nm inside SPARSE_RANGE, joins two different
    32-atom sub-tiles, and is the only pair of both its atoms: "gb" pairs
    rows with rows (the triangular GB list), "born" rows with screeners
    (the Born/descreening list).

    Each pair couples two sub-tiles whose valid atoms lie on one line,
    SPARSE_STEP apart, on either side of the pair, so the 32-atom boxes'
    lower distance bound is the pair's distance itself: a pruning that
    drops anything near the range drops the pair.  In a box, a third of
    the couples meet across the x face and a third across the z face
    (through the triclinic c vector).  The near ends hold row n - 1 and
    the screener whose row id is 0.  Returns the inputs as sweep_inputs
    does, with "pairs" [P, 2] (row, column) and "range"."""
    rng = np.random.default_rng(seed)
    tile, npad, n, nh = 256, 512, 500, 490
    nsub = npad // 32
    box = SPARSE_BOXES[box_name]
    vec = None if box is None else np.array(box, np.float64)
    if vec is not None and vec.ndim == 1:
        vec = np.diag(vec)
    d_pair = SPARSE_RANGE - rng.uniform(2e-4, 9e-4, nsub)
    pos_r = np.zeros((npad, 3))
    rvalid = np.arange(npad) < n
    if kind == "gb":
        pos_c, cvalid = pos_r, rvalid
        couples = np.sort(rng.permutation(nsub).reshape(-1, 2), axis=1)
    else:
        pos_c = np.zeros((npad, 3))
        cvalid = np.arange(npad) < nh
        cvalid[rng.choice(nh, 8, replace=False)] = False
        couples = np.stack([np.arange(nsub), rng.permutation(nsub)], 1)

    def lanes(valid, sub, last):
        """The sub-tile's valid atoms, the near end (last, if valid) first,
        the rest in a random order."""
        ids = np.flatnonzero(valid[32 * sub:32 * sub + 32]) + 32 * sub
        near = last if last in ids else ids[rng.integers(len(ids))]
        return np.concatenate([[near], rng.permutation(ids[ids != near])])

    pairs = []
    for p, (a, b) in enumerate(couples):
        mode = "direct" if vec is None else ("direct", "x", "z")[p % 3]
        y = 5.0 + 3.0 * p
        if mode == "direct":
            u, near, wrap = np.array([1.0, 0, 0]), np.array([40.0, y, 50]), 0
        elif mode == "x":
            u, near, wrap = np.array([-1.0, 0, 0]), np.array([0.5, y, 50]), \
                vec[0]
        else:
            u, near, wrap = np.array([0, 0, -1.0]), np.array([45.0, y, 0.5]), \
                vec[2]
        ia = lanes(rvalid, a, n - 1)
        jb = lanes(cvalid, b, n - 1 if kind == "gb" else -1)
        pos_r[ia] = near - np.arange(len(ia))[:, None] * SPARSE_STEP * u
        pos_c[jb] = (near + d_pair[p] * u + wrap
                     + np.arange(len(jb))[:, None] * SPARSE_STEP * u)
        pairs.append((ia[0], jb[0]))
    pairs = np.array(pairs)
    hids = np.where(rvalid, np.arange(npad), -1)
    if kind == "born":
        # the screeners' row ids: distinct, 0 at a near end, never the row
        # of the screener's own pair
        hids = np.full(npad, -1, np.int64)
        hids[cvalid] = rng.permutation(np.arange(1, n))[:int(cvalid.sum())]
        hids[pairs[pairs[:, 0] != 0][0, 1]] = 0
        spare = cvalid.copy()
        spare[pairs[:, 1]] = False
        for i, j in pairs:
            if hids[j] == i:
                k = np.flatnonzero(spare)[0]
                hids[j], hids[k] = hids[k], hids[j]

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    def rand(lo, hi, valid):
        return t(np.where(valid, rng.uniform(lo, hi, npad), 0.0))

    nti, ntj = ytab.shape[:2]
    excl = np.full((npad, 24), -1, np.int64)
    for k, (i, j) in enumerate(pairs if kind == "gb" else []):
        if k % 2:  # half the pairs excluded from the MM terms
            excl[i, 0], excl[j, 0] = j, i
    excl[:n, 1] = (np.arange(n) + 7) % n
    sign = np.where(rng.random(npad) < 0.5, -1.0, 1.0)
    spline = PK.SplineArgs(
        t(hids, torch.int32), t(rng.integers(0, nti, npad), torch.int32),
        t(rng.integers(0, ntj, npad), torch.int32), ytab.to(dev),
        y2tab.to(dev), n, SPARSE_RANGE)
    pos_pad = t(pos_r.T).contiguous()
    return dict(
        n=n, tile=tile, pos_pad=pos_pad, rvalid=t(rvalid, torch.bool),
        pos_h=pos_pad if kind == "gb" else t(pos_c.T).contiguous(),
        hvalid=t(cvalid, torch.bool), s_h=rand(0.3, 1.0, cvalid),
        born=rand(0.12, 0.45, rvalid),
        charge=t(sign * np.where(rvalid, rng.uniform(0.3, 1.0, npad), 0.0)),
        brw=rand(-5.0, 5.0, rvalid), bru=rand(-50.0, 50.0, rvalid),
        mm=dict(sig_pad=rand(0.2, 0.4, rvalid),
                epsq_pad=rand(0.1, 0.9, rvalid),
                excl_rows_pad=t(excl, torch.int32)),
        spline=spline, pairs=torch.as_tensor(pairs), range=SPARSE_RANGE)


@pytest.fixture(scope="module")
def spline_tables(fixture_system):
    params, pos = fixture_system
    a = AGBNPModel(params, device="cpu", dtype=torch.float32, version=1,
                   positions=pos).arrays
    return a["ytab"], a["y2tab"]


@pytest.mark.parametrize("box", list(SPARSE_BOXES))
@pytest.mark.parametrize("kind", ["gb", "born"])
def test_list_kernels_keep_the_pairs_at_the_range(cuda, spline_tables, kind,
                                                  box):
    """The kernels' own sub-tile pruning on the sparse layout, where each
    live pair lies just inside the range across two sub-tiles and is its
    atoms' only pair: a pair the kernel dropped would take away its atoms'
    whole outputs (tests/test_torch_subtiles.py checks that on the twin),
    so the GB kernel with and without MM and both descreening variants
    must match the unpruned twins."""
    L = sparse_layout(kind, box, *spline_tables, dev=cuda)
    box = box_tensor(box, cuda, SPARSE_BOXES)
    rng_dist, tile, n = L["range"], L["tile"], L["n"]
    if kind == "gb":
        tl, nv = headroom_list(L, rng_dist, triangular=True, box=box)
        args = (nv, tl, L["pos_pad"], L["charge"], L["born"], n, tile)
        for mm in ({}, L["mm"]):
            kw = dict(cutoff=rng_dist, box=box, **mm)
            assert_outputs(TL.gb_pair_tiles(*args, **kw),
                           TL.gb_pair_tiles_reference(*args, **kw))
        return
    sp = L["spline"]
    tl, nv = headroom_list(L, rng_dist, box=box)
    args = (nv, tl, L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], n, tile)
    kw = dict(box=box, horizon=rng_dist, save_qd=True)
    out = TL.born_sums_tiles(*args, **kw)
    ref = TL.born_sums_tiles_reference(*args, **kw)
    assert_born(out, ref, nv, born_kept(L, nv, tl, rng_dist, box))
    dargs = (nv, tl, L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"])
    for qd_k, qd_r, spl in ((out[1:], ref[1:], sp), (ref[1:], ref[1:], sp),
                            (ref[1:], ref[1:], None), (None, None, sp)):
        assert_outputs(TL.descreening_tiles(*dargs, qd_k, tile, box=box,
                                            spline=spl),
                       TL.descreening_tiles_reference(*dargs, qd_r, tile,
                                                      box=box, spline=spl))


@pytest.mark.parametrize("box", list(SPARSE_BOXES))
def test_dense_chunk_kernels_keep_the_pairs_at_the_range(cuda, spline_tables,
                                                         box):
    """The chunk list kernel on the sparse layout, where each live Born
    pair lies just inside the horizon and its row sub-tile's box is exactly
    as far from the column: bitwise its twin, every pair listed, and the
    dense Born kernel, the reload and the recompute over it against the
    dense twins."""
    L = sparse_layout("born", box, *spline_tables, dev=cuda)
    box = box_tensor(box, cuda, SPARSE_BOXES)
    sp, n, hz = L["spline"], L["n"], L["range"]
    bargs = (L["pos_pad"], L["pos_h"], *sp[:5], L["s_h"], n)
    chunks = PK.subtile_columns(*bargs[:3], n, box=box, horizon=hz)
    for x, y in zip(chunks, PK.subtile_columns_reference(
            *bargs[:3], n, box=box, horizon=hz)):
        assert torch.equal(x, y)
    rows, cols = L["pairs"][:, 0].to(cuda), L["pairs"][:, 1].to(cuda)
    on = (chunks.cols.long()[rows // PK.SUB] == cols[:, None]).any(dim=1)
    assert bool(on.all())
    ref = PK.born_sums_reference(*bargs, box=box, horizon=hz, save_qd=True)
    desc = (L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"])
    for given in (chunks, None):   # the list given, and built by #1
        born = PK.born_sums(*bargs, box=box, horizon=hz, save_qd=True,
                            chunks=given)
        assert_dense_born(born, ref)
        assert_list_is_twin(born[3], bargs, box=box, horizon=hz)
        assert_outputs(PK.descreening(*desc, born[1:], box=box),
                       PK.descreening_reference(*desc, ref[1:], box=box))
    assert_outputs(PK.descreening(*desc, None, box=box, spline=sp,
                                  chunks=chunks),
                   PK.descreening_reference(*desc, None, box=box, spline=sp))


@pytest.mark.parametrize("box", ["nobox", "triclinic"])
def test_redesigned_list_kernels_bitwise_repeatable(cuda, shapes, box):
    """The list kernels add every sum in a fixed order: two launches on the
    same inputs are equal bit for bit (the Born kernel's Q/dQ on the
    sub-tile pairs it keeps, its keep bits below nv)."""
    L = shapes
    n, tile = L["n"], L["tile"]
    box = box_tensor(box, cuda)
    tl, nv = headroom_list(L, 1.0, box=box)
    bargs = (nv, tl, L["pos_pad"], L["pos_h"], *L["spline"][:5], L["s_h"],
             n, tile)
    born, again = (TL.born_sums_tiles(*bargs, box=box, horizon=1.0,
                                      save_qd=True) for _ in range(2))
    nvv = int(nv[0])
    kept = TL._expand_subtiles(TL.keep_flags(born[3], nv))
    assert torch.equal(born[0], again[0])
    assert torch.equal(born[3][:nvv], again[3][:nvv])
    for x, y in zip(born[1:3], again[1:3]):
        assert torch.equal(x[kept], y[kept])
    dargs = (nv, tl, L["pos_pad"], L["pos_h"], L["s_h"], L["brw"], L["bru"])
    tl_g, nv_g = headroom_list(L, 1.0, triangular=True, box=box)
    gargs = (nv_g, tl_g, L["pos_pad"], L["charge"], L["born"], n, tile)
    calls = [lambda: TL.gb_pair_tiles(*gargs, cutoff=1.0, box=box, **L["mm"]),
             lambda: TL.descreening_tiles(*dargs, born[1:], tile, box=box,
                                          spline=L["spline"]),
             lambda: TL.descreening_tiles(*dargs, None, tile, box=box,
                                          spline=L["spline"])]
    for call in calls:
        first, second = call(), call()
        for x, y in zip(first, second):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The row kernels (csrc/rows.cu) and the Context
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,parents,cols", [
    (85504, 34816, 8), (4097, 1500, 8), (1, 3, 4), (777, 200, 16),
    (85504, 34816, 1), (85504, 5983, 6), (85504, 5983, 12),
    (85504, 34816, 13), (85504, 34816, 26), (4097, 1500, 28), (33, 7, 5)])
def test_take_rows_bitwise_equal_to_the_twin(cuda, rows, parents, cols):
    """Sorted ids, an unsorted id vector and ids outside [0, P), at the
    probe's width and at every width the tree gathers (1, 6, 12, 13, 26:
    16-, 8- and 4-byte pieces): every row is a copy or zero, so the kernel
    equals the twin bit for bit, twice.  A table that starts one word off a
    16-byte address moves in single words to the same rows, and a
    one-column table also as a vector."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    rng = np.random.RandomState(1)
    table = torch.as_tensor(rng.rand(parents, cols), dtype=torch.float32,
                            device=cuda)
    sorted_ids = torch.as_tensor(RW.make_segments(rows, parents), device=cuda)
    wild = torch.as_tensor(rng.randint(-5, parents + 5, size=rows)
                           .astype(np.int32), device=cuda)
    assert bool(((wild < 0) | (wild >= parents)).any()) or rows == 1
    off = torch.empty(table.numel() + 1, dtype=torch.float32,
                      device=cuda)[1:].view(table.shape).copy_(table)
    assert off.data_ptr() % 8 == 4
    before = PK.launch_counts()["take_rows"]
    for ids in (sorted_ids, wild, sorted_ids.flip(0).contiguous()):
        out = RW.take_rows(table, ids)
        assert torch.equal(out, RW.take_rows_reference(table, ids))
        assert torch.equal(out, RW.take_rows(table, ids))
        assert torch.equal(out, RW.take_rows(off, ids))
        assert torch.equal(out.cpu(), RW.take_rows(table.cpu(), ids.cpu()))
    assert PK.launch_counts()["take_rows"] == before + 9
    # the kernel moves 32-bit words: a float64 table moves as two words a
    # value, bitwise its twin (the tree's passes in f64 on the card); a
    # table of another dtype raises
    t64 = table.double() / 3.0
    before = PK.launch_counts()["take_rows"]
    out64 = RW.take_rows(t64, wild)
    assert out64.dtype == torch.float64 and out64.shape == (rows, cols)
    assert torch.equal(out64, RW.take_rows_reference(t64, wild))
    if cols == 1:
        assert torch.equal(RW.take_rows(t64[:, 0].contiguous(), wild),
                           out64[:, 0])
    assert PK.launch_counts()["take_rows"] == before + 1 + (cols == 1)
    with pytest.raises(TypeError):
        RW.take_rows(table.half(), wild)
    want = 16 if cols % 4 == 0 else 8 if cols % 2 == 0 else 4
    assert RW.take_rows_piece_bytes(table, out) == want
    assert RW.take_rows_piece_bytes(off, out) == 4
    if cols == 1:
        vec = RW.take_rows(table[:, 0].contiguous(), wild)
        assert tuple(vec.shape) == (rows,)
        assert torch.equal(vec, RW.take_rows(table, wild)[:, 0])


@pytest.mark.parametrize("rows,cols", [(85504, 8), (1056, 8), (1057, 8),
                                       (1, 8), (33, 1), (5000, 13),
                                       (3000, 256)])
def test_cumsum_rows_repeatable_and_within_its_bound(cuda, rows, cols):
    """R not a multiple of the tile (1,024 rows at 8 columns), R = 1, other
    widths: one launch a call, two launches equal bit for bit; every
    output is a chain of at most 8 + log2(parts) + a few look-back sums of
    rounded partial sums, so it lies within 1e-5 of an f64 prefix sum at
    these sizes, measured against the running sum of |d|; signed data
    included."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    rng = np.random.RandomState(2)
    d = torch.as_tensor(rng.rand(rows, cols) - 0.25, dtype=torch.float32,
                        device=cuda)
    before = PK.launch_counts()["cumsum_rows"]
    out = RW.cumsum_rows(d)
    assert torch.equal(out, RW.cumsum_rows(d))
    assert PK.launch_counts()["cumsum_rows"] == before + 2
    ref = torch.cumsum(d.double(), 0)
    scale = float(torch.cumsum(d.double().abs(), 0).max())
    assert float((out.double() - ref).abs().max()) <= 1e-5 * scale
    # the twin is a sequential f32 sum: the kernel is no further from it
    # than the twin is from f64, plus its own bound
    twin = RW.cumsum_rows_reference(d)
    assert float((out - twin).abs().max()) <= float(
        (twin.double() - ref).abs().max()) + 1e-5 * scale


@pytest.mark.parametrize("cols", [1, 3, 8, 13, 26, 256])
def test_cumsum_rows_bitwise_its_mirror(cuda, cols):
    """The kernel's bits are cumsum_rows_mirror's (the same float32 sums
    in the same order), on shapes that are not a tile multiple, with the
    carry over every tile before and over groups of 32 tiles, on 1 row,
    and on 0 rows (no launch);
    twice bitwise; within 1e-5 of max|f64 prefix sum|."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    tile_rows = RW.cumsum_layout(cols)[1]
    # past FLAT_VALUES // C tiles the carry takes the group level (and more
    # than 32 groups); 4 tiles: one tree over every tile before
    grouped = RW.FLAT_VALUES // cols + 34
    for rows in (grouped * tile_rows - 3, 3 * tile_rows + 5, 1, 0):
        rng = np.random.RandomState(rows + cols)
        d = torch.as_tensor(rng.rand(rows, cols) - 0.3, dtype=torch.float32,
                            device=cuda)
        before = PK.launch_counts()["cumsum_rows"]
        out = RW.cumsum_rows(d)
        assert PK.launch_counts()["cumsum_rows"] == before + (rows > 0)
        assert tuple(out.shape) == (rows, cols)
        if rows == 0:
            continue
        assert torch.equal(out, RW.cumsum_rows(d))
        assert torch.equal(out, RW.cumsum_rows_mirror(d))
        assert torch.equal(out.cpu(), RW.cumsum_rows_mirror(d.cpu()))
        ref = torch.cumsum(d.double(), 0)
        assert float((out.double() - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max().clamp_min(1.0))


def test_cumsum_rows_two_streams_at_once(cuda):
    """Calls in flight on two streams keep their own tickets and flags:
    each result is bitwise the one-stream result, and a third call on the
    default stream after them is too (the flags were cleared)."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    rng = np.random.RandomState(9)
    xs = [torch.as_tensor(rng.rand(85504, 8) - 0.5, dtype=torch.float32,
                          device=cuda) for _ in range(2)]
    ref = [RW.cumsum_rows(x) for x in xs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in xs]
    outs = [None, None]
    for _ in range(20):
        for i, (x, st) in enumerate(zip(xs, streams)):
            st.wait_stream(torch.cuda.current_stream(cuda))
            with torch.cuda.stream(st):
                outs[i] = RW.cumsum_rows(x)
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert torch.equal(o, r)
    assert torch.equal(RW.cumsum_rows(xs[0]), ref[0])


def test_row_wrappers_reject_bad_inputs(cuda):
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    table = torch.zeros((16, 8), dtype=torch.float32, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        RW.take_rows(table, ids.long())
    with pytest.raises(ValueError, match="contiguous"):
        RW.take_rows(table[:, :4], ids)
    with pytest.raises(ValueError, match=r"\[P, C\]"):
        RW.take_rows(table.view(16, 4, 2), ids)
    with pytest.raises(ValueError, match="no columns"):
        RW.take_rows(table[:, :0].contiguous(), ids)
    with pytest.raises(ValueError, match="contiguous"):
        RW.take_rows(table[:, :4].requires_grad_(True), ids)
    with pytest.raises(ValueError):
        RW.take_rows(table, ids.cpu())
    with pytest.raises(TypeError):
        RW.cumsum_rows(table.double())
    with pytest.raises(ValueError, match="contiguous"):
        RW.cumsum_rows(table.T)


@pytest.fixture(scope="module")
def tree_2clr(cuda):
    """2clr's tree on the card at the model's capacities: (levels of the
    vdW parameterization from the model's own pass, their topology, the two
    level-1 tables, natoms)."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    d = load_dms(os.path.join(DATA, "2clr_agbnp1.dms"))
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    m = AGBNPModel(p, device=cuda, dtype=torch.float32,
                   positions=d.positions)
    pos = torch.as_tensor(d.positions, dtype=torch.float32, device=cuda)
    a, pair_rows, _ = M.tree_candidates(m.arrays, pos, m.neighbor_rcut,
                                        m.neighbor_kmax, m.neighbor_grid)
    out = M.tree_passes(a, pos, m.caps, p.roffset, pair_rows=pair_rows)
    assert not T.check_overflow(out[5])["any"]
    gdr = a["gamma"] / p.roffset
    l1 = T.make_level1(pos, a["radii_large"], a["vol_large"], gdr,
                       a["ishydrogen"])
    return out[3], T.tree_topology(out[3]), l1, out[4], p.n


def test_tree_passes_with_the_kernel_equal_the_stock_gather(cuda, tree_2clr,
                                                            monkeypatch):
    """Every pass of 2clr's tree with take_rows against the same pass with
    the stock gather in its place: the kernel is a pure move, so energies,
    gradients and self volumes are equal bit for bit; twice."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    _, topo, l1, v1, natoms = tree_2clr
    level_bounds = T.level_bounds
    gam = torch.as_tensor(np.random.default_rng(3).normal(0.0, 10.0, natoms),
                          dtype=torch.float32, device=cuda)
    wu = {**v1, "gamma1i": gam}

    def passes():
        la, lb = T.rescan_volumes2(topo, l1, v1)
        r1, r2 = T.reduce_tree2(la, lb, l1, v1)
        lv = T.rescan_volumes(topo, v1)
        rg = T.reduce_tree(T.rescan_gammas(lv, wu), wu, with_selfvol=False)
        vt, counts = T.compact_topology(lv, [l["valid"].shape[0]
                                             for l in lv])
        rc = T.reduce_tree(T.rescan_volumes(vt, wu), wu, with_selfvol=False)
        return [r1["energy"], r1["dr"], r2["energy"], r2["dr"],
                r2["self_volume"], rg["energy"], rg["dr"], rc["dr"], counts]

    before = PK.launch_counts()["take_rows"]
    first, second = passes(), passes()
    launched = PK.launch_counts()["take_rows"] - before
    assert launched == 2 * 4 * 2 * T.NUM_TREE_LEVELS
    # the stock gather, and the padding rows deposited on atom 0 as zeros
    # instead of left out of the deposit sum
    monkeypatch.setattr(T, "take_rows", lambda x, ids: x[ids.long()])
    monkeypatch.setattr(T, "level_bounds", lambda pmono, atom, *a: dict(
        level_bounds(pmono, atom, *a), atom_dep=atom))
    topo = tuple({**t, "bnd": {**t["bnd"], "atom_dep": t["atom"]}}
                 for t in topo)
    stock = passes()
    assert PK.launch_counts()["take_rows"] - before == launched
    for x, y, z in zip(first, second, stock):
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, y) and torch.equal(x, z)


def test_segment_sum_over_valid_rows_on_the_card(cuda, tree_2clr):
    """On every level of 2clr's tree, built and compacted: the sorted sum
    with the level's lengths (its valid rows, which come first) equals the
    sum whose lengths count every row bit for bit, reads no padding row
    (NaN there changes nothing), and repeats bit for bit."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    levels_vdw, topo, _, _, natoms = tree_2clr
    compacted, _ = T.compact_topology(
        levels_vdw, [max(8, int(l["valid"].sum()) // 2) for l in levels_vdw])
    gen = torch.Generator(device=cuda).manual_seed(6)
    for levels in (topo, compacted):
        nparents = natoms
        for lvl in levels:
            valid, bnd = lvl["valid"], lvl["bnd"]
            cap = valid.shape[0]
            nv = int(valid.sum())
            assert bool(valid[:nv].all()) and not bool(valid[nv:].any())
            assert int(bnd["lengths"].sum()) == nv
            x = torch.randn((cap, 11), generator=gen, device=cuda) \
                * valid[:, None]
            full = T.segment_sum(x, bnd["pmono"], nparents, ids_sorted=True)
            lean = T._upward_segment_sum(x, lvl, nparents)
            assert torch.equal(lean, full)
            assert torch.equal(lean, T._upward_segment_sum(x, lvl, nparents))
            junk = torch.where(valid[:, None], x, float("nan"))
            assert torch.equal(T._upward_segment_sum(junk, lvl, nparents),
                               full)
            nparents = cap


@pytest.mark.parametrize("case", ["nocutoff", "nocutoff-mm", "1nm",
                                  "1nm-mm", "1nm-mm-ortho",
                                  "1nm-mm-triclinic"])
def test_dense_gb_pair_matches_twin(cuda, shapes, case):
    """The dense GB sweep (the list kernel over every tile pair ti <= tj)
    against gb_pair's twin at the fixture's, 1li2's and 2clr's dense
    shapes, without a cutoff (nothing pruned) and at 1 nm, with the fused
    MM terms and with boxes; launched twice, bitwise equal."""
    L = shapes
    parts = case.split("-")
    kw = dict(cutoff=None if parts[0] == "nocutoff" else 1.0,
              box=box_tensor(parts[2] if len(parts) > 2 else "nobox", cuda),
              **(L["mm"] if "mm" in parts else {}))
    args = (L["pos_pad"], L["charge"], L["born"], L["n"])
    before = PK.launch_counts()
    out = PK.gb_pair(*args, **kw)
    assert_outputs(out, PK.gb_pair_reference(*args, **kw))
    again = PK.gb_pair(*args, **kw)
    assert all(x is None if y is None else torch.equal(x, y)
               for x, y in zip(out, again))
    after = PK.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), gb_pair=2)


def test_gather_free_broadcast_on_the_card(cuda):
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    rows, parents = 85504, 34816
    ids = torch.as_tensor(RW.make_segments(rows, parents), device=cuda)
    v = torch.as_tensor(np.random.RandomState(1).rand(parents, 8),
                        dtype=torch.float32, device=cuda)
    dev = RW.broadcast_deviation(v, ids)
    assert 0.0 <= dev <= rows * 2.0 ** -23 * float(v.abs().max())


def _force_of(pkg_force, params, version):
    pkg_force.setVersion(version)
    for i in range(params.n):
        pkg_force.addParticle(params.radius[i], params.gamma[i],
                              params.alpha[i], params.charge[i],
                              bool(params.ishydrogen[i]))
    return pkg_force


@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("method", ["NoCutoff", "CutoffNonPeriodic",
                                    "CutoffPeriodic"])
def test_context_on_card_matches_cpu_f64(cuda, fixture_system, version,
                                         method):
    """The Context on the card (f32, the default device) against the
    Context on the CPU in f64, for every nonbonded method."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, Context, \
        NonbondedMethod

    params, pos = fixture_system
    force = _force_of(AGBNPForce(), params, version)
    force.setNonbondedMethod(NonbondedMethod[method])
    force.setCutoffDistance(1.2)
    box = (((6.0, 0, 0), (0.8, 6.2, 0), (-0.5, 0.7, 6.4))
           if method == "CutoffPeriodic" else None)
    ctx = Context(force, box=box)
    ref = Context(force, dtype=torch.float64, device="cpu", box=box)
    assert ctx._device == cuda
    for c in (ctx, ref):
        c.setPositions(pos)
    e, f = ctx.getEnergyForces()
    e_ref, f_ref = ref.getEnergyForces()
    assert isinstance(e, float) and f.device == cuda
    assert f.dtype == torch.float32
    assert abs(e - e_ref) <= 1e-5 * abs(e_ref)
    assert rel(f, f_ref) <= 1e-5
    assert ctx.getEnergy() == e
    e0, f0 = ctx.calcForcesAndEnergy(includeForces=False)
    assert e0 == e and not bool(f0.any()) and f0.device == cuda
    # a parameter edit keeps the model and matches a fresh Context
    model = ctx._model
    for i in range(params.n):
        r, g, a, q, h = force.getParticleParameters(i)
        force.setParticleParameters(i, r, g, a, 0.5 * q, h)
    force.updateParametersInContext(ctx)
    assert ctx._model is model
    fresh = Context(force, box=box)
    fresh.setPositions(pos)
    e1, f1 = ctx.getEnergyForces()
    e2, f2 = fresh.getEnergyForces()
    assert e1 == e2 and torch.equal(f1, f2)


@pytest.mark.parametrize("name", ["trpcage", "rnaseh", "1dwc"])
def test_shipped_systems_on_card_against_f64_records(cuda, name):
    """The three shipped systems beside 1li2 and 2clr, f32 on the card
    against the JAX package's stored f64 results; rnaseh builds its tree
    candidates with half_neighbor_pairs on the device, without a grid."""
    d = load_dms(os.path.join(DATA, f"{name}_agbnp1.dms"))
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    m = AGBNPModel(p, device=cuda, dtype=torch.float32,
                   positions=d.positions)
    if name == "rnaseh":
        assert m.neighbor_kmax > 0 and m.neighbor_grid is None
    for _ in range(8):
        e, f, out = m.energy_forces(d.positions, with_details=True)
        if not m.check_and_grow(out["diag"]):
            break
    else:
        raise AssertionError("capacities did not converge")
    ref = np.load(os.path.join(os.path.dirname(DATA), ".parity_cache",
                               f"{name}_agbnp1_f64.npz"))
    assert abs(float(e) - float(ref["e"])) <= 1e-5 * abs(float(ref["e"]))
    assert rel(f, torch.as_tensor(ref["f"])) <= 1e-5


@pytest.fixture(scope="module")
def v2_systems():
    """name -> (AGBNPParams, positions): the fixture's first 40 atoms, all
    264, and 1li2."""
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(FIXTURE)
    out = {}
    for n in (40, 264):
        out[f"fixture{n}"] = (AGBNPParams(
            radius=radius[:n], gamma=gamma[:n], alpha=alpha[:n],
            charge=charge[:n], ishydrogen=ish[:n]), pos[:n])
    d = load_dms(os.path.join(DATA, "1li2_agbnp1.dms"))
    out["1li2"] = (AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                               alpha=d.agbnp_alpha, charge=d.charges,
                               ishydrogen=d.ishydrogen), d.positions)
    return out


@pytest.mark.parametrize("name", ["fixture40", "fixture264", "1li2"])
def test_v2_f32_kernels_on_card_against_f64_plain(cuda, v2_systems, name):
    """AGBNP2 at f32 through PairCavity and the dense kernels #1-#3 (one
    launch each an evaluation) against the port's f64 plain route on the
    card, both at the f64 model's capacities, grown until nothing
    overflows (1li2 overflows JAX's MS-tree neighbor width of 64): energy
    to 1e-5 relative, forces to 1e-4 of max|f| (f32 through two overlap
    trees, the MS free volumes and the pair sweeps); the f32 evaluation
    overflows nothing; two f32 evaluations bitwise equal."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import AGBNP2Model

    params, pos = v2_systems[name]
    ref = AGBNP2Model(params, device=cuda, dtype=torch.float64,
                      positions=pos)
    assert not ref.pair_kernel
    e0, f0, out0 = ref.energy_forces(pos, with_details=True)
    while ref.check_and_grow(out0["diags"]):
        e0, f0, out0 = ref.energy_forces(pos, with_details=True)
    m = AGBNP2Model(params, device=cuda, dtype=torch.float32, positions=pos,
                    caps=ref.caps, caps_ms=ref.caps_ms, cap_ms=ref.cap_ms,
                    ms_kmax=ref.ms_kmax, ms_sub_k=ref.ms_sub_k)
    assert m.pair_kernel and m.pair_pad > 0
    PK.reset_launch_counts()
    e1, f1, out1 = m.energy_forces(pos, with_details=True)
    counts = PK.launch_counts()
    assert not m.check_and_grow(out1["diags"])
    for k in ("born_sums", "gb_pair", "descreening"):
        assert counts[k] == 1, (k, counts)
    assert counts["descreening_recompute"] == 0
    assert abs(float(e1) - float(e0)) <= 1e-5 * abs(float(e0))
    assert rel(f1, f0) <= 1e-4
    e2, f2 = m.energy_forces(pos)
    assert torch.equal(e1, e2) and torch.equal(f1, f2)


def test_v2_context_on_card(cuda, v2_systems):
    """The v2 Context on the card (f32, the kernels) against the f64 CPU
    Context: energy to 1e-5, the V2 anchor within 0.01 kJ/mol."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, Context

    params, pos = v2_systems["fixture40"]
    force = AGBNPForce()
    force.setVersion(2)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    out = {}
    for dev, dtype in ((cuda, torch.float32), ("cpu", torch.float64)):
        ctx = Context(force, dtype=dtype, device=dev)
        ctx.setPositions(pos)
        e, f = ctx.getEnergyForces()
        assert isinstance(e, float) and f.dtype == dtype
        assert f.device.type == torch.device(dev).type
        out[str(dev)] = (e, f)
    (e1, f1), (e0, f0) = out[str(cuda)], out["cpu"]
    assert abs(e1 - e0) <= 1e-5 * abs(e0)
    assert abs(e1 - (-505.76495633268286)) < 0.01
    assert rel(f1, f0) <= 1e-4


def test_v2_context_on_card_grows_on_1li2(cuda, v2_systems):
    """The v2 Context on 1li2 (f32, the kernels): JAX's MS-tree neighbor
    width of 64 overflows there, the Context's PanicButton grows it and
    evaluates again, to an f64 model on the card whose capacities were
    grown until nothing overflowed: energy to 1e-5 relative, forces to
    1e-4 of max|f|."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, Context
    from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import AGBNP2Model

    params, pos = v2_systems["1li2"]
    force = AGBNPForce()
    force.setVersion(2)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    ctx = Context(force, device=cuda)
    ctx.setPositions(pos)
    e1, f1 = ctx.getEnergyForces()
    assert ctx._model.ms_kmax > 64 and ctx._model.pair_kernel
    ref = AGBNP2Model(params, device=cuda, dtype=torch.float64,
                      positions=pos)
    e0, f0, out0 = ref.energy_forces(pos, with_details=True)
    while ref.check_and_grow(out0["diags"]):
        e0, f0, out0 = ref.energy_forces(pos, with_details=True)
    assert abs(e1 - float(e0)) <= 1e-5 * abs(float(e0))
    assert rel(f1, f0) <= 1e-4


# what the Born kernels' Q/dQ buffers hold before a launch
FILLS = {"nan": float("nan"), "zero": 0.0}


def replica_inputs(L, nb, seed=21):
    """A batch of nb replicas of sweep_inputs' layouts: replica 0 as given,
    the others with their rows displaced by 0.01 nm (numpy seed) and the
    heavy columns taken from the displaced rows, their screening factors,
    Born radii and chain factors scaled."""
    rng = np.random.default_rng(seed)
    dev = L["pos_pad"].device
    hperm = L["spline"].hids_perm.long().clamp(min=0)
    out = dict(pos_pad=[], pos_h=[], s_h=[], born=[], brw=[], bru=[])
    for b in range(nb):
        pp = L["pos_pad"]
        if b:
            pp = pp + torch.as_tensor(rng.normal(0.0, 0.01, pp.shape),
                                      dtype=torch.float32,
                                      device=dev) * L["rvalid"]
        f = 1.0 + 0.05 * b
        vals = dict(pos_pad=pp,
                    pos_h=torch.where(L["hvalid"], pp[:, hperm], 0.0),
                    s_h=L["s_h"] / f, born=L["born"] * f, brw=L["brw"] * f,
                    bru=L["bru"] / f)
        for k, v in vals.items():
            out[k].append(v.contiguous())
    return {k: torch.stack(v).contiguous() for k, v in out.items()}


def assert_replicas(out, refs, mask=None):
    """out (a batch, nested) bitwise refs[b] on every replica, on mask[b]
    where given."""
    if isinstance(out, torch.Tensor):
        assert out.shape[0] == len(refs)
        for b, r in enumerate(refs):
            o = out[b]
            if mask is not None:
                o, r = o[mask[b]], r[mask[b]]
            assert torch.equal(o, r), b
        return
    for k, o in enumerate(out):
        if o is not None:
            assert_replicas(o, [r[k] for r in refs],
                            None if mask is None else mask[k])


def counted(name, fn):
    """fn()'s result, checking it launched kernel `name` once."""
    before = PK.LAUNCHES[name]
    out = fn()
    assert PK.LAUNCHES[name] - before == 1, name
    return out


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_replica_axis_dense_kernels_bitwise_each_replica(cuda, shapes, nb):
    """The dense sweeps and the chunk list with a replica axis: one launch
    for the batch, each replica bitwise its own B = 1 launch (the Born
    kernel's Q/dQ on the chunk slots it walks), the reload reading Q/dQ
    buffers that were NaN outside those slots."""
    L = shapes
    X = replica_inputs(L, nb)
    sp, n = L["spline"], L["n"]
    tables = tuple(sp[:5])
    one = range(nb)
    for h in (1.0, 2.0):
        ch = counted("subtile_columns", lambda: PK.subtile_columns(
            X["pos_pad"], X["pos_h"], sp.hids_perm, n, horizon=h))
        ch1 = [PK.subtile_columns(X["pos_pad"][b], X["pos_h"][b],
                                  sp.hids_perm, n, horizon=h) for b in one]
        assert_replicas(ch, ch1)
        shape = (nb, L["pos_pad"].shape[1] // PK.SUB, L["pos_h"].shape[1],
                 PK.SUB)
        outs = {}
        for fill in FILLS:
            bufs = tuple(torch.full(shape, FILLS[fill], device=cuda)
                         for _ in range(2))
            outs[fill] = counted("born_sums", lambda: PK.born_sums(
                X["pos_pad"], X["pos_h"], *tables, X["s_h"], n, horizon=h,
                save_qd=True, qd_out=bufs))
        out = outs["zero"]
        ref = [PK.born_sums(X["pos_pad"][b], X["pos_h"][b], *tables,
                            X["s_h"][b], n, horizon=h, save_qd=True)
               for b in one]
        slots = torch.stack([PK.chunk_slots(r[3]) for r in ref])
        assert_replicas((out[0], out[3]), [(r[0], r[3]) for r in ref])
        assert_replicas(out[1:3], [r[1:3] for r in ref], (slots, slots))
        assert torch.isnan(outs["nan"][1][~slots]).all()
        dargs = (X["pos_pad"], X["pos_h"], X["s_h"], X["brw"], X["bru"])
        refs = [PK.descreening(*(x[b] for x in dargs), ref[b][1:])
                for b in one]
        for fill in FILLS:
            d = counted("descreening", lambda: PK.descreening(
                *dargs, outs[fill][1:]))
            assert_replicas(d, refs)
        d = counted("descreening_recompute", lambda: PK.descreening(
            *dargs, None, spline=sp._replace(horizon=h), chunks=ch))
        assert_replicas(d, [PK.descreening(*(x[b] for x in dargs), None,
                                           spline=sp._replace(horizon=h),
                                           chunks=ch1[b]) for b in one])
    for kw in (dict(cutoff=1.0, **L["mm"]), dict(cutoff=None)):
        g = counted("gb_pair", lambda: PK.gb_pair(
            X["pos_pad"], L["charge"], X["born"], n, **kw))
        assert_replicas(g, [PK.gb_pair(X["pos_pad"][b], L["charge"],
                                       X["born"][b], n, **kw) for b in one])


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_replica_axis_list_kernels_bitwise_each_replica(cuda, shapes, nb):
    """The list sweeps with a replica axis, each replica on its own list:
    one launch for the batch, each replica bitwise its own B = 1 launch;
    one replica's list cut to half its entries and, with several
    replicas, one replica's list empty (nv 0); the reload reading Q/dQ
    buffers that were NaN outside the kept sub-tile pairs."""
    L = shapes
    X = replica_inputs(L, nb)
    sp, n, tile = L["spline"], L["n"], L["tile"]
    tables = tuple(sp[:5])
    one = range(nb)
    rb = TL.tile_bounds(X["pos_pad"], L["rvalid"], tile)
    cb = TL.tile_bounds(X["pos_h"], L["hvalid"], tile)

    def lists(c_r, c_c, rng_d, triangular=False):
        cnt = TL.build_tile_list(*c_r, *c_c, rng_d, 1,
                                 triangular=triangular)[2]
        tl, nv, _ = TL.build_tile_list(*c_r, *c_c, rng_d,
                                       int(cnt.max()) + 8,
                                       triangular=triangular)
        nv = nv.clone()
        nv[0] = (nv[0] + 1) // 2      # unequal: replica 0's list cut
        if nb > 2:
            nv[nb - 1] = 0            # an empty list
        return tl, nv

    for rng_d in (1.0, 2.0):
        spb = sp._replace(horizon=rng_d)
        tl, nv = lists(rb, cb, rng_d)
        lmax = tl.shape[-1]
        shape = (nb, lmax, tile, tile)
        outs = {}
        for fill in FILLS:
            bufs = tuple(torch.full(shape, FILLS[fill], device=cuda)
                         for _ in range(2))
            outs[fill] = counted("born_sums_tiles", lambda: TL.born_sums_tiles(
                nv, tl, X["pos_pad"], X["pos_h"], *tables, X["s_h"], n, tile,
                horizon=rng_d, save_qd=True, qd_out=bufs))
        out = outs["zero"]
        ref = [TL.born_sums_tiles(nv[b], tl[b], X["pos_pad"][b],
                                  X["pos_h"][b], *tables, X["s_h"][b], n,
                                  tile, horizon=rng_d, save_qd=True)
               for b in one]
        ent = (torch.arange(lmax, device=cuda)[None, :] < nv).expand(nb,
                                                                     lmax)
        kept = torch.stack([TL._expand_subtiles(TL.keep_flags(r[3], nv[b]))
                            for b, r in enumerate(ref)])
        assert_replicas(out[0], [r[0] for r in ref])
        assert_replicas(out[3], [r[3] for r in ref], ent)
        assert_replicas(out[1:3], [r[1:3] for r in ref], (kept, kept))
        assert torch.isnan(outs["nan"][1][~kept]).all()
        dargs = (X["pos_pad"], X["pos_h"], X["s_h"], X["brw"], X["bru"])
        refs = [TL.descreening_tiles(nv[b], tl[b], *(x[b] for x in dargs),
                                     ref[b][1:], tile, spline=spb)
                for b in one]
        for fill in FILLS:
            d = counted("descreening_tiles", lambda: TL.descreening_tiles(
                nv, tl, *dargs, outs[fill][1:], tile, spline=spb))
            assert_replicas(d, refs)
        d = counted("descreening_tiles_recompute",
                    lambda: TL.descreening_tiles(nv, tl, *dargs, None, tile,
                                                 spline=spb))
        assert_replicas(d, [TL.descreening_tiles(
            nv[b], tl[b], *(x[b] for x in dargs), None, tile, spline=spb)
            for b in one])
        if nb > 2:
            assert not out[0][nb - 1].any()
    tl, nv = lists(rb, rb, 1.0, triangular=True)
    for kw in (dict(cutoff=1.0, **L["mm"]), dict(cutoff=1.0)):
        g = counted("gb_pair_tiles", lambda: TL.gb_pair_tiles(
            nv, tl, X["pos_pad"], L["charge"], X["born"], n, tile, **kw))
        assert_replicas(g, [TL.gb_pair_tiles(nv[b], tl[b], X["pos_pad"][b],
                                             L["charge"], X["born"][b], n,
                                             tile, **kw) for b in one])


def test_batched_model_on_card_matches_each_conformer(cuda, fixture_system):
    """AGBNPModel.batched_energy_forces of 4 conformers on the card (f32,
    lists and dense grid) against each conformer's own evaluation."""
    params, pos = fixture_system
    batch = pos[None] + 0.01 * np.random.default_rng(2).standard_normal(
        (4,) + pos.shape)
    for tiles, cutoff in ((None, 1.0), (False, None)):
        m = AGBNPModel(params, device=cuda, dtype=torch.float32,
                       positions=pos, cutoff=cutoff, pair_tiles=tiles)
        out = m.batched_energy_forces(batch)
        for b in range(4):
            e, f = m.energy_forces(batch[b])
            assert abs(float(out["energy"][b]) - float(e)) <= 1e-6 * abs(
                float(e))
            assert rel(out["force"][b], f) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_take_rows_backward_on_the_card(cuda, dtype):
    """TakeRows on the card: the kernel's forward (one launch; an f64
    table moves as its float32 words) and the segment-sum backward, equal
    to the CPU's bit for bit on integer-valued gradients, in the table's
    dtype, and the same bits again on a second pass."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    rng = np.random.default_rng(3)
    nparents, ncols, nrows = 1000, 6, 5000
    ids = torch.as_tensor(rng.integers(-3, nparents + 3, nrows).astype(
        np.int32))
    tab = torch.as_tensor(rng.standard_normal((nparents, ncols)),
                          dtype=dtype)
    g = torch.as_tensor(rng.integers(-64, 64, (nrows, ncols)), dtype=dtype)
    t_cpu = tab.clone().requires_grad_(True)
    t_gpu = tab.to(cuda).requires_grad_(True)
    grads = []
    for _ in range(2):
        before = PK.LAUNCHES["take_rows"]
        out = RW.take_rows(t_gpu, ids.to(cuda))
        assert PK.LAUNCHES["take_rows"] == before + 1
        assert type(out.grad_fn).__name__ == "TakeRowsBackward"
        assert torch.equal(out.detach().cpu(),
                           RW.take_rows_reference(tab, ids))
        grads.append(torch.autograd.grad(out, t_gpu, g.to(cuda))[0])
    (ref,) = torch.autograd.grad(RW.take_rows(t_cpu, ids), t_cpu, g)
    assert grads[0].dtype == dtype
    assert torch.equal(grads[0].cpu(), ref)
    assert torch.equal(grads[0], grads[1])


def test_gamma_gradient_on_the_card(cuda, fixture_system):
    """ParameterGradients on the card (f64, the plain pair route, the
    tree's gathers through TakeRows) against the CPU on the fixture's
    first 48 atoms, 2 poses: energies and gamma gradients within 1e-10
    relative, the hydrogens' entries exactly 0."""
    from openmm_agbnp_plugin_tpu_torch import ParameterGradients

    params, pos = fixture_system
    n = 48
    p = AGBNPParams(radius=params.radius[:n], gamma=params.gamma[:n],
                    alpha=params.alpha[:n], charge=params.charge[:n],
                    ishydrogen=params.ishydrogen[:n])
    poses = pos[None, :n] + 0.005 * np.random.default_rng(3).standard_normal(
        (2, n, 3))
    outs = []
    for dev in ("cpu", cuda):
        m = AGBNPModel(p, device=dev, dtype=torch.float64, version=1,
                       pair_kernel=False, positions=pos[:n])
        pg = ParameterGradients(m)
        before = PK.LAUNCHES["take_rows"]
        outs.append(pg.energy_grads(pg.initial_theta(("gamma",)), poses))
        if dev != "cpu":
            assert PK.LAUNCHES["take_rows"] > before
            assert outs[-1]["gamma"].device.type == "cuda"
    for k in ("energy", "gamma"):
        assert rel(outs[1][k], outs[0][k]) <= 1e-10
    hyd = torch.as_tensor(np.asarray(p.ishydrogen) > 0)
    assert (outs[1]["gamma"].cpu()[:, hyd] == 0).all()


def test_constrained_two_replica_window_on_the_card(cuda):
    """A 10-step ensemble window of 2 trp-cage replicas with X-H
    constraints (SHAKE/RATTLE per replica) in f32 on the card: every
    replica's violation within the f32 tolerance, the SHAKE channel and
    the capacities clean, the list kernels every step, and the first
    step's energies (the jittered start) within 1e-5 of the f64 CPU
    run's."""
    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation
    from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica

    d = load_dms(os.path.join(DATA, "trpcage_agbnp1.dms"))
    kw = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff",
              constraints=True)
    steps, first, pos0 = 10, {}, None
    for dev, dtype in (("cpu", torch.float64), (cuda, torch.float32)):
        sim = Simulation(d, device=dev, dtype=dtype, **kw)
        ens = ReplicaEnsemble(sim, 2)
        states = ens.initial_states(jitter=1e-3)
        if pos0 is None:
            pos0 = states[0]
        states = (pos0.to(dev, dtype), states[1], states[2])
        PK.reset_launch_counts()
        (pos, _, _), (e, *diag) = ens.make_runner(neighbor_every=steps)(
            states, steps)
        first[str(dev)] = e[:, 0].double().cpu()
        assert not sim.overflow_report(*worst_replica(diag))
        viol = sim.constraints.max_violation(pos)
        assert viol.shape == (2,)
        assert float(viol.max()) <= sim.constraints.tolerance(dtype)
        assert float(diag[4].max()) <= sim.constraints.tolerance(dtype)
        if dev != "cpu":
            counts = PK.launch_counts()
            for k in ("born_sums_tiles", "gb_pair_tiles",
                      "descreening_tiles"):
                assert counts[k] >= steps
    assert rel(first[str(cuda)], first["cpu"]) <= 1e-5


@pytest.mark.parametrize("nb", [1, 3])
def test_batched_v2_on_card_against_each_pose(cuda, v2_systems, nb):
    """The batched AGBNP2 evaluation on the card (f32, #1-#3 with the
    replica axis, one launch each for the batch) of nb poses of the
    264-atom fixture (0.005 nm, numpy seed), each pose's MS candidates
    found on the device, against each pose's own B = 1 evaluation (its
    host candidates) at the capacities the batch grew to: energy to 1e-6
    relative, forces to 1e-5 of max|f|."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp2_torch import (
        AGBNP2Model, ms_candidate_pairs, ms_pair_cutoff)
    from openmm_agbnp_plugin_tpu_torch.models.capacity import V2, v2_counts

    params, pos = v2_systems["fixture264"]
    m = AGBNP2Model(params, device=cuda, dtype=torch.float32, positions=pos)
    poses = pos[None] + 0.005 * np.random.default_rng(23).standard_normal(
        (nb,) + pos.shape)
    heavy = torch.as_tensor(np.asarray(params.ishydrogen) == 0, device=cuda)
    x = torch.as_tensor(poses, dtype=torch.float32, device=cuda)
    pairs = ms_candidate_pairs(x, heavy, ms_pair_cutoff(m.params.radii_vdw),
                               256)
    for _ in range(8):  # JAX's MS-tree neighbor width 64 is short here
        PK.reset_launch_counts()
        out = m.batched_energy_forces(x, ms_pairs=pairs[:3])
        if not m.check_and_grow(out["diags"]):
            break
    counts = PK.launch_counts()
    for k in ("born_sums", "gb_pair", "descreening"):
        assert counts[k] == 1, (k, counts)
    c = v2_counts(out["diags"], pairs[3])
    assert c.shape == (nb, 18) and int(c[:, V2.MS_CANDIDATE_KMAX].max()) <= 256
    assert out["energy"].shape == (nb,) and out["force"].shape == x.shape
    for b in range(nb):
        m.set_positions(poses[b])
        e, f = m.energy_forces(poses[b])
        assert abs(float(out["energy"][b]) - float(e)) <= 1e-6 * abs(
            float(e))
        assert rel(out["force"][b], f) <= 1e-5


def test_row_blocked_half_list_on_card(cuda, monkeypatch):
    """half_neighbor_pairs on the card in blocks of 17 and 256 rows (its
    HALF_LIST_BLOCK set to that many rows) bitwise the one-block list,
    replicas with per-replica masks and one system with a shared mask."""
    from openmm_agbnp_plugin_tpu_torch.ops import neighbors as NBM

    rng = np.random.default_rng(8)
    n = 3000
    pos = torch.as_tensor(rng.uniform(0.0, 3.0, (2, n, 3)),
                          dtype=torch.float32, device=cuda)
    heavy = torch.as_tensor(rng.random((2, n)) < 0.6, device=cuda)
    for p, h in ((pos, heavy), (pos[0], heavy[0])):
        nb = p.shape[0] if p.dim() == 3 else 1
        monkeypatch.setattr(NBM, "HALF_LIST_BLOCK", n * nb * n)
        want = NBM.half_neighbor_pairs(p, h, 0.6, 96)
        assert int(want[3].max()) > 0
        for rows in (17, 256):
            monkeypatch.setattr(NBM, "HALF_LIST_BLOCK", rows * nb * n)
            got = NBM.half_neighbor_pairs(p, h, 0.6, 96)
            for a, b in zip(got, want):
                assert torch.equal(a, b), rows


def rank_atoms_mesh_evaluation():
    """One rank's sharded_energy_forces of the fixture on the card (f64)
    and the unsharded energy_forces beside it."""
    from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import (
        arrays_from_numpy, energy_forces, prepare_arrays)
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.parallel import sharding as S

    mesh = S.atom_mesh()
    dev = mesh.device
    pos, radius, charge, gamma, alpha, ish = load_gaussvol_dat(FIXTURE)
    p = AGBNPParams(radius=radius, gamma=gamma, alpha=alpha, charge=charge,
                    ishydrogen=ish)
    a = arrays_from_numpy(prepare_arrays(p), dev, torch.float64)
    pos = torch.as_tensor(pos, dtype=torch.float64, device=dev)
    caps = TreeCaps.for_natoms(p.n)
    lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                         a["gamma"] / p.roffset, a["ishydrogen"])
    levels, _ = T.build_tree(lvl1, a["pairs_i"], a["pairs_j"], caps,
                             pairs_valid=a["pairs_valid"])
    topo = T.tree_topology(levels)
    ntj = int(a["type_j"].max()) + 1
    out = S.sharded_energy_forces(mesh, a, p.roffset, ntj)(pos, topo)
    ref = energy_forces(a, pos, caps=caps, version=1, roffset=p.roffset,
                        ntypes_j=ntj, topology=topo)
    return dict(energy=out["energy"], force=out["force"],
                ref_energy=ref["energy"], ref_force=ref["force"],
                device=str(dev))


def test_atoms_mesh_two_ranks_on_the_card(cuda, tmp_path):
    """sharded_energy_forces over 2 gloo ranks sharing cuda:0 (f64, the
    264-atom fixture) equals the unsharded evaluation on the card to 1e-12
    and -2476.66, every rank the same bits."""
    from openmm_agbnp_plugin_tpu_torch.parallel.sharding import run_ranks

    out = run_ranks(rank_atoms_mesh_evaluation, 2, device="cuda",
                    timeout=300.0, init_file=tmp_path / "rdv")
    r0 = out[0]
    assert r0["device"].startswith("cuda")
    assert abs(float(r0["energy"]) - float(r0["ref_energy"])) <= 1e-12 * abs(
        float(r0["ref_energy"]))
    assert float(np.abs(r0["force"] - r0["ref_force"]).max()) <= 1e-12 * \
        float(np.abs(r0["ref_force"]).max())
    assert float(r0["energy"]) == pytest.approx(-2476.66, abs=1e-2)
    assert np.array_equal(out[1]["energy"], r0["energy"])
    assert np.array_equal(out[1]["force"], r0["force"])


def test_native_engine_golden_on_the_card_host(cuda, fixture_system):
    """The native f64 engine builds on the GPU host and gives the goldens
    (-2476.66, E_cav 872.514, the displacement check), and the f32 model
    on the card holds to it within 1e-5."""
    from openmm_agbnp_plugin_tpu_torch.runtime import native

    params, pos = fixture_system
    assert native.available()
    out = native.NativeAGBNP1(params).energy_forces(pos)
    assert out["energy"] == pytest.approx(-2476.66, abs=1e-2)
    assert out["e_cav"] == pytest.approx(872.514, abs=1e-3)
    pos2 = np.array(pos)
    pos2[121, 1] += 0.002
    de = native.NativeAGBNP1(params).energy_forces(pos2)["energy"] - \
        out["energy"]
    assert de == pytest.approx(0.0874992, abs=1e-6)
    assert out["force"][121][1] * -0.002 == pytest.approx(0.0886249,
                                                          abs=1e-6)
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, version=1,
                   positions=pos)
    e, f = m.energy_forces(pos)
    assert abs(float(e) - out["energy"]) <= 1e-5 * abs(out["energy"])
    assert rel(f, torch.as_tensor(out["force"])) <= 1e-5


def test_mixed_f32_on_card_against_f64_on_card(cuda):
    """mixed=True on the card (f32 pair math, f64 sums, the plain route)
    against f64 on the card, 1li2 at NoCutoff: energy within 2e-6
    relative, forces within 1e-5 of max|f|; the tree's row gathers still
    run their kernel."""
    from openmm_agbnp_plugin_tpu_torch.ops.kernels import rows as RW

    d = load_dms(os.path.join(DATA, "1li2_agbnp1.dms"))
    params = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                         alpha=d.agbnp_alpha, charge=d.charges,
                         ishydrogen=d.ishydrogen)
    pos = np.asarray(d.positions)
    ref = AGBNPModel(params, device=cuda, dtype=torch.float64,
                     pair_kernel=False, positions=pos)
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, mixed=True,
                   caps=ref.caps)
    assert m.pair_pad == 0
    e0, f0 = ref.energy_forces(pos)
    before = RW.LAUNCHES["take_rows"]
    e1, f1 = m.energy_forces(pos)
    assert RW.LAUNCHES["take_rows"] > before
    assert e1.dtype == torch.float32 and e1.device == cuda
    assert abs(float(e1) - float(e0)) <= 2e-6 * abs(float(e0))
    assert rel(f1, f0) <= 1e-5


def test_port_oracle_against_f64_v1_on_the_card(cuda, fixture_system):
    """The port's f64 NumPy oracle (the card host's golden, no JAX) against
    the card's f64 AGBNP1 on the fixture (the plain pair route; the pair
    kernels take f32 only): energy to 1e-8, forces to 1e-9, as on the
    CPU."""
    from openmm_agbnp_plugin_tpu_torch.models.oracle import \
        agbnp1_energy_forces

    params, pos = fixture_system
    e_o, f_o = agbnp1_energy_forces(params, pos)
    assert e_o == pytest.approx(-2476.66, abs=0.01)
    m = AGBNPModel(params, device=cuda, dtype=torch.float64,
                   pair_kernel=False)
    e, f = m.energy_forces(pos)
    assert float(e) == pytest.approx(e_o, abs=1e-8)
    np.testing.assert_allclose(f.cpu().numpy(), f_o, rtol=0, atol=1e-9)


def test_chunked_build_and_cell_grid_on_the_card(cuda, fixture_system,
                                                 monkeypatch):
    """The large-system paths on the card at fixture scale (the JAX
    package's tests/test_tpu.py::test_chunked_build_and_cell_grid_on_chip):
    every sibling level built chunked (thresholds 0, blocks of 128 rows)
    against the one-shot build, levels and diag bitwise; the f32 model
    with chunking forced against the unforced one (energy 1e-6 relative,
    forces 1e-5 of max|f|); the cell grid's candidate pairs equal to the
    dense half list's."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.ops.neighbors import (
        CellGrid, cell_neighbor_pairs, half_neighbor_pairs,
        tree_pair_cutoff)

    params, pos = fixture_system
    kw = dict(device=cuda, dtype=torch.float32, version=1, cutoff=1.0,
              positions=pos, descreen_horizon="cutoff")
    m = AGBNPModel(params, **kw)
    e0, f0 = m.energy_forces(pos)
    a = m.arrays
    pt = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    lvl1 = T.make_level1(pt, a["radii_large"], a["vol_large"],
                         a["gamma"] / params.roffset, a["ishydrogen"])

    def build():
        return T.build_tree(lvl1, a["pairs_i"], a["pairs_j"], m.caps,
                            pairs_valid=a["pairs_valid"])

    levels0, diag0 = build()
    for k in ("_CHUNK_BUILD_ELEMS", "_CHUNK_LEVEL_MIN", "_SLICE_BUILD_TOTAL"):
        monkeypatch.setattr(T, k, 0)
    monkeypatch.setattr(T, "_CHUNK_ROWS", 128)
    levels1, diag1 = build()
    for k in diag0:
        assert torch.equal(diag0[k], diag1[k]), k
    for x, y in zip(levels0, levels1):
        for k in ("_ints", "_dat", "valid"):
            assert torch.equal(x[k], y[k]), k
        for k in x["bnd"]:
            assert torch.equal(x["bnd"][k], y["bnd"][k]), k
    e1, f1 = AGBNPModel(params, caps=m.caps, **kw).energy_forces(pos)
    assert abs(float(e1) - float(e0)) <= 1e-6 * abs(float(e0))
    assert rel(f1, f0) <= 1e-5
    assert not T.check_overflow({k: v[0] for k, v in diag0.items()})["any"]
    assert M.QD_BYTES_LIMIT == 1 << 30

    heavy = np.asarray(params.ishydrogen) == 0
    rcut = tree_pair_cutoff(params.radii_large) + 0.05
    grid = CellGrid(np.asarray(pos), rcut, heavy_mask=heavy)
    hm = torch.as_tensor(heavy, device=cuda)
    pg = cell_neighbor_pairs(pt, hm, rcut, 64, grid=grid)
    ph = half_neighbor_pairs(pt, hm, rcut, 64)
    assert int(pg[3]) <= 64 and int(ph[3]) <= 64

    def pairs(out):
        i, j, v = (x.cpu().numpy() for x in out[:3])
        return {tuple(sorted((int(x), int(y)))) for x, y, ok in zip(i, j, v)
                if ok}
    assert pairs(pg) == pairs(ph) and len(pairs(ph)) > 0


def test_free_volumes_on_the_card(cuda, fixture_system):
    """reduce_tree(with_freevol=True) in f32 on the card, on the tree the
    model's pass builds of the fixture, against the port's f64 oracle
    (GaussVol.compute_volume): free volumes within 1e-5 of their max,
    the volume 1e-5 relative; twice bitwise, take_rows at every level."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.models.constants import sphere_volume
    from openmm_agbnp_plugin_tpu_torch.models.oracle import GaussVol
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    params, pos = fixture_system
    m = AGBNPModel(params, device=cuda, dtype=torch.float32, positions=pos)
    p = torch.as_tensor(pos, dtype=torch.float32, device=cuda)
    a, pair_rows, _ = M.tree_candidates(m.arrays, p, m.neighbor_rcut,
                                        m.neighbor_kmax, m.neighbor_grid)
    out = M.tree_passes(a, p, m.caps, params.roffset, pair_rows=pair_rows)
    assert not T.check_overflow(out[5])["any"]
    l1 = T.make_level1(p, a["radii_large"], a["vol_large"],
                       a["gamma"] / params.roffset, a["ishydrogen"])
    before = PK.launch_counts()["take_rows"]
    got = [T.reduce_tree(T.rescan_volumes(T.tree_topology(out[3]), l1), l1,
                         with_freevol=True) for _ in range(2)]
    assert PK.launch_counts()["take_rows"] - before >= 2 * T.NUM_TREE_LEVELS
    for k in ("free_volume", "volume", "self_volume", "energy"):
        assert torch.equal(got[0][k], got[1][k]), k
    radii = np.asarray(params.radii_large)
    gv = GaussVol(params.n, params.ishydrogen)
    gv.set_radii(radii)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0, sphere_volume(radii)))
    gv.set_gammas(np.asarray(params.gamma / params.roffset))
    gv.compute_tree(pos)
    v_o, _, _, _, fv_o, _ = gv.compute_volume(pos)
    assert rel(got[0]["free_volume"], torch.as_tensor(fv_o)) <= 1e-5
    assert abs(float(got[0]["volume"][0]) - v_o) <= 1e-5 * abs(v_o)


# ---------------------------------------------------------------------------
# The fixed-topology tree passes as per-level kernels (csrc/tree.cu)
# ---------------------------------------------------------------------------

# (system, replicas) of each fixed topology the kernels are held to
TREE_TOPOLOGIES = {"1li2": ("1li2", 1), "2clr": ("2clr", 1),
                   "2clr-x4": ("2clr", 4)}
# f32 against the f64 twin, of max|x| (energies relative): the f32 path's
# 1e-5, and for the cavity force 3e-5, about twice what the f32 twin itself
# reads at 1li2 (1.55e-5 on the H100; the route 1.10e-5 there and 1.36e-5
# in this test): that force is the small difference of the two
# parameterizations' larger ones
TREE_F32_BARS = dict(e_cav=1e-5, f_cav=3e-5, self_volume=1e-5, f_wu=1e-5)


def _fixed_topologies(name, dev):
    """f64 on the card: the replicas' union arrays and positions (the DMS
    state and jittered copies, 0.003 nm, numpy seed), the model's caps,
    the union's fixed topology and its compacted WU topology, as a
    window build makes them but without the per-level kernels' prep."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    system, nrep = TREE_TOPOLOGIES[name]
    d = load_dms(os.path.join(DATA, f"{system}_agbnp1.dms"))
    p = AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                    alpha=d.agbnp_alpha, charge=d.charges,
                    ishydrogen=d.ishydrogen)
    m = AGBNPModel(p, device=dev, dtype=torch.float64,
                   positions=d.positions)
    rng = np.random.default_rng(17)
    pos = torch.as_tensor(np.stack(
        [d.positions] + [d.positions + rng.normal(0.0, 0.003,
                                                  d.positions.shape)
                         for _ in range(nrep - 1)]), device=dev)
    a, pair_rows, _ = M.tree_candidates(m.arrays, pos, m.neighbor_rcut,
                                        m.neighbor_kmax, m.neighbor_grid)
    at = M.union_arrays(a, nrep, pairs=False)
    pt = pos.reshape(-1, 3)
    gdr = at["gamma"] / p.roffset
    l1 = T.make_level1(pt, at["radii_large"], at["vol_large"], gdr,
                       at["ishydrogen"])
    levels, diag = T.build_tree(l1, at["pairs_i"], at["pairs_j"], m.caps,
                                pairs_valid=at["pairs_valid"],
                                pair_rows=pair_rows, nrep=nrep)
    assert not T.check_overflow(M.batched_diag_max(diag))["any"]
    topo = T.tree_topology(levels)
    v1 = T.make_level1(pt, at["radii_vdw"], at["vol_vdw"], -gdr,
                       at["ishydrogen"])
    lv = T.rescan_volumes(topo, v1)
    kept = T.compact_topology(lv, [l["valid"].shape[0] // nrep for l in lv],
                              nrep=nrep)[1]
    vt, _ = T.compact_topology(lv, [max(8, int(k)) for k in kept.max(0)[0]],
                               nrep=nrep)
    gam = torch.as_tensor(rng.normal(0.0, 10.0, pt.shape[0]), device=dev)
    return dict(at=at, pos=pt, caps=m.caps, roffset=p.roffset, topo=topo,
                vt=vt, nrep=nrep, gam=gam)


@pytest.fixture(scope="module")
def fixed_topologies(cuda):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _fixed_topologies(name, cuda)
        return cache[name]
    return get


def _tree_passes(t, dtype, twin):
    """The MD step's two tree passes on a fixed topology in dtype: the
    cavity pass (rescan_volumes2 + reduce_tree2 with the vdW self volumes)
    and the compacted WU pass (rescan_volumes + reduce_tree without them);
    on the kernel route (the topologies with ops/tree.py::kernel_prep,
    as Simulation.window_build gives them), or with twin on the torch
    passes (the topologies as they are)."""
    from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T

    at = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
          else v for k, v in t["at"].items()}
    pos = t["pos"].to(dtype)
    topo, vt = t["topo"], t["vt"]
    if not twin:
        topo, vt = T.kernel_prep(topo), T.kernel_prep(vt)
    e_cav, f_cav, sv, _, v1, _, _, _ = M.tree_passes(
        at, pos, t["caps"], t["roffset"], topology=topo, nrep=t["nrep"])
    wu = {**v1, "gamma1i": t["gam"].to(dtype)}
    red = T.reduce_tree(T.rescan_volumes(vt, wu), wu, with_selfvol=False,
                        nrep=t["nrep"])
    return dict(e_cav=e_cav, f_cav=f_cav, self_volume=sv,
                e_wu=red["energy"], f_wu=red["dr"])


def _tree_err(key, x, ref):
    """x's distance from ref: each replica's energy relative, else max |x -
    ref| / max |ref|."""
    x, ref = x.double(), ref.double()
    if key.startswith("e_"):
        return float(((x - ref).abs() / ref.abs()).max())
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(TREE_TOPOLOGIES))
def test_tree_kernels_match_the_twin(cuda, fixed_topologies, name, dtype):
    """The per-level tree kernels on the card against the torch passes on
    the same fixed topology (1li2, 2clr, the 4-replica 2clr union; the
    cavity pass over the build topology, the WU pass over its compacted
    one): in f64 energies to 1e-12 relative, forces and self volumes to
    1e-10 of their max; in f32 against the f64 twin within
    TREE_F32_BARS; two calls bitwise equal;
    each pass 7 rescan, 7 reduce and 1 deposit launch, each a tree.kernel
    counter, and no row gather."""
    from openmm_agbnp_plugin_tpu_torch.ops import tree as T
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    t = fixed_topologies(name)
    want = _tree_passes(t, torch.float64, twin=True)
    before = PK.launch_counts()
    with profiling.record():
        profiling.reset()
        got = _tree_passes(t, dtype, twin=False)
        sites = [c["site"] for c in profiling.recorded()["counts"]
                 if c["name"] == "tree.kernel"]
    after = PK.launch_counts()
    levels = T.NUM_TREE_LEVELS
    assert {k: after[k] - before[k] for k in (
        "tree_rescan", "tree_reduce", "tree_deposit", "take_rows")} == dict(
        tree_rescan=2 * levels, tree_reduce=2 * levels, tree_deposit=2,
        take_rows=0)
    assert sites == (["rescan"] * levels + ["reduce"] * levels
                     + ["deposit"]) * 2
    again = _tree_passes(t, dtype, twin=False)
    for k, v in got.items():
        assert v.dtype == dtype and bool(torch.isfinite(v).all()), k
        assert torch.equal(v, again[k]), k
    assert got["e_cav"].shape == (t["nrep"],)
    if dtype == torch.float64:
        bars = dict.fromkeys(got, 1e-10)
        bars.update(e_cav=1e-12, e_wu=1e-12)
    else:
        del got["e_wu"]  # a sum of random-signed gammas: no f32 bar
        bars = TREE_F32_BARS
    for k, v in got.items():
        assert _tree_err(k, v, want[k]) <= bars[k], (
            k, _tree_err(k, v, want[k]), bars[k])


@pytest.mark.parametrize("version", [1, 2])
def test_scorer_bypasses_the_tree_kernels(cuda, fixture_system, v2_systems,
                                          version):
    """The scorer builds its trees each call (version 1 on the fixture,
    version 2's atomic and MS trees on its first 40 atoms): the
    topologies carry no per-level kernels' prep, so their tree passes run
    the torch code, no tree kernel launches and the recorder holds no
    tree.kernel counter."""
    from openmm_agbnp_plugin_tpu_torch import AGBNPForce, ConformerScorer
    from openmm_agbnp_plugin_tpu_torch.utils import profiling

    params, pos = (fixture_system if version == 1
                   else v2_systems["fixture40"])
    force = AGBNPForce()
    force.setVersion(version)
    for i in range(params.n):
        force.addParticle(params.radius[i], params.gamma[i], params.alpha[i],
                          params.charge[i], bool(params.ishydrogen[i]))
    scorer = ConformerScorer(force, pos, device=cuda)
    poses = pos[None] + 0.01 * np.random.default_rng(5).standard_normal(
        (4,) + pos.shape)
    before = PK.launch_counts()
    with profiling.record():
        profiling.reset()
        energy = scorer.score(poses)["energy"]
        names = {c["name"] for c in profiling.recorded()["counts"]}
    after = PK.launch_counts()
    assert energy.shape == (4,) and bool(torch.isfinite(energy).all())
    assert "tree.kernel" not in names
    assert all(after[k] == before[k]
               for k in ("tree_rescan", "tree_reduce", "tree_deposit"))
    assert after["take_rows"] > before["take_rows"]
