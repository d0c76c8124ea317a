"""The chunked sibling build of the port's overlap tree (ops/tree.py
_build_sibling_level_chunked, the JAX package's memory-bounded build), f64
on the CPU.

With every dispatch threshold at 0 and blocks of 128 rows, the chunked
build is bitwise the one-shot build (every level's _ints, _dat, valid and
bnd, and the diag) on the 264-atom fixture and on 1li2, with and without
the birth-margin relax, for one system and for a union of three replicas;
it matches the JAX package's chunked build to 1e-12; the dispatch chunks
exactly the levels that JAX's rule chunks for the same thresholds; an
AGBNPModel evaluation with chunking forced is bitwise the unforced one;
and synthetic.run's model of the 600-atom ball gives JAX's AGBNPModel
energy and forces to 1e-10.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JaxModel
from openmm_agbnp_plugin_tpu.models.agbnp_jax import \
    prepare_arrays as jax_prepare_arrays
from openmm_agbnp_plugin_tpu.models.oracle import AGBNPParams as JaxParams
from openmm_agbnp_plugin_tpu.ops import tree as JT
from openmm_agbnp_plugin_tpu_torch import AGBNPModel, AGBNPParams, load_dms
from openmm_agbnp_plugin_tpu_torch.models import agbnp_torch as M
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.utils import synthetic

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-12
# test_torch_tree.py's capacities: window candidates (cap_prev x offs) of
# the six sibling levels 184,320, 262,144, 175,104, 59,392, 11,264, 1,536
CAPS = ((3840, 8192, 7296, 3712, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
TOTAL = sum(c * o for c, o in zip(CAPS[0][:-1], CAPS[1]))
DISPATCH = ("_CHUNK_BUILD_ELEMS", "_CHUNK_LEVEL_MIN", "_SLICE_BUILD_TOTAL")


def force_chunked(monkeypatch, module, rows=128):
    """Every sibling level of `module`'s builds in blocks of `rows` rows."""
    for k in DISPATCH:
        monkeypatch.setattr(module, k, 0)
    monkeypatch.setattr(module, "_CHUNK_ROWS", rows)


def rel(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    return np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300)


def load_system(name, gaussvol_system):
    """(port params, positions) of the fixture or a shipped DMS system."""
    if name == "fixture":
        jp, pos = gaussvol_system
        return AGBNPParams(radius=jp.radius, gamma=jp.gamma, alpha=jp.alpha,
                           charge=jp.charge, ishydrogen=jp.ishydrogen), pos
    d = load_dms(os.path.join(ROOT, "benchmarks", "data",
                              f"{name}_agbnp1.dms"))
    return AGBNPParams(radius=d.agbnp_radius, gamma=d.agbnp_gamma,
                       alpha=d.agbnp_alpha, charge=d.charges,
                       ishydrogen=d.ishydrogen), d.positions


def assert_same_tree(a, b):
    """Two builds bitwise equal: every diag leaf, and every level's _ints,
    _dat, valid and bnd leaf."""
    (la, da), (lb, db) = a, b
    assert sorted(da) == sorted(db)
    for k in da:
        assert torch.equal(da[k], db[k]), k
    for n, (x, y) in enumerate(zip(la, lb)):
        for k in ("_ints", "_dat", "valid"):
            assert torch.equal(x[k], y[k]), (n + 2, k)
        assert sorted(x["bnd"]) == sorted(y["bnd"])
        for k in x["bnd"]:
            assert torch.equal(x["bnd"][k], y["bnd"][k]), (n + 2, "bnd", k)


@pytest.mark.parametrize("nrep", [1, 3], ids=["one", "union3"])
@pytest.mark.parametrize("relax", [None, 0.5], ids=["exact", "relax"])
@pytest.mark.parametrize("name", ["fixture", "1li2"])
def test_chunked_build_is_bitwise_the_one_shot_build(gaussvol_system,
                                                     monkeypatch, name,
                                                     relax, nrep):
    """One-shot against chunked (thresholds 0, 128-row blocks) on the
    model's all-pairs candidates at the model's capacities, grown until
    the one-shot build is clean; replicas jittered 0.01 nm (numpy seed)."""
    p, pos = load_system(name, gaussvol_system)
    m = AGBNPModel(p, device="cpu", dtype=torch.float64, positions=pos)
    rng = np.random.default_rng(0)
    batch = np.stack([pos] + [pos + rng.normal(0.0, 0.01, pos.shape)
                              for _ in range(nrep - 1)])
    a = M.union_arrays(m.arrays, nrep)
    pt = torch.as_tensor(batch.reshape(-1, 3))
    lvl1 = T.make_level1(pt, a["radii_large"], a["vol_large"],
                         a["gamma"] / p.roffset, a["ishydrogen"])
    caps = m.caps

    def build():
        return T.build_tree(lvl1, a["pairs_i"], a["pairs_j"], caps,
                            pairs_valid=a["pairs_valid"], nrep=nrep,
                            relax=relax)

    for _ in range(6):
        one_shot = build()
        ov = T.check_overflow(M.batched_diag_max(one_shot[1]))
        if not ov["any"]:
            break
        caps = caps.grow([bool(c) for c in ov["cap_overflow"]],
                         [bool(s) for s in ov["sib_overflow"][:-1]])
    assert not ov["any"]
    assert one_shot[1]["counts"].shape == (nrep, 7)
    assert int(one_shot[1]["counts"][:, 4].min()) > 0
    force_chunked(monkeypatch, T)
    assert caps.caps[1] * nrep > T._CHUNK_ROWS  # several blocks a level
    assert_same_tree(one_shot, build())


def jax_build(*args, **kw):
    """JAX's build_tree, jitted afresh: its dispatch thresholds are read
    when it is traced, so a build after a monkeypatch must not reuse an
    earlier trace."""
    return jax.jit(functools.partial(JT.build_tree),
                   static_argnames=("caps", "pair_rows"))(*args, **kw)


@pytest.fixture(scope="module")
def fixture_level1(gaussvol_system):
    """The fixture's level-1 tables and all-pairs candidates at the large
    radii: (JAX's, the port's)."""
    params, pos = gaussvol_system
    aj = jax_prepare_arrays(params, dtype=np.float64)
    at = M.arrays_from_numpy(aj, "cpu", torch.float64)
    gj = jnp.asarray(aj["gamma"]) / params.roffset
    l1j = JT.make_level1(jnp.asarray(pos), jnp.asarray(aj["radii_large"]),
                         jnp.asarray(aj["vol_large"]), gj,
                         jnp.asarray(aj["ishydrogen"]))
    l1t = T.make_level1(torch.as_tensor(pos), at["radii_large"],
                        at["vol_large"], at["gamma"] / params.roffset,
                        at["ishydrogen"])
    pj = tuple(jnp.asarray(aj[k]) for k in ("pairs_i", "pairs_j",
                                            "pairs_valid"))
    pt = tuple(at[k] for k in ("pairs_i", "pairs_j", "pairs_valid"))
    return (l1j, pj), (l1t, pt)


def test_chunked_build_matches_jax_chunked_build(fixture_level1,
                                                 monkeypatch):
    """Both packages' chunked builds (thresholds 0, 128-row blocks, set in
    both modules): equal node sets, order and pmono, data to 1e-12."""
    (l1j, pj), (l1t, pt) = fixture_level1
    force_chunked(monkeypatch, JT)
    force_chunked(monkeypatch, T)
    lev_j, diag_j = jax_build(l1j, pj[0], pj[1], JT.TreeCaps(*CAPS),
                              pairs_valid=pj[2])
    lev_t, diag_t = T.build_tree(l1t, pt[0], pt[1], T.TreeCaps(*CAPS),
                                 pairs_valid=pt[2])
    for key in ("counts", "max_siblings"):
        np.testing.assert_array_equal(np.asarray(diag_j[key]),
                                      diag_t[key][0].numpy())
    assert np.asarray(diag_j["counts"])[4] > 0
    for lj, lt in zip(lev_j, lev_t):
        valid = np.asarray(lj["valid"])
        np.testing.assert_array_equal(valid, lt["valid"].numpy())
        np.testing.assert_array_equal(np.asarray(lj["_ints"])[valid],
                                      lt["_ints"].numpy()[valid])
        np.testing.assert_array_equal(np.asarray(lj["bnd"]["pmono"])[valid],
                                      lt["bnd"]["pmono"].numpy()[valid])
        if valid.any():
            assert rel(lt["_dat"].numpy(), lj["_dat"]) <= TOL


def spy_chunked(monkeypatch, module, seen):
    """Record (cap_prev, offs) of every level `module` builds chunked."""
    orig = module._build_sibling_level_chunked

    def spy(prev_lvl, prev_a6, level1, offs, cap, relax=None):
        seen.append((int(prev_lvl["_dat"].shape[0]), int(offs)))
        return orig(prev_lvl, prev_a6, level1, offs, cap, relax)
    monkeypatch.setattr(module, "_build_sibling_level_chunked", spy)


# (total threshold, per-level floor) -> the (cap_prev, offs) levels chunked
DISPATCH_CASES = {
    "pressured": (0, 100_000, [(3840, 48), (8192, 32), (7296, 24)]),
    "calm": (10 ** 9, 0, []),
    "at_the_total": (TOTAL, 0, []),
    "below_the_total": (TOTAL - 1, 175_104, [(3840, 48), (8192, 32)]),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES) + ["per_level_over",
                                                        "per_level_at"])
def test_dispatch_chunks_the_levels_jax_chunks(fixture_level1, monkeypatch,
                                               case):
    """A spy on both packages' chunked builds: build_tree chunks the same
    levels as JAX's build_tree (traced) for the same total and per-level
    thresholds, and a level built outside build_tree chunks as JAX's does
    against _CHUNK_BUILD_ELEMS, strictly above it."""
    (l1j, pj), (l1t, pt) = fixture_level1
    seen_j, seen_t = [], []
    spy_chunked(monkeypatch, JT, seen_j)
    spy_chunked(monkeypatch, T, seen_t)
    if case in DISPATCH_CASES:
        total, floor, want = DISPATCH_CASES[case]
        for mod in (JT, T):
            monkeypatch.setattr(mod, "_SLICE_BUILD_TOTAL", total)
            monkeypatch.setattr(mod, "_CHUNK_LEVEL_MIN", floor)
            monkeypatch.setattr(mod, "_CHUNK_BUILD_ELEMS", 0)
        jax.make_jaxpr(functools.partial(
            JT.build_tree, caps=JT.TreeCaps(*CAPS)))(
                l1j, pj[0], pj[1], pairs_valid=pj[2])
        T.build_tree(l1t, pt[0], pt[1], T.TreeCaps(*CAPS),
                     pairs_valid=pt[2])
    else:
        # level 3 from a built level 2, outside build_tree (pressured None)
        cap_prev, offs, cap = CAPS[0][0], CAPS[1][0], CAPS[0][1]
        elems = cap_prev * offs
        edge = elems - 1 if case == "per_level_over" else elems
        want = [(cap_prev, offs)] if edge < elems else []
        lev_j, _ = jax_build(l1j, pj[0], pj[1], JT.TreeCaps(*CAPS),
                             pairs_valid=pj[2])
        lev_t, _ = T.build_tree(l1t, pt[0], pt[1], T.TreeCaps(*CAPS),
                                pairs_valid=pt[2])
        seen_t.clear()
        for mod in (JT, T):
            monkeypatch.setattr(mod, "_CHUNK_BUILD_ELEMS", edge)
        jax.make_jaxpr(functools.partial(
            JT._build_sibling_level, offs=offs, cap=cap, relax=None))(
                lev_j[0], l1j["_at"][lev_j[0]["atom"]], l1j)
        T._build_sibling_level(lev_t[0], l1t["_at"][lev_t[0]["atom"]], l1t,
                               offs, cap, None)
    assert seen_j == want
    assert seen_t == want


@pytest.mark.parametrize("batch", [1, 3], ids=["one", "batch3"])
def test_model_with_chunking_forced_is_bitwise_the_unforced_one(
        gaussvol_system, monkeypatch, batch):
    """AGBNPModel on the fixture (f64, the kernel route's CPU twins, tile
    lists): energy, forces and diag with every level chunked equal the
    one-shot evaluation's bit for bit, for one system and a batch of three
    poses (0.01 nm, numpy seed)."""
    p, pos = load_system("fixture", gaussvol_system)
    m = AGBNPModel(p, device="cpu", dtype=torch.float64, positions=pos)
    rng = np.random.default_rng(1)
    poses = np.stack([pos] + [pos + rng.normal(0.0, 0.01, pos.shape)
                              for _ in range(batch - 1)])

    def evaluate():
        if batch == 1:
            return m.energy_forces(pos, with_details=True)[2]
        return m.batched_energy_forces(poses)

    ref = evaluate()
    force_chunked(monkeypatch, T)
    out = evaluate()
    assert torch.equal(out["energy"], ref["energy"])
    assert torch.equal(out["force"], ref["force"])
    for k in ref["diag"]:
        assert torch.equal(torch.as_tensor(out["diag"][k]),
                           torch.as_tensor(ref["diag"][k])), k
    assert int(torch.as_tensor(ref["diag"]["counts"])[..., 3].min()) > 0


@pytest.fixture(scope="module")
def reference_generator():
    """benchmarks/synthetic_scale.py, the reference's generator and run
    (its import sets JAX's compile cache directory, which is put back)."""
    cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location(
        "synthetic_scale_ref", os.path.join(ROOT, "benchmarks",
                                            "synthetic_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


def test_synthetic_run_matches_jax(reference_generator, capsys):
    """synthetic.run(600) on the CPU (f64, one timed evaluation): its
    model's energy and forces against JAX's AGBNPModel (version 1, cutoff
    1 nm, given the positions, the PanicButton loop) of the reference's
    ball to 1e-10; the reference's three lines printed; the sizing it
    returns is its model's."""
    res = synthetic.run(600, repeats=1, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].startswith("n=600 init ")
    assert "first eval" in lines[1] and "steady-state eval" in lines[2]
    m = res["model"]
    assert m.dtype == torch.float64 and not res["overflow"]
    assert res["s_per_eval"] > 0 and res["natoms"] == 600
    assert (res["caps"], res["offs"]) == (m.caps.caps, m.caps.offs)
    assert res["kmax"] == 0 and not res["grid"]  # 600 atoms: all pairs
    assert res["pair_tiles"] == m.pair_tiles is not None

    pos, radius, gamma, alpha, charge, ish = \
        reference_generator.synthetic_system(600)
    jm = JaxModel(JaxParams(radius=radius, gamma=gamma, alpha=alpha,
                            charge=charge, ishydrogen=ish),
                  version=1, cutoff=1.0, dtype=np.float64, positions=pos)
    for _ in range(8):
        e_j, f_j, out = jm.energy_forces(pos, with_details=True)
        if not jm.check_and_grow(out["diag"]):
            break
    e_t, f_t = m.energy_forces(pos)
    assert float(e_t) == res["energy"]
    assert torch.equal(f_t, res["force"])
    e_j, f_j = float(e_j), np.asarray(f_j)
    assert abs(float(e_t) - e_j) <= 1e-10 * abs(e_j)
    assert np.abs(f_t.numpy() - f_j).max() <= 1e-10 * np.abs(f_j).max()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.run(600, repeats=1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_candidate_data_rounds_alike_at_any_shape(dtype):
    """_cand_dat of a [rows, width] window grid against the same
    candidates recomputed one slot a row ([rows x width, 1], the chunked
    build's phase 3), in a grid of another width and one at a time
    (every third row): bitwise equal, so the
    chunked build's recompute can reproduce the one-shot candidates (the
    CPU's pow rounds its vector path and its scalar tail apart)."""
    rng = np.random.default_rng(5)
    rows, width = 61, 37

    def t(*shape, lo=0.0, hi=1.0):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype)

    s = [t(rows, 1, lo=0.5, hi=3.0), t(rows, 1, lo=20.0, hi=90.0),
         t(rows, 1, 3, hi=2.0), t(rows, 1, lo=-1.0, hi=1.0)]
    a = torch.cat([t(rows, width, 1, lo=0.5, hi=3.0),
                   t(rows, width, 1, lo=20.0, hi=90.0),
                   t(rows, width, 3, hi=2.0),
                   t(rows, width, 1, lo=-1.0, hi=1.0)], dim=-1)
    grid, sg = T._cand_dat(s[0], s[1], s[2][:, :, :], s[3], a)
    r = torch.arange(rows).repeat_interleave(width)
    one, so = T._cand_dat(s[0][r], s[1][r], s[2][r], s[3][r],
                          a.reshape(rows * width, 1, 6))
    assert torch.equal(one[:, 0], grid.reshape(-1, T._D))
    assert torch.equal(so[:, 0], sg.reshape(-1))
    half, _ = T._cand_dat(s[0][::2], s[1][::2], s[2][::2], s[3][::2],
                          a[::2, 5:])
    assert torch.equal(half, grid[::2, 5:])
    # one candidate at a time: the CPU's scalar loops throughout
    for i in range(0, rows, 3):
        for j in range(width):
            each, _ = T._cand_dat(s[0][i:i + 1], s[1][i:i + 1],
                                  s[2][i:i + 1], s[3][i:i + 1],
                                  a[i:i + 1, j:j + 1])
            assert torch.equal(each[0, 0], grid[i, j]), (i, j)
