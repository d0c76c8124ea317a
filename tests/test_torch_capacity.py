"""The PanicButton rules of models/capacity.py against the JAX package's.

Each case bumps one channel of a counts vector past its capacity (or none)
and drives both packages' own regrow paths on the same capacities: the
Simulation's AGBNP1 regrow (md/simulation.py::_regrow), the AGBNP2 regrow
of the Simulation and of the scorer (JAX's _regrow_v2 in both) and the
models' check_and_grow.  The model constructors are replaced by recorders,
so each case compares the capacities a rebuild would get, on the host,
without building a model.
"""

import functools
import types

import numpy as np
import pytest
import torch

import openmm_agbnp_plugin_tpu.md.simulation as JSIM
import openmm_agbnp_plugin_tpu.models.agbnp2_jax as JAGBNP2
from openmm_agbnp_plugin_tpu.api.scoring import \
    ConformerScorer as JConformerScorer
from openmm_agbnp_plugin_tpu.models.agbnp_jax import AGBNPModel as JModel
from openmm_agbnp_plugin_tpu.ops import tree as JT
import openmm_agbnp_plugin_tpu_torch.api.scoring as TSCORING
import openmm_agbnp_plugin_tpu_torch.md.simulation as TSIM
from openmm_agbnp_plugin_tpu_torch.api.scoring import ConformerScorer
from openmm_agbnp_plugin_tpu_torch.md.simulation import Simulation
from openmm_agbnp_plugin_tpu_torch.models import capacity
from openmm_agbnp_plugin_tpu_torch.models.agbnp_torch import AGBNPModel
from openmm_agbnp_plugin_tpu_torch.models.capacity import V2
from openmm_agbnp_plugin_tpu_torch.ops import tree as T

CAPS = (3840, 8192, 7424, 3840, 1408, 384, 256)
OFFS = (48, 32, 24, 16, 8, 4)
MS_CAPS = (1024, 2048, 2048, 1024, 512, 128, 128)
KMAX, TILES, WU = 64, (200, 300), (512, 1024, 896, 512, 256, 64, 32)
CAP_MS, MS_KMAX, MS_KMAX_LIST = 4096, 64, 48
HEADROOMS = (1.3, 1.3 * 1.25 ** 3)

# one case a channel, by its name in the report (None: nothing bumped)
V1_CASES = ([f"tree_level{i + 1}" for i in range(7)]
            + [f"sibling_window{i + 1}" for i in range(6)]
            + ["neighbor_kmax", "neighbor_kmax_grid", "tile_list_born",
               "tile_list_gb"]
            + [f"wu_compact_level{i + 1}" for i in range(7)] + [None])


def _recorder(*args, **kw):
    return types.SimpleNamespace(**kw)


class _Grid:
    """A cell grid that only counts its regrowths."""

    def __init__(self, grown=0):
        self.n = grown

    def grown(self):
        return _Grid(self.n + 1)


def _v1_diag(case):
    """(counts [9], neighbor max, sibling maxima [7], WU kept rows [7]):
    every channel at about half its capacity, `case` past it."""
    counts = np.array([c // 2 for c in CAPS] + [t // 2 for t in TILES])
    sibs = np.array([o // 2 + 1 for o in OFFS] + [3])
    nbmax = np.array(KMAX // 2)
    wu = np.array([w // 2 for w in WU])
    if case is None:
        return counts, nbmax, sibs, wu
    name = case.rstrip("0123456789")
    i = int(case[len(name):]) - 1 if name != case else 0
    if name == "tree_level":
        counts[i] = CAPS[i] + 7 * (i + 1)
    elif name == "sibling_window":
        sibs[i] = OFFS[i] + 3 + i
    elif case.startswith("neighbor_kmax"):
        nbmax = np.array(KMAX + 5)
    elif case == "tile_list_born":
        counts[7] = TILES[0] + 9
    elif case == "tile_list_gb":
        counts[8] = TILES[1] + 1
    else:
        wu[i] = WU[i] + 11 * (i + 1)
    return counts, nbmax, sibs, wu


def _model_ns(**kw):
    return types.SimpleNamespace(
        params=None, version=1, cutoff=1.0, mixed=False, pair_kernel=True,
        descreen_horizon=None, share_qd=True, **kw)


def _sims(grid):
    """A JAX and a port Simulation holding the capacities above, without
    their models (the rebuilds are recorded)."""
    jsim = object.__new__(JSIM.Simulation)
    jm = _model_ns(caps=JT.TreeCaps(CAPS, OFFS), pair_tiles=TILES)
    jm.grow_pair_tiles = functools.partial(JModel.grow_pair_tiles, jm)
    tsim = object.__new__(Simulation)
    for sim, m in ((jsim, jm), (tsim, _model_ns(caps=T.TreeCaps(CAPS, OFFS),
                                                pair_tiles=TILES))):
        sim.agbnp, sim.agbnp2, sim.kmax = m, None, KMAX
        sim.grid = _Grid() if grid else None
        sim._vdw_caps = (0.5, WU)
        sim.dms = types.SimpleNamespace(positions=np.zeros((4, 3)))
        sim.dtype, sim.device, sim.pairs = torch.float64, "cpu", None
        sim.constraints = None
    return jsim, tsim


@pytest.mark.parametrize("case", V1_CASES)
def test_v1_channel_regrows_as_jax(monkeypatch, case):
    """The bumped channel alone is reported, as JAX's overflow_report
    reports it, and the Simulation's regrow gives JAX's capacities (tree
    levels and windows, neighbor width and cell grid, WU rows, tile
    budgets) at escalating headroom; an unbumped vector reports none."""
    monkeypatch.setattr(JSIM, "AGBNPModel", _recorder)
    monkeypatch.setattr(TSIM, "AGBNPModel", _recorder)
    counts, nbmax, sibs, wu = _v1_diag(case)
    want = [] if case is None else [case.replace("_grid", "")]
    for headroom in HEADROOMS:
        jsim, tsim = _sims(grid=case == "neighbor_kmax_grid")
        rep = tsim.overflow_report(counts, nbmax, sibs, wu)
        assert list(rep) == want
        assert rep == jsim.overflow_report(counts, nbmax, sibs, wu)
        tsim._regrow(counts, nbmax, sibs, wu, headroom=headroom)
        jsim._regrow(counts, nbmax, sibs, headroom=headroom, wu=wu)
        tm, jm = tsim.agbnp, jsim.agbnp
        assert tm.caps.caps == tuple(jm.caps.caps)
        assert tm.caps.offs == tuple(jm.caps.offs)
        assert tm.pair_tiles == tuple(jm.pair_tiles)
        assert tsim.kmax == jsim.kmax
        assert tsim._vdw_caps == (jsim._vdw_caps[0],
                                  tuple(jsim._vdw_caps[1]))
        if tsim.grid is not None:
            assert tsim.grid.n == jsim.grid.n == 1
        assert not tsim.overflow_report(counts, nbmax, sibs, wu)


@pytest.mark.parametrize("case", V1_CASES[:17] + [None])
def test_model_rule_grows_as_jax(case):
    """AGBNPModel.check_and_grow over a build's diag: the overflowed
    levels and windows double, the neighbor width and tile budgets widen,
    as JAX's models/agbnp_jax.py::check_and_grow does; the port's model
    also grows its cell grid on a neighbor overflow."""
    counts, nbmax, sibs, _ = _v1_diag(case)
    diag = dict(counts=counts[:7], caps=np.asarray(CAPS),
                max_siblings=sibs, offs=np.asarray(OFFS + (0,)),
                neighbor_max=nbmax, pair_tile_counts=counts[7:])
    jm = object.__new__(JModel)
    tm = object.__new__(AGBNPModel)
    for m, caps in ((jm, JT.TreeCaps(CAPS, OFFS)), (tm, T.TreeCaps(CAPS,
                                                                  OFFS))):
        m.caps, m.neighbor_kmax, m.pair_tiles = caps, KMAX, TILES
    jm._build_jit = lambda: None
    tm.neighbor_grid = _Grid() if case == "neighbor_kmax_grid" else None
    assert tm.check_and_grow(diag) == jm.check_and_grow(diag) == (
        case is not None)
    assert (tm.caps.caps, tm.caps.offs) == (jm.caps.caps, jm.caps.offs)
    assert (tm.neighbor_kmax, tm.pair_tiles) == (jm.neighbor_kmax,
                                                 jm.pair_tiles)
    if tm.neighbor_grid is not None:
        assert tm.neighbor_grid.n == 1


def _v2_counts(entry):
    """An 18-entry vector at about half of each capacity, `entry` (None:
    none) past its own."""
    c = np.zeros(18, np.int64)
    c[V2.TREE] = np.asarray(CAPS) // 2
    c[V2.MS_TREE] = np.asarray(MS_CAPS) // 3
    c[V2.MS_COUNT] = CAP_MS // 2
    c[V2.MS_TREE_KMAX] = MS_KMAX // 2
    c[V2.MS_CANDIDATE_KMAX] = MS_KMAX_LIST // 2
    if entry is None:
        return c
    cap = (CAPS + MS_CAPS + (CAP_MS, MS_KMAX, MS_KMAX_LIST, 0))[entry]
    c[entry] = cap + 3 * entry + 1
    return c


def _v2_model():
    return types.SimpleNamespace(
        caps=JT.TreeCaps(CAPS, OFFS), caps_ms=JT.TreeCaps(MS_CAPS, OFFS),
        cap_ms=CAP_MS, ms_kmax=MS_KMAX, ms_sub_k=0, params=None, cutoff=1.0,
        pair_kernel=False, dtype=np.float64)


@pytest.mark.parametrize("entry", list(range(18)) + [None])
def test_v2_entry_regrows_as_jax(monkeypatch, entry):
    """Each entry of the 18-entry vector: the Simulation reports its
    channel and regrows as JAX's Simulation does, and the scorer regrows
    as JAX's scorer does (JAX's one rule, capacity.regrow_v2); an unbumped
    vector reports and grows nothing."""
    for mod in (JAGBNP2, TSIM, TSCORING):
        monkeypatch.setattr(mod, "AGBNP2Model", _recorder)
    c = _v2_counts(entry)
    force = types.SimpleNamespace(to_params=lambda: None)
    for headroom in HEADROOMS:
        jsim = object.__new__(JSIM.Simulation)
        tsim = object.__new__(Simulation)
        jsc = object.__new__(JConformerScorer)
        tsc = object.__new__(ConformerScorer)
        for x in (jsim, tsim):
            x.agbnp2 = x.agbnp = _v2_model()
            x.ms_kmax_list, x.constraints = MS_KMAX_LIST, None
            x.dms = types.SimpleNamespace(positions=np.zeros((4, 3)))
            x.dtype, x.device = torch.float64, "cpu"
        for x in (jsc, tsc):
            x._model, x._ms_kmax_list = _v2_model(), MS_KMAX_LIST
            x._force, x._pos0, x._cutoff = force, np.zeros((4, 3)), 1.0
            x.dtype, x.device = torch.float64, "cpu"
        rep = tsim.overflow_report(c, None, None)
        assert len(rep) == (entry is not None)
        assert bool(rep) == jsim._check_overflow_v2(c)
        assert tsc._regrow_v2(c, headroom) == jsc._regrow_v2(c, headroom) \
            == (entry is not None)
        if entry is None:
            continue
        tsim._regrow(c, None, None, headroom=headroom)
        jsim._regrow(c, None, None, headroom=headroom)
        for (t, tk), (j, jk) in (((tsim.agbnp2, tsim.ms_kmax_list),
                                  (jsim.agbnp2, jsim.ms_kmax_list)),
                                 ((tsc._model, tsc._ms_kmax_list),
                                  (jsc._model, jsc._ms_kmax_list))):
            assert t.caps.caps == tuple(j.caps.caps)
            assert t.caps_ms.caps == tuple(j.caps_ms.caps)
            assert t.caps.offs == tuple(j.caps.offs)
            assert (t.cap_ms, t.ms_kmax, t.ms_sub_k, tk) == (
                j.cap_ms, j.ms_kmax, j.ms_sub_k, jk)
        assert not capacity.v2_channels(c, tsim.agbnp2, tsim.ms_kmax_list)


@pytest.mark.parametrize("seen,factor,align,floor,want", [
    (0, 1.5, 16, 0, 0), (1, 1.5, 16, 0, 16), (32, 1.5, 16, 0, 48),
    (0, 1.5, 8, 8, 8), (90, 1.3, 128, 128, 128), (1000, 1.3, 128, 128,
                                                   1408),
    (1, 1.6, 1, 4, 4), (7, 1.3, 1, 0, 10),
])
def test_grow_past(seen, factor, align, floor, want):
    """The one piece of arithmetic every rule goes through."""
    assert capacity.grow_past(seen, factor, align, floor) == want
