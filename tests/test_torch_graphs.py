"""One CUDA graph a rebuild window (md/graphs.py): where it engages, what a
window carries for it, and that a graphed window is the eager one.

CPU tests: the graph declines off the card and off the plain AGBNP1
Langevin step, a window's topology carries its capacity rows, and, with
a stand-in graph that records the captured step and runs it again at each
replay, the window loop's energies, counts and launch tallies.  The
`cuda` tests hold graphed windows bitwise to eager ones on the card
(eager: `capturable` patched to decline) and run them with

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation, \
    TemperatureREMD, load_dms
from openmm_agbnp_plugin_tpu_torch.md import graphs
from openmm_agbnp_plugin_tpu_torch.md.integrators import langevin_middle_step
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.utils import profiling as PR

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "benchmarks", "data")
TRPCAGE = os.path.join(DATA, "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
EVERY = 2
ON_CARD = types.SimpleNamespace(is_cuda=True)


@pytest.fixture(scope="module")
def trpcage():
    return load_dms(TRPCAGE)


def _sim(dms, **kw):
    return Simulation(dms, device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **{**KW, **kw})


def _counts(rec, name):
    return sum(c["n"] for c in rec["counts"] if c["name"] == name)


# --- where the graph engages ------------------------------------------------

def _stand_in(version=1, agbnp2=None, constraints=None):
    return types.SimpleNamespace(agbnp=types.SimpleNamespace(version=version),
                                 agbnp2=agbnp2, constraints=constraints)


def test_capturable_on_the_plain_agbnp1_window_only(trpcage):
    sim = _sim(trpcage)
    ff = sim.ff_state()
    pos = sim.positions
    _, topo, _, _ = sim.window_build(pos[None], ff)
    bare = tuple({**lvl, "bnd": {k: v for k, v in lvl["bnd"].items()
                                  if k != "dep_order"}} for lvl in topo)
    assert graphs.capturable(sim, ON_CARD, topo, 40)
    # CPU tensors, and every tier-1 run with them
    assert not graphs.capturable(sim, pos, topo, 40)
    # a 1-step window: nothing to replay
    assert not graphs.capturable(sim, ON_CARD, topo, 1)
    # no window topology, or one without the tree kernels' prep
    assert not graphs.capturable(sim, ON_CARD, None, 40)
    assert not graphs.capturable(sim, ON_CARD, bare, 40)
    # AGBNP2, version 0, constraints
    assert not graphs.capturable(_stand_in(agbnp2=object()), ON_CARD, topo,
                                 40)
    assert not graphs.capturable(_stand_in(version=0), ON_CARD, topo, 40)
    assert not graphs.capturable(_stand_in(constraints=object()), ON_CARD,
                                 topo, 40)
    assert graphs.capturable(_stand_in(), ON_CARD, topo, 40)


@pytest.fixture
def spy(monkeypatch):
    """The `graph` each window_steps call is given, with `capturable`
    reading the positions as on a card; the steps run eagerly."""
    seen = []
    real_steps, real_cap = graphs.window_steps, graphs.capturable

    def steps(step, pos, vel, ninner, noise, graph=False):
        seen.append(graph)
        return real_steps(step, pos, vel, ninner, noise)

    monkeypatch.setattr(graphs, "window_steps", steps)
    monkeypatch.setattr(graphs, "capturable",
                        lambda sim, pos, topo, n: real_cap(sim, ON_CARD,
                                                           topo, n))
    return seen


@pytest.mark.parametrize("opts,want", [
    (dict(), [True, True, False]),
    (dict(mts_inner=2), [False, False, False]),
    (dict(wu_every=2), []),
    (dict(rebuild_topology=False), [False, False, False]),
    (dict(constraints=True), [False, False, False]),
])
def test_runner_graphs_only_the_plain_step(trpcage, spy, opts, want):
    cons = opts.pop("constraints", False)
    sim = _sim(trpcage, constraints=cons)
    run = sim.make_langevin_runner(neighbor_every=EVERY, **opts)
    # two whole windows and a 1-step remainder window
    run(sim.positions, sim.velocities, 2 * EVERY + 1,
        generator=torch.Generator().manual_seed(0))
    assert spy == want


def test_replica_runners_graph_their_windows(trpcage, spy):
    sim = _sim(trpcage)
    ens = ReplicaEnsemble(sim, 2)
    ens.make_runner(neighbor_every=EVERY)(ens.initial_states(jitter=1e-3),
                                          2 * EVERY + 1)
    assert spy == [True, True, False]
    spy.clear()
    remd = TemperatureREMD(sim, [300.0, 320.0])
    states, xgen = remd.initial_states(jitter=1e-3)
    remd.make_runner(steps_per_cycle=EVERY, neighbor_every=EVERY)(
        states, xgen, 2)
    assert spy == [True, True]
    spy.clear()
    # the per-step path: its steps run eagerly through the same loop
    ens.make_runner(neighbor_every=0)(ens.initial_states(jitter=1e-3), 2)
    assert spy == [False]


def test_off_the_card_no_graph_is_recorded(trpcage):
    sim = _sim(trpcage)
    PR.reset()
    with PR.record():
        out = sim.run_md(2 * EVERY, neighbor_every=EVERY,
                         generator=torch.Generator().manual_seed(0))
    rec = PR.recorded()
    PR.reset()
    assert _counts(rec, "md.graph_capture") == 0
    assert _counts(rec, "md.graph_replay") == 0
    assert sum(s["name"] == "md.step" for s in rec["spans"]) == 2 * EVERY
    assert not any(s["name"] == "md.graph_capture" for s in rec["spans"])
    assert out["energies"].shape == (2 * EVERY,)


# --- what a window carries ---------------------------------------------------

@pytest.mark.parametrize("nrep", [1, 3])
def test_window_caps_rows_are_caps_rows(trpcage, nrep):
    sim = _sim(trpcage)
    pos = ReplicaEnsemble(sim, nrep).initial_states(jitter=1e-3)[0]
    _, topo, vt, _ = sim.window_build(pos, sim.ff_state(),
                                      sim._ensure_vdw_caps())
    want = T.caps_rows(sim.agbnp.caps, nrep, pos.device)
    held = T.topology_caps_rows(topo, sim.agbnp.caps, nrep, pos.device)
    assert held is topo[0]["bnd"]["caps_rows"][1]
    assert held.keys() == want.keys()
    for k in want:
        assert torch.equal(held[k], want[k]), k
    # other caps or another replica count: made anew, as caps_rows makes them
    other = T.TreeCaps(tuple(c + 8 for c in sim.agbnp.caps.caps),
                       sim.agbnp.caps.offs)
    for caps, r in ((other, nrep), (sim.agbnp.caps, nrep + 1)):
        got = T.topology_caps_rows(topo, caps, r, pos.device)
        for k, v in T.caps_rows(caps, r, pos.device).items():
            assert torch.equal(got[k], v), k
    # the compacted WU topology and a bare one carry none
    assert "caps_rows" not in vt[0]["bnd"]


# --- the window loop with a stand-in graph -----------------------------------

class _Tape:
    """A stand-in torch.cuda.CUDAGraph: the ops a capture records run again
    at each replay."""

    capturing = None

    def __init__(self):
        self.ops = []

    def capture_begin(self, pool=None):
        _Tape.capturing = self

    def capture_end(self):
        _Tape.capturing = None

    def replay(self):
        for op in self.ops:
            op()


def _launch(op):
    """A kernel launch of the stand-in: counted at the call, run now or, in
    a capture, at each replay."""
    PK.LAUNCHES["tree_rescan"] += 1
    PR.count("tree.kernel", site="rescan")
    if _Tape.capturing is not None:
        _Tape.capturing.ops.append(op)
    else:
        op()


def _toy_step(pos, vel, noise):
    """An integrator step that updates pos and vel in place, in two
    launches, and returns a fresh energy and counts."""
    e = torch.empty((), dtype=pos.dtype)
    c = torch.empty(2, dtype=torch.int64)

    def kick():
        vel.mul_(0.5).add_(noise)

    def drift():
        pos.add_(0.1 * vel)
        e.copy_((pos * pos).sum())
        c.copy_(torch.stack([(pos > 0).sum(), (vel > 0).sum()]))

    _launch(kick)
    _launch(drift)
    return pos, vel, e, c, None


@pytest.fixture
def tape(monkeypatch):
    class Stream:
        def __init__(self, dev=None):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Tape)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None:
                        Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(graphs, "_POOLS", {})
    monkeypatch.setattr(graphs, "_STREAMS", {})


def _toy_window(graph, ninner):
    gen = torch.Generator().manual_seed(3)
    pos = torch.randn(5, 3, generator=gen, dtype=torch.float64)
    vel = torch.zeros_like(pos)
    noise = [torch.randn(5, 3, generator=gen, dtype=torch.float64)
             for _ in range(ninner)]
    it = iter(noise)
    PK.reset_launch_counts()
    PR.reset()
    with PR.record():
        out = graphs.window_steps(_toy_step, pos.clone(), vel.clone(),
                                  ninner, lambda: next(it), graph)
    rec = PR.recorded()
    PR.reset()
    return out, PK.launch_counts(), rec


@pytest.mark.parametrize("ninner", [2, 5])
def test_replayed_window_is_the_eager_window(tape, ninner):
    (p0, v0, e0, c0, s0), n0, r0 = _toy_window(False, ninner)
    (p1, v1, e1, c1, s1), n1, r1 = _toy_window(True, ninner)
    assert torch.equal(p0, p1) and torch.equal(v0, v1)
    assert len(e1) == ninner
    for x, y in zip(e0, e1):
        assert torch.equal(x, y)
    # each step's energy is its own, not the graph's last
    assert len({float(x) for x in e1}) == ninner
    assert torch.equal(c0, c1) and s0 is None and s1 is None
    # the launch tallies and the held counters are the eager window's
    assert n1 == n0 and n0["tree_rescan"] == 2 * ninner
    assert _counts(r1, "tree.kernel") == _counts(r0, "tree.kernel")
    assert _counts(r1, "md.graph_capture") == 1
    assert _counts(r1, "md.graph_replay") == ninner - 1
    assert _counts(r0, "md.graph_capture") == 0
    steps = [s for s in r1["spans"] if s["name"] == "md.step"]
    assert len(steps) == ninner
    (cap,) = [s for s in r1["spans"] if s["name"] == "md.graph_capture"]
    assert cap["parent"] == steps[1]["id"]


def test_a_graph_keeps_its_pool_for_the_next(tape):
    _toy_window(True, 3)
    pool, first = graphs._POOLS[None]
    _toy_window(True, 3)
    again, second = graphs._POOLS[None]
    assert again == pool and second is not first


def test_hold_keeps_counters_for_their_replays():
    PR.reset()
    with PR.record():
        with PR.hold() as held:
            PR.count("tree.kernel", site="reduce")
            PR.count("comm.x", 64, kind="x")
        assert PR.recorded()["counts"] == []
        PR.count_again(held)
        PR.count_again(held)
    rec = PR.recorded()
    PR.reset()
    assert [(c["name"], c["n"], c["site"]) for c in rec["counts"]] == [
        ("tree.kernel", 1, "reduce"), ("comm.x", 64, None)] * 2
    assert rec["counts"][1]["kind"] == "x"


# --- the benchmark's reader --------------------------------------------------

def test_graph_step_pct_reader(monkeypatch):
    import importlib.util

    path = os.path.join(ROOT, "portbench", "metrics",
                        "md.graph_step_pct.py")
    spec = importlib.util.spec_from_file_location("reader_graph_step_pct",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    spans = [dict(id=i, name="md.step", start_ns=i, end_ns=i + 1,
                  parent=None, request=0) for i in range(40)]
    counts = [dict(name="md.graph_replay", n=1)] * 39
    monkeypatch.setattr(PR, "recorded",
                        lambda: dict(spans=spans, counts=counts, dropped=0))
    assert mod.read(dict(kind="md")) == pytest.approx(97.5, rel=1e-12)
    assert mod.read(dict(kind="score")) is None
    monkeypatch.setattr(PR, "recorded",
                        lambda: dict(spans=spans, counts=[], dropped=0))
    assert mod.read(dict(kind="md")) == 0.0
    monkeypatch.setattr(PR, "recorded",
                        lambda: dict(spans=[], counts=[], dropped=0))
    assert mod.read(dict(kind="md")) is None


# --- on the card -------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


NE = 40  # the benchmark's rebuild window


def _card_sim(dev, name, **kw):
    return Simulation(load_dms(os.path.join(DATA, f"{name}_agbnp1.dms")),
                      device=dev, dtype=torch.float32, skin=0.25,
                      descreen_horizon="cutoff", version=1, cutoff=1.0,
                      **kw)


@contextlib.contextmanager
def _eager():
    """Windows inside run eagerly: capturable declines."""
    real = graphs.capturable
    graphs.capturable = lambda *a: False
    try:
        yield
    finally:
        graphs.capturable = real


def _both(fn):
    """(eager result, graphed result, their launch tallies, the graphed
    run's captures and replays)."""
    out = []
    for eager in (True, False):
        PK.reset_launch_counts()
        PR.reset()
        with PR.record(), (_eager() if eager
                           else contextlib.nullcontext()):
            res = fn()
            torch.cuda.synchronize()
        rec = PR.recorded()
        out.append((res, PK.launch_counts(),
                    (_counts(rec, "md.graph_capture"),
                     _counts(rec, "md.graph_replay"))))
    PR.reset()
    (r0, n0, g0), (r1, n1, g1) = out
    assert g0 == (0, 0)
    return r0, r1, n0, n1, g1


def _same(x, y, what=""):
    if isinstance(x, torch.Tensor):
        assert torch.equal(x, y), what
    elif isinstance(x, np.ndarray):
        assert x.dtype == y.dtype and np.array_equal(x, y), what
    elif isinstance(x, (tuple, list)):
        assert len(x) == len(y), what
        for k, (a, b) in enumerate(zip(x, y)):
            _same(a, b, f"{what}[{k}]")
    elif isinstance(x, dict):
        assert x.keys() == y.keys(), what
        for k in x:
            _same(x[k], y[k], f"{what}.{k}")
    else:
        assert x == y or (x is None and y is None), what


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw", [("1li2", dict(pair_tiles=False)),
                                     ("2clr", dict())])
def test_graphed_windows_are_the_eager_windows(cuda, name, kw):
    sim = _card_sim(cuda, name, **kw)
    run = sim.make_langevin_runner(neighbor_every=NE)

    def windows():
        # two whole windows and a 1-step remainder window (no capture)
        return run(sim.positions, sim.velocities, 2 * NE + 1,
                   generator=torch.Generator(device=cuda).manual_seed(7))

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert bool(torch.isfinite(r1[2]).all())
    assert n1 == n0 and n0["tree_rescan"] > 0
    assert g1 == (2, 2 * (NE - 1))


@pytest.mark.cuda
def test_graphed_ensemble_is_the_eager_ensemble(cuda):
    sim = _card_sim(cuda, "2clr")
    ens = ReplicaEnsemble(sim, 4)
    run = ens.make_runner(neighbor_every=NE)

    def windows():
        states, out = run(ens.initial_states(jitter=1e-3, seed=11), 2 * NE)
        return states[:2], out

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert n1 == n0 and g1 == (2, 2 * (NE - 1))


@pytest.mark.cuda
def test_graphed_remd_is_the_eager_remd(cuda):
    sim = _card_sim(cuda, "1li2")
    remd = TemperatureREMD(sim, [300.0, 310.0, 320.0, 330.0])
    # no remainder window: the second cycle's first step takes the force
    # of the first cycle's window_start (run_window(start=))
    run = remd.make_runner(steps_per_cycle=NE, neighbor_every=NE)

    def cycles():
        states, xgen = remd.initial_states(jitter=1e-3, seed=5)
        states, out = run(states, xgen, 2)
        return states[:2], states[3], out

    r0, r1, n0, n1, g1 = _both(cycles)
    _same(r0, r1)
    assert n1 == n0 and g1 == (2, 2 * (NE - 1))


@pytest.mark.cuda
def test_graphed_run_md_regrow_is_the_eager_one(cuda):
    # capacities at the DMS state's own counts: a window overflows and
    # run_md regrows and reruns it; the graphs follow the new caps
    def md(sim):
        out = sim.run_md(4 * NE, neighbor_every=NE, report_interval=NE,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(3))
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows",
                                    "tree_counts_max")}

    with _eager():
        r0 = md(_card_sim(cuda, "1li2", caps_boost=1.0))
    PR.reset()
    with PR.record():
        r1 = md(_card_sim(cuda, "1li2", caps_boost=1.0))
    rec = PR.recorded()
    PR.reset()
    assert r0["regrows"] >= 1
    _same(r0, r1)
    assert _counts(rec, "md.graph_capture") == 4 + r1["regrows"]


@pytest.mark.cuda
def test_graphed_step_makes_no_host_sync(cuda):
    sim = _card_sim(cuda, "1li2")
    ff = sim.ff_state()
    pos, vel = sim.positions, sim.velocities
    pairs, topo, vt, _ = sim.window_build(pos[None], ff,
                                          sim._ensure_vdw_caps())
    step = langevin_middle_step(
        sim.force_fn(pairs=pairs, topology=topo, ff=ff, vdw_topology=vt),
        sim.masses, 0.001, 300.0, 1.0)
    noise = torch.randn(pos.shape, generator=torch.Generator(device=cuda)
                        .manual_seed(1), dtype=pos.dtype, device=cuda)
    step(pos, vel, noise)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        want = step(pos, vel, noise)
        g = graphs.StepGraph(step, pos, vel, noise)
        got = g(noise)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _same(tuple(want[:4]), tuple(got))
