"""A runner's CUDA graphs, one a step kind, kept across its rebuild windows
(md/graphs.py): where they engage, what a window carries for them, and
that graphed windows are the eager ones.

CPU tests: the graphs decline off the card and off the steps they take
(the plain Langevin step of AGBNP1's and AGBNP2's windows, AGBNP1's WU
impulse schedule and r-RESPA MTS step, each with or without the
star-cluster SHAKE/RATTLE; not the Jacobi fallback), a runner keeps one
set across its windows (T-REMD one a window), a window's topology
carries its capacity rows (AGBNP2's: its steps' diagnostics, so that a
step reads nothing back and copies nothing from the host), and, with a
stand-in graph that records the captured step and runs it again at each
replay, the window loop's energies, counts, launch tallies, captures and
reuses, a WU window's counters step by step and an MTS window's substeps,
SHAKE sweeps and SHAKE residual, a build of another layout recaptured,
a window's outputs kept apart from the graphs the next window replays,
and a build captured once and replayed over later positions.  The `cuda`
tests hold graphed windows bitwise to eager ones on the card (eager:
`capturable` patched to decline and the build graph to run each build;
the 4 fs protocol's SHAKE residual too, and its regrow's new graphs), a
build's replay to its eager build with no host sync, eager AGBNP2
windows to each other, and run them with

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""

import contextlib
import os
import types

import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble, Simulation, \
    TemperatureREMD, load_dms
from openmm_agbnp_plugin_tpu_torch.md import graphs
from openmm_agbnp_plugin_tpu_torch.md.constraints import Constraints
from openmm_agbnp_plugin_tpu_torch.md.integrators import \
    langevin_middle_step, mts_langevin_step, wu_impulse_langevin_steps
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.ops.neighbors import CellGrid
from openmm_agbnp_plugin_tpu_torch.ops.kernels import pairs as PK
from openmm_agbnp_plugin_tpu_torch.parallel.ensemble import worst_replica
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


def _jacobi(dms):
    """dms's X-H constraints with one more, H-H, that makes them no star
    forest: the Jacobi fallback, which reads the host every sweep."""
    idx = np.concatenate([dms.constraint_idx, dms.constraint_idx[:2, 1][
        None]])
    d = np.concatenate([dms.constraint_d, [0.16]])
    cons = Constraints(idx, d, dms.masses, device="cpu")
    assert cons.clusters is None
    return cons


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
    # AGBNP2 on this window topology (not a _v2_build one), version 0
    assert not graphs.capturable(_stand_in(agbnp2=object()), ON_CARD, topo,
                                 40)
    assert not graphs.capturable(_stand_in(version=0), ON_CARD, topo, 40)
    assert graphs.capturable(_stand_in(), ON_CARD, topo, 40)
    # constraints: the star-cluster path (fixed sweeps, no host read), not
    # the Jacobi fallback
    star = _sim(trpcage, constraints=True)
    assert star.constraints.clusters is not None
    assert graphs.capturable(star, ON_CARD, topo, 40)
    assert graphs.capturable(_stand_in(constraints=star.constraints),
                             ON_CARD, topo, 40)
    assert not graphs.capturable(_stand_in(constraints=_jacobi(trpcage)),
                                 ON_CARD, topo, 40)


@pytest.fixture(scope="module")
def sim_v2(trpcage):
    return Simulation(trpcage, device="cpu", version=2, dtype=torch.float64)


def test_capturable_on_the_agbnp2_window(sim_v2):
    sim = sim_v2
    pos = sim.positions
    _, topo = sim._v2_build(pos)
    assert graphs.capturable(sim, ON_CARD, topo, 40)
    assert not graphs.capturable(sim, pos, topo, 40)
    assert not graphs.capturable(sim, ON_CARD, topo, 1)
    assert not graphs.capturable(sim, ON_CARD, None, 40)
    # a topology without its fixed-topology diagnostics
    bare = ({k: v for k, v in topo[0].items() if k != "diags"}, topo[1])
    assert not graphs.capturable(sim, ON_CARD, bare, 40)
    cons = Constraints.from_dms(sim.dms, device="cpu")
    assert graphs.capturable(_stand_in(agbnp2=object(), constraints=cons),
                             ON_CARD, topo, 40)
    assert not graphs.capturable(_stand_in(agbnp2=object(),
                                           constraints=_jacobi(sim.dms)),
                                 ON_CARD, topo, 40)
    assert graphs.capturable(_stand_in(agbnp2=object()), ON_CARD, topo, 40)
    # MTS: AGBNP2's runner refuses it before a window
    with pytest.raises(ValueError, match="MTS"):
        sim.make_langevin_runner(mts_inner=2)(
            pos, sim.velocities, 2, generator=torch.Generator().manual_seed(0))


@pytest.fixture
def spy(monkeypatch):
    """The WindowGraphs each window_steps call is given (None: eager), with
    `capturable` reading the positions as on a card; the steps run
    eagerly."""
    seen = []
    real_steps, real_cap = graphs.window_steps, graphs.capturable

    def steps(make, inputs, pos, vel, ninner, noise, held=None):
        seen.append(held)
        return real_steps(make, inputs, pos, vel, ninner, noise)

    monkeypatch.setattr(graphs, "window_steps", steps)
    monkeypatch.setattr(graphs, "capturable",
                        lambda sim, pos, topo, n: real_cap(sim, ON_CARD,
                                                           topo, n))
    return seen


@pytest.mark.parametrize("opts,want", [
    (dict(), [True, True, False]),
    (dict(mts_inner=2), [True, True, False]),
    (dict(wu_every=2), [True, True, False]),
    (dict(rebuild_topology=False), [False, False, False]),
    (dict(constraints=True), [True, True, False]),
    (dict(mts_inner=2, constraints=True), [True, True, False]),
    (dict(version=2), [True, True, False]),
    (dict(version=2, constraints=True), [True, True, False]),
])
def test_runner_graphs_only_the_plain_step(trpcage, spy, opts, want):
    cons = opts.pop("constraints", False)
    version = opts.pop("version", 1)
    sim = (_sim(trpcage, constraints=cons) if version == 1 else
           Simulation(trpcage, device="cpu", version=2, dtype=torch.float64,
                      constraints=cons))
    run = sim.make_langevin_runner(neighbor_every=EVERY, **opts)
    # two whole windows and a 1-step remainder window
    run(sim.positions, sim.velocities, 2 * EVERY + 1,
        generator=torch.Generator().manual_seed(0))
    assert [h is not None for h in spy] == want
    # the runner's windows share its graphs
    assert len({id(h) for h in spy if h is not None}) <= 1


def test_replica_runners_graph_their_windows(trpcage, spy):
    sim = _sim(trpcage)
    ens = ReplicaEnsemble(sim, 2)
    run = ens.make_runner(neighbor_every=EVERY)
    states = run(ens.initial_states(jitter=1e-3), 2 * EVERY + 1)[0]
    run(states, EVERY)
    assert [h is not None for h in spy] == [True, True, False, True]
    # one set of graphs for the runner, across its run calls
    assert spy[0] is spy[1] is spy[3]
    spy.clear()
    remd = TemperatureREMD(sim, [300.0, 320.0])
    states, xgen = remd.initial_states(jitter=1e-3)
    remd.make_runner(steps_per_cycle=EVERY, neighbor_every=EVERY)(
        states, xgen, 2)
    # a cycle's window takes the force of the cycle before and the rungs'
    # temperatures: graphs of its own
    assert [h is not None for h in spy] == [True, True]
    assert spy[0] is not spy[1]
    spy.clear()
    # the per-step path: its steps run eagerly through the same loop
    ens.make_runner(neighbor_every=0)(ens.initial_states(jitter=1e-3), 2)
    assert spy == [None]


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


class _HostTraffic(TorchDispatchMode):
    """The ops that read a value to the host or make a tensor from host
    data: on a card a sync or a copy from the host, which a CUDA graph's
    capture refuses."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default,
                    torch.ops.aten.lift_fresh.default):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("grid", [False, True], ids=["dense", "grid"])
def test_a_later_window_build_makes_no_tensor_from_host_data(trpcage, grid):
    """A window build after the first (what a BuildGraph captures) makes
    no tensor from host data: the caps rows and the cell grid's dims and
    stencil are made once and kept; the same build, bitwise."""
    sim = _sim(trpcage)
    if grid:
        sim._set_grid(None, CellGrid(np.asarray(trpcage.positions),
                                     sim.rcut_list,
                                     heavy_mask=np.asarray(sim.heavy_mask)))
    ff, caps = sim.ff_state(), sim._ensure_vdw_caps()
    pos = sim.positions[None]
    first = sim.window_build(pos, ff, caps)
    with _HostTraffic() as seen:
        again = sim.window_build(pos, ff, caps)
    assert [f for f in seen.seen if "lift_fresh" in f] == []
    for x, y in zip(_pytree.tree_leaves(first), _pytree.tree_leaves(again)):
        assert not isinstance(x, torch.Tensor) or torch.equal(x, y)


def test_v2_window_carries_its_step_diagnostics(sim_v2, monkeypatch):
    sim, m2 = sim_v2, sim_v2.agbnp2
    ff = sim.ff_state()
    pos, vel = sim.positions, sim.velocities
    ms_pairs, (topo, counts) = sim._v2_build(pos, ff)
    d0, d1 = topo["diags"]
    # the fixed-topology steps' diagnostics: the valid rows, the caps rows,
    # the frozen MS count, zeros for what a rescan does not build
    want = ((topo["atoms"], pos.shape[0], m2.caps, d0),
            (topo["ms"], m2.cap_ms, m2.caps_ms, d1))
    for levels, natoms, caps, d in want:
        assert torch.equal(d["counts"], T.replica_counts(levels, 1, natoms))
        for k, v in T.caps_rows(caps, 1, pos.device).items():
            assert torch.equal(d[k], v), k
        assert not d["max_siblings"].any()
    assert d1["ms_count"] is topo["ms_count"]
    assert not d1["ms_nbmax"].any() and not d1["ms_sub_max"].any()
    step = langevin_middle_step(
        sim.force_fn(pairs=ms_pairs, topology=(topo, counts), ff=ff),
        sim.masses, 0.001, 300.0, 1.0)
    noise = torch.randn(pos.shape, dtype=pos.dtype,
                        generator=torch.Generator().manual_seed(1))
    want = step(pos, vel, noise)

    def refused(*args, **kw):
        raise AssertionError("a fixed-topology step made diagnostics")

    monkeypatch.setattr(T, "caps_rows", refused)
    monkeypatch.setattr(T, "replica_counts", refused)
    with _HostTraffic() as seen:
        got = step(pos, vel, noise)
    assert seen.seen == []
    for x, y in zip(want[:4], got[:4]):
        assert torch.equal(x, y)
    assert got[3] is counts


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


def _toy_make(build):
    """The toy's schedule over a window's build: an integrator step that
    updates pos and vel in place, in two launches, its kick adding the
    build's k, and returns a fresh energy and counts."""
    k = build["k"]

    def step(pos, vel, noise):
        e = torch.empty((), dtype=pos.dtype)
        c = torch.empty(3, dtype=torch.int64)

        def kick():
            vel.mul_(0.5).add_(noise).add_(k)

        def drift():
            pos.add_(0.1 * vel)
            e.copy_((pos * pos).sum())
            c.copy_(torch.stack([(pos > 0).sum(), (vel > 0).sum(),
                                 (noise > 1).sum()]))

        _launch(kick)
        _launch(drift)
        return pos, vel, e, c, None

    return graphs.every_step(step)


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
    monkeypatch.setattr(graphs, "_upload", lambda graph, stream: None)


def _toy_run(held, ks, ninner):
    """Windows of ninner toy steps, one a build k in ks, through
    window_steps with held (a WindowGraphs; None: eagerly), each an
    md.window span.  Returns each window's returned (pos, vel, energies,
    counts), their copies taken as the window returned, the launch
    tallies and the record."""
    gen = torch.Generator().manual_seed(3)
    pos = torch.randn(5, 3, generator=gen, dtype=torch.float64)
    vel = torch.zeros_like(pos)
    noise = iter([torch.randn(5, 3, generator=gen, dtype=torch.float64)
                  for _ in range(len(ks) * ninner)])
    outs, copies = [], []
    PK.reset_launch_counts()
    PR.reset()
    with PR.record():
        for k in ks:
            with PR.span("md.window"):
                pos, vel, e, c, s = graphs.window_steps(
                    _toy_make, dict(k=k), pos, vel, ninner,
                    lambda: next(noise), held)
            assert s is None
            outs.append((pos, vel, e, c))
            copies.append((pos.clone(), vel.clone(),
                           [x.clone() for x in e], c.clone()))
    rec = PR.recorded()
    PR.reset()
    return outs, copies, PK.launch_counts(), rec


def _toy_window(graph, ninner):
    """One window of the toy, k zero: ((pos, vel, energies, counts,
    None), launch tallies, record)."""
    held = graphs.WindowGraphs() if graph else None
    _, [out], n, rec = _toy_run(held, [torch.zeros(5, 3,
                                                   dtype=torch.float64)],
                                ninner)
    return (*out, None), n, rec


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
    assert _counts(r1, "md.graph_reuse") == 0
    assert _counts(r0, "md.graph_capture") == 0
    steps = [s for s in r1["spans"] if s["name"] == "md.step"]
    assert len(steps) == ninner
    (cap,) = [s for s in r1["spans"] if s["name"] == "md.graph_capture"]
    assert cap["parent"] == steps[1]["id"]


def _toy_ks(shapes):
    gen = torch.Generator().manual_seed(5)
    return [0.1 * torch.randn(sh, generator=gen, dtype=torch.float64)
            for sh in shapes]


@pytest.mark.parametrize("ninner", [2, 4])
def test_kept_graphs_are_the_eager_windows(tape, ninner):
    """Four windows, each with its own build: the graph captured in the
    first replays every step of the next three over their builds, copied
    into its inputs, bitwise the eager windows."""
    ks = _toy_ks([(5, 3)] * 4)
    _, want, n0, r0 = _toy_run(None, ks, ninner)
    _, got, n1, r1 = _toy_run(graphs.WindowGraphs(), ks, ninner)
    for w, (x, y) in enumerate(zip(want, got)):
        for a, b in zip((x[0], x[1], *x[2], x[3]), (y[0], y[1], *y[2],
                                                     y[3])):
            assert torch.equal(a, b), w
    assert n1 == n0 and _counts(r1, "tree.kernel") == \
        _counts(r0, "tree.kernel")
    assert _counts(r1, "md.graph_capture") == 1
    assert _counts(r1, "md.graph_reuse") == 3
    assert _counts(r1, "md.graph_replay") == 4 * ninner - 1
    windows = [s["id"] for s in r1["spans"] if s["name"] == "md.window"]
    reuses = [c["span"] for c in r1["counts"] if c["name"] ==
              "md.graph_reuse"]
    assert reuses == windows[1:]


def test_kept_graphs_recapture_a_build_of_another_layout(tape):
    """A build whose layout differs from the slots' (here k's shape in
    the third window) takes fresh slots and a new capture, which the
    fourth window reuses; bitwise the eager windows throughout."""
    ks = _toy_ks([(5, 3), (5, 3), (1, 3), (1, 3)])
    _, want, _, _ = _toy_run(None, ks, 3)
    held = graphs.WindowGraphs()
    _, got, _, rec = _toy_run(held, ks, 3)
    for x, y in zip(want, got):
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])
        assert all(torch.equal(a, b) for a, b in zip(x[2], y[2]))
        assert torch.equal(x[3], y[3])
    assert _counts(rec, "md.graph_capture") == 2
    assert _counts(rec, "md.graph_reuse") == 2
    assert _counts(rec, "md.graph_replay") == 2 * 2 + 2 * 3
    # the key sees strides too: a transposed build of k's shape
    k = ks[-1].expand(5, 3).t().contiguous().t()
    assert graphs._layout(dict(k=k))[0] != graphs._layout(
        dict(k=ks[-1].expand(5, 3).contiguous()))[0]


def test_a_windows_outputs_outlive_the_next_window(tape):
    """What a window returns (pos, vel, its energies and counts) is its
    own: the next window's replays, which rewrite the graph's static
    tensors and outputs, leave it as it was."""
    ks = _toy_ks([(5, 3)] * 3)
    outs, copies, _, _ = _toy_run(graphs.WindowGraphs(), ks, 3)
    for (p, v, e, c), (p0, v0, e0, c0) in zip(outs, copies):
        assert torch.equal(p, p0) and torch.equal(v, v0)
        assert all(torch.equal(a, b) for a, b in zip(e, e0))
        assert torch.equal(c, c0)


def _taped(step):
    """step for the stand-in graph: inside a capture it records a call of
    itself on the static tensors and returns them with output buffers
    (the SHAKE residual's too, where the step has one); each replay makes
    that call and writes its results into them, as a graph's kernels
    write their fixed outputs."""
    def run(pos, vel, noise):
        if _Tape.capturing is None:
            return step(pos, vel, noise)
        _, _, e, c, s = step(pos.clone(), vel.clone(),
                             torch.zeros_like(noise))
        e, c = torch.empty_like(e), torch.empty_like(c)
        s = None if s is None else torch.empty_like(s)

        def replay():
            # a replay runs the captured kernels, not the step's Python: its
            # counters and launch tallies are the capture's, held
            launches = dict(PK.LAUNCHES)
            with PR.hold():
                p, v, e_new, c_new, s_new = step(pos, vel, noise)
            PK.LAUNCHES.update(launches)
            for out, x in ((pos, p), (vel, v), (e, e_new), (c, c_new),
                           (s, s_new)):
                if out is not None:
                    out.copy_(x)

        _Tape.capturing.ops.append(replay)
        return pos, vel, e, c, s

    return run


def _taped_make(make):
    """make for the stand-in graph: its schedules' steps _taped, the
    steps of one kind one callable across windows."""
    def taped_make(inputs):
        schedule, kinds = make(inputs), {}

        def taped(ninner):
            out = []
            for st in schedule(ninner):
                if st not in kinds:
                    kinds[st] = _taped(st)
                out.append(kinds[st])
            return out

        return taped

    return taped_make


def _runner_windows(monkeypatch, sim, graph, nsteps, **kw):
    """make_langevin_runner(**kw)'s run of nsteps from sim's state on the
    stand-in graph (graph: capturable reads the positions as on a card;
    else it declines): (its output, launch tallies, record)."""
    real_steps, real_cap = graphs.window_steps, graphs.capturable
    monkeypatch.setattr(graphs, "window_steps", lambda make, *a:
                        real_steps(_taped_make(make), *a))
    monkeypatch.setattr(graphs, "capturable", lambda s, pos, topo, n:
                        graph and real_cap(s, ON_CARD, topo, n))
    run = sim.make_langevin_runner(**kw)
    PK.reset_launch_counts()
    PR.reset()
    with PR.record():
        out = run(sim.positions, sim.velocities, nsteps,
                  generator=torch.Generator().manual_seed(0))
    rec = PR.recorded()
    PR.reset()
    monkeypatch.setattr(graphs, "window_steps", real_steps)
    monkeypatch.setattr(graphs, "capturable", real_cap)
    return out, PK.launch_counts(), rec


def _same_runs(r0, r1, nsteps):
    (p0, v0, e0, d0), (p1, v1, e1, d1) = r0, r1
    assert torch.equal(p0, p1) and torch.equal(v0, v1)
    assert torch.equal(e0, e1) and len(set(e1.tolist())) == nsteps
    for x, y in zip(d0, d1):
        assert (x is None and y is None) or torch.equal(x, y)


def test_runner_keeps_its_graph_across_windows(trpcage, tape, monkeypatch):
    """Four 2-step windows of the plain step: the first window's graph
    replays every step of the next three, bitwise the eager runner."""
    sim = _sim(trpcage)
    kw = dict(neighbor_every=2)
    r0, n0, rec0 = _runner_windows(monkeypatch, sim, False, 8, **kw)
    r1, n1, rec = _runner_windows(monkeypatch, sim, True, 8, **kw)
    _same_runs(r0, r1, 8)
    assert not sim.overflow_report(*r1[3])
    assert n1 == n0
    assert _counts(rec, "md.graph_capture") == 1
    assert _counts(rec, "md.graph_reuse") == 3
    assert _counts(rec, "md.graph_replay") == 7
    assert _counts(rec0, "md.graph_replay") == 0


def test_replayed_v2_window_is_the_eager_window(sim_v2, tape, monkeypatch):
    # two whole 3-step windows and a 1-step remainder window, which runs
    # eagerly: the second window replays the first's graph
    sim = sim_v2
    (r0, n0, rec0), (r1, n1, rec1) = (
        _runner_windows(monkeypatch, sim, graph, 7, neighbor_every=3)
        for graph in (False, True))
    _same_runs(r0, r1, 7)
    assert not sim.overflow_report(*r1[3])
    assert n1 == n0
    assert (_counts(rec0, "md.graph_capture"),
            _counts(rec0, "md.graph_replay")) == (0, 0)
    assert (_counts(rec1, "md.graph_capture"),
            _counts(rec1, "md.graph_replay"),
            _counts(rec1, "md.graph_reuse")) == (1, 5, 1)


def test_replayed_wu_window_is_the_eager_window(trpcage, tape, monkeypatch):
    """The WU impulse schedule (wu_every=2) in 6-step windows and a 3-step
    remainder window: in the first window a step kind's first step eager,
    its second captured and replayed with the rest; the later windows
    replay the kept graphs from their first step, the remainder block's
    impulse captured where it first occurs; one md.step span a step, an
    md.wu_impulse counter an impulse step, replayed or not."""
    sim = _sim(trpcage)
    kw = dict(neighbor_every=6, wu_every=2)
    r0, n0, rec0 = _runner_windows(monkeypatch, sim, False, 15, **kw)
    r1, n1, rec1 = _runner_windows(monkeypatch, sim, True, 15, **kw)
    _same_runs(r0, r1, 15)
    assert n1 == n0
    # by step: an impulse every other step from each window's start (the
    # remainder window's last one of weight 1); the replays from the
    # first window's third step on
    impulse = [1, 0, 1, 0, 1, 0] * 2 + [1, 0, 1]
    replay = [0, 0] + [1] * 13
    for rec, want_replay in ((rec0, [0] * 15), (rec1, replay)):
        steps = [sp for sp in rec["spans"] if sp["name"] == "md.step"]
        assert len(steps) == 15

        def by_step(name):
            ids = [sp["id"] for sp in steps]
            out = [0] * 15
            for c in rec["counts"]:
                if c["name"] == name:
                    out[ids.index(c["span"])] += c["n"]
            return out

        assert by_step("md.wu_impulse") == impulse
        assert by_step("md.graph_replay") == want_replay
        assert by_step("md.graph_capture") == (
            [0] * 15 if rec is rec0 else [0, 0, 1, 1] + [0] * 10 + [1])
    # once a step kind (impulse 2, skip, impulse 1); every window after the
    # first reuses
    assert _counts(rec1, "md.graph_capture") == 3
    assert _counts(rec1, "md.graph_reuse") == 2
    assert _counts(rec0, "md.graph_capture") == 0


def test_replayed_mts_window_is_the_eager_window(trpcage, tape,
                                                  monkeypatch):
    """The 4 fs protocol's step (r-RESPA, mts_inner=2, with the X-H
    constraints) in 3-step windows and a 1-step remainder window: the
    first window's second step captured and replayed, every later step
    of a whole window replayed, bitwise the eager runner, the windows' SHAKE
    residual included; by step, replayed or not, one md.step span, two
    md.mts_substep counters and two SHAKE calls of the star path's
    sweeps."""
    sim = _sim(trpcage, constraints=True)
    sweeps = sim.constraints.sweeps
    kw = dict(neighbor_every=3, mts_inner=2, dt=0.004)
    r0, n0, rec0 = _runner_windows(monkeypatch, sim, False, 7, **kw)
    r1, n1, rec1 = _runner_windows(monkeypatch, sim, True, 7, **kw)
    _same_runs(r0, r1, 7)
    assert r1[3].shake is not None and float(r1[3].shake) > 0
    assert not sim.overflow_report(*r1[3])
    assert n1 == n0
    for rec, replay in ((rec0, [0] * 7), (rec1, [0, 1, 1, 1, 1, 1, 0])):
        steps = [sp["id"] for sp in rec["spans"] if sp["name"] == "md.step"]
        assert len(steps) == 7
        parent = {sp["id"]: sp["parent"] for sp in rec["spans"]}

        def by_step(name):
            # a counter in a span inside its step (md.shake) is the step's
            out = [0] * 7
            for c in rec["counts"]:
                if c["name"] == name:
                    at = c["span"]
                    while at not in steps:
                        at = parent[at]
                    out[steps.index(at)] += c["n"]
            return out

        assert by_step("md.mts_substep") == [2] * 7
        assert by_step("constraints.shake_sweeps") == [2 * sweeps] * 7
        assert by_step("md.graph_replay") == replay
    assert (_counts(rec1, "md.graph_capture"),
            _counts(rec1, "md.graph_reuse")) == (1, 1)
    # the spans of the eager steps' constraints and fast class
    names = [sp["name"] for sp in rec0["spans"]]
    assert names.count("md.shake") == 14 and names.count("eval.fast") == 14
    assert names.count("md.rattle") == 7 * 3


def _toy_build(pos):
    """A stand-in window build: one launch writing fresh outputs, a
    positions-like tensor and diagnostics, from pos."""
    out = torch.empty_like(pos)
    n = torch.empty((), dtype=torch.int64)

    def op():
        out.copy_(2.0 * pos + 1.0)
        n.copy_((pos > 0).sum())

    _launch(op)
    return out, (n,)


def test_build_graph_replays_the_build(tape):
    """Four windows' builds through a BuildGraph: the first eager, then
    captured, the next three replays over their own positions copied in;
    each the eager build's, launch tallies and held counters the eager
    builds'."""
    gen = torch.Generator().manual_seed(7)
    xs = [torch.randn(5, 3, generator=gen, dtype=torch.float64)
          for _ in range(4)]

    def builds(graph):
        PK.reset_launch_counts()
        PR.reset()
        outs, captured = [], []
        with PR.record():
            for x in xs:
                o, (n,) = (graph(_toy_build, x) if graph is not None
                           else _toy_build(x))
                outs.append((o.clone(), n.clone()))
                captured.append(graph is not None and graph.replayed)
        rec = PR.recorded()
        PR.reset()
        return outs, captured, PK.launch_counts(), rec

    want, _, n0, r0 = builds(None)
    got, captured, n1, r1 = builds(graphs.BuildGraph())
    for (a, b), (c, d) in zip(want, got):
        assert torch.equal(a, c) and torch.equal(b, d)
    assert captured == [False, True, True, True]
    assert n1 == n0 and n0["tree_rescan"] == 4
    assert _counts(r1, "tree.kernel") == _counts(r0, "tree.kernel") == 4
    assert _counts(r1, "window.build_capture") == 1
    assert _counts(r1, "window.build_replay") == 3
    assert sum(s["name"] == "window.build_capture" for s in r1["spans"]) == 1


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


def _card_sim(dev, name, version=1, **kw):
    return Simulation(load_dms(os.path.join(DATA, f"{name}_agbnp1.dms")),
                      device=dev, dtype=torch.float32, skin=0.25,
                      descreen_horizon="cutoff", version=version, cutoff=1.0,
                      **kw)


@pytest.fixture(scope="module")
def v2_1li2(cuda):
    """1li2 in AGBNP2 with its capacities grown by one run_md window (JAX's
    MS-tree neighbor width, 64, is short for 1li2), as the benchmark's
    warm-up grows them."""
    sim = _card_sim(cuda, "1li2", version=2)
    sim.run_md(NE, neighbor_every=NE)
    return sim


@contextlib.contextmanager
def _eager():
    """Windows inside run eagerly: capturable declines, and a runner's
    BuildGraph runs each build as it comes."""
    real, call = graphs.capturable, graphs.BuildGraph.__call__
    graphs.capturable = lambda *a: False
    graphs.BuildGraph.__call__ = lambda self, build, pos: build(pos)
    try:
        yield
    finally:
        graphs.capturable = real
        graphs.BuildGraph.__call__ = call


def _both(fn):
    """(eager result, graphed result, their launch tallies, the graphed
    run's captures, replays and reuses)."""
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
                     _counts(rec, "md.graph_replay"),
                     _counts(rec, "md.graph_reuse"))))
    PR.reset()
    (r0, n0, g0), (r1, n1, g1) = out
    assert g0 == (0, 0, 0)
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
        # two whole windows, the second replaying the first's graph, and a
        # 1-step remainder window, eager
        return run(sim.positions, sim.velocities, 2 * NE + 1,
                   generator=torch.Generator(device=cuda).manual_seed(7))

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert bool(torch.isfinite(r1[2]).all())
    assert n1 == n0 and n0["tree_rescan"] > 0
    assert g1 == (1, 2 * NE - 1, 1)


@pytest.mark.cuda
def test_eager_v2_windows_repeat_bitwise(v2_1li2):
    # what holds a graphed AGBNP2 window to the eager one bit for bit
    sim = v2_1li2
    run = sim.make_langevin_runner(neighbor_every=NE)

    def window():
        return run(sim.positions, sim.velocities, NE,
                   generator=torch.Generator(device=sim.device)
                   .manual_seed(7))

    with _eager():
        first = window()
        again = window()
    _same(first, again)


@pytest.mark.cuda
def test_graphed_v2_windows_are_the_eager_windows(v2_1li2):
    sim = v2_1li2
    run = sim.make_langevin_runner(neighbor_every=NE)

    def windows():
        # two whole windows, the second replaying the first's graph, and a
        # 1-step remainder window, eager
        return run(sim.positions, sim.velocities, 2 * NE + 1,
                   generator=torch.Generator(device=sim.device)
                   .manual_seed(7))

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert bool(torch.isfinite(r1[2]).all())
    assert not sim.overflow_report(*r1[3])
    assert n1 == n0 and n0["take_rows"] > 0 and n0["born_sums"] > 0
    assert g1 == (1, 2 * NE - 1, 1)


@pytest.mark.cuda
def test_graphed_ensemble_is_the_eager_ensemble(cuda):
    """4 x 2clr: a runner's windows over three run calls, a window each
    after the first's two (as the benchmark drives it), replay the graph
    its first window captured."""
    sim = _card_sim(cuda, "2clr")
    ens = ReplicaEnsemble(sim, 4)
    run = ens.make_runner(neighbor_every=NE)

    def windows():
        states = ens.initial_states(jitter=1e-3, seed=11)
        outs = []
        for steps in (2 * NE, NE, NE):
            states, out = run(states, steps)
            outs.append((states[:2], out))
        return outs

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert n1 == n0 and g1 == (1, 4 * NE - 1, 3)


@pytest.mark.cuda
def test_graphed_constrained_ensemble_is_the_eager_ensemble(cuda):
    """2 x 1li2 with the X-H constraints (the star path, a SHAKE residual
    [R] a window): the runner's graphs replay its windows, bitwise the
    eager ensemble, the residual included."""
    sim = _card_sim(cuda, "1li2", constraints=True)
    sim.run_md(4 * NE, neighbor_every=NE)  # capacities grown
    ens = ReplicaEnsemble(sim, 2)
    run = ens.make_runner(neighbor_every=NE)

    def windows():
        states, out = run(ens.initial_states(jitter=1e-3, seed=13), 2 * NE)
        return states[:2], out

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    assert not sim.overflow_report(*worst_replica(r1[1][1:]))
    shake = r1[1][-1]
    assert shake is not None and shake.shape == (2,)
    assert float(shake.max()) <= sim.constraints.tolerance(torch.float32)
    assert n1 == n0 and g1 == (1, 2 * NE - 1, 1)


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
    # a cycle's window captures graphs of its own
    assert n1 == n0 and g1 == (2, 2 * (NE - 1), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_graphed_run_md_regrow_is_the_eager_one(cuda, version):
    # capacities at the DMS state's own counts (AGBNP2: the MS-tree
    # neighbor width sized short): a window overflows and run_md regrows
    # and reruns it with a new runner, which captures anew; each runner's
    # later windows replay its graph
    def md(sim):
        out = sim.run_md(4 * NE, neighbor_every=NE, report_interval=NE,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(3))
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows",
                                    "tree_counts_max")}

    with _eager():
        r0 = md(_card_sim(cuda, "1li2", version, caps_boost=1.0))
    PR.reset()
    with PR.record():
        r1 = md(_card_sim(cuda, "1li2", version, caps_boost=1.0))
    rec = PR.recorded()
    PR.reset()
    assert r0["regrows"] >= 1
    _same(r0, r1)
    runners = 1 + r1["regrows"]
    assert _counts(rec, "md.graph_capture") == runners
    # 4 + regrows windows, each runner's first capturing
    assert _counts(rec, "md.graph_reuse") == 3
    assert _counts(rec, "md.graph_replay") == (4 + r1["regrows"]) * NE \
        - runners


@pytest.mark.cuda
def test_graphed_wu_run_md_is_the_eager_one(cuda):
    """run_md(wu_every=4) over two 40-step windows and a 2-step remainder
    window (an impulse of weight 2, then a skip step), from capacities at
    the DMS state's own counts, so that a window overflows and run_md
    regrows and reruns it with a new runner: graphed, bitwise the eager
    run, with the same launch tallies.  A runner's first 40-step window
    captures its impulse and its skip step and replays the two graphs in
    turns, 38 steps; its later windows replay them from their first step,
    the 2-step window capturing its impulse of weight 2 at once."""
    def md():
        sim = _card_sim(cuda, "1li2", caps_boost=1.0)
        out = sim.run_md(2 * NE + 2, neighbor_every=NE, report_interval=NE,
                         wu_every=4, generator=torch.Generator(device=cuda)
                         .manual_seed(3))
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows",
                                    "tree_counts_max")}

    out = []
    for eager in (True, False):
        PK.reset_launch_counts()
        PR.reset()
        with PR.record(), (_eager() if eager
                           else contextlib.nullcontext()):
            res = md()
            torch.cuda.synchronize()
        out.append((res, PK.launch_counts(), PR.recorded()))
    PR.reset()
    (r0, n0, rec0), (r1, n1, rec) = out
    assert r1["regrows"] >= 1
    _same(r0, r1)
    assert bool(np.isfinite(r1["energies"]).all())
    assert n1 == n0 and n0["tree_rescan"] > 0
    windows = [sp["id"] for sp in rec["spans"] if sp["name"] == "md.window"]
    steps = [sum(sp["parent"] == w and sp["name"] == "md.step"
                 for sp in rec["spans"]) for w in windows]
    assert sorted(set(steps)) == [2, NE] and steps[-1] == 2
    whole = steps.count(NE)
    runners = 1 + r1["regrows"]
    assert whole == 2 + r1["regrows"]
    assert _counts(rec, "md.graph_capture") == 2 * runners + 1
    assert _counts(rec, "md.graph_reuse") == whole + 1 - runners
    assert _counts(rec, "md.graph_replay") == NE * whole + 2 - 2 * runners
    assert _counts(rec, "md.wu_impulse") == NE // 4 * whole + 1
    assert _counts(rec0, "md.wu_impulse") == _counts(rec, "md.wu_impulse")
    assert _counts(rec0, "md.graph_replay") == 0


def _window_make(sim, ff, wu):
    """(make, build): a 1li2 window's schedule over its build, the plain
    step (wu 1) or the WU impulse schedule, and build(pos) -> the
    window's inputs at pos."""
    def make(inputs):
        _, pairs, topo, vt = inputs
        mk = dict(pairs=pairs, topology=topo, ff=ff, vdw_topology=vt)
        if wu == 1:
            return graphs.every_step(langevin_middle_step(
                sim.force_fn(**mk), sim.masses, 0.001, 300.0, 1.0))
        return wu_impulse_langevin_steps(
            sim.force_fn(wu_mode="split", **mk),
            sim.force_fn(wu_mode="skip", **mk), sim.masses, 0.001, 300.0,
            1.0, wu)

    def build(pos):
        return (sim.agbnp, *sim.window_build(pos[None], ff,
                                             sim._ensure_vdw_caps())[:3])

    return make, build


@pytest.mark.cuda
def test_graphed_wu_window_makes_no_host_sync(cuda):
    """A 40-step WU impulse window of 1li2 (wu_every=4), eagerly and with
    its two step kinds captured and replayed in turns, under
    set_sync_debug_mode("error"): no host sync, and bitwise equal."""
    sim = _card_sim(cuda, "1li2")
    make, build = _window_make(sim, sim.ff_state(), 4)
    pos, vel = sim.positions, sim.velocities
    inputs = build(pos)
    assert len(set(make(inputs)(NE))) == 2
    gen = torch.Generator(device=cuda).manual_seed(1)
    noise = [torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                         device=cuda) for _ in range(NE)]
    # both kinds' lazy set-up, eagerly
    graphs.window_steps(make, inputs, pos, vel, 2, iter(noise).__next__)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager, graphed = (graphs.window_steps(make, inputs, pos, vel, NE,
                                              iter(noise).__next__, held)
                          for held in (None, graphs.WindowGraphs()))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    _same(eager, graphed)


@pytest.mark.cuda
@pytest.mark.parametrize("wu", [1, 4])
def test_kept_graph_window_makes_no_host_sync(cuda, wu):
    """A runner's second 1li2 window (the plain step, and wu_every=4) from
    its build's end to its last step under set_sync_debug_mode("error"):
    the build copied into the first window's slots, every step a replay of
    its graphs; bitwise the eager window."""
    sim = _card_sim(cuda, "1li2")
    make, build = _window_make(sim, sim.ff_state(), wu)
    pos, vel = sim.positions, sim.velocities
    gen = torch.Generator(device=cuda).manual_seed(2)
    noise = [torch.randn(pos.shape, generator=gen, dtype=pos.dtype,
                         device=cuda) for _ in range(2 * NE)]
    held = graphs.WindowGraphs()
    p1, v1, *_ = graphs.window_steps(make, build(pos), pos, vel, NE,
                                     iter(noise[:NE]).__next__, held)
    inputs = build(p1)
    torch.cuda.synchronize()
    PR.reset()
    with PR.record():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = graphs.window_steps(make, inputs, p1, v1, NE,
                                      iter(noise[NE:]).__next__, held)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rec = PR.recorded()
    PR.reset()
    torch.cuda.synchronize()
    assert (_counts(rec, "md.graph_reuse"), _counts(rec, "md.graph_replay"),
            _counts(rec, "md.graph_capture")) == (1, NE, 0)
    want = graphs.window_steps(make, inputs, p1, v1, NE,
                               iter(noise[NE:]).__next__)
    _same(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("version,wu", [(1, 1), (1, 4), (2, 1)])
def test_kept_graphs_run_md_is_the_eager_one(cuda, v2_1li2, version, wu):
    """run_md over four 40-step windows of 1li2 (the plain step, wu_every=4
    and AGBNP2) at capacities an eager run of the same trajectory grew:
    graphed, bitwise the eager run, the graphs captured once a step kind
    and every window after the first a reuse."""
    sim = v2_1li2 if version == 2 else _card_sim(cuda, "1li2")

    def md():
        out = sim.run_md(4 * NE, neighbor_every=NE, report_interval=NE,
                         wu_every=wu, generator=torch.Generator(
                             device=cuda).manual_seed(4))
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows",
                                    "tree_counts_max")}

    with _eager():
        md()
    r0, r1, n0, n1, g1 = _both(md)
    assert r0["regrows"] == 0
    _same(r0, r1)
    assert bool(np.isfinite(r1["energies"]).all())
    kinds = 1 if wu == 1 else 2
    assert n1 == n0 and g1 == (kinds, 4 * NE - kinds, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["1li2", "2clr"])
def test_build_replay_makes_no_host_sync(cuda, name):
    """A BuildGraph over a Simulation's window build (1li2's dense
    neighbor candidates, 2clr's cell grid): its third call, a replay over
    other positions, under set_sync_debug_mode("error"), is the eager
    build of those positions, bitwise."""
    sim = _card_sim(cuda, name)
    ff, caps = sim.ff_state(), sim._ensure_vdw_caps()
    gen = torch.Generator(device=cuda).manual_seed(5)
    xs = [(sim.positions + 1e-3 * torch.randn(
        sim.positions.shape, generator=gen, dtype=sim.dtype,
        device=cuda))[None] for _ in range(3)]

    def build(p):
        return sim._window_build(p, ff, caps, 0.5, None)

    held = graphs.BuildGraph()
    for x in xs[:2]:
        held(build, x)
    assert held.replayed
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = held(build, xs[2])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same(build(xs[2]), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(neighbor_every=NE),
                                dict(dt=0.004, mts_inner=2,
                                     neighbor_every=10)],
                         ids=["plain", "mts4fs"])
def test_graphed_build_run_md_is_the_eager_one(cuda, kw):
    """run_md over four windows of 1li2 (the plain step; the 4 fs
    protocol, constrained): the build eager in the first window and
    captured after it, replayed in the other three, bitwise the run with
    eager builds and eager steps."""
    cons = "mts_inner" in kw
    sim = _card_sim(cuda, "1li2", constraints=cons)
    every = kw["neighbor_every"]

    def md():
        out = sim.run_md(4 * every, report_interval=every, **kw,
                         generator=torch.Generator(device=cuda).manual_seed(6))
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows", "tree_counts_max")}

    with _eager():
        md()
    PR.reset()
    with PR.record():
        graphed = md()
        torch.cuda.synchronize()
    rec = PR.recorded()
    PR.reset()
    with _eager():
        eager = md()
    assert graphed["regrows"] == 0
    _same(eager, graphed)
    assert (_counts(rec, "window.build_capture"),
            _counts(rec, "window.build_replay")) == (1, 3)


MTS_NE = 10  # the 4 fs protocol's rebuild window, in outer steps
MTS = dict(dt=0.004, mts_inner=2, neighbor_every=MTS_NE)


def _mts_make(sim, ff):
    """(make, build) as _window_make's for the 4 fs protocol's step: the
    r-RESPA MTS step (mts_inner=2) with sim's constraints."""
    _, build = _window_make(sim, ff, 1)

    def make(inputs):
        _, pairs, topo, vt = inputs
        slow, fast = sim.force_fn(pairs=pairs, topology=topo, ff=ff,
                                  split=True, vdw_topology=vt)
        return graphs.every_step(mts_langevin_step(
            slow, fast, sim.masses, 0.004, 300.0, 1.0, 2,
            constraints=sim.constraints))

    return make, build


@pytest.mark.cuda
def test_graphed_mts_windows_are_the_eager_windows(cuda):
    """The 4 fs protocol on 1li2 (r-RESPA, mts_inner=2, the X-H
    constraints on the star path): a runner's two whole 10-step windows,
    the first capturing its step and the second replaying it, and a
    1-step remainder window, eager: bitwise the eager runner, the
    windows' SHAKE residual included, with the same launch tallies."""
    sim = _card_sim(cuda, "1li2", constraints=True)
    sim.run_md(4 * MTS_NE, report_interval=MTS_NE, **MTS)
    run = sim.make_langevin_runner(**MTS)

    def windows():
        return run(sim.positions, sim.velocities, 2 * MTS_NE + 1,
                   generator=torch.Generator(device=cuda).manual_seed(7))

    r0, r1, n0, n1, g1 = _both(windows)
    _same(r0, r1)
    shake = r1[3].shake
    assert shake is not None and 0 < float(shake) <= \
        sim.constraints.tolerance(torch.float32)
    assert not sim.overflow_report(*r1[3])
    assert n1 == n0 and n0["tree_rescan"] > 0
    assert g1 == (1, 2 * MTS_NE - 1, 1)


@pytest.mark.cuda
def test_graphed_mts_run_md_is_the_eager_one(cuda):
    """run_md of the 4 fs protocol over four windows at capacities an
    eager run grew: graphed, bitwise the eager run; the graph captured
    once, every window after the first a reuse; one packed host read a
    window besides run_md's energies and frame; two md.mts_substep
    counters and 2 x the sweeps of constraints.shake_sweeps a step."""
    sim = _card_sim(cuda, "1li2", constraints=True)

    def md():
        out = sim.run_md(4 * MTS_NE, report_interval=MTS_NE,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(4), **MTS)
        return {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows",
                                    "tree_counts_max")}

    with _eager():
        md()
    PR.reset()
    with PR.record():
        r1 = md()
    rec = PR.recorded()
    PR.reset()
    with _eager():
        r0 = md()
    assert r0["regrows"] == 0
    _same(r0, r1)
    assert bool(np.isfinite(r1["energies"]).all())
    assert (_counts(rec, "md.graph_capture"), _counts(rec, "md.graph_reuse"),
            _counts(rec, "md.graph_replay")) == (1, 3, 4 * MTS_NE - 1)
    steps = 4 * MTS_NE
    assert sum(sp["name"] == "md.step" for sp in rec["spans"]) == steps
    assert _counts(rec, "md.mts_substep") == 2 * steps
    assert _counts(rec, "constraints.shake_sweeps") == \
        2 * steps * sim.constraints.sweeps
    assert _counts(rec, "host_read") == 3 * 4
    viol = float(sim.constraints.max_violation(
        torch.as_tensor(r1["final_pos"]).double()))
    assert viol <= sim.constraints.tolerance(torch.float32)


@pytest.mark.cuda
def test_kept_mts_window_makes_no_host_sync(cuda):
    """A runner's second window of the 4 fs protocol on 1li2 from its
    build's end to its last step under set_sync_debug_mode("error"): the
    build copied into the first window's slots, every step a replay;
    bitwise the eager window, its SHAKE residual included."""
    sim = _card_sim(cuda, "1li2", constraints=True)
    make, build = _mts_make(sim, sim.ff_state())
    pos, vel = sim.positions, sim.velocities
    gen = torch.Generator(device=cuda).manual_seed(2)
    noise = [torch.randn((2,) + tuple(pos.shape), generator=gen,
                         dtype=pos.dtype, device=cuda)
             for _ in range(2 * MTS_NE)]
    held = graphs.WindowGraphs()
    p1, v1, *_ = graphs.window_steps(make, build(pos), pos, vel, MTS_NE,
                                     iter(noise[:MTS_NE]).__next__, held)
    inputs = build(p1)
    torch.cuda.synchronize()
    PR.reset()
    with PR.record():
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = graphs.window_steps(make, inputs, p1, v1, MTS_NE,
                                      iter(noise[MTS_NE:]).__next__, held)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    rec = PR.recorded()
    PR.reset()
    torch.cuda.synchronize()
    assert (_counts(rec, "md.graph_reuse"), _counts(rec, "md.graph_replay"),
            _counts(rec, "md.graph_capture")) == (1, MTS_NE, 0)
    want = graphs.window_steps(make, inputs, p1, v1, MTS_NE,
                               iter(noise[MTS_NE:]).__next__)
    assert got[4] is not None
    _same(want, got)


@pytest.mark.cuda
def test_shake_regrow_takes_new_graphs(cuda):
    """1li2 under the 4 fs protocol with one SHAKE sweep, too few: the
    first window misses the tolerance, run_md gives SHAKE more sweeps and
    reruns the window with a new runner, which captures its graph anew
    with the new sweep count; bitwise the eager run of the same."""
    def md():
        sim = _card_sim(cuda, "1li2", constraints=True)
        sim.constraints.sweeps = 1
        PR.reset()
        with PR.record():
            out = sim.run_md(3 * MTS_NE, report_interval=MTS_NE,
                             generator=torch.Generator(device=cuda)
                             .manual_seed(5), **MTS)
        rec = PR.recorded()
        PR.reset()
        keep = {k: out[k] for k in ("final_pos", "final_vel", "energies",
                                    "frames", "regrows")}
        return keep, rec, sim.constraints.sweeps

    with _eager():
        r0, rec0, sweeps0 = md()
    r1, rec, sweeps = md()
    _same(r0, r1)
    assert r1["regrows"] >= 1 and sweeps == sweeps0 > 1
    runners = 1 + r1["regrows"]
    assert _counts(rec, "md.graph_capture") == runners
    # a step's sweeps, by window: the first runner's 1 a SHAKE call, the
    # last runner's the regrown count
    parent = {sp["id"]: sp["parent"] for sp in rec["spans"]}
    windows = [sp["id"] for sp in rec["spans"] if sp["name"] == "md.window"]
    by_window = dict.fromkeys(windows, 0)
    for c in rec["counts"]:
        if c["name"] == "constraints.shake_sweeps":
            at = c["span"]
            while at not in by_window:
                at = parent[at]
            by_window[at] += c["n"]
    assert by_window[windows[0]] == MTS_NE * 2 * 1
    assert by_window[windows[-1]] == MTS_NE * 2 * sweeps
    assert _counts(rec0, "constraints.shake_sweeps") == \
        _counts(rec, "constraints.shake_sweeps")


def _window_step(sim):
    """The plain Langevin step of a window from sim's positions: AGBNP1 on
    window_build's topologies, AGBNP2 on _v2_build's."""
    ff = sim.ff_state()
    pos = sim.positions
    if sim.agbnp2 is not None:
        pairs, topo = sim._v2_build(pos, ff)
        fn = sim.force_fn(pairs=pairs, topology=topo, ff=ff)
    else:
        pairs, topo, vt, _ = sim.window_build(pos[None], ff,
                                              sim._ensure_vdw_caps())
        fn = sim.force_fn(pairs=pairs, topology=topo, ff=ff,
                          vdw_topology=vt)
    return langevin_middle_step(fn, sim.masses, 0.001, 300.0, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("version", [1, 2])
def test_graphed_step_makes_no_host_sync(cuda, version):
    sim = _card_sim(cuda, "1li2", version)
    pos, vel = sim.positions, sim.velocities
    step = _window_step(sim)
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
    _same(tuple(want), tuple(got))
