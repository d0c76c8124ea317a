"""The port's recorder (utils/profiling.py): spans and counters of the MD
loop, the scorer and the evaluation, their clock against torch.profiler's,
and the benchmark's readers of them (portbench/metrics/).

CPU tests on trp-cage (272 atoms, benchmarks/data/trpcage_agbnp1.dms) with
2-step rebuild windows; the `cuda` test runs on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_profiling.py
"""

import collections
import importlib.util
import os

import numpy as np
import pytest
import torch

from openmm_agbnp_plugin_tpu_torch import AGBNPForce, ConformerScorer, \
    Simulation, load_dms
from openmm_agbnp_plugin_tpu_torch.models.capacity import V2
from openmm_agbnp_plugin_tpu_torch.ops import tree as T
from openmm_agbnp_plugin_tpu_torch.utils import profiling as PR

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DMS = os.path.join(ROOT, "benchmarks", "data", "trpcage_agbnp1.dms")
CAPS = ((3840, 8192, 7424, 3840, 1408, 384, 256), (48, 32, 24, 16, 8, 4))
KW = dict(version=1, cutoff=1.0, skin=0.25, descreen_horizon="cutoff")
EVERY = 2
# the kineto clock against time.time_ns(): ns of slack either way
SLACK_NS = 50_000

# host reads of one rebuild window of run_md(report_interval=EVERY), site by
# site: the window's one read of its diagnostics (whose verdict run_md
# takes), then run_md's energies and frame
WINDOW_READS = {"window.diag": 1}
RUN_MD_READS = {"run_md.energies": 1, "run_md.frame": 1}


def _sim():
    return Simulation(load_dms(DMS), device="cpu", dtype=torch.float64,
                      caps=T.TreeCaps(*CAPS), **KW)


@pytest.fixture(scope="module")
def md_record():
    """A two-window run_md of trp-cage, recorded."""
    sim = _sim()
    PR.reset()
    with PR.record():
        sim.run_md(2 * EVERY, neighbor_every=EVERY, report_interval=EVERY,
                   generator=torch.Generator().manual_seed(0))
    rec = PR.recorded()
    PR.reset()
    return sim, rec


def _children(rec, sid):
    return [s for s in rec["spans"] if s["parent"] == sid]


def test_spans_nest_with_parent_and_request(md_record):
    _, rec = md_record
    assert rec["dropped"] == 0
    byid = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = byid[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]
            assert s["request"] == p["request"]
    roots = [s["name"] for s in rec["spans"] if s["parent"] is None]
    assert roots.count("md.runner_setup") == 1
    windows = sorted((s for s in rec["spans"] if s["name"] == "md.window"),
                     key=lambda s: s["start_ns"])
    assert [w["request"] for w in windows] == [0, 1]
    for w in windows:
        assert w["parent"] is None
        kids = collections.Counter(s["name"]
                                   for s in _children(rec, w["id"]))
        assert kids == {"window.build": 1, "md.step": EVERY,
                        "md.host_read": 1}
        build = next(s for s in _children(rec, w["id"])
                     if s["name"] == "window.build")
        assert sorted(s["name"] for s in _children(rec, build["id"])) == [
            "window.compact", "window.neighbors", "window.tree_build"]
        for step in (s for s in _children(rec, w["id"])
                     if s["name"] == "md.step"):
            assert sorted(s["name"] for s in _children(rec, step["id"])) \
                == ["eval.mm", "eval.pairs", "eval.tree", "eval.wu"]
        read = next(s for s in _children(rec, w["id"])
                    if s["name"] == "md.host_read")
        # the window's one read, with no span of its own inside
        assert not _children(rec, read["id"])


def test_host_reads_of_a_window_site_by_site(md_record):
    _, rec = md_record
    reads = [c for c in rec["counts"] if c["name"] == "host_read"]
    assert all(c["n"] == 1 for c in reads)
    for k in (0, 1):
        got = collections.Counter(c["site"] for c in reads
                                  if c["request"] == k)
        assert got == WINDOW_READS
    want = collections.Counter()
    for _ in range(2):
        want.update(WINDOW_READS)
        want.update(RUN_MD_READS)
    assert collections.Counter(c["site"] for c in reads) == want
    assert sum(want.values()) == 2 * 3


def test_replica_window_reads_its_diagnostics_once():
    """A ReplicaEnsemble window of R = 2 replicas makes one host read of
    its diagnostics, every replica's at once, in its md.host_read span."""
    from openmm_agbnp_plugin_tpu_torch import ReplicaEnsemble

    ens = ReplicaEnsemble(_sim(), 2)
    run = ens.make_runner(neighbor_every=EVERY)
    states = ens.initial_states(jitter=1e-3, seed=4)
    PR.reset()
    with PR.record():
        _, (energies, *diag) = run(states, 2 * EVERY)
    rec = PR.recorded()
    PR.reset()
    assert energies.shape == (2, 2 * EVERY)
    windows = [s for s in rec["spans"] if s["name"] == "md.window"]
    assert len(windows) == 2
    reads = [c for c in rec["counts"] if c["name"] == "host_read"]
    for w in windows:
        assert [c["site"] for c in reads
                if c["request"] == w["request"]] == ["window.diag"]
        assert collections.Counter(s["name"] for s in _children(
            rec, w["id"]))["md.host_read"] == 1
    assert len(reads) == 2


def test_tree_rows_are_tree_stats_counts_and_caps(md_record):
    """Window 0's rows are its build's at the DMS positions; the scorer's
    are its batch's, summed over poses."""
    sim, rec = md_record
    rows = {(c["name"], c["request"]): c["n"] for c in rec["counts"]
            if c["name"].startswith("tree.")}
    assert set(rows) == {(n, k) for n in ("tree.rows_valid", "tree.rows_cap")
                         for k in (0, 1)}
    _, _, _, (counts, *_) = sim.window_build(sim.positions[None],
                                             sim.ff_state(),
                                             sim._ensure_vdw_caps())
    stats = PR.tree_stats(dict(counts=counts,
                               caps=np.asarray([sim.agbnp.caps.caps])))
    assert rows["tree.rows_valid", 0] == stats["counts"].sum() > 0
    assert rows["tree.rows_cap", 0] == stats["caps"].sum() == sum(CAPS[0])

    dms = load_dms(DMS)
    force = AGBNPForce()
    for i in range(len(dms.positions)):
        force.addParticle(dms.agbnp_radius[i], dms.agbnp_gamma[i],
                          dms.agbnp_alpha[i], dms.charges[i],
                          bool(dms.ishydrogen[i]))
    scorer = ConformerScorer(force, dms.positions, dtype=torch.float64,
                             device="cpu")
    poses = np.asarray(dms.positions)[None] + 0.01 * np.random.default_rng(
        3).standard_normal((3, *np.shape(dms.positions)))
    PR.reset()
    with PR.record():
        scorer.score(poses)
    rec = PR.recorded()
    PR.reset()
    out = scorer.model.batched_energy_forces(torch.as_tensor(poses))
    stats = PR.tree_stats(out["diag"])
    got = {c["name"]: c["n"] for c in rec["counts"]
           if c["name"].startswith("tree.")}
    assert got == {"tree.rows_valid": stats["counts"].sum(),
                   "tree.rows_cap": stats["caps"].sum()}
    call = [s for s in rec["spans"] if s["name"] == "score.call"]
    assert len(call) == 1 and call[0]["request"] == 0
    assert {s["name"] for s in _children(rec, call[0]["id"])} >= {
        "eval.tree", "eval.pairs", "eval.wu", "score.host_read"}
    assert all(c["request"] == 0 for c in rec["counts"])


def test_off_records_nothing_and_returns_the_shared_noop():
    PR.reset()
    assert not PR.active()
    a, b = PR.span("a"), PR.span("b", request=3)
    assert a is b
    with a:
        PR.count("host_read", site="x")
    assert PR.recorded() == dict(spans=[], counts=[], dropped=0)


def test_recording_follows_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    PR.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert PR.active()
        with PR.span("inside", request=7):
            PR.count("c", 2, site="s")
    assert not PR.active()
    with PR.span("after"):
        PR.count("c")
    rec = PR.recorded()
    PR.reset()
    assert [(s["name"], s["request"]) for s in rec["spans"]] == [
        ("inside", 7)]
    assert [(c["name"], c["n"], c["site"], c["request"])
            for c in rec["counts"]] == [("c", 2, "s", 7)]


def test_buffer_is_bounded():
    rec = PR.Recorder(limit=3)
    for k in range(5):
        rec.keep(rec.counts, dict(k=k))
    assert [c["k"] for c in rec.counts] == [0, 1, 2] and rec.dropped == 2


def _kineto(prof):
    """(name, on the device, start ns, end ns) of every traced event."""
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        yield (ev.name(), "CUDA" in str(ev.device_type()), start,
               start + ev.duration_ns())


def _inside(ev, sp):
    return (sp["start_ns"] - SLACK_NS <= ev[2]
            and ev[3] <= sp["end_ns"] + SLACK_NS)


def test_span_clock_is_the_profilers():
    """Every aten event a program span wraps lies inside the span, and an
    evaluation's aten events fall inside its eval spans."""
    from torch.profiler import ProfilerActivity, profile

    sim = _sim()
    fn = sim.force_fn()
    x = torch.randn(64, 64, dtype=torch.float64)
    PR.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(20):
            with PR.span("probe", request=k):
                with torch.profiler.record_function(f"probe{k}"):
                    torch.mm(x, x).sum()
        fn(sim.positions)
    rec = PR.recorded()
    PR.reset()
    events = list(_kineto(prof))
    probes = {s["request"]: s for s in rec["spans"] if s["name"] == "probe"}
    for k in range(20):
        (ev,) = [e for e in events if e[0] == f"probe{k}"]
        assert _inside(ev, probes[k])
    mm = sorted((e for e in events if e[0] == "aten::mm"),
                key=lambda e: e[2])
    assert len(mm) >= 20
    for k, ev in enumerate(mm[:20]):
        assert _inside(ev, probes[k])
    tree = [s for s in rec["spans"] if s["name"] == "eval.tree"]
    assert len(tree) == 1
    inside = [e for e in events if e[0].startswith("aten::")
              and e[2] >= tree[0]["start_ns"] and e[3] <= tree[0]["end_ns"]]
    assert len(inside) > 100


@pytest.mark.cuda
def test_span_ending_in_synchronize_holds_its_kernels():
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    x = torch.randn(2048, 2048, device="cuda")
    (x @ x).sum()
    torch.cuda.synchronize()
    PR.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with PR.span("gpu"):
            for _ in range(10):
                y = torch.relu(x @ x)
            y.sum()
            torch.cuda.synchronize()
        torch.cuda.synchronize()
    rec = PR.recorded()
    PR.reset()
    (sp,) = rec["spans"]
    dev = [e for e in _kineto(prof) if e[1]]
    assert len(dev) >= 20
    for ev in dev:
        assert _inside(ev, sp), ev


# --- the benchmark's readers ------------------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(sid, name, start, end, parent=None, request=0):
    return dict(id=sid, name=name, start_ns=start, end_ns=end,
                parent=parent, request=request)


# a window [0, 1000] ns: its build, a step with the evaluation's phases,
# its read; the gaps' starts fall in window.build (50 ns), eval.tree (40),
# eval.wu (20), eval.pairs (30), md.step's own work (90), md.host_read
# (30) and no span (40)
HAND_SPANS = [
    _span(0, "md.window", 0, 1000),
    _span(1, "window.build", 0, 200, 0),
    _span(2, "md.step", 200, 900, 0),
    _span(3, "eval.tree", 250, 400, 2),
    _span(4, "eval.wu", 400, 450, 2),
    _span(5, "eval.pairs", 450, 600, 2),
    _span(6, "md.host_read", 900, 1000, 0),
]
HAND_OPS = [("k", 0, 50), ("k", 10, 40), ("k", 100, 260), ("k", 300, 420),
            ("k", 440, 470), ("k", 500, 610), ("k", 700, 950),
            ("k", 980, 1050), ("k", 1090, 1100)]
HAND_COUNTS = ([dict(name="host_read", n=1, site="s")] * 5
               + [dict(name="tree.rows_valid", n=30),
                  dict(name="tree.rows_cap", n=100),
                  dict(name="tree.rows_valid", n=50),
                  dict(name="tree.rows_cap", n=100)])
# untraced 0.1 s a step against 0.2 s traced: half the slice's idle
DATA = dict(device_ops=HAND_OPS, slice_units=2, units=10, timed_s=1.0,
            slice_s=0.4)


@pytest.mark.parametrize("name,kind,want", [
    ("device.idle_ms.tree", "md", 60e-6 / 2 * 0.5),
    ("device.idle_ms.pairs", "md", 30e-6 / 2 * 0.5),
    ("device.idle_ms.window", "md", 80e-6 / 2 * 0.5),
    ("md.host_reads_per_window", "md", 5.0),
    ("tree.row_fill_pct.md", "md", 40.0),
    ("tree.row_fill_pct.score", "score", 40.0),
])
def test_metric_readers(monkeypatch, name, kind, want):
    mod = _reader(name)
    hand = dict(spans=HAND_SPANS, counts=HAND_COUNTS, dropped=0)
    monkeypatch.setattr(PR, "recorded", lambda: hand)
    assert mod.read(dict(DATA, kind=kind)) == pytest.approx(want, rel=1e-12)
    other = "score" if kind == "md" else "md"
    assert mod.read(dict(DATA, kind=other)) is None
    monkeypatch.setattr(PR, "recorded",
                        lambda: dict(spans=[], counts=[], dropped=0))
    assert mod.read(dict(DATA, kind=kind)) is None


def test_comm_log_is_a_tap_of_the_recorder():
    x = torch.zeros(4, 3, dtype=torch.float32)
    PR.reset()
    T.record_comm("psum", x, 2)
    log = T.start_comm_log()
    with PR.record():
        T.record_comm("all_gather", x, 2)
    T.record_comm("psum", x[0], 2)
    assert T.stop_comm_log() is log
    T.record_comm("psum", x, 2)
    assert [(e["kind"], e["shape"], e["dtype"], e["bytes"], e["ndev"])
            for e in log] == [("all_gather", (4, 3), "float32", 48, 2),
                              ("psum", (3,), "float32", 12, 2)]
    rec = PR.recorded()
    PR.reset()
    assert [(c["name"], c["n"]) for c in rec["counts"]] == [
        ("comm.all_gather", 48)]


# --- AGBNP2 (version 2) windows -----------------------------------------

# host reads of one AGBNP2 window of run_md(report_interval=EVERY), site by
# site: the window's one read of its diagnostics (the ms.* and ms_tree.*
# counters ride it), then run_md's energies and frame
V2_WINDOW_READS = {"window.diag": 1}
V2_RUN_MD_READS = {"run_md.energies": 1, "run_md.frame": 1}


@pytest.fixture(scope="module")
def v2_record():
    """A two-window run_md of trp-cage in AGBNP2, recorded, after a window
    that grows the MS capacities (so the recorded run retries none)."""
    sim = Simulation(load_dms(DMS), device="cpu", version=2, cutoff=1.0,
                     dtype=torch.float64)
    sim.run_md(EVERY, neighbor_every=EVERY,
               generator=torch.Generator().manual_seed(1))
    PR.reset()
    with PR.record():
        out = sim.run_md(2 * EVERY, neighbor_every=EVERY,
                         report_interval=EVERY,
                         generator=torch.Generator().manual_seed(0))
    rec = PR.recorded()
    PR.reset()
    assert out["regrows"] == 0
    return sim, rec


def test_v2_window_spans(v2_record):
    """A window: its build (MS candidates, both trees and the MS
    compaction), then steps whose evaluation records the atomic tree, the
    MS stage, the pair phases (each forward and its reverse rule) and the
    MM terms."""
    _, rec = v2_record
    assert rec["dropped"] == 0
    windows = [s for s in rec["spans"] if s["name"] == "md.window"]
    # the warm-up took window 0
    assert [w["request"] for w in windows] == [1, 2]
    for w in windows:
        kids = collections.Counter(s["name"]
                                   for s in _children(rec, w["id"]))
        assert kids == {"window.build": 1, "md.step": EVERY,
                        "md.host_read": 1}
        build = next(s for s in _children(rec, w["id"])
                     if s["name"] == "window.build")
        assert [s["name"] for s in _children(rec, build["id"])] == [
            "window.ms_candidates", "window.tree_build"]
        assert not _children(rec, _children(rec, build["id"])[1]["id"])
        for step in (s for s in _children(rec, w["id"])
                     if s["name"] == "md.step"):
            assert collections.Counter(
                s["name"] for s in _children(rec, step["id"])) == {
                "eval.tree": 2, "eval.ms": 2, "eval.pairs": 2, "eval.mm": 1}


def test_v2_ms_counters_are_the_window_vector(v2_record):
    """ms.* and ms_tree.* of the recorded run's first window (request 1)
    are its build's 18-entry vector at the DMS positions against the
    capacities; the reads are as many as before the counters, site by
    site."""
    sim, rec = v2_record
    got = {(c["name"], c["request"]): c["n"] for c in rec["counts"]
           if c["name"].startswith("ms")}
    names = ("ms.particles_valid", "ms.particles_cap", "ms_tree.rows_valid",
             "ms_tree.rows_cap")
    assert set(got) == {(n, k) for n in names for k in (1, 2)}
    _, (_, counts) = sim._v2_build(sim.positions)
    m2 = sim.agbnp2
    assert got["ms.particles_valid", 1] == int(counts[V2.MS_COUNT]) > 0
    assert got["ms.particles_cap", 1] == m2.cap_ms
    assert got["ms_tree.rows_valid", 1] == int(counts[V2.MS_TREE].sum()) > 0
    assert got["ms_tree.rows_cap", 1] == sum(m2.caps_ms.caps)
    reads = [c for c in rec["counts"] if c["name"] == "host_read"]
    for k in (1, 2):
        assert collections.Counter(c["site"] for c in reads
                                   if c["request"] == k) == V2_WINDOW_READS
    want = collections.Counter()
    for _ in range(2):
        want.update(V2_WINDOW_READS)
        want.update(V2_RUN_MD_READS)
    assert collections.Counter(c["site"] for c in reads) == want


# HAND_SPANS with AGBNP2's MS stage where the WU pass was (20 ns of idle)
V2_HAND_SPANS = [dict(s, name="eval.ms") if s["name"] == "eval.wu" else s
                 for s in HAND_SPANS]
V2_HAND_COUNTS = [dict(name="ms.particles_valid", n=30),
                  dict(name="ms.particles_cap", n=100),
                  dict(name="ms.particles_valid", n=50),
                  dict(name="ms.particles_cap", n=100),
                  dict(name="ms_tree.rows_valid", n=5),
                  dict(name="ms_tree.rows_cap", n=200),
                  dict(name="ms_tree.rows_valid", n=15),
                  dict(name="ms_tree.rows_cap", n=200)]


@pytest.mark.parametrize("name,want", [
    ("device.idle_ms.ms", 20e-6 / 2 * 0.5),
    ("ms.particle_fill_pct", 40.0),
    ("ms_tree.row_fill_pct", 5.0),
])
def test_ms_metric_readers(monkeypatch, name, want):
    """The MS stage's readers; None on a record without AGBNP2 (no eval.ms
    span, no ms counters: the recording of versions 0 and 1)."""
    mod = _reader(name)
    hand = dict(spans=V2_HAND_SPANS, counts=HAND_COUNTS + V2_HAND_COUNTS,
                dropped=0)
    monkeypatch.setattr(PR, "recorded", lambda: hand)
    assert mod.read(dict(DATA, kind="md")) == pytest.approx(want, rel=1e-12)
    assert mod.read(dict(DATA, kind="score")) is None
    v1 = dict(spans=HAND_SPANS, counts=HAND_COUNTS, dropped=0)
    monkeypatch.setattr(PR, "recorded", lambda: v1)
    assert mod.read(dict(DATA, kind="md")) is None
