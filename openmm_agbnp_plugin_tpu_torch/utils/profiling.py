"""Profiling and observability helpers.

The reference's observability is verbose_level couts of per-term energies
and per-section iteration counts (reference ReferenceAGBNPKernels.cpp:328-352,
OpenCLAGBNPKernels.cpp:3649-3665).  The equivalents here:
  * energy_breakdown: per-term energies from the pipeline's details dict
  * tree_stats: per-level occupancy vs capacity (the NIterations analogue)
  * the recorder: the program's own spans and counters (span, count,
    host_read, count_tree_rows; record, recorded, reset; tap for the
    collective log of ops/tree.py)
  * trace: torch.profiler wrapper writing a TensorBoard trace and, beside
    it, the program's spans as program_spans.json

The recorder.  `span(name, request=None)` marks a phase of the host's work
(name, start, end, the enclosing span and a request id: the rebuild
window's index in MD, the call's index in the scorer; a span without one
takes its parent's), `count(name, n=1, site=None)` a counter.  Both land in
one bounded in-memory buffer that `recorded()` returns and `reset()`
clears.  Recording is on while a torch.profiler session is active, so a
profiled block gets the program's spans with no switch of its own, and
inside `record()`.  Off, `span` costs one flag check and one
torch.autograd._profiler_enabled() check and returns a shared no-op
context.  The recorder never touches the device and opens no profiler
range of its own (a range would also be drawn on the device timeline):
it adds no kernel, no event and no device read.  Spans are
stamped with time.time_ns(), the Unix-epoch clock that torch.profiler
reports its events on (kineto_results.events()' start_ns()), so a device
idle gap in a trace can be put down to the span the host was in.

Spans and counters the package records:

  md.runner_setup   make_langevin_runner's and ReplicaEnsemble.make_runner's
                    set-up (ff_state, the WU-compact caps)
  md.window         a rebuild window (request: the Simulation's window
                    index), in the Langevin and replica runners
  md.step           one integrator step of a window (each step of a WU
                    impulse window too)
  md.graph_capture  span: the capture of a step kind into a CUDA graph
                    (md/graphs.py), inside that step's md.step; counter:
                    one a capture (once a step kind a runner)
  md.graph_replay   counter: one step of a window run as a replay of its
                    graph
  md.graph_reuse    counter: one a window that replays the graphs of an
                    earlier window of its runner, its build copied into
                    the graphs' inputs
  md.wu_impulse     counter: one WU impulse step (md/integrators.py::
                    wu_impulse_langevin_steps; a replay counts it again)
  md.mts_substep    counter: one fast substep of an r-RESPA MTS step
                    (md/integrators.py; a replay counts it again)
  md.shake          SHAKE (md/constraints.py Constraints.shake)
  md.rattle         RATTLE (Constraints.velocities)
  constraints.shake_sweeps
                    counter: a SHAKE call's sweeps, as its n (the star
                    path's fixed Newton sweeps; a replay counts it again)
  md.host_read      WindowDiag.read (models/capacity.py: a window's one
                    read; worst_replica, overflow_report, _regrow given
                    device tensors), run_md's energies and frames
  window.build      Simulation.window_build, with window.neighbors,
                    window.tree_build and window.compact inside; an AGBNP2
                    window's build (_v2_build), with window.ms_candidates
                    and window.tree_build (both trees, the MS compaction)
  eval.tree         the tree passes (tree_passes; AGBNP2's atomic passes
                    and their reverse rule)
  eval.ms           AGBNP2's MS stage: the MS particles, their free
                    volumes, both MS tree passes and their reverse rule,
                    the self volumes returned to the parents
  eval.pairs        the pair phases (kernel, plain or sharded route; with
                    AGBNP2's reverse rule)
  eval.wu           the WU gamma-rescan force pass
  eval.mm           the MM terms the pair sweeps do not carry
  eval.fast         the fast class of an MTS step: the bonded and 1-4
                    terms (force_fn(split=True)'s fast_fn)
  score.call        ConformerScorer.score (request: the scorer's call index)
  score.host_read   the scorer's read of the batch's diagnostics
  host_read         counter: one blocking device-to-host read, with its site
  tree.rows_valid   counter: the overlap tree's valid rows of an evaluation,
  tree.rows_cap     and its capacity rows, summed over levels and replicas
  ms.particles_valid, ms.particles_cap
                    counters: an AGBNP2 window's MS particles and cap_ms
  ms_tree.rows_valid, ms_tree.rows_cap
                    counters: its MS tree's valid and capacity rows,
                    summed over levels (both at the window's read)
  tree.kernel       counter: one launch of a fixed-topology tree kernel
                    (ops/kernels/tree.py), site rescan, reduce or deposit
  comm.<kind>       counter: one collective of the sharded passes (its bytes;
                    ops/tree.py's comm log)
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
import threading
import time

import numpy as np
import torch

_profiler_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()


def energy_breakdown(details: dict) -> dict:
    """Scalar energy terms from an energy_forces(with_details=True) output's
    details."""
    out = {}
    for key in ("e_vol1", "e_vol2", "e_cav", "gb_self", "gb_pair", "e_vdw"):
        if key in details:
            out[key] = float(details[key])
    return out


def tree_stats(diag) -> dict:
    """Per-level occupancy diagnostics (overlap counts vs capacities), as
    numpy arrays on the host; max_siblings where the diag has them."""
    def host(x):
        return np.asarray(torch.as_tensor(x).cpu())

    counts = host(diag["counts"])
    caps = host(diag["caps"])
    out = dict(counts=counts, caps=caps,
               occupancy=counts / np.maximum(caps, 1))
    if "max_siblings" in diag:
        out["max_siblings"] = host(diag["max_siblings"])
    return out


class Recorder:
    """The buffer of spans and counters (one per process: the module's
    functions below act on it).  At most `limit` records are kept; later
    ones are counted in `dropped`."""

    def __init__(self, limit: int = 1 << 16):
        self.limit = limit
        self.depth = 0          # open record() blocks
        self.taps = []          # [(name prefix, live list)]
        self.spans, self.counts, self.dropped = [], [], 0
        self.held = None        # hold()'s list while a block holds counters
        self._ids = itertools.count()
        self._local = threading.local()

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def keep(self, buf: list, item: dict):
        if len(self.spans) + len(self.counts) < self.limit:
            buf.append(item)
        else:
            self.dropped += 1


_REC = Recorder()


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start")

    def __init__(self, name, request):
        self.name, self.request = name, request

    def __enter__(self):
        st = _REC.stack()
        outer = st[-1] if st else None
        self.parent = None if outer is None else outer.id
        if self.request is None and outer is not None:
            self.request = outer.request
        self.id = next(_REC._ids)
        st.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _REC.stack().pop()
        _REC.keep(_REC.spans, dict(name=self.name, start_ns=self.start,
                                   end_ns=end, id=self.id,
                                   parent=self.parent,
                                   request=self.request))
        return False


def span(name: str, request=None):
    """A context manager that records a span of the host's work while
    recording is on, and is a shared no-op otherwise."""
    if not _REC.depth and not _profiler_enabled():
        return _NOOP
    return _Span(name, request)


def active() -> bool:
    """Whether a counter would be kept now (recording, or a tap open)."""
    return bool(_REC.depth or _REC.taps or _profiler_enabled())


def count(name: str, n=1, site=None, **detail):
    """Record counter `name` (n: its amount; site: where in the code;
    detail: further fields of the record).  Kept in the buffer while
    recording is on, and in every open tap whose prefix starts `name`;
    inside hold(), kept in its list instead."""
    if _REC.held is not None:
        _REC.held.append((name, n, site, detail))
        return
    on = _REC.depth or _profiler_enabled()
    if not on and not _REC.taps:
        return
    taps = [buf for prefix, buf in _REC.taps if name.startswith(prefix)]
    if not on and not taps:
        return
    st = _REC.stack()
    item = dict(detail, name=name, n=n, site=site, t_ns=time.time_ns(),
                span=st[-1].id if st else None,
                request=st[-1].request if st else None)
    for buf in taps:
        buf.append(item)
    if on:
        _REC.keep(_REC.counts, item)


@contextlib.contextmanager
def hold():
    """Counters made inside the block go to the list it yields, not to
    the buffer or a tap: a CUDA graph's capture counts the launches it
    records, which run only when it is replayed (count_again)."""
    outer, _REC.held = _REC.held, []
    try:
        yield _REC.held
    finally:
        _REC.held = outer


def count_again(held: list):
    """Make the counters a hold() block held, now."""
    if active():
        for name, n, site, detail in held:
            count(name, n, site, **detail)


def host_read(x, site: str):
    """x on the host as a numpy array.  A tensor is copied from its device
    (a blocking read on a card) and counted as `host_read` at `site`;
    anything else is taken as it is."""
    if isinstance(x, torch.Tensor):
        count("host_read", site=site)
        x = x.detach().cpu()
    return np.asarray(x)


def count_tree_rows(diag):
    """tree.rows_valid and tree.rows_cap of one evaluation from a diag's
    counts and caps already on the host ([..., 7] per level, a leading
    replica axis summed; tree_stats' arithmetic)."""
    if not active():
        return
    s = tree_stats(diag)
    count("tree.rows_valid", int(s["counts"].sum()))
    count("tree.rows_cap", int(s["caps"].sum()))


@contextlib.contextmanager
def record():
    """Record spans and counters inside the block (also without a
    profiler)."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def recorded() -> dict:
    """What the buffer holds: dict(spans=[dict(name, start_ns, end_ns, id,
    parent, request)], counts=[dict(name, n, site, t_ns, span, request,
    ...)], dropped=records past the limit)."""
    return dict(spans=list(_REC.spans), counts=list(_REC.counts),
                dropped=_REC.dropped)


def reset():
    """Clear the buffer."""
    _REC.spans, _REC.counts, _REC.dropped = [], [], 0


def tap(prefix: str) -> list:
    """A live list that receives every counter whose name starts with
    prefix from now on, recording or not, until untap(list)."""
    buf = []
    _REC.taps.append((prefix, buf))
    return buf


def untap(buf: list):
    _REC.taps = [t for t in _REC.taps if t[1] is not buf]


def _chrome_events(rec: dict, base_ns: int) -> list:
    """The recorded spans as Chrome trace complete events and the counters
    as instant events, timestamps in µs from base_ns (the
    baseTimeNanoseconds of torch.profiler's own trace)."""
    pid, tid = os.getpid(), threading.get_ident()
    out = [dict(ph="X", name=s["name"], cat="program", pid=pid, tid=tid,
                ts=(s["start_ns"] - base_ns) / 1e3,
                dur=(s["end_ns"] - s["start_ns"]) / 1e3,
                args=dict(request=s["request"], id=s["id"],
                          parent=s["parent"]))
           for s in rec["spans"]]
    out += [dict(ph="i", s="t", name=c["name"], cat="program", pid=pid,
                 tid=tid, ts=(c["t_ns"] - base_ns) / 1e3,
                 args=dict(n=c["n"], site=c["site"], request=c["request"]))
            for c in rec["counts"]]
    return out


def _trace_base_ns(logdir: str) -> int:
    """baseTimeNanoseconds of the newest torch.profiler trace in logdir
    (read from its head), 0 without one."""
    names = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    if not names:
        return 0
    with open(max(names, key=os.path.getmtime)) as f:
        m = re.search(r'"baseTimeNanoseconds":\s*(\d+)', f.read(1 << 16))
    return int(m.group(1)) if m else 0


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block with torch.profiler (host and, where there is a
    card, device activity); the trace lands under `logdir` for TensorBoard.
    The recorder is reset and records the block's program spans and
    counters, written beside the trace as program_spans.json: Chrome trace
    events on the trace's own time base, so the two read side by side.
    Yields the profiler, whose key_averages() hold the block's totals."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    reset()
    with record(), profile(activities=acts,
                           on_trace_ready=tensorboard_trace_handler(
                               logdir)) as prof:
        yield prof
    rec = recorded()
    base = _trace_base_ns(logdir)
    with open(os.path.join(logdir, "program_spans.json"), "w") as f:
        json.dump(dict(traceEvents=_chrome_events(rec, base),
                       baseTimeNanoseconds=base, displayTimeUnit="ms",
                       dropped=rec["dropped"]), f)
