"""CUDA graphs of a runner's rebuild windows, one a step kind, kept from
one window to the next.

Inside a rebuild window of the AGBNP1 runners (Simulation's Langevin
runner, parallel/ensemble.py::run_window) and of AGBNP2's (the Langevin
runner's window_v2) every shape is fixed by the capacities and the
window's topology, no step reads the device back or copies from the host,
and every kernel, PyTorch's and csrc/'s, launches on the current stream.
On the card the host's enqueue of the step's ~665 kernels (AGBNP2's
~4,900) sets the pace, not the device (PERF.md §5).  A window's inputs,
its build (neighbor list, tree topology, compacted WU topology; AGBNP2's
MS candidates and trees), have shapes fixed by the capacities too, so one
set of graphs serves every window of a runner (WindowGraphs):

  1. the runner's first window copies its build into persistent slot
     tensors and makes its steps over them (window_steps' `make`); each
     step kind's first step runs eagerly, as before (lazy set-up), its
     second is captured on a side stream into a torch.cuda.CUDAGraph over
     static position, velocity and noise tensors, the graph ending by
     writing the step's positions and velocities into the static ones,
     and its later steps replay the graph;
  2. a later window whose build has the slots' layout (pytree structure,
     every tensor's dtype, shape, strides and storage, every other leaf's
     value) copies the build into the slots, its tensors' storages in one
     torch._foreach_copy_, and replays every step, its first too; a kind
     first met then (a WU remainder block's impulse, whose force the
     window's impulse steps have run) is captured at once;
  3. a build of another layout (a runner's first, capacities that
     changed, another model object among its leaves) takes fresh slots,
     steps and graphs as in 1.

Each step's noise is drawn eagerly, by the same calls in the same order as
before, and copied into the static noise; a replayed step's energy is
cloned and its counts taken into the window's running maximum, which
starts from a copy.  A window returns copies of the static positions and
velocities, which the next window's replays overwrite; the next window
copies them back in.

The r-RESPA MTS step (md/integrators.py::mts_langevin_step) and a step
constrained on the star-cluster path (md/constraints.py: fixed Newton
sweeps, no host read) are captured alike.  An MTS step's draws, one a
substep, are stacked into one static [inner, N, 3] noise tensor; a
constrained step's SHAKE residual is a static output of its graph, which
window_steps takes into the window's running maximum as it takes the
counts.  The Jacobi fallback, which reads the host every sweep, stays
eager (capturable).

A window of the WU impulse (md/integrators.py::wu_impulse_langevin_steps)
is a schedule of two step kinds, the impulse step every wu_every steps and
the skip step between (and a remainder block's impulse, a third).  The
kinds' graphs share the static tensors, so a replay after another kind's
copies nothing; after an eager step it copies that step's positions and
velocities in.

A replay runs the captured kernels on the same inputs, so the trajectory
is the eager loop's bit for bit.  A runner's graphs live as long as the
runner (a PanicButton regrow, SHAKE's added sweeps too, makes run_md
build a new runner, whose graphs are captured afresh); T-REMD
(parallel/remd.py), whose windows take their first force from the cycle
before and whose rungs' temperatures change, gives each window its own.
Each graph is uploaded to the device as it is captured (_upload).  The
graphs of a device share one memory pool, kept alive by the last graph
captured into it.  Graphs replay in turns on one stream, and a
step's outputs are taken (the energy cloned, the counts and the SHAKE
residual into the running maxima) before the next step is enqueued, so
one graph's scratch memory may be another's outputs.

The build itself (AGBNP1's Simulation.window_build) is a graph of its own,
kept by the Langevin runner (BuildGraph): on a card it reads nothing back
(ops/tree.py's checks are device-side asserts there) and its shapes are
the capacities', so its first window runs it eagerly and then captures it
over a static copy of the window's positions, and every later window
copies its positions in and replays it.  The host then enqueues a window
as one build replay and a replay a step, and waits once, at the window's
read.

Launch tallies stay those of the eager loop: the kernels' counts in
ops/kernels/pairs.py LAUNCHES and the recorder's counters made while
capturing are taken back, and added again at each replay.  The recorder
counts md.graph_capture (one a capture, also a span inside its md.step:
once a step kind a runner), md.graph_replay (one a replayed step) and
md.graph_reuse (one a window that replays the graphs of an earlier one
after copying its build into the slots); a build's graph counts
window.build_capture (also a span) and window.build_replay.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils import _pytree

from ..ops.kernels import pairs as PK
from ..utils import profiling
from .integrators import running_max

# device index -> (the graphs' memory pool, the last graph captured in it)
_POOLS: dict = {}
# device index -> the side stream captures run on
_STREAMS: dict = {}
# libcuda (_upload), loaded at the first capture
_LIBCUDA = None


def capturable(sim, pos, topology, ninner: int) -> bool:
    """Whether a window of ninner Langevin steps of sim runs as a captured
    graph: positions on a card, two steps or more, constraints (if any) on
    the star-cluster path, whose fixed Newton sweeps read nothing back
    (md/constraints.py; the Jacobi fallback reads the host every sweep),
    and AGBNP1 on a window topology with the tree kernels' prep
    (ops/tree.py::kernel_prep) or AGBNP2 on a _v2_build topology, which
    carries its fixed-topology diagnostics
    (models/agbnp2_torch.py::fixed_topology_diags).  The plain step, the
    r-RESPA MTS step and the WU impulse schedule (AGBNP1) qualify alike;
    the caller rules out the atoms mesh, whose steps are not (AGBNP2's
    Simulation refuses MTS)."""
    cons = sim.constraints
    if not (pos.is_cuda and ninner >= 2
            and (cons is None or cons.clusters is not None)):
        return False
    if sim.agbnp2 is not None:
        return topology is not None and "diags" in topology[0]
    return (sim.agbnp.version == 1 and topology is not None
            and "dep_order" in topology[0]["bnd"])


class StepGraph:
    """step(pos, vel, noise) -> (pos, vel, energy, counts, shake) captured
    once at (pos, vel, noise); calling it with a step's noise replays it
    from the positions and velocities of the step before and returns
    (pos, vel, energy, counts, shake), shake the step's SHAKE residual
    (a static output, rewritten by the next replay) or None without
    constraints.  noise: one draw [N, 3] (replicas [R, N, 3]), or an MTS
    step's draws, one a substep, stacked [inner, N, 3].  like: a
    StepGraph of the same WindowGraphs whose static tensors this one
    shares (another step kind of its schedule)."""

    def __init__(self, step, pos, vel, noise, like=None):
        dev = pos.device
        if like is None:
            self.pos, self.vel = pos.clone(), vel.clone()
            self.noise = torch.empty_like(noise)
        else:
            self.pos, self.vel, self.noise = like.pos, like.vel, like.noise
            self._take(pos, vel)
        pool, _ = _POOLS.get(dev.index, (None, None))
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        side = _side_stream(dev)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = dict(PK.LAUNCHES)
        with profiling.span("md.graph_capture"), \
                profiling.hold() as held, torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                p, v, self.energy, self.counts, self.shake = step(
                    self.pos, self.vel, self.noise)
                self.pos.copy_(p)
                self.vel.copy_(v)
            finally:
                graph.capture_end()
            _upload(graph, side)
        main.wait_stream(side)
        self.launches = {k: n - before[k] for k, n in PK.LAUNCHES.items()
                         if n != before[k]}
        PK.LAUNCHES.update(before)
        self.held = held
        self.graph = graph
        _POOLS[dev.index] = (pool, graph)
        profiling.count("md.graph_capture")

    def _take(self, pos, vel):
        """The step's start state into the static tensors, where it is
        not there already (it is after a replay of the runner's graphs)."""
        if pos is not self.pos:
            self.pos.copy_(pos)
        if vel is not self.vel:
            self.vel.copy_(vel)

    def __call__(self, noise, pos=None, vel=None):
        if pos is not None:
            self._take(pos, vel)
        self.noise.copy_(noise)
        self.graph.replay()
        for k, n in self.launches.items():
            PK.LAUNCHES[k] += n
        profiling.count_again(self.held)
        profiling.count("md.graph_replay")
        return (self.pos, self.vel, self.energy.clone(), self.counts,
                self.shake)


def _upload(graph, stream):
    """Upload an instantiated graph to the device now, on stream.  Left
    lazy (CUDA's default), a process's first replays of a 4 fs window ran
    11-14% slower on the device for up to ~30 s (PERF.md §6)."""
    global _LIBCUDA
    if _LIBCUDA is None:
        _LIBCUDA = ctypes.CDLL("libcuda.so.1")
    rc = _LIBCUDA.cuGraphUpload(ctypes.c_void_p(graph.raw_cuda_graph_exec()),
                                ctypes.c_void_p(stream.cuda_stream))
    if rc != 0:
        raise RuntimeError(f"cuGraphUpload failed with CUDA error {rc}")


def _side_stream(dev):
    side = _STREAMS.get(dev.index)
    if side is None:
        side = _STREAMS[dev.index] = torch.cuda.Stream(dev)
    return side


class BuildGraph:
    """A runner's window build, build(pos) -> its outputs, as one CUDA
    graph kept across the runner's windows (the module's docstring), for
    positions on a card: the first call runs build eagerly (lazy set-up)
    and returns its outputs, then captures build over a static copy of
    pos; each later call copies pos in and replays the graph.  build is
    the same computation at every call (the runner's force field and
    capacities).  The graph has a memory pool of its own, so no step
    graph's scratch holds its outputs; a replay returns them, the graph's
    static tensors, which the next replay rewrites (replayed says that the
    last call's outputs are the graph's)."""

    def __init__(self):
        self.graph = None
        self.replayed = False

    def __call__(self, build, pos):
        if self.graph is None:
            out = build(pos)
            self._capture(build, pos)
            self.replayed = False
            return out
        self.pos.copy_(pos)
        self.graph.replay()
        for k, n in self.launches.items():
            PK.LAUNCHES[k] += n
        profiling.count_again(self.held)
        profiling.count("window.build_replay")
        self.replayed = True
        return self.out

    def _capture(self, build, pos):
        dev = pos.device
        self.pos = pos.clone()
        side, main = _side_stream(dev), torch.cuda.current_stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = dict(PK.LAUNCHES)
        with profiling.span("window.build_capture"), \
                profiling.hold() as held, torch.cuda.stream(side):
            graph.capture_begin(pool=torch.cuda.graph_pool_handle())
            try:
                self.out = build(self.pos)
            finally:
                graph.capture_end()
            _upload(graph, side)
        main.wait_stream(side)
        self.launches = {k: n - before[k] for k, n in PK.LAUNCHES.items()
                         if n != before[k]}
        PK.LAUNCHES.update(before)
        self.held = held
        self.graph = graph
        profiling.count("window.build_capture")


def every_step(step):
    """The schedule of a window whose steps are all `step`."""
    return lambda ninner: [step] * ninner


def _layout(inputs):
    """(key, the storages of inputs' tensors as flat byte tensors, inputs'
    leaves, their pytree spec).  The key: the spec, each tensor leaf's
    storage (its index among the storages), dtype, device, shape, strides
    and offset, each storage's bytes, each other leaf's value."""
    leaves, spec = _pytree.tree_flatten(inputs)
    index, stores, desc = {}, [], []
    for x in leaves:
        if not isinstance(x, torch.Tensor):
            desc.append(x)
            continue
        st = x.untyped_storage()
        k = index.setdefault(st.data_ptr(), len(stores))
        if k == len(stores):
            stores.append(torch.empty(0, dtype=torch.uint8,
                                      device=x.device).set_(st))
        desc.append((k, x.dtype, x.device, tuple(x.shape), x.stride(),
                     x.storage_offset()))
    key = (spec, tuple(desc), tuple(b.numel() for b in stores))
    return key, stores, leaves, spec


class WindowGraphs:
    """A runner's CUDA graphs, one a step kind, kept across its windows
    (the module's docstring): slot tensors holding the window's build,
    the steps made over them, their StepGraphs and the layout key the
    slots were made for."""

    def __init__(self):
        self.key = None     # the slots' layout (_layout); None: no slots
        self.slots = []     # the slots' storages, flat bytes
        self.schedule = None
        self.graphs = {}    # step kind -> its StepGraph
        self.ran = set()    # kinds run eagerly over the slots
        self.like = None    # the StepGraph whose static tensors all share

    def bind(self, make, inputs):
        """The schedule of a window whose build is `inputs`: the build
        copied into the slots, the kept steps and graphs where its layout
        is the slots', else fresh slots and make(slots)'s steps."""
        key, stores, leaves, spec = _layout(inputs)
        if key == self.key:
            torch._foreach_copy_(self.slots, stores)
            if self.graphs:
                profiling.count("md.graph_reuse")
            return self.schedule
        self.slots = [torch.empty_like(b) for b in stores]
        torch._foreach_copy_(self.slots, stores)
        slot_leaves = [
            torch.empty(0, dtype=x.dtype, device=x.device).set_(
                self.slots[d[0]].untyped_storage(), x.storage_offset(),
                x.shape, x.stride())
            if isinstance(x, torch.Tensor) else x
            for x, d in zip(leaves, key[1])]
        self.schedule = make(_pytree.tree_unflatten(slot_leaves, spec))
        self.key, self.graphs, self.ran, self.like = key, {}, set(), None
        return self.schedule

    def step(self, st, pos, vel, noise):
        """One step of kind st over the slots -> (pos, vel, energy,
        counts, shake): a replay of the kind's graph, captured first where
        the kind ran eagerly over the slots or another kind has a graph
        (the schedule's forces have then run); else eagerly."""
        graph = self.graphs.get(st)
        if graph is not None:
            return graph(noise, pos, vel)
        if st in self.ran or self.graphs:
            graph = self.graphs[st] = self.like = StepGraph(
                st, pos, vel, noise, self.like)
            return graph(noise)  # the capture took pos and vel
        self.ran.add(st)
        return st(pos, vel, noise)


def window_steps(make, inputs, pos, vel, ninner: int, noise, held=None):
    """ninner steps of a window, each an md.step span: the steps of
    make(inputs)(ninner), make giving a window's schedule (every_step, or
    md/integrators.py::wu_impulse_langevin_steps) over its build, inputs.
    Returns (pos, vel, energies [ninner], the steps' maximum counts, the
    steps' maximum SHAKE residual or None).  held (where capture is
    sound, capturable): the runner's WindowGraphs, over whose slots the
    steps run as its graphs' replays (the module's docstring)."""
    if held is None:
        schedule = make(inputs)(ninner)
    else:
        schedule = held.bind(make, inputs)(ninner)
    energies, counts, shake = [], None, None
    for st in schedule:
        with profiling.span("md.step"):
            xi = noise()
            if held is None:
                pos, vel, e, c, sh = st(pos, vel, xi)
            else:
                pos, vel, e, c, sh = held.step(st, pos, vel, xi)
            energies.append(e)
            # a replay's counts and SHAKE residual are its graph's,
            # rewritten by the next step
            counts = c.clone() if counts is None else running_max(counts, c)
            shake = (sh.clone() if shake is None and sh is not None
                     else running_max(shake, sh))
    if held is not None and held.like is not None and pos is held.like.pos:
        # the static tensors, which the next window's replays overwrite
        pos, vel = pos.clone(), vel.clone()
    return pos, vel, energies, counts, shake
