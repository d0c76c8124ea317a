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

A window of the WU impulse (md/integrators.py::wu_impulse_langevin_steps)
is a schedule of two step kinds, the impulse step every wu_every steps and
the skip step between (and a remainder block's impulse, a third).  The
kinds' graphs share the static tensors, so a replay after another kind's
copies nothing; after an eager step it copies that step's positions and
velocities in.

A replay runs the captured kernels on the same inputs, so the trajectory
is the eager loop's bit for bit.  A runner's graphs live as long as the
runner; T-REMD (parallel/remd.py), whose windows take their first force
from the cycle before and whose rungs' temperatures change, gives each
window its own.  The graphs of a device share one memory pool, kept alive
by the last graph captured into it.  Graphs replay in turns on one
stream, and a step's outputs are taken (the energy cloned, the counts into
the running maximum) before the next step is enqueued, so one graph's
scratch memory may be another's outputs.

Launch tallies stay those of the eager loop: the kernels' counts in
ops/kernels/pairs.py LAUNCHES and the recorder's counters made while
capturing are taken back, and added again at each replay.  The recorder
counts md.graph_capture (one a capture, also a span inside its md.step:
once a step kind a runner), md.graph_replay (one a replayed step) and
md.graph_reuse (one a window that replays the graphs of an earlier one
after copying its build into the slots).
"""

from __future__ import annotations

import torch
from torch.utils import _pytree

from ..ops.kernels import pairs as PK
from ..utils import profiling
from .integrators import running_max

# device index -> (the graphs' memory pool, the last graph captured in it)
_POOLS: dict = {}
# device index -> the side stream captures run on
_STREAMS: dict = {}


def capturable(sim, pos, topology, ninner: int) -> bool:
    """Whether a window of ninner plain Langevin steps of sim runs as a
    captured graph: positions on a card, no constraints (the SHAKE
    fallback reads the host), two steps or more, and AGBNP1 on a window
    topology with the tree kernels' prep (ops/tree.py::kernel_prep) or
    AGBNP2 on a _v2_build topology, which carries its fixed-topology
    diagnostics (models/agbnp2_torch.py::fixed_topology_diags).  The
    plain step and the WU impulse schedule (AGBNP1) qualify alike; the
    caller rules out MTS and the atoms mesh, whose steps are neither
    (AGBNP2's Simulation refuses them)."""
    if sim.agbnp2 is not None:
        return (pos.is_cuda and ninner >= 2 and sim.constraints is None
                and topology is not None and "diags" in topology[0])
    return (pos.is_cuda and ninner >= 2 and sim.agbnp2 is None
            and sim.agbnp.version == 1 and sim.constraints is None
            and topology is not None and "dep_order" in topology[0]["bnd"])


class StepGraph:
    """step(pos, vel, noise) -> (pos, vel, energy, counts, shake) captured
    once at (pos, vel, noise); calling it with a step's noise replays it
    from the positions and velocities of the step before and returns
    (pos, vel, energy, counts).  The step has no SHAKE residual: capturable
    rules out constraints.  like: a StepGraph of the same WindowGraphs
    whose static tensors this one shares (another step kind of its
    schedule)."""

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
        side = _STREAMS.get(dev.index)
        if side is None:
            side = _STREAMS[dev.index] = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = dict(PK.LAUNCHES)
        with profiling.span("md.graph_capture"), \
                profiling.hold() as held, torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                p, v, self.energy, self.counts, _ = step(
                    self.pos, self.vel, self.noise)
                self.pos.copy_(p)
                self.vel.copy_(v)
            finally:
                graph.capture_end()
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
        return self.pos, self.vel, self.energy.clone(), self.counts


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
            return (*graph(noise, pos, vel), None)
        if st in self.ran or self.graphs:
            graph = self.graphs[st] = self.like = StepGraph(
                st, pos, vel, noise, self.like)
            return (*graph(noise), None)  # the capture took pos and vel
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
            # a replay's counts are its graph's, rewritten by the next step
            counts = c.clone() if counts is None else running_max(counts, c)
            shake = running_max(shake, sh)
    if held is not None and held.like is not None and pos is held.like.pos:
        # the static tensors, which the next window's replays overwrite
        pos, vel = pos.clone(), vel.clone()
    return pos, vel, energies, counts, shake
