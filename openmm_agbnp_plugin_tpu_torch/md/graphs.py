"""One CUDA graph a rebuild window for each kind of Langevin step.

Inside a rebuild window of the AGBNP1 runners (Simulation's Langevin
runner, parallel/ensemble.py::run_window) and of AGBNP2's (the Langevin
runner's window_v2) every shape is fixed by the capacities and the
window's topology, no step reads the device back or copies from the host,
and every kernel, PyTorch's and csrc/'s, launches on the current stream.
On the card the host's enqueue of the step's ~665 kernels (AGBNP2's
~4,900) sets the pace, not the device (PERF.md §5).  So a window of
ninner steps runs as:

  1. its first step eagerly, as before (lazy set-up; T-REMD's first step
     takes the force window_start evaluated);
  2. its second step captured on a side stream into a torch.cuda.CUDAGraph
     over static position, velocity and noise tensors; the graph ends by
     writing the step's positions and velocities into the static ones;
  3. the graph replayed for steps 2 .. ninner: each step's noise is drawn
     eagerly, by the same calls in the same order as before, and copied
     into the static noise; the step's energy is cloned and its counts
     taken into the running maximum.

A window of the WU impulse (md/integrators.py::wu_impulse_langevin_steps)
is a schedule of two step kinds, the impulse step every wu_every steps and
the skip step between (and a remainder block's impulse, a third): each
kind's first step runs eagerly, its second is captured, and the later ones
replay its graph.  The kinds' graphs of a window share the static tensors,
so a replay after another kind's step copies nothing; after an eager step
it copies that step's positions and velocities in.

A replay runs the captured kernels on the same inputs, so the trajectory
is the eager loop's bit for bit.  The graph lives for its window only: the
next window's build makes new topology tensors.  The graphs of a device
share one memory pool, kept alive by the last graph captured into it, so a
window's capture reuses the memory of the one before.  Graphs of one
window replay in turns on one stream, and a step's outputs are taken (the
energy cloned, the counts into the running maximum) before the next step
is enqueued, so one graph's scratch memory may be another's outputs.

Launch tallies stay those of the eager loop: the kernels' counts in
ops/kernels/pairs.py LAUNCHES and the recorder's counters made while
capturing are taken back, and added again at each replay.  The recorder
counts md.graph_capture (one a capture, also a span inside its md.step)
and md.graph_replay (one a replayed step).
"""

from __future__ import annotations

import torch

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
    rules out constraints.  like: a StepGraph of the same window whose
    static tensors this one shares (another step kind of its schedule)."""

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
        not there already (it is after a replay of this window's graphs)."""
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


def window_steps(step, pos, vel, ninner: int, noise, graph: bool = False):
    """ninner steps of a window, each an md.step span: step(pos, vel,
    noise()) or, where step is a list (a schedule of ninner steps, as
    md/integrators.py::wu_impulse_langevin_steps makes), its i-th at step
    i.  Returns (pos, vel, energies [ninner], the steps' maximum counts,
    the steps' maximum SHAKE residual or None).  graph (capturable): each
    step kind's first step runs eagerly, its second is captured as a
    StepGraph and its later ones replay it."""
    schedule = step if isinstance(step, list) else [step] * ninner
    energies, counts, shake = [], None, None
    kinds, like = {}, None  # step kind -> its StepGraph, None until taken
    for i in range(ninner):
        st = schedule[i]
        with profiling.span("md.step"):
            xi = noise()
            if graph and st in kinds:
                replay, start = kinds[st], (pos, vel)
                if replay is None:
                    replay = kinds[st] = like = StepGraph(st, pos, vel, xi,
                                                          like)
                    start = ()  # the capture took them
                pos, vel, e, c = replay(xi, *start)
                sh = None
            else:
                kinds[st] = None
                pos, vel, e, c, sh = st(pos, vel, xi)
            energies.append(e)
            counts = running_max(counts, c)
            shake = running_max(shake, sh)
    return pos, vel, energies, counts, shake
