"""One CUDA graph a rebuild window for the plain Langevin step.

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

A replay runs the captured kernels on the same inputs, so the trajectory
is the eager loop's bit for bit.  The graph lives for its window only: the
next window's build makes new topology tensors.  The graphs of a device
share one memory pool, kept alive by the last graph captured into it, so a
window's capture reuses the memory of the one before.

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
    caller rules out MTS, the WU impulse and the atoms mesh, whose steps
    are not langevin_middle_step's (AGBNP2's Simulation refuses them)."""
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
    rules out constraints."""

    def __init__(self, step, pos, vel, noise):
        dev = pos.device
        self.pos, self.vel = pos.clone(), vel.clone()
        self.noise = torch.empty_like(noise)
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

    def __call__(self, noise):
        self.noise.copy_(noise)
        self.graph.replay()
        for k, n in self.launches.items():
            PK.LAUNCHES[k] += n
        profiling.count_again(self.held)
        profiling.count("md.graph_replay")
        return self.pos, self.vel, self.energy.clone(), self.counts


def window_steps(step, pos, vel, ninner: int, noise, graph: bool = False):
    """ninner steps step(pos, vel, noise()) of a window, each an md.step
    span.  Returns (pos, vel, energies [ninner], the steps' maximum counts,
    the steps' maximum SHAKE residual or None).  graph (capturable): the
    first step runs eagerly, the second is captured as a StepGraph and
    steps 2 .. ninner replay it."""
    energies, counts, shake = [], None, None
    replay = None
    for i in range(ninner):
        with profiling.span("md.step"):
            xi = noise()
            if graph and i > 0:
                if replay is None:
                    replay = StepGraph(step, pos, vel, xi)
                pos, vel, e, c = replay(xi)
                sh = None
            else:
                pos, vel, e, c, sh = step(pos, vel, xi)
            energies.append(e)
            counts = running_max(counts, c)
            shake = running_max(shake, sh)
    return pos, vel, energies, counts, shake
