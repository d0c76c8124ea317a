"""md.graph_step_pct: the share of the profiled slice's MD steps that ran
as a replay of their rebuild window's CUDA graph (the program's
md/graphs.py): 100 x the program's `md.graph_replay` counters over its
`md.step` spans, both from its recorder
(openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which records while the
profiler runs).  A replayed step is one launch of the host, an eager one
~665 (a window's first step runs eagerly, its second is captured).  0
where the program has graphs and the cell's steps take none (AGBNP2's
windows); None where the program has no graphs or records no steps."""

import importlib.util


def _record():
    """The program's recorded spans and counters (the profiled slice's:
    recording is on while the profiler is); None where the program has no
    recorder or no window graphs."""
    try:
        from openmm_agbnp_plugin_tpu_torch.utils import profiling
        graphs = importlib.util.find_spec("openmm_agbnp_plugin_tpu_torch.md."
                                          "graphs")
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if graphs is None or recorded is None:
        return None
    return recorded()


def read(data):
    if data.get("kind") != "md":
        return None
    rec = _record()
    if not rec:
        return None
    steps = sum(1 for s in rec["spans"] if s["name"] == "md.step")
    if not steps:
        return None
    replays = sum(c["n"] for c in rec["counts"]
                  if c["name"] == "md.graph_replay")
    return 100.0 * replays / steps
