"""constraints.shake_sweeps_per_step: the SHAKE sweeps an MD step of the
profiled slice ran (the program's md/constraints.py: the star clusters'
Newton sweeps, a fixed count a SHAKE call, one call a substep): the n of
the program's `constraints.shake_sweeps` counters summed over its
`md.step` spans, both from its recorder
(openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which records while
the profiler runs; a replayed step's counters count again).  8.0 at
mts_inner 2 with 4 sweeps a call; more after a SHAKE regrow.  None where
the program records no such counter or no steps."""


def _record():
    """The program's recorded spans and counters (the profiled slice's);
    None where the program has no recorder."""
    try:
        from openmm_agbnp_plugin_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


def read(data):
    if data.get("kind") != "md":
        return None
    rec = _record()
    if not rec:
        return None
    steps = sum(1 for s in rec["spans"] if s["name"] == "md.step")
    sweeps = sum(c["n"] for c in rec["counts"]
                 if c["name"] == "constraints.shake_sweeps")
    if not steps or not sweeps:
        return None
    return sweeps / steps
