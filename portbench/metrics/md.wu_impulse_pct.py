"""md.wu_impulse_pct: the share of the profiled slice's MD steps that were
WU impulse steps (the program's md/integrators.py::wu_impulse_langevin_steps:
the WU force pass split out and kicked in k-fold, every k-th step of a
window): 100 x the program's `md.wu_impulse` counters over its `md.step`
spans, both from its recorder (openmm_agbnp_plugin_tpu_torch/utils/
profiling.py, which records while the profiler runs; a replayed step's
counters count again).  25.0 at wu_every 4 in 40-step windows.  None
where the program records no such counter or no steps."""


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
    impulses = sum(c["n"] for c in rec["counts"]
                   if c["name"] == "md.wu_impulse")
    if not steps or not impulses:
        return None
    return 100.0 * impulses / steps
