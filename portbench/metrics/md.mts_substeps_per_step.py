"""md.mts_substeps_per_step: the fast substeps an MD step of the profiled
slice took (the program's md/integrators.py::mts_langevin_step: the
bonded and 1-4 class on `inner` substeps of each r-RESPA outer step):
the program's `md.mts_substep` counters over its `md.step` spans, both
from its recorder (openmm_agbnp_plugin_tpu_torch/utils/profiling.py,
which records while the profiler runs; a replayed step's counters count
again).  2.0 at mts_inner 2.  None where the program records no such
counter or no steps."""


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
    substeps = sum(c["n"] for c in rec["counts"]
                   if c["name"] == "md.mts_substep")
    if not steps or not substeps:
        return None
    return substeps / steps
