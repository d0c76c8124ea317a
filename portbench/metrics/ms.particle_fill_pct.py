"""ms.particle_fill_pct: 100 x AGBNP2's MS particles over their capacity
(cap_ms), summed over the slice's rebuild windows (one count a window:
its build's, read at the window's host read).
The program's `ms.particles_valid` and `ms.particles_cap` counters, from
its recorder (openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which
records while the profiler runs).  The MS stage's dense free-volume
subtraction and the MS tree's level 1 run over every capacity slot, so
the rest is padding the device walks for nothing.  None where the
program records no MS particles."""

KIND = "md"


def _record():
    """The program's recorded spans and counters (the profiled slice's:
    recording is on while the profiler is); None where the program has no
    recorder."""
    try:
        from openmm_agbnp_plugin_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    return recorded() if recorded is not None else None


def read(data):
    if data.get("kind") != KIND:
        return None
    rec = _record()
    if not rec:
        return None
    total = {}
    for c in rec["counts"]:
        total[c["name"]] = total.get(c["name"], 0) + c["n"]
    valid, cap = total.get("ms.particles_valid"), total.get("ms.particles_cap")
    if not cap:
        return None
    return 100.0 * valid / cap
