"""ms_tree.row_fill_pct: 100 x AGBNP2's MS overlap tree's valid rows over
its capacity rows (caps_ms), summed over levels and the slice's rebuild
windows (one count a window: its build's counts, read at the window's
host read).
The program's `ms_tree.rows_valid` and `ms_tree.rows_cap` counters, from
its recorder (openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which
records while the profiler runs).  Every row-indexed pass of the MS tree
runs over the capacity rows, so the rest is padding the device walks for
nothing.  None where the program records no MS tree."""

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
    valid, cap = total.get("ms_tree.rows_valid"), total.get("ms_tree.rows_cap")
    if not cap:
        return None
    return 100.0 * valid / cap
