"""tree.row_fill_pct.score: 100 x the overlap tree's valid rows over its
capacity rows, summed over levels, poses and the slice's scoring calls
(one count an evaluation, from the batch's diagnostics read at the
scorer's check).
The program's `tree.rows_valid` and `tree.rows_cap` counters, from its
recorder (openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which records
while the profiler runs).  Every row-indexed tree pass runs over the
capacity rows, so the rest is padding the device walks for nothing.  None
where the program records no rows."""

KIND = "score"


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
    valid, cap = total.get("tree.rows_valid"), total.get("tree.rows_cap")
    if not cap:
        return None
    return 100.0 * valid / cap
