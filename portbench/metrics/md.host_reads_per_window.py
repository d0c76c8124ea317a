"""md.host_reads_per_window: blocking device-to-host reads a rebuild window
in the profiled slice: the program's `host_read` counters (one a read, at
the read itself: the window's diagnostics, run_md's checks, energies and
frames, and the overflow_report a replica runner's caller makes) over its
`md.window` spans, both from the program's recorder
(openmm_agbnp_plugin_tpu_torch/utils/profiling.py, which records while the
profiler runs).  Each read stalls the host until the device drains its
queue.  None where the program records no windows."""


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
    if data.get("kind") != "md":
        return None
    rec = _record()
    if not rec:
        return None
    windows = sum(1 for s in rec["spans"] if s["name"] == "md.window")
    if not windows:
        return None
    reads = sum(c["n"] for c in rec["counts"] if c["name"] == "host_read")
    return reads / windows
