"""device.idle_pct.score: 100 x (1 - device busy time a unit in the profiled
slice / wall time a unit of the same run's untraced timed window), a unit
a step (MD) or a pose (scoring).  The profiler slows the host, so the
idle share is never taken under it."""

KIND = "score"


def read(data):
    if data.get("kind") != KIND or not data.get("busy_s"):
        return None
    busy = data["busy_s"] / data["slice_units"]
    wall = data["timed_s"] / data["units"]
    return 100.0 * (1.0 - busy / wall)
