"""window.build_ms: the median time of a rebuild window's set-up
(Simulation.window_build: the neighbor list or cell grid, build_tree and
compact_topology), each build timed by CUDA events on the stream around
the call, over the traced run's builds (its timed window and slice)."""

import statistics


def read(data):
    ms = data.get("build_ms")
    if data.get("kind") != "md" or not ms:
        return None
    return statistics.median(ms)
