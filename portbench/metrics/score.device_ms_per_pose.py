"""score.device_ms_per_pose: the seconds in which the device ran an
operation during the profiled scoring calls, in ms, over the poses they
scored."""


def read(data):
    if data.get("kind") != "score" or not data.get("busy_s"):
        return None
    return data["busy_s"] * 1e3 / data["slice_units"]
