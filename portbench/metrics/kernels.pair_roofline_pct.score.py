"""kernels.pair_roofline_pct.score: the least time of the Born, GB and
descreening sweeps' work in the profiled slice (roofline.py: live pairs
counted from the slice's positions, FP32 operations over 67 TFLOP/s or
bytes over 3.35 TB/s, whichever is larger), as a share of the device time
of the kernels that run them (kernel_sets/pair_sweeps.json).  The GB
kernel's fused MM sum is not counted, so the share is understated."""

import json
import os

KIND = "score"


def read(data):
    ops = data.get("device_ops")
    if data.get("kind") != KIND or not ops or not data.get("pair_least_s"):
        return None
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "kernel_sets", "pair_sweeps.json")) as f:
        frags = tuple(json.load(f)["fragments"])
    ns = sum(e - s for name, s, e in ops if any(f in name for f in frags))
    if ns <= 0:
        return None
    return 100.0 * data["pair_least_s"] / (ns * 1e-9)
