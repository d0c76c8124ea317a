"""Readings for a cell's limits: the program's numbers over many seeds
(the lower readings) and the control's on the same states (the upper
readings).  The benchmark's own runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed it runs the cell's set-up and timed window (at the cell's
own load, for --seconds), then the cell's check twice: with the
program's outputs, and with the control in the program's place: the
reference computed in bfloat16 (the precision below the configurations'
float32) from the same states and noise.  One JSON line
a seed, then the largest program reading and the smallest control
reading of each number.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"

import harness  # noqa: E402


def readings(workload, seeds, seconds, device=None):
    """[(seed, program numbers, control numbers)] of one cell."""
    import torch

    out = []
    for seed in seeds:
        ctx = harness.Context(workload, seed, seconds, False, device)
        if device is None:
            harness.card_or_exit(int(ctx.cell["chips"]))
            ctx.device = torch.device("cuda", 0)
        kind = harness.load_module("kinds", ctx.traffic["kind"] + ".py")
        state = kind.setup(ctx)
        rec = kind.window(ctx, state)
        kind.release(state)
        prog = kind.check(ctx, rec)
        ctrl = kind.check(ctx, rec, control=torch.bfloat16)
        out.append((seed, prog, ctrl))
        print(json.dumps(dict(seed=seed, program=prog, control=ctrl)),
              flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    got = readings(args.workload, [int(s) for s in args.seeds.split(",")],
                   args.seconds)
    names = got[0][1].keys()
    summary = dict(
        workload=args.workload, seeds=len(got),
        lower={k: max(p[k] for _, p, _ in got) for k in names},
        upper={k: min(c[k] for _, _, c in got) for k in names},
        seconds=time.perf_counter() - t0)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
