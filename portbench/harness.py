"""The benchmark's runner: finds a cell's files by name, runs its set-up,
timed window, traced slice and correctness check, and prints the result.

Everything that belongs to one cell, configuration, traffic mix or
per-layer metric is a file of its own, found by name:

  cells/<workload>.json     config, traffic, chips, why, check limits
  configs/<config>.json     the deployment (system file, force field,
                            integrator, cut-offs, dtype)
  traffic/<traffic>.json    the traffic mix: its kind and parameters
  kinds/<kind>.py           the generator of one kind of traffic
  metrics/<metric>.py       read(data) -> value or None, one per-layer
                            metric
  kernel_sets/<set>.json    device kernels by name fragment

BENCHMARK.json says which end-to-end and per-layer metrics a cell reports.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "openmm_agbnp_plugin_tpu")


def load_json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """A benchmark source file by path, as a module of its own."""
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    name = "portbench_" + "_".join(parts).replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench, workload, section):
    """The metrics of `section` (end_to_end or per_layer) that a cell
    reports: those listing it, or listing no cells."""
    return [m for m in bench[section]
            if workload in m.get("workloads", [workload])]


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a traffic kind is given: the cell, its configuration and
    traffic parameters, the seed and the device."""

    def __init__(self, workload, seed, seconds, trace, device):
        self.workload = workload
        self.cell = load_json("cells", workload + ".json")
        self.config = load_json("configs", self.cell["config"] + ".json")
        self.traffic = load_json("traffic", self.cell["traffic"] + ".json")
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.timer = None

    def path(self, rel):
        """A file of the checkout, by its path from the root."""
        return os.path.join(ROOT, rel)

    def log(self, msg):
        print(f"[portbench {self.workload}] {msg}", file=sys.stderr,
              flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description="The port's benchmark: one "
                                 "cell, one run.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_or_exit(chips):
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card (torch.cuda.is_available() is "
                 "false); the benchmark measures the card and never falls "
                 "back to the CPU")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell asks for {chips} cards, "
                 f"{torch.cuda.device_count()} visible")


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(checks, limits):
    """Each number compared against its limit: {name: {value, limit}} and
    whether every number is finite and within it."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return out, ok


def run(args, t_start, device=None, hooks=None):
    """One run; returns the result dict.  device None: the card (after
    checking for it); a CPU device drives the rest of a run for the tests.
    hooks: {"after_setup": fn(state)} for the tests' planted faults."""
    import torch

    import roofline
    from spans import BuildTimer, busy_seconds, idle_gaps, profile, top_ops

    ctx = Context(args.workload, args.seed, args.seconds, args.trace,
                  device)
    if device is None:
        card_or_exit(int(ctx.cell["chips"]))
        ctx.device = torch.device("cuda", 0)
    dev = ctx.device
    bench = benchmark_spec()
    kind = load_module("kinds", ctx.traffic["kind"] + ".py")

    state = kind.setup(ctx)
    if hooks and "after_setup" in hooks:
        hooks["after_setup"](state)
    if ctx.trace and dev.type == "cuda" and "sim" in state:
        ctx.timer = BuildTimer()
        ctx.timer.install(state["sim"])
    sync(dev)
    setup_s = time.perf_counter() - t_start

    rec = kind.window(ctx, state)
    sync(dev)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    result = {"correct": False, "attempted": rec["attempted"],
              "failed": rec["failed"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": name, "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    if ctx.trace:
        data = dict(rec["trace_data"])
        if dev.type == "cuda":
            sl, dv, host, window_s = profile(lambda: kind.slice(ctx, state))
            busy = busy_seconds(dv)
            w = kind.work(ctx)
            flops, nbytes = roofline.pair_work(
                sl.pop("work_positions"), w["heavy"], w["horizon"],
                w["cutoff"], w["table_bytes"])
            reps = sl.pop("work_repeats")
            data.update(sl, device_ops=dv, busy_s=busy, slice_s=window_s,
                        pair_least_s=reps * roofline.least_seconds(flops,
                                                                   nbytes),
                        build_ms=ctx.timer.build_ms() if ctx.timer else [])
            device_info.update(busy_s=busy, window_s=window_s)
            result["breakdown"] = {"device_ops": top_ops(dv),
                                   "idle_gaps": idle_gaps(dv, host)}
        for m in cell_metrics(bench, ctx.workload, "per_layer"):
            value = load_module("metrics", m["name"] + ".py").read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(rec["metrics"], setup_s=setup_s)
        for m in cell_metrics(bench, ctx.workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info

    kind.release(state)
    t0 = time.perf_counter()
    checks = kind.check(ctx, rec)
    ctx.log(f"the reference took {time.perf_counter() - t0:.3f} s")
    checks, ok = judge(checks, ctx.cell["limits"])
    bad = forbidden_modules()
    if bad:
        sys.exit(f"portbench: modules of JAX or the JAX package are loaded: "
                 f"{bad}")
    result["correct"] = bool(ok)
    result["checks"] = checks
    return result


def main(argv=None, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    result = run(args, t_start)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
