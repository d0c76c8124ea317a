"""The traced run's readings: device activity from torch.profiler, host
spans from the benchmark's own record_function ranges, and the CUDA-event
times of the window builds.

Spans come only from this benchmark's files, around calls into a layer:
`portbench.<name>` ranges that the traffic kinds open around each call,
and the wrappers `install_spans` puts on a Simulation instance
(`window_build`, `_regrow`).
"""

from __future__ import annotations

import torch

SPAN_PREFIX = "portbench."


def span(name: str):
    """A host span around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class BuildTimer:
    """Wraps an instance's `window_build` (and `_regrow`) in spans, and
    times each build with CUDA events on the current stream."""

    def __init__(self):
        self.events = []

    def install(self, sim):
        build, regrow = sim.window_build, sim._regrow

        def timed_build(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with span("window_build"):
                start.record()
                out = build(*args, **kw)
                end.record()
            self.events.append((start, end))
            return out

        def spanned_regrow(*args, **kw):
            with span("regrow"):
                return regrow(*args, **kw)

        sim.window_build = timed_build
        sim._regrow = spanned_regrow

    def build_ms(self):
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _events(prof):
    """(name, on the device, start ns, end ns) of every traced event."""
    try:
        for ev in prof.profiler.kineto_results.events():
            start = ev.start_ns()
            yield ev.name(), _device(ev), start, start + ev.duration_ns()
    except AttributeError:
        for ev in prof.events():
            yield (ev.name, _device(ev), int(ev.time_range.start * 1e3),
                   int(ev.time_range.end * 1e3))


def profile(fn):
    """Run fn() under torch.profiler (host and device).  Returns (fn's
    result, device intervals [(name, start_ns, end_ns)], host spans
    [(name, start_ns, end_ns)], traced window seconds)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with span("slice"):
            out = fn()
            torch.cuda.synchronize()
    dev, host = [], []
    for name, device, start, end in _events(prof):
        if not name.startswith(SPAN_PREFIX):
            if device:
                dev.append((name, start, end))
        elif not device:
            # a span is also drawn on the device's timeline: only the
            # host's counts
            host.append((name[len(SPAN_PREFIX):], start, end))
    window = [h for h in host if h[0] == "slice"]
    window_s = (window[0][2] - window[0][1]) * 1e-9 if window else 0.0
    return out, dev, host, window_s


def busy_intervals(dev):
    """The union of the device intervals, sorted: [(start, end)]."""
    out = []
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_seconds(dev) -> float:
    return sum(e - s for s, e in busy_intervals(dev)) * 1e-9


def top_ops(dev, n: int = 10):
    """[[kernel name, total device seconds]] of the n that took most."""
    tot = {}
    for name, s, e in dev:
        tot[name] = tot.get(name, 0.0) + (e - s) * 1e-9
    return [[k, v] for k, v in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def idle_gaps(dev, host, n: int = 10):
    """The n longest idle gaps between device operations inside the
    traced window, each named by the innermost benchmark span the host
    was in when it began: [[span, seconds]]."""
    iv = busy_intervals(dev)
    spans = sorted((h for h in host if h[0] != "slice"),
                   key=lambda h: h[2] - h[1])
    gaps = []
    for (_, a), (b, _) in zip(iv, iv[1:]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:n]:
        name = next((h[0] for h in spans if h[1] <= a <= h[2]), "host")
        out.append([name, (b - a) * 1e-9])
    return out
