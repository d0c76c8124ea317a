"""device.idle_ms.ms: the device's idle ms a step while the host was in
AGBNP2's MS stage (the span eval.ms: the MS particles, their free
volumes, both MS tree passes and their reverse rule).

Each idle gap between the profiled slice's device operations
(data["device_ops"], merged into busy intervals) is put down to the
innermost program span open on the host when the gap began: the spans of
the program's recorder (openmm_agbnp_plugin_tpu_torch/utils/profiling.py,
which records while the profiler runs, so recorded() holds the slice's),
stamped on the profiler's own clock.  The slice's idle ms a step in these
spans is scaled to the untraced window by (timed_s / units) / (slice_s /
slice_units): the profiler slows the host, and this assumes it slows
every phase alike.  None where the program records no eval.ms span."""


def _mine(names):
    return names[0] == "eval.ms"


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


def _idle_by_span(ops, spans):
    """{id of the innermost span open when a gap began (None: no span):
    idle ns} over the gaps between the device's busy intervals.  Spans of
    one thread nest, so a stack swept in time order finds the innermost."""
    iv = []
    for s, e in sorted((s, e) for _, s, e in ops):
        if iv and s <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], e)
        else:
            iv.append([s, e])
    spans = sorted(spans, key=lambda x: (x["start_ns"], -x["end_ns"]))
    out, stack, k = {}, [], 0
    for (_, a), (b, _) in zip(iv, iv[1:]):
        while k < len(spans) and spans[k]["start_ns"] <= a:
            while stack and stack[-1]["end_ns"] < spans[k]["start_ns"]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1]["end_ns"] < a:
            stack.pop()
        key = stack[-1]["id"] if stack else None
        out[key] = out.get(key, 0) + (b - a)
    return out


def _names(byid, sid):
    """The names of span sid and its ancestors, innermost first."""
    out = []
    while sid is not None:
        out.append(byid[sid]["name"])
        sid = byid[sid]["parent"]
    return out


def read(data):
    ops = data.get("device_ops")
    if data.get("kind") != "md" or not ops or not data.get("slice_s"):
        return None
    rec = _record()
    if not rec or not rec["spans"]:
        return None
    if not any(s["name"] == "eval.ms" for s in rec["spans"]):
        return None
    byid = {s["id"]: s for s in rec["spans"]}
    ns = sum(v for sid, v in _idle_by_span(ops, rec["spans"]).items()
             if sid is not None and _mine(_names(byid, sid)))
    scale = (data["timed_s"] / data["units"]) / (data["slice_s"]
                                                 / data["slice_units"])
    return ns * 1e-6 / data["slice_units"] * scale
