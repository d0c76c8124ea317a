"""md.regrows: PanicButton retries in the traced run's timed window (the
`regrows` that Simulation.run_md returns; the ensemble kind's own count
of windows retried after a regrow).  Moves ns_per_day: a retry reruns its
window."""


def read(data):
    return data.get("regrows") if data.get("kind") == "md" else None
