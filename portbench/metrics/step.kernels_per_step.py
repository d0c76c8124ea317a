"""step.kernels_per_step: device kernels (memory copies and sets left
out) in the profiled slice over the slice's integrator steps (a step of
all replicas is one step)."""


def read(data):
    ops = data.get("device_ops")
    if data.get("kind") != "md" or not ops:
        return None
    kernels = sum(1 for name, _, _ in ops
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / data["slice_units"]
