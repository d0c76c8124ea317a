"""Profiling and observability helpers.

The reference's observability is verbose_level couts of per-term energies
and per-section iteration counts (reference ReferenceAGBNPKernels.cpp:328-352,
OpenCLAGBNPKernels.cpp:3649-3665).  The equivalents here:
  * energy_breakdown: per-term energies from the pipeline's details dict
  * tree_stats: per-level occupancy vs capacity (the NIterations analogue)
  * trace: torch.profiler wrapper writing a TensorBoard trace
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def energy_breakdown(details: dict) -> dict:
    """Scalar energy terms from an energy_forces(with_details=True) output's
    details."""
    out = {}
    for key in ("e_vol1", "e_vol2", "e_cav", "gb_self", "gb_pair", "e_vdw"):
        if key in details:
            out[key] = float(details[key])
    return out


def tree_stats(diag) -> dict:
    """Per-level occupancy diagnostics (overlap counts vs capacities), as
    numpy arrays on the host."""
    def host(x):
        return np.asarray(torch.as_tensor(x).cpu())

    counts = host(diag["counts"])
    caps = host(diag["caps"])
    return dict(counts=counts, caps=caps,
                occupancy=counts / np.maximum(caps, 1),
                max_siblings=host(diag["max_siblings"]))


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a block with torch.profiler (host and, where there is a
    card, device activity); the trace lands under `logdir` for TensorBoard.
    Yields the profiler, whose key_averages() hold the block's totals."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
