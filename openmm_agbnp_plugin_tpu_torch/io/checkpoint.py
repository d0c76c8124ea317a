"""Exact-resume MD checkpoints (the JAX package's io/checkpoint.py format).

The reference persists state only through the .dms file (its benchmark
scripts write final positions and velocities back, reference
example/trpcage_benchmark.py:9-43): a statistical restart that loses the
Langevin random stream.  Saving (step, positions, velocities, random
state) at a segment boundary instead lets `Simulation.run_md` resume and
reproduce the uninterrupted trajectory bitwise, since every reduction of
the step is deterministic.  Where the JAX format stores the PRNG key, this
one stores the torch.Generator's state (`get_state()` bytes) and the
device type it belongs to.

Format: a single .npz written atomically (tmp file + os.replace), so a
crash mid-write never corrupts the previous checkpoint.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

_FORMAT_VERSION = 1


def save_checkpoint(path: str, step: int, positions, velocities,
                    generator: torch.Generator,
                    meta: dict | None = None) -> None:
    """Atomically write an MD checkpoint.

    step is the number of completed MD steps; positions/velocities are
    [N, 3] (any device); generator is the Langevin noise generator as of
    that boundary.  meta is an optional JSON-serializable dict.
    """
    payload = dict(
        format_version=np.int64(_FORMAT_VERSION),
        step=np.int64(step),
        positions=positions.detach().cpu().numpy(),
        velocities=velocities.detach().cpu().numpy(),
        generator_state=generator.get_state().numpy(),
        generator_device=np.frombuffer(
            generator.device.type.encode(), dtype=np.uint8),
        meta=np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8),
    )
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> dict:
    """Read a checkpoint written by save_checkpoint.

    Returns dict(step, positions, velocities, generator_state,
    generator_device, meta); `restore_generator` turns the last three
    random-state fields back into a generator for run_md(generator=...).
    """
    with np.load(path) as z:
        version = int(z["format_version"])
        if version > _FORMAT_VERSION:
            raise ValueError(f"checkpoint format {version} is newer than "
                             f"this library supports ({_FORMAT_VERSION})")
        return dict(
            step=int(z["step"]),
            positions=z["positions"],
            velocities=z["velocities"],
            generator_state=z["generator_state"],
            generator_device=bytes(z["generator_device"]).decode(),
            meta=json.loads(bytes(z["meta"]).decode() or "{}"),
        )


def restore_generator(ck: dict, device=None) -> torch.Generator:
    """A torch.Generator in the state a checkpoint recorded.  device
    defaults to the recorded device type (its first device)."""
    dev = torch.device(ck["generator_device"] if device is None else device)
    if dev.type != ck["generator_device"]:
        raise ValueError(f"checkpoint generator is a {ck['generator_device']}"
                         f" generator, not {dev.type}")
    g = torch.Generator(device=dev)
    g.set_state(torch.as_tensor(ck["generator_state"], dtype=torch.uint8))
    return g
