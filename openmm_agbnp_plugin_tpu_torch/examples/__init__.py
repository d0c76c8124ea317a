"""The JAX package's four examples (examples/) on the port.

  test_agbnp.py          install check: FIRE minimization, Langevin, then
                         Verlet energy drift on trp-cage (AGBNP_TEST_*
                         environment overrides of the step counts)
  rescore_conformers.py  a pose ensemble scored in one batched evaluation
  remd_trpcage.py        T-REMD over 8 temperature rungs
  multichip_md.py        trp-cage MD over an `atoms` mesh of ranks
                         (parallel/sharding.py::run_ranks, 8 by default)

Each runs on the card by default (float32) and takes `--device cpu`
(float64), as the JAX examples pick their dtype by platform:

    python -m openmm_agbnp_plugin_tpu_torch.examples.test_agbnp [--device cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def dms_path(system: str) -> str:
    """A shipped system's DMS file (benchmarks/data)."""
    return os.path.join(REPO, "benchmarks", "data", f"{system}.dms")


def parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def device_dtype(name):
    """(device, dtype): the card in float32 unless name is given; float64
    on the CPU."""
    if name is None or torch.device(name).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu")
        return torch.device(name or "cuda:0"), torch.float32
    return torch.device(name), torch.float64
