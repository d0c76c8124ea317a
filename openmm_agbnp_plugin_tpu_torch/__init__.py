"""AGBNP/GaussVol implicit-solvent MD in PyTorch, with CUDA pair kernels.

A port of the JAX package `openmm_agbnp_plugin_tpu` (the reference it is
tested against), with the same module names:

  models/agbnp_torch.py   AGBNPModel, energy_forces, prepare_arrays
  ops/tree.py             the flattened Gaussian overlap tree
  ops/born.py             dense pair phases (the plain route)
  ops/kernels/pairs.py    the three pair sweeps on the dense tile grid, and
  ops/kernels/tiles.py    over interacting-tile lists: CUDA kernels + twins
  ops/neighbors.py        half neighbor lists, the cell grid
  md/simulation.py        Simulation: Langevin (with the vdW-compact and
                          impulse WU pass, r-RESPA MTS), Verlet, run_md
  md/integrators.py       Langevin, MTS, WU-impulse and Verlet steps
  md/constraints.py       SHAKE/RATTLE; md/vsites.py virtual sites;
  md/minimize.py          FIRE
  io/checkpoint.py        exact-resume checkpoints; io/dcd.py trajectories
  runtime/build.py        builds csrc/*.cu with nvcc at first kernel use

This package imports torch and numpy only; nothing is built at import.
"""

from .io.dms import load_dms
from .io.gaussvol_dat import load_gaussvol_dat
from .md.simulation import Simulation
from .models.agbnp_torch import AGBNPModel, arrays_from_numpy, \
    energy_forces, prepare_arrays
from .models.params import AGBNPParams
from .ops.tree import TreeCaps

__all__ = ["AGBNPModel", "AGBNPParams", "Simulation", "TreeCaps",
           "arrays_from_numpy", "energy_forces", "load_dms",
           "load_gaussvol_dat", "prepare_arrays"]
