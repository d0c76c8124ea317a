"""AGBNP/GaussVol implicit-solvent MD in PyTorch, with CUDA pair kernels.

A port of the JAX package `openmm_agbnp_plugin_tpu` (the reference it is
tested against), with the same module names:

  models/agbnp_torch.py   AGBNPModel, energy_forces, prepare_arrays
  models/agbnp2_torch.py  AGBNP2Model, agbnp2_energy (version 2)
  models/oracle.py        float64 golden reference implementation (NumPy:
                          GaussVol's L0 API, gvolsa/agbnp1_energy_forces;
                          models/oracle_agbnp2.py agbnp2_energy_forces)
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
  ops/kernels/rows.py     the tree's row gather and prefix sum (probes)
  api/force.py            AGBNPForce, Context, NonbondedMethod
  api/scoring.py          ConformerScorer (batched pose scoring, FIRE refine)
  api/fitting.py          ParameterGradients (d energy / d gamma, alpha,
                          charge over pose batches)
  api/hydration.py        HydrationSites (virtual hydration sites)
  parallel/ensemble.py    ReplicaEnsemble: R replicas' MD as one batch
  parallel/remd.py        TemperatureREMD, attempt_swaps, geometric_ladder
  parallel/sharding.py    atom and replica meshes over torch.distributed,
                          sharded_energy_forces, run_ranks
  runtime/native.py       the f64 native GaussVol/AGBNP1 engine (g++)
  examples/               the JAX package's four examples on the port
  utils/                  AGBNPHtable; energy_breakdown, tree_stats;
                          profiling.py: the program's spans and counters
                          (span, count, recorded), and trace(logdir): a
                          torch.profiler trace with program_spans.json
  runtime/build.py        builds csrc/*.cu with nvcc at first kernel use

Replicas of one system run as a batch on one device: positions [B, N, 3]
through batched_energy_forces (one overlap tree over the replicas' disjoint
union, the pair kernels' replica axis).  Across processes, a replica mesh
splits the replicas into blocks and an atoms mesh one system's tree levels
and pair rows (parallel/sharding.py).

This package imports torch and numpy only; nothing is built at import.
"""

from .api.fitting import ParameterGradients
from .api.force import AGBNPForce, Context, NonbondedMethod
from .api.hydration import HydrationSites
from .api.scoring import ConformerScorer
from .io.dms import load_dms
from .io.gaussvol_dat import load_gaussvol_dat
from .md.simulation import Simulation
from .models.agbnp2_torch import AGBNP2Model
from .models.agbnp_torch import AGBNPModel, arrays_from_numpy, \
    batched_diag_max, batched_energy_forces, energy_forces, prepare_arrays
from .models.params import AGBNPParams
from .ops.tree import TreeCaps
from .parallel.ensemble import ReplicaEnsemble
from .parallel.remd import TemperatureREMD, attempt_swaps, geometric_ladder

__all__ = ["AGBNP2Model", "AGBNPForce", "AGBNPModel", "AGBNPParams",
           "ConformerScorer", "Context", "HydrationSites", "NonbondedMethod",
           "ParameterGradients", "ReplicaEnsemble", "Simulation", "TemperatureREMD", "TreeCaps",
           "arrays_from_numpy", "attempt_swaps", "batched_diag_max",
           "batched_energy_forces", "energy_forces", "geometric_ladder",
           "load_dms", "load_gaussvol_dat", "prepare_arrays"]
