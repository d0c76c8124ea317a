"""Replicas of one system as a batch on one device (ReplicaEnsemble,
T-REMD), and sharding over torch.distributed (parallel/sharding.py: the
replica and atoms meshes, run_ranks)."""

from .ensemble import ReplicaEnsemble
from .remd import TemperatureREMD, attempt_swaps, geometric_ladder
from .sharding import atom_mesh, replica_mesh, run_ranks, \
    sharded_energy_forces, sharded_pair_phases

__all__ = ["ReplicaEnsemble", "TemperatureREMD", "atom_mesh",
           "attempt_swaps", "geometric_ladder", "replica_mesh", "run_ranks",
           "sharded_energy_forces", "sharded_pair_phases"]
