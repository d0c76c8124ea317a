"""Replicas of one system as a batch on one device: ReplicaEnsemble and
T-REMD."""

from .ensemble import ReplicaEnsemble
from .remd import TemperatureREMD, attempt_swaps, geometric_ladder

__all__ = ["ReplicaEnsemble", "TemperatureREMD", "attempt_swaps",
           "geometric_ladder"]
