"""The public AGBNPForce / Context surface of the port, the batched
conformer scorer and the hydration-site helper."""

from .force import AGBNPForce, Context, NonbondedMethod
from .hydration import HydrationSites
from .scoring import ConformerScorer

__all__ = ["AGBNPForce", "ConformerScorer", "Context", "HydrationSites",
           "NonbondedMethod"]
