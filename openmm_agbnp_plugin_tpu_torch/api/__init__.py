"""The public AGBNPForce / Context surface of the port, the batched
conformer scorer, parameter gradients and the hydration-site helper."""

from .fitting import FITTABLE, ParameterGradients
from .force import AGBNPForce, Context, NonbondedMethod
from .hydration import HydrationSites
from .scoring import ConformerScorer

__all__ = ["AGBNPForce", "ConformerScorer", "Context", "FITTABLE",
           "HydrationSites", "NonbondedMethod", "ParameterGradients"]
