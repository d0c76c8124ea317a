"""The public AGBNPForce / Context surface of the port."""

from .force import AGBNPForce, Context, NonbondedMethod

__all__ = ["AGBNPForce", "Context", "NonbondedMethod"]
