"""Per-particle AGBNP parameters (numpy, shared by every compute path)."""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import AGBNP_RADIUS_INCREMENT


@dataclasses.dataclass
class AGBNPParams:
    """Per-particle parameters, mirroring AGBNPForce::addParticle semantics.

    radius: vdW radius [nm]; gamma: surface tension [kJ/mol/nm^2];
    alpha: solute-solvent dispersion parameter; charge: electric charge [e];
    ishydrogen: 1 for hydrogens (no volume, never descreens).
    Hydrogen gammas are zeroed as in reference
    ReferenceAGBNPKernels.cpp:96-118.
    """

    radius: np.ndarray
    gamma: np.ndarray
    alpha: np.ndarray
    charge: np.ndarray
    ishydrogen: np.ndarray
    roffset: float = AGBNP_RADIUS_INCREMENT

    def __post_init__(self):
        self.radius = np.asarray(self.radius, dtype=np.float64)
        self.gamma = np.where(np.asarray(self.ishydrogen) > 0, 0.0,
                              np.asarray(self.gamma, dtype=np.float64))
        self.alpha = np.asarray(self.alpha, dtype=np.float64)
        self.charge = np.asarray(self.charge, dtype=np.float64)
        self.ishydrogen = np.asarray(self.ishydrogen, dtype=np.int64)

    @property
    def n(self):
        return self.radius.shape[0]

    @property
    def radii_large(self):
        return self.radius + self.roffset

    @property
    def radii_vdw(self):
        return self.radius
