"""Hydration-site helper, mirroring the reference's python AGBNPUtils.

Counterpart of the JAX package's api/hydration.py.  The reference adds
massless "hydration site" particles at hydrogen-bonding positions along a
heavy-atom--hydrogen axis via TwoParticleAverageSite virtual sites,
registering them with the nonbonded and AGBNP forces (reference
python/AGBNPUtils.py:5-67).  The same bookkeeping here builds the
VirtualSites table (md/vsites.py) the MD loop projects and spreads.
"""

from __future__ import annotations

import numpy as np

from ..md.vsites import VirtualSites

HO_DIST = 0.1  # nm, the reference's 1 A heavy-hydrogen reference distance


class HydrationSites:
    """Collects hydration virtual sites for a system + AGBNP force."""

    def __init__(self, agbnp_force=None):
        self.force = agbnp_force
        self._site = []
        self._p1 = []
        self._p2 = []
        self._w1 = []
        self._w2 = []

    def add_hydrogen_bonding_site(self, next_particle_index: int,
                                  heavy: int, hydrogen: int,
                                  distance: float) -> int:
        """Place a site along heavy->hydrogen at `distance` nm from heavy.

        Weights follow reference AGBNPUtils.py:28-31: w_heavy = 1 -
        d/d_OH, w_hydrogen = d/d_OH.  Returns the site index.  The site is
        appended to the AGBNP force (radius 0.15 nm, zero gamma/alpha/
        charge, not a hydrogen) if a force was given."""
        idx = next_particle_index
        self._site.append(idx)
        self._p1.append(heavy)
        self._p2.append(hydrogen)
        self._w1.append(1.0 - distance / HO_DIST)
        self._w2.append(distance / HO_DIST)
        if self.force is not None:
            self.force.addParticle(0.15, 0.0, 0.0, 0.0, False)
        return idx

    def virtual_sites(self) -> VirtualSites:
        return VirtualSites(
            site=np.asarray(self._site, dtype=np.int64),
            parent1=np.asarray(self._p1, dtype=np.int64),
            parent2=np.asarray(self._p2, dtype=np.int64),
            w1=np.asarray(self._w1),
            w2=np.asarray(self._w2),
        )
