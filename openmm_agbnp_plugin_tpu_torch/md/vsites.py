"""Two-particle-average virtual sites (hydration sites).

Counterpart of the JAX package's md/vsites.py.  The reference's Python
helper places massless hydration-site particles on a heavy-atom--hydrogen
axis as OpenMM TwoParticleAverageSite virtual sites (reference
python/AGBNPUtils.py:23-35).  The MD-loop equivalents here:

  * project_positions:  pos[site] = w1 pos[p1] + w2 pos[p2]
  * spread_forces:      F[p1] += w1 F[site]; F[p2] += w2 F[site];
                        F[site] = 0

Several sites can share a parent, so the spread goes through the
deterministic segment sum (no float atomics): MD stays bitwise repeatable.
Both act on the atom axis (-2): one system [N, 3] or R replicas [R, N, 3],
replica r getting the bits of its own [N, 3] call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.tree import batched_segment_sum


@dataclasses.dataclass
class VirtualSites:
    site: np.ndarray     # [S] particle indices of the sites
    parent1: np.ndarray  # [S]
    parent2: np.ndarray  # [S]
    w1: np.ndarray       # [S]
    w2: np.ndarray       # [S]

    @staticmethod
    def empty():
        z = np.zeros(0, dtype=np.int64)
        return VirtualSites(z, z, z, np.zeros(0), np.zeros(0))

    @property
    def count(self):
        return len(self.site)

    def arrays(self, dtype, *, device):
        """The table as tensors on `device` (weights in `dtype`)."""
        def ints(v):
            return torch.as_tensor(np.asarray(v, np.int64), device=device)

        def floats(v):
            return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

        return dict(site=ints(self.site), p1=ints(self.parent1),
                    p2=ints(self.parent2), w1=floats(self.w1),
                    w2=floats(self.w2))


def project_positions(pos, vs):
    """Set virtual-site positions from their parents (pos [..., N, 3])."""
    new = (vs["w1"][:, None] * pos[..., vs["p1"], :]
           + vs["w2"][:, None] * pos[..., vs["p2"], :])
    return pos.index_copy(-2, vs["site"], new)


def spread_forces(force, vs):
    """Redistribute site forces onto parents and zero the site forces
    (force [..., N, 3])."""
    fsite = force[..., vs["site"], :]
    n = force.shape[-2]
    add = (batched_segment_sum(vs["w1"][:, None] * fsite, vs["p1"], n)
           + batched_segment_sum(vs["w2"][:, None] * fsite, vs["p2"], n))
    return force.index_fill(-2, vs["site"], 0.0) + add
