"""The WU split of AGBNP1's force and the Langevin middle step with the WU
force as an r-RESPA impulse, on reference/agbnp.py's System, any dtype.

The WU force is the part of -dE/dx that flows through the self volumes
where they enter the Born radii's screening factors, s = selfv / vol_vdw:
the self-volume-gradient force that the plugin computes in its W and U
passes (ReferenceAGBNPKernels.cpp's gamma rescans over the derivatives of
the vdW and GB energies by the self volumes).  Without it, the force is
-dE/dx with the self volumes held where they enter s: the volume and
cavity terms, the Born radii's distance derivatives, GB, vdW and OPLS.

The impulse (r-RESPA: Tuckerman, Berne & Martyna, J. Chem. Phys. 97, 1990
(1992)) treats the WU force as a slow class of period k dt: from the
first step of a trajectory, each block of k steps starts with a kick by
the force without WU plus k times the WU force, and its other k - 1 steps
kick with the force without WU.  A trajectory of n steps ends with a
block of n mod k steps, whose impulse weighs its own length.  The energy
of every step is the exact energy: the split touches forces only.

Imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from .agbnp import System
from .langevin import KB


class WUSystem(System):
    """System with energy_forces_split.  While the split runs, the vdW
    tree pass's self volumes enter the screening factors as a leaf of the
    autograd graph, whose gradient is taken apart."""

    _cut = None

    def _tree_pass(self, pos, levels, radius, vol, gamma):
        energy, selfv = super()._tree_pass(pos, levels, radius, vol, gamma)
        if self._cut is not None and vol is self.v_vdw:
            # the vdW pass: its self volumes make s (agbnp_energy)
            leaf = selfv.detach().requires_grad_(True)
            self._cut.append((selfv, leaf))
            return energy, leaf
        return energy, selfv

    def energy_forces_split(self, pos, wu: bool = True):
        """(energy, force without WU, WU force) at pos [N, 3]; wu=False
        leaves the WU force out (None).  The force without WU is minus the
        gradient with the self volumes held where they enter s; the WU
        force is minus the self volumes' share of the gradient, their
        vector-Jacobian product with dE/dselfv, so the two add up to
        energy_forces' force."""
        self._cut = []
        try:
            with torch.enable_grad():
                x = pos.detach().to(self.dtype).requires_grad_(True)
                e = self.energy(x)
                [(selfv, leaf)] = self._cut
                gx, gs = torch.autograd.grad(e, (x, leaf), retain_graph=wu)
                f_wu = None
                if wu:
                    (gw,) = torch.autograd.grad(selfv, x, grad_outputs=gs)
                    f_wu = -gw
        finally:
            self._cut = None
        return e.detach(), -gx, f_wu


def wu_impulse_langevin(system, pos, vel, masses, noise, dt, temperature,
                        friction, k):
    """Steps from (pos, vel), one for each draw in `noise`, in the system's
    dtype (a WUSystem): reference/langevin.py's middle step, with step i
    kicking by F + j F_WU when i % k == 0 (j = min(k, steps - i), the
    block's length) and by F otherwise, F the force without WU.  Returns
    (pos, vel, energies): the energy at the start of each step."""
    dtype = system.dtype
    pos, vel = pos.to(dtype), vel.to(dtype)
    inv_m = (1.0 / torch.as_tensor(masses, dtype=torch.float64,
                                   device=pos.device))[:, None]
    sigma = torch.sqrt(KB * temperature * inv_m).to(dtype)
    inv_m = inv_m.to(dtype)
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - a * a)
    steps = len(noise)
    energies = []
    for i, xi in enumerate(noise):
        impulse = i % k == 0
        e, f, f_wu = system.energy_forces_split(pos, wu=impulse)
        if impulse:
            f = f + min(k, steps - i) * f_wu
        energies.append(float(e))
        vel = vel + dt * f * inv_m
        pos = pos + 0.5 * dt * vel
        vel = a * vel + b * sigma * xi.to(dtype)
        pos = pos + 0.5 * dt * vel
    return pos, vel, energies
