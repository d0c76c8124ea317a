"""The Langevin middle step (OpenMM's LangevinMiddleIntegrator) on the
reference's forces:

    v <- v + dt F(x) / m
    x <- x + dt/2 v
    v <- a v + sqrt(1 - a^2) sqrt(kT/m) xi,   a = exp(-friction dt)
    x <- x + dt/2 v

with xi the standard-normal draw of the step, handed in by the caller.
Units: nm, ps, kJ/mol, amu.
"""

from __future__ import annotations

import math

import torch

KB = 0.00831446261815324  # kJ/mol/K


def langevin(system, pos, vel, masses, noise, dt, temperature, friction):
    """Steps from (pos, vel), one for each draw in `noise`, in the system's
    dtype.  Returns (pos, vel, energies): the energy at the start of each
    step."""
    dtype = system.dtype
    pos, vel = pos.to(dtype), vel.to(dtype)
    inv_m = (1.0 / torch.as_tensor(masses, dtype=torch.float64,
                                   device=pos.device))[:, None]
    sigma = torch.sqrt(KB * temperature * inv_m).to(dtype)
    inv_m = inv_m.to(dtype)
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - a * a)
    energies = []
    for xi in noise:
        e, f = system.energy_forces(pos)
        energies.append(float(e))
        vel = vel + dt * f * inv_m
        pos = pos + 0.5 * dt * vel
        vel = a * vel + b * sigma * xi.to(dtype)
        pos = pos + 0.5 * dt * vel
    return pos, vel, energies
