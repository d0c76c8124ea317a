"""MD integrators on tensors.

The reference benchmarks use OpenMM's LangevinIntegrator at 300 K / 1 fs
(reference example/t4lysozyme_benchmark.py:21).  The step here is the
middle-scheme Langevin integrator (BAOAB family).  Randomness comes only
from an explicit torch.Generator, or from noise tensors the caller hands in
(so a test can feed another implementation's exact noise).

Units: nm, ps, kJ/mol, amu.  kB = 0.00831446261815324 kJ/mol/K.
"""

from __future__ import annotations

import math

import torch

KB = 0.00831446261815324  # kJ/mol/K


def kinetic_energy(vel, masses):
    return 0.5 * torch.sum(masses[:, None] * vel * vel)


def temperature(vel, masses):
    ndof = vel.shape[0] * 3
    return 2.0 * kinetic_energy(vel, masses) / (ndof * KB)


def maxwell_boltzmann_velocities(masses, temp, generator: torch.Generator,
                                 remove_com: bool = True):
    """Velocities drawn from the Maxwell-Boltzmann distribution at `temp`
    (OpenMM's setVelocitiesToTemperature analogue), on masses.device in
    masses.dtype.  With remove_com the center-of-mass drift is projected out
    and the sample rescaled so the kinetic temperature of the remaining DOF
    is exactly `temp`."""
    sigma = torch.sqrt(KB * temp / masses)[:, None]
    vel = sigma * torch.randn((masses.shape[0], 3), generator=generator,
                              dtype=masses.dtype, device=masses.device)
    if remove_com:
        m = masses[:, None]
        vel = vel - torch.sum(m * vel, dim=0) / torch.sum(m)
        ndof = masses.shape[0] * 3 - 3
        ke = 0.5 * torch.sum(m * vel * vel)
        vel = vel * torch.sqrt(0.5 * ndof * KB * temp / ke)
    return vel


def langevin_middle_step(force_fn, masses, dt, temp, friction):
    """One step of the middle-scheme Langevin integrator.

      v <- v + dt f(x)/m
      x <- x + dt/2 v
      v <- a v + sqrt(1-a^2) sqrt(kT/m) xi        (a = exp(-friction dt))
      x <- x + dt/2 v

    One force evaluation per step.  Returns step(pos, vel, noise) ->
    (pos, vel, energy, *aux) where noise is a standard-normal [N, 3] tensor
    and aux the extra outputs of force_fn(pos) -> (energy, force, *aux).
    """
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - a * a)
    inv_m = 1.0 / masses[:, None]
    sigma = torch.sqrt(KB * temp * inv_m)

    def step(pos, vel, noise):
        energy, force, *aux = force_fn(pos)
        vel = vel + dt * force * inv_m
        pos = pos + 0.5 * dt * vel
        vel = a * vel + b * sigma * noise
        pos = pos + 0.5 * dt * vel
        return (pos, vel, energy, *aux)

    return step
