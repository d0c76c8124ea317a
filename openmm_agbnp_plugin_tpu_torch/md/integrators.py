"""MD integrators on tensors.

The reference benchmarks use OpenMM's LangevinIntegrator at 300 K / 1 fs
and VerletIntegrator for energy-conservation checks (reference
example/t4lysozyme_benchmark.py:21, example/test_agbnp.py:58-64).  The
steps here are the JAX package's (md/integrators.py): middle-scheme
Langevin (BAOAB family), its r-RESPA variants (the MTS step and the WU
impulse steps) and velocity Verlet, each optionally constrained
(md/constraints.py: RATTLE after every kick, SHAKE against the pre-drift
positions plus the implied velocity fix-up after every drift).

Randomness comes only from noise tensors the caller hands in: one standard
normal [N, 3] draw per (sub)step, in the order JAX's key splits consume
them, so a test can feed JAX's exact stream.  Every step returns, last,
the largest SHAKE residual of its substeps (Constraints.shake: relative
distance error on the device, a 0-d tensor for one system, [R] for R
replicas) or None without constraints; the MD runners read it once per
window, with the overflow counts.

Units: nm, ps, kJ/mol, amu.  kB = 0.00831446261815324 kJ/mol/K.
"""

from __future__ import annotations

import math

import torch

from ..utils import profiling

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


def running_max(acc, x):
    """Elementwise max of two device diagnostics, None standing for
    absent (no constraints, or the first step)."""
    if acc is None:
        return x
    if x is None:
        return acc
    return torch.maximum(acc, x)


def _sigma(temp, inv_m):
    """sqrt(kT/m): [N, 1] for one bath temperature, [R, N, 1] for
    per-replica temperatures temp [R] (the replicas of a batch).  kT is
    formed in float64 and rounded once to inv_m's type."""
    kt = KB * torch.as_tensor(temp, dtype=torch.float64, device=inv_m.device)
    return torch.sqrt(kt.to(inv_m.dtype).reshape(kt.shape + (1, 1)) * inv_m)


def _ovrvo(pos, vel, force, noise, dt, inv_m, a, b, sigma, constraints,
           shake):
    """Kick by dt*force, then the middle scheme's drift / O-step / drift,
    constrained when constraints is given.  Returns (pos, vel, shake) with
    shake the running max SHAKE residual (per replica for [R, N, 3])."""
    vel = vel + dt * force * inv_m
    if constraints is not None:
        vel = constraints.velocities(pos, vel)
    pos0 = pos
    pos = pos + 0.5 * dt * vel
    vel = a * vel + b * sigma * noise
    pos = pos + 0.5 * dt * vel
    if constraints is not None:
        posc, resid = constraints.shake(pos, pos0)
        vel = vel + (posc - pos) / dt
        pos = posc
        shake = running_max(shake, resid)
    return pos, vel, shake


def langevin_middle_step(force_fn, masses, dt, temp, friction,
                         constraints=None):
    """One step of the middle-scheme Langevin integrator.

      v <- v + dt f(x)/m           [+ RATTLE]
      x <- x + dt/2 v
      v <- a v + sqrt(1-a^2) sqrt(kT/m) xi        (a = exp(-friction dt))
      x <- x + dt/2 v              [+ SHAKE vs pre-step x, velocity fixup]

    One force evaluation per step.  Returns step(pos, vel, noise) ->
    (pos, vel, energy, *aux, shake) where noise is a standard-normal [N, 3]
    tensor and aux the extra outputs of force_fn(pos) -> (energy, force,
    *aux).

    Replicas: with positions, velocities, forces and noise [R, N, 3] (a
    batched force_fn), every replica takes its own step; temp may then be
    a tensor [R] of per-replica bath temperatures (T-REMD's rungs), and
    the SHAKE residual is [R].
    """
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - a * a)
    inv_m = 1.0 / masses[:, None]
    sigma = _sigma(temp, inv_m)

    def step(pos, vel, noise):
        energy, force, *aux = force_fn(pos)
        pos, vel, shake = _ovrvo(pos, vel, force, noise, dt, inv_m, a, b,
                                 sigma, constraints, None)
        return (pos, vel, energy, *aux, shake)

    return step


def mts_langevin_step(slow_force_fn, fast_force_fn, masses, dt, temp,
                      friction, inner: int, constraints=None):
    """Multiple-timestep (r-RESPA) middle-scheme Langevin step.

    The expensive class (`slow_force_fn`: AGBNP + the MM nonbonded sum) is
    one impulse per outer step dt; the stiff cheap class (`fast_force_fn`:
    MM bonded + 1-4) integrates at delta = dt/inner:

      v <- v + dt F_slow(x)/m                        [+ RATTLE]
      repeat `inner` times (middle scheme at delta with F_fast):
        v <- v + delta F_fast(x)/m                   [+ RATTLE]
        x <- x + delta/2 v
        v <- a v + sqrt(1-a^2) sqrt(kT/m) xi         (a = e^{-friction delta})
        x <- x + delta/2 v                           [+ SHAKE, vel fixup]

    slow_force_fn(pos) -> (energy, force, *aux); fast_force_fn(pos) ->
    (energy, force).  Returns step(pos, vel, noise [inner, N, 3]) ->
    (pos, vel, energy_slow + energy_fast_at_start, *aux, shake); noise
    may be a list of inner draws or one tensor (the runner stacks them, a
    CUDA graph's static noise).  Each substep counts md.mts_substep.  With
    inner=1 the net kick at the same x and the same noise reproduce
    langevin_middle_step with the summed force.
    """
    delta = dt / inner
    a = math.exp(-friction * delta)
    b = math.sqrt(1.0 - a * a)
    inv_m = 1.0 / masses[:, None]
    sigma = torch.sqrt(KB * temp * inv_m)

    def step(pos, vel, noise):
        e_slow, f_slow, *aux = slow_force_fn(pos)
        vel = vel + dt * f_slow * inv_m
        if constraints is not None:
            vel = constraints.velocities(pos, vel)
        e_fast0 = None
        shake = None
        for i in range(inner):
            profiling.count("md.mts_substep")
            e_fast, f_fast = fast_force_fn(pos)
            e_fast0 = e_fast if e_fast0 is None else e_fast0
            pos, vel, shake = _ovrvo(pos, vel, f_fast, noise[i], delta, inv_m,
                                     a, b, sigma, constraints, shake)
        return (pos, vel, e_slow + e_fast0, *aux, shake)

    return step


def wu_impulse_langevin_steps(split_force_fn, skip_force_fn, masses, dt,
                              temp, friction, k: int, constraints=None):
    """Middle-Langevin steps with the WU self-volume-gradient force applied
    as an r-RESPA impulse every k steps (the `mts_wu` option).

    The WU gamma-rescan force pass differentiates switched self volumes,
    which change on the neighbor-rebuild timescale, so it is an r-RESPA slow
    class at period k*dt: the first step of each k-step block is the
    impulse step, which kicks with force + k*force_wu, and the other k-1
    steps skip the pass.  With k=1 the impulse step is langevin_middle_step
    with the fused force, bit for bit.

    split_force_fn(pos) -> (e, force_without_wu, force_wu, counts)
    skip_force_fn(pos)  -> (e, force_without_wu, counts)

    Returns schedule(nsteps) -> a list of nsteps steps, each step(pos, vel,
    noise [N, 3]) -> (pos, vel, energy, counts, shake): blocks of k steps
    from the first, a remainder block of nsteps % k closing the list (its
    impulse weighs its own length).  Steps of one kind are one callable,
    so md/graphs.py captures one graph a kind.  Each impulse step counts
    md.wu_impulse.  The energies are exact: the WU pass adds force only.
    The whole impulse lands at block start rather than as symmetric
    half-kicks, so the splitting is not NVE-grade time-symmetric.
    """
    a = math.exp(-friction * dt)
    b = math.sqrt(1.0 - a * a)
    inv_m = 1.0 / masses[:, None]
    sigma = torch.sqrt(KB * temp * inv_m)

    def impulse(j):
        def step(pos, vel, noise):
            e, force, f_wu, c = split_force_fn(pos)
            profiling.count("md.wu_impulse")
            pos, vel, shake = _ovrvo(pos, vel, force + j * f_wu, noise, dt,
                                     inv_m, a, b, sigma, constraints, None)
            return pos, vel, e, c, shake

        return step

    def skip(pos, vel, noise):
        e, force, c = skip_force_fn(pos)
        pos, vel, shake = _ovrvo(pos, vel, force, noise, dt, inv_m, a, b,
                                 sigma, constraints, None)
        return pos, vel, e, c, shake

    impulses = {}

    def schedule(nsteps: int):
        out = []
        for start in range(0, nsteps, k):
            j = min(k, nsteps - start)
            if j not in impulses:
                impulses[j] = impulse(j)
            out += [impulses[j]] + [skip] * (j - 1)
        return out

    return schedule


def mts_verlet_step(slow_force_fn, fast_force_fn, masses, dt, inner: int,
                    constraints=None):
    """Symmetric r-RESPA velocity Verlet (NVE): half slow kick, `inner`
    velocity-Verlet substeps with the fast force, half slow kick.

    Returns step(pos, vel, f_slow, f_fast) -> (pos, vel, f_slow, f_fast,
    pe, ke, *aux, shake), pe at the step's final positions.
    """
    inv_m = 1.0 / masses[:, None]

    def step(pos, vel, f_slow, f_fast):
        vel = vel + 0.5 * dt * f_slow * inv_m
        if constraints is not None:
            vel = constraints.velocities(pos, vel)
        delta = dt / inner
        e_fast = None
        shake = None
        for _ in range(inner):
            vel_half = vel + 0.5 * delta * f_fast * inv_m
            new_pos = pos + delta * vel_half
            if constraints is not None:
                posc, resid = constraints.shake(new_pos, pos)
                vel_half = vel_half + (posc - new_pos) / delta
                new_pos = posc
                shake = running_max(shake, resid)
            pos = new_pos
            e_fast, f_fast = fast_force_fn(pos)
            vel = vel_half + 0.5 * delta * f_fast * inv_m
        e_slow, f_slow, *aux = slow_force_fn(pos)
        vel = vel + 0.5 * dt * f_slow * inv_m
        if constraints is not None:
            vel = constraints.velocities(pos, vel)
        ke = kinetic_energy(vel, masses)
        return (pos, vel, f_slow, f_fast, e_slow + e_fast, ke, *aux, shake)

    return step


def velocity_verlet_step(force_fn, masses, dt, constraints=None):
    """Velocity Verlet; carries the force to avoid re-evaluation.  With
    constraints: SHAKE the drifted positions against the previous ones
    (with the matching half-kick velocity fix-up), RATTLE the final
    velocities.

    Returns step(pos, vel, force) -> (pos, vel, force, pe, ke, *aux,
    shake).
    """
    inv_m = 1.0 / masses[:, None]

    def step(pos, vel, force):
        vel_half = vel + 0.5 * dt * force * inv_m
        new_pos = pos + dt * vel_half
        shake = None
        if constraints is not None:
            posc, shake = constraints.shake(new_pos, pos)
            vel_half = vel_half + (posc - new_pos) / dt
            new_pos = posc
        energy, new_force, *aux = force_fn(new_pos)
        vel = vel_half + 0.5 * dt * new_force * inv_m
        if constraints is not None:
            vel = constraints.velocities(new_pos, vel)
        ke = kinetic_energy(vel, masses)
        return (new_pos, vel, new_force, energy, ke, *aux, shake)

    return step
