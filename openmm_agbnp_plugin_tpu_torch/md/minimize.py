"""Energy minimization (FIRE) for MD setup.

Counterpart of the JAX package's md/minimize.py.  The reference workflow
minimizes before dynamics (simulation.minimizeEnergy(), reference
example/test_agbnp.py:49); here the equivalent is FIRE (fast inertial
relaxation engine) for a fixed number of iterations: no line searches, and
the state (step size, mixing factor, uphill counter) stays on the device,
so an iteration reads nothing back to the host.
"""

from __future__ import annotations

import torch

# diag entries whose running maxima a PanicButton check must see
_MAXKEYS = ("counts", "max_siblings", "neighbor_max")


def _fire_state(pos0, dt0, alpha0):
    return (pos0, torch.zeros_like(pos0),
            torch.tensor(dt0, dtype=pos0.dtype, device=pos0.device),
            torch.tensor(alpha0, dtype=pos0.dtype, device=pos0.device),
            torch.zeros((), dtype=torch.int64, device=pos0.device))


def _fire_update(pos, vel, dt, alpha, n_pos, force, dt_max, n_min, f_inc,
                 f_dec, alpha0, f_alpha):
    """One FIRE iteration given the force at pos."""
    power = torch.sum(force * vel)
    fnorm = torch.linalg.norm(force) + 1e-30
    vnorm = torch.linalg.norm(vel)
    vel_mixed = (1.0 - alpha) * vel + alpha * vnorm * force / fnorm

    uphill = power <= 0.0
    vel = torch.where(uphill, torch.zeros_like(vel), vel_mixed)
    n_pos = torch.where(uphill, 0, n_pos + 1)
    grow = (~uphill) & (n_pos > n_min)
    dt = torch.where(grow, torch.clamp(dt * f_inc, max=dt_max),
                     torch.where(uphill, dt * f_dec, dt))
    alpha = torch.where(grow, alpha * f_alpha,
                        torch.where(uphill, alpha0, alpha))

    vel = vel + dt * force
    pos = pos + dt * vel
    return pos, vel, dt, alpha, n_pos


def fire_minimize(force_fn, pos0, maxiter: int = 200, dt0: float = 1e-4,
                  dt_max: float = 2e-3, n_min: int = 5, f_inc: float = 1.1,
                  f_dec: float = 0.5, alpha0: float = 0.1,
                  f_alpha: float = 0.99):
    """Minimize energy; force_fn(pos) -> (energy, force[, aux]).

    Returns (pos, energy_trace [maxiter]).
    """
    pos, vel, dt, alpha, n_pos = _fire_state(pos0, dt0, alpha0)
    energies = []
    for _ in range(maxiter):
        out = force_fn(pos)
        energies.append(out[0])
        pos, vel, dt, alpha, n_pos = _fire_update(
            pos, vel, dt, alpha, n_pos, out[1], dt_max, n_min, f_inc, f_dec,
            alpha0, f_alpha)
    return pos, torch.stack(energies)


def make_fire_runner(force_fn, maxiter: int = 200, dt0: float = 1e-4,
                     dt_max: float = 2e-3, n_min: int = 5, f_inc: float = 1.1,
                     f_dec: float = 0.5, alpha0: float = 0.1,
                     f_alpha: float = 0.99):
    """FIRE minimizer over a dict-returning force function.

    force_fn(pos) -> dict with "energy", "force" and optionally "diag".
    Returns run(pos0) -> (pos_min, energy_trace [maxiter], diag), where
    diag is the first evaluation's diag with the overflow-checked counters
    ("counts", "max_siblings", "neighbor_max") replaced by running maxima
    over all iterations: minimization moves atoms, so the tree seen
    mid-way can be larger than at either end, and a PanicButton check
    must see the worst case.
    """

    def run(pos0):
        out = force_fn(pos0)
        diag0 = out.get("diag")
        dmax = ({} if diag0 is None
                else {k: diag0[k] for k in _MAXKEYS if k in diag0})
        pos, vel, dt, alpha, n_pos = _fire_state(pos0, dt0, alpha0)
        energies = []
        for it in range(maxiter):
            if it:
                out = force_fn(pos)
            diag = out.get("diag")
            if diag is not None:
                dmax = {k: torch.maximum(dmax[k], diag[k]) for k in dmax}
            energies.append(out["energy"])
            pos, vel, dt, alpha, n_pos = _fire_update(
                pos, vel, dt, alpha, n_pos, out["force"], dt_max, n_min,
                f_inc, f_dec, alpha0, f_alpha)
        diag = None if diag0 is None else {**diag0, **dmax}
        return pos, torch.stack(energies), diag

    return run
