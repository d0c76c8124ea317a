"""Differentiable AGBNP: gradients of the energy with respect to model
parameters over conformation batches.

Counterpart of the JAX package's api/fitting.py.  The reference's energy is
C++/OpenCL, so fitting AGBNP parameters (surface tensions gamma, dispersion
coefficients alpha, charges) against target data there means finite
differences over full re-evaluations; here d(energy)/d(theta) is one
reverse-mode pass through the PyTorch evaluation.

Fittable parameters and where they enter (reference semantics):
  * gamma  - cavity surface tension (per atom; hydrogen gammas are pinned
    to zero as in ReferenceAGBNPKernels.cpp:100-116, so their gradient is
    exactly zero);
  * alpha  - vdW dispersion coefficient, E_vdw = sum alpha_i/(B_i+rw)^3
    (ReferenceAGBNPKernels.cpp:513-521);
  * charge - GB self and pair energies (cpp:464-504).

Radii are not fittable here: the descreening spline tables are built on
the host per radius-type pair (models/i4_tables.py); use finite
differences with AGBNPModel.update_params for radii.

The evaluation is the model's plain route (AGBNPModel(pair_kernel=False):
the dense ops/born.py pair phases), as in JAX: the pair kernels have no
backward.  The overlap tree's row gathers (ops/kernels/rows.py::take_rows)
run their kernel on a card inside an autograd.Function whose backward is
a deterministic segment sum, so gradients are the same bits from run to
run.  A mixed model (AGBNPModel(mixed=True)) evaluates with its pair
sums widened to float64, as JAX's does (api/fitting.py:87), and autograd
goes through the widened sums.  Everything runs on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.agbnp_torch import batched_energy_forces

FITTABLE = ("gamma", "alpha", "charge")


class ParameterGradients:
    """Differentiable energies over a conformation batch.

    theta is a dict with any subset of {"gamma", "alpha", "charge"}, each
    an [N] array (numpy or a tensor); its entries override the model's
    parameter arrays inside the evaluation.  Results are tensors on the
    model's device.

    model: an AGBNPModel of version 0 or 1 on the plain pair route
    (pair_kernel=False)."""

    def __init__(self, model):
        if model.pair_pad > 0:
            raise ValueError(
                "ParameterGradients requires the plain pair route (construct "
                "the model with pair_kernel=False): the pair kernels carry "
                "no backward")
        if model.version not in (0, 1):
            raise ValueError("versions 0 and 1 are supported")
        self._model = model
        self.device = model.device

    @property
    def model(self):
        return self._model

    def initial_theta(self, keys=FITTABLE) -> dict:
        """The model's current parameters as a theta dict: float64 tensors
        [N] on the model's device."""
        p = self._model.params
        src = dict(gamma=p.gamma, alpha=p.alpha, charge=p.charge)
        return {k: torch.as_tensor(np.asarray(src[k], np.float64),
                                   device=self.device) for k in keys}

    def _theta(self, theta: dict) -> dict:
        """theta's entries as tensors on the model's device (a tensor keeps
        its autograd history)."""
        for k in theta:
            if k not in FITTABLE:
                raise ValueError(f"unknown parameter {k!r}; fittable: "
                                 f"{FITTABLE}")
        return {k: (v.to(self.device) if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v, np.float64),
                                         device=self.device))
                for k, v in theta.items()}

    def _poses(self, poses):
        m = self._model
        pos = torch.as_tensor(poses, dtype=m.dtype, device=self.device)
        if pos.dim() == 2:
            pos = pos[None]
        if pos.dim() != 3 or pos.shape[1:] != (m.params.n, 3):
            raise ValueError(f"poses [B, {m.params.n}, 3], got "
                             f"{tuple(pos.shape)}")
        return pos

    def _energy(self, theta: dict, pos):
        """Energies [B] of poses pos [B, N, 3] at parameters theta (tensors
        on the device), differentiable in theta.  The energy-only
        evaluation: the WU force pass carries force only, and the energy is
        bitwise that of the full evaluation."""
        m = self._model
        a = dict(m.arrays)
        if "gamma" in theta:
            a["gamma"] = torch.where(a["ishydrogen"] != 0, 0.0,
                                     theta["gamma"].to(m.dtype))
        if "alpha" in theta:
            a["alpha"] = theta["alpha"].to(m.dtype)
        if "charge" in theta:
            a["charge"] = theta["charge"].to(m.dtype)
        out = batched_energy_forces(
            a, pos, caps=m.caps, version=m.version, roffset=m.params.roffset,
            ntypes_j=m.ntypes_j, cutoff=m.cutoff, box=m.box,
            descreen_horizon=m.descreen_horizon,
            neighbor_rcut=m.neighbor_rcut, neighbor_kmax=m.neighbor_kmax,
            neighbor_grid=m.neighbor_grid, wu_mode="skip", mixed=m.mixed)
        return out["energy"]

    def energies(self, theta: dict, poses):
        """Energies [B] at parameters theta, one batched evaluation."""
        theta = self._theta(theta)
        with torch.no_grad():
            return self._energy(theta, self._poses(poses))

    def energy_grads(self, theta: dict, poses):
        """Per-pose parameter gradients: a dict of [B, N] tensors d E_b /
        d theta_k (plus "energy" [B]), from one evaluation and one
        torch.autograd.grad a pose."""
        theta = self._theta(theta)
        pos = self._poses(poses)
        keys = sorted(theta)
        grads = {k: [] for k in keys}
        energies = []
        for b in range(pos.shape[0]):
            leaves = {k: theta[k].detach().requires_grad_(True)
                      for k in keys}
            with torch.enable_grad():
                e = self._energy(leaves, pos[b:b + 1])[0]
                gs = torch.autograd.grad(e, [leaves[k] for k in keys])
            energies.append(e.detach())
            for k, g in zip(keys, gs):
                grads[k].append(g)
        out = {k: torch.stack(v) for k, v in grads.items()}
        out["energy"] = torch.stack(energies)
        return out

    def make_loss_grad(self, loss_fn):
        """vg(theta, poses) -> (loss, grads) for loss_fn(energies [B]) ->
        a scalar tensor: one batched evaluation and one backward pass;
        grads is a dict like theta (tensors on the device).  It serves a
        plain torch.optim loop (copy grads into the parameters' .grad)."""

        def vg(theta, poses):
            theta = self._theta(theta)
            pos = self._poses(poses)
            keys = sorted(theta)
            leaves = {k: theta[k].detach().requires_grad_(True)
                      for k in keys}
            with torch.enable_grad():
                loss = loss_fn(self._energy(leaves, pos))
                gs = torch.autograd.grad(loss, [leaves[k] for k in keys])
            return loss.detach(), dict(zip(keys, gs))

        return vg
