"""Molecular-mechanics force field terms (OPLS via Desmond DMS), PyTorch.

The reference plugin provides only the AGBNP force; its benchmarks take the
rest of the force field from the .dms files (reference
example/t4lysozyme_benchmark.py:8-10).  The bonded terms and 1-4 pairs are
energy functions here with forces from torch.autograd; the dense
LJ + Coulomb sum rides the GB pair sweep (ops/kernels/pairs.py::gb_pair),
and `dense_nonbonded_energy` is its plain twin.

Every term also takes B replicas' positions [B, N, 3] and returns the
energy of each [B]; forces_of then gives [B, N, 3].

Terms (units: nm, kJ/mol, ps, e):
  * stretch_harm:   E = fc (r - r0)^2
  * angle_harm:     E = fc (theta - theta0)^2
  * dihedral_trig:  E = sum_{n=0..6} fc_n cos(n (phi - phi0))
  * nonbonded:      OPLS geometric-rule LJ + Coulomb, exclusions masked,
                    pre-scaled 1-4 pair terms (aij/r^12 - bij/r^6 + ke qij/r)
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

ONE_4PI_EPS0 = 138.935456  # kJ mol^-1 nm e^-2


def _sum_terms(x, dims: int = 1):
    """Sum of the last `dims` axes of x (the terms of one system), per
    replica when x has more."""
    return torch.sum(x.reshape(x.shape[:x.dim() - dims] + (-1,)), dim=-1)


def _atoms(pos, ids):
    return pos[..., ids, :]


def bond_energy(pos, idx, r0, k):
    d = _atoms(pos, idx[:, 1]) - _atoms(pos, idx[:, 0])
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    return _sum_terms(k * (r - r0) ** 2)


def angle_energy(pos, idx, theta0, k):
    a = _atoms(pos, idx[:, 0]) - _atoms(pos, idx[:, 1])
    b = _atoms(pos, idx[:, 2]) - _atoms(pos, idx[:, 1])
    cosang = torch.sum(a * b, dim=-1) / torch.sqrt(
        torch.sum(a * a, dim=-1) * torch.sum(b * b, dim=-1))
    theta = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
    return _sum_terms(k * (theta - theta0) ** 2)


def dihedral_angle(pos, idx):
    b1 = _atoms(pos, idx[:, 1]) - _atoms(pos, idx[:, 0])
    b2 = _atoms(pos, idx[:, 2]) - _atoms(pos, idx[:, 1])
    b3 = _atoms(pos, idx[:, 3]) - _atoms(pos, idx[:, 2])
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    b2n = b2 / torch.linalg.norm(b2, dim=-1, keepdim=True)
    x = torch.sum(n1 * n2, dim=-1)
    y = torch.sum(torch.linalg.cross(n1, n2) * b2n, dim=-1)
    return torch.atan2(y, x)


def dihedral_energy(pos, idx, phi0, fc):
    phi = dihedral_angle(pos, idx)
    dphi = phi[..., None] - phi0[:, None]
    orders = torch.arange(fc.shape[1], dtype=pos.dtype,
                          device=pos.device)[None, :]
    return _sum_terms(fc * torch.cos(orders * dphi), 2)


def dense_nonbonded_energy(pos, charge, sigma, epsilon, cutoff=None,
                           excl_mask=None):
    """The dense all-pairs LJ + Coulomb double sum (OPLS geometric rules),
    excluded pairs ([N, N] bool, True = excluded) masked inside the sum."""
    n = pos.shape[-2]
    dist = pos[..., None, :, :] - pos[..., :, None, :]
    d2 = torch.sum(dist * dist, dim=-1)
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    d2s = torch.where(eye, 1.0, d2)

    # geometric combination (OPLS): sigma_ij = sqrt(si sj), eps_ij = sqrt(ei ej)
    sig2 = sigma[:, None] * sigma[None, :]   # = sigma_ij^2
    epsij = torch.sqrt(epsilon[:, None] * epsilon[None, :])
    sr2 = sig2 / d2s
    sr6 = sr2 * sr2 * sr2
    elj = 4.0 * epsij * (sr6 * sr6 - sr6)
    ecoul = ONE_4PI_EPS0 * charge[:, None] * charge[None, :] / torch.sqrt(d2s)

    mask = ~eye
    if excl_mask is not None:
        mask = mask & ~excl_mask
    if cutoff is not None:
        mask = mask & (d2s < cutoff * cutoff)
    return 0.5 * _sum_terms(torch.where(mask, elj + ecoul, 0.0), 2)


def pair14_energy(pos, pair_idx, pair_aij, pair_bij, pair_qij):
    """1-4 scaled pair terms (pre-scaled aij/bij/qij from the DMS tables)."""
    pi, pj = pair_idx[:, 0], pair_idx[:, 1]
    dxp = _atoms(pos, pj) - _atoms(pos, pi)
    d2p = torch.sum(dxp * dxp, dim=-1)
    inv2 = 1.0 / d2p
    inv6 = inv2 ** 3
    return _sum_terms(pair_aij * inv6 * inv6 - pair_bij * inv6
                      + ONE_4PI_EPS0 * pair_qij * torch.sqrt(inv2))


@dataclasses.dataclass
class MMForceField:
    """Static MM topology arrays prepared from a DMSSystem (host numpy;
    `tensors` moves them to a device)."""

    arrays: dict
    cutoff: float | None = None

    @staticmethod
    def from_dms(dms, cutoff=None, dtype=np.float64) -> "MMForceField":
        a = dict(
            bond_idx=np.asarray(dms.bond_idx, np.int64),
            bond_r0=np.asarray(dms.bond_r0, dtype),
            bond_k=np.asarray(dms.bond_k, dtype),
            angle_idx=np.asarray(dms.angle_idx, np.int64),
            angle_theta0=np.asarray(dms.angle_theta0, dtype),
            angle_k=np.asarray(dms.angle_k, dtype),
            dihedral_idx=np.asarray(dms.dihedral_idx, np.int64),
            dihedral_phi0=np.asarray(dms.dihedral_phi0, dtype),
            dihedral_fc=np.asarray(dms.dihedral_fc, dtype),
            charge=np.asarray(dms.charges, dtype),
            sigma=np.asarray(dms.lj_sigma, dtype),
            epsilon=np.asarray(dms.lj_epsilon, dtype),
            excl_idx=np.asarray(dms.exclusions, np.int64),
            pair_idx=np.asarray(dms.pair_idx, np.int64),
            pair_aij=np.asarray(dms.pair_aij, dtype),
            pair_bij=np.asarray(dms.pair_bij, dtype),
            pair_qij=np.asarray(dms.pair_qij, dtype),
            epsq=np.sqrt(np.asarray(dms.lj_epsilon, dtype)),
        )
        return MMForceField(arrays=a, cutoff=cutoff)

    def tensors(self, device, dtype=torch.float64) -> dict:
        """The arrays as tensors on `device` (floats as `dtype`)."""
        return {k: torch.as_tensor(v, dtype=(dtype if np.issubdtype(
                    v.dtype, np.floating) else None), device=device)
                for k, v in self.arrays.items()}

    def energy_bonded_and_14(self, pos, a):
        """Bonded terms + 1-4 pairs: the part that does not ride the GB
        sweep.  `a` is a tensors() dict on pos.device."""
        e = bond_energy(pos, a["bond_idx"], a["bond_r0"], a["bond_k"])
        e = e + angle_energy(pos, a["angle_idx"], a["angle_theta0"],
                             a["angle_k"])
        e = e + dihedral_energy(pos, a["dihedral_idx"], a["dihedral_phi0"],
                                a["dihedral_fc"])
        e = e + pair14_energy(pos, a["pair_idx"], a["pair_aij"],
                              a["pair_bij"], a["pair_qij"])
        return e

    def bonded_and_14_forces(self, pos, a):
        """(energy, force) of energy_bonded_and_14, force by autograd."""
        return self.forces_of(self.energy_bonded_and_14, pos, a)

    def energy(self, pos, a, excl_mask):
        """Total MM energy: bonded + 1-4 + the dense all-pairs LJ and
        Coulomb sum (excl_mask [N, N] bool on pos.device), as the JAX
        package's MMForceField.energy: what AGBNP versions 0 and 2 add,
        whose pair phases carry no MM sum."""
        return self.energy_bonded_and_14(pos, a) + self.energy_nonbonded(
            pos, a, excl_mask)

    def energy_nonbonded(self, pos, a, excl_mask):
        """The dense LJ + Coulomb sum alone (the slow r-RESPA class when
        the GB sweep does not carry it)."""
        return dense_nonbonded_energy(pos, a["charge"], a["sigma"],
                                      a["epsilon"], cutoff=self.cutoff,
                                      excl_mask=excl_mask)

    def forces_of(self, energy_fn, pos, *args):
        """(energy, force) of energy_fn(pos, *args), force by autograd
        (per replica for positions [B, N, 3]: energy [B])."""
        with torch.enable_grad():
            x = pos.detach().requires_grad_(True)
            e = energy_fn(x, *args)
            (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach(), -g

    def excl_mask(self):
        """[N, N] bool exclusion mask for dense_nonbonded_energy."""
        ex = self.arrays["excl_idx"]
        n = self.arrays["charge"].shape[0]
        m = np.zeros((n, n), bool)
        m[ex[:, 0], ex[:, 1]] = True
        m[ex[:, 1], ex[:, 0]] = True
        return m

    def excl_rows(self, max_excl: int | None = None):
        """Per-atom exclusion lists [N, E] (int32, -1 padded) for the
        in-kernel exclusion test of the fused pair sweep."""
        ex = self.arrays["excl_idx"]
        n = self.arrays["charge"].shape[0]
        lists = [[] for _ in range(n)]
        for i, j in ex:
            lists[int(i)].append(int(j))
            lists[int(j)].append(int(i))
        e = max(len(l) for l in lists) if lists else 0
        if max_excl is None:
            max_excl = max(8, (e + 7) // 8 * 8)
        if e > max_excl:
            raise ValueError(f"{e} exclusions on one atom > max_excl "
                             f"{max_excl}")
        out = np.full((n, max_excl), -1, np.int32)
        for i, l in enumerate(lists):
            out[i, :len(l)] = l
        return out
