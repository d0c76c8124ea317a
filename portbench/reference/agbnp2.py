"""Plain PyTorch reference of AGBNP2 implicit solvent + OPLS, any dtype.

Written for the benchmark from the published model, independent of the
program under test: it imports nothing of it and takes nothing it made.
Float64 is the reference; a lower dtype is the benchmark's control.

AGBNP2 (Gallicchio, Paris & Levy, J. Chem. Theory Comput. 5, 2544
(2009); the OpenMM AGBNP plugin's version 2, its Reference platform
ReferenceAGBNPKernels.cpp:797-1793) is AGBNP1 (reference/agbnp.py) with
a radius increment of 0.01 nm and molecular-surface (MS) water-probe
particles that fill the solvent-excluded crevices between heavy atoms:

* Atomic volumes: the GaussVol tree of the heavy atoms, built with the
  radii grown by 0.01 nm; the volume energy with gamma / 0.01 at those
  radii and with -gamma / 0.01 at the vdW radii on the same tree, each
  pass giving the atoms' self volumes.
* MS particles: one for each heavy pair i < j (in that order) whose
  switched volume is positive: with q = sqrt(R_i R_j) / r_w (r_w = 0.1
  nm, V_w its sphere's volume), volume V = 0.17 q^2 V_w exp(-(d -
  d_ms)^2 / 2 sigma^2), d_ms = R_i + R_j + r_w / 2, sigma = 0.5 sqrt(q)
  r_w, switched by s(V) V (a quintic from 0 at 0.25 A^3 to 1 at 1 A^3);
  placed at x_i + f (x_j - x_i), f = (1 + (R_i - R_j) / d) / 2; a
  Gaussian of radius r_w.
* Free volumes: each particle's volume less its switched overlaps with
  the other heavy atoms' Gaussians (every heavy atom but its parents),
  each atom weighted by its self volume: at the large radii with the
  large self volumes, and at the vdW radii with the vdW self volumes;
  each switched by the MS switch.
* The MS tree: the GaussVol tree of the particles, built on their vdW
  free volumes; the volume energy with -gamma_c / 0.01 on the vdW free
  volumes and +gamma_c / 0.01 on the large ones over the same tree
  (gamma_c: the first heavy atom's gamma); the vdW pass's self volumes
  of the particles go half to each parent's vdW self volume.
* Born radii, GB and vdW dispersion as in AGBNP1 on those self volumes,
  with the Born sums over the I4 tables' 2 nm and the GB pair sum cut at
  the cutoff (CutoffNonPeriodic).  OPLS as reference/agbnp.py has it.

At every evaluation the particles and both trees are made afresh at the
positions.  Forces are minus the gradient of the energy by autograd,
with the particle set and both trees' topologies held at the positions
where they were made.

Where this departs from the plugin's Reference platform (its AGBNP2 is
marked work in progress upstream):

* Forces are the exact gradient of the energy.  The plugin's analytic
  chain gives each particle half of parent 1's U and half of parent 2's
  W (cpp:1593-1600) and leaves out the leg of the particle's position in
  the atoms' overlaps with it; both are whole here.
* A particle whose two free volumes are below 0.25 A^3 stays in the set
  with switched volume 0 (the plugin drops it): the same energy.
* The GB pair sum is cut sharply at the cutoff, as the plugin's OpenCL
  platform does in cutoff mode; the Born sums keep the 2 nm horizon.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .agbnp import DIELECTRIC, HB_RADIUS, I4_MAXA, KFC, MIN_GVOL, PIFAC, \
    VOLMINA, System, _pairs_within, _switch, sphere_volume

ROFFSET2 = 0.01             # nm, AGBNP2's radius increment
SOLVENT_RADIUS = 0.1        # nm, r_w
MS_VOL_COEFF = 0.17
MS_VOLA = 0.25e-3           # nm^3: the MS switch's window, 0.25 to 1 A^3
MS_VOLB = 1.0e-3


def _ms_switch(v):
    """The MS volumes' quintic switch: 0 below MS_VOLA, 1 above MS_VOLB."""
    u = ((v - MS_VOLA) / (MS_VOLB - MS_VOLA)).clamp(0.0, 1.0)
    return u ** 3 * (10.0 - 15.0 * u + 6.0 * u * u)


def _gaussian_reach(v, a):
    """The distance past which two Gaussians of volume v and exponent a
    overlap by less than VOLMINA (where the switch is 0)."""
    df = 0.5 * a
    pref = v * v * (df / math.pi) ** 1.5
    return math.sqrt(max(math.log(pref / VOLMINA), 0.0) / df)


class _Spheres:
    """A set of Gaussian spheres for System.topology: the MS particles,
    with the free volumes the tree is built on."""

    _level1 = System._level1

    def __init__(self, radius, vol, rmax):
        self.r_large, self.v_large, self.tree_rmax = radius, vol, rmax
        self.heavy = torch.ones(vol.shape, dtype=torch.bool,
                                device=vol.device)


class AGBNP2System(System):
    """One AGBNP2 + OPLS system prepared in a dtype on a device.

    sysd: read_dms's dict (or one with n, hydrogen, radius, gamma, alpha,
    charge alone when include_mm is False); cutoff: the GB and MM cutoff
    (nm, None: none).  The Born sums run to the I4 tables' 2 nm."""

    def __init__(self, sysd, device, dtype=torch.float64, cutoff=None,
                 include_mm=True):
        super().__init__(sysd, device, dtype, cutoff, None, include_mm)
        h = sysd["hydrogen"]
        r = np.asarray(sysd["radius"], dtype=np.float64)
        gamma = np.where(h, 0.0, sysd["gamma"])

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        # the atomic tree at AGBNP2's increment; the pair reach AGBNP1's
        # larger radii gave stays a bound (a pair past it is pruned anyway)
        self.r_large = t(r + ROFFSET2)
        self.v_large = t(np.where(h, 0.0, sphere_volume(r + ROFFSET2)))
        self.g_off = t(gamma / ROFFSET2)
        self.gamma_ms = float(gamma[~h][0]) / ROFFSET2 if (~h).any() else 0.0
        rw = SOLVENT_RADIUS
        self.a_ms = KFC / rw ** 2
        # the largest particle volume, and the heavy pairs' reach: past
        # it every pair's volume is below MS_VOLA, where the switch is 0
        rmax = float(r[~h].max()) if (~h).any() else 0.0
        q = rmax / rw
        v0 = MS_VOL_COEFF * q * q * sphere_volume(rw)
        spread = 0.5 * math.sqrt(q) * rw * math.sqrt(
            2.0 * max(math.log(v0 / MS_VOLA), 0.0))
        self.ms_rmax = 2.0 * rmax + 0.5 * rw + spread + 1e-3
        self.ms_tree_rmax = _gaussian_reach(v0, self.a_ms) + 1e-3

    # -- the MS particles --------------------------------------------------

    def ms_particles(self, pos):
        """The particles at pos: dict(pos [M, 3], vol [M], p1, p2 [M]),
        positions and volumes differentiable in pos."""
        with torch.no_grad():
            i, j = _pairs_within(pos.detach(), self.ms_rmax, self.heavy)
        rw = SOLVENT_RADIUS
        r1, r2 = self.radius[i], self.radius[j]
        q = torch.sqrt(r1 * r2) / rw
        d = torch.linalg.vector_norm(pos[j] - pos[i], dim=-1)
        sigma = 0.5 * torch.sqrt(q) * rw
        vol = MS_VOL_COEFF * q * q * sphere_volume(rw) * torch.exp(
            -0.5 * (d - (r1 + r2 + 0.5 * rw)) ** 2 / (sigma * sigma))
        vol = vol * _ms_switch(vol)
        keep = (vol > MIN_GVOL).detach()
        i, j, vol, d = i[keep], j[keep], vol[keep], d[keep]
        f = 0.5 * (1.0 + (self.radius[i] - self.radius[j]) / d)
        x = pos[i] + f[:, None] * (pos[j] - pos[i])
        return dict(pos=x, vol=vol, p1=i, p2=j)

    def free_volumes(self, ms, pos, radius, selfv):
        """Each particle's volume less its switched overlaps with every
        heavy atom but its parents (atom Gaussians at `radius`, weighted
        by the self volumes `selfv`), switched by the MS switch."""
        a = KFC / (radius * radius)
        df = self.a_ms * a / (self.a_ms + a)
        d2 = torch.sum((pos[None, :, :] - ms["pos"][:, None, :]) ** 2, dim=-1)
        g = (ms["vol"][:, None] * selfv[None, :] * (df / math.pi) ** 1.5
             * torch.exp(-df * d2))
        atom = torch.arange(self.n, device=pos.device)
        sub = (self.heavy[None, :] & (atom[None, :] != ms["p1"][:, None])
               & (atom[None, :] != ms["p2"][:, None]))
        fv = ms["vol"] - torch.sum(torch.where(sub, _switch(g) * g, 0.0),
                                   dim=-1)
        return fv * _ms_switch(fv)

    def ms_tree(self, ms, fv_vdw, fv_large):
        """The MS tree's two passes: (vdW energy, large energy, the
        particles' vdW self volumes)."""
        x = ms["pos"]
        if x.shape[0] == 0:
            zero = torch.sum(fv_vdw)
            return zero, zero, fv_vdw
        rw = torch.full_like(fv_vdw, SOLVENT_RADIUS)
        g = torch.full_like(fv_vdw, self.gamma_ms)
        with torch.no_grad():
            levels = System.topology(
                _Spheres(rw, fv_vdw.detach(), self.ms_tree_rmax), x.detach())
        e_vdw, selfv = self._tree_pass(x, levels, rw, fv_vdw, -g)
        e_large, _ = self._tree_pass(x, levels, rw, fv_large, g)
        return e_vdw, e_large, selfv

    # -- the energy ----------------------------------------------------------

    def agbnp_energy(self, pos, levels, pi, pj, d, inside):
        """AGBNP2 energy at pos on the atomic tree `levels`, over the pairs
        (pi, pj) at distances d, `inside` their membership of the Born
        sums and the GB pair sum."""
        e1, sv_large = self._tree_pass(pos, levels, self.r_large,
                                       self.v_large, self.g_off)
        e2, sv_vdw = self._tree_pass(pos, levels, self.radius, self.v_vdw,
                                     -self.g_off)
        ms = self.ms_particles(pos)
        fv_large = self.free_volumes(ms, pos, self.r_large, sv_large)
        fv_vdw = self.free_volumes(ms, pos, self.radius, sv_vdw)
        e_ms_vdw, e_ms_large, sv_ms = self.ms_tree(ms, fv_vdw, fv_large)
        selfv = (sv_vdw.index_add(0, ms["p1"], 0.5 * sv_ms)
                 .index_add(0, ms["p2"], 0.5 * sv_ms))
        return (e1 + e2 + e_ms_vdw + e_ms_large
                + self.gb_vdw(selfv, pi, pj, d, inside))

    def gb_vdw(self, selfv, pi, pj, d, inside):
        """Born radii from the self volumes, then the GB self and pair
        energies and the vdW dispersion."""
        s = selfv / self.vol_vdw
        beta = 1.0 / self.radius
        for a, b in ((pi, pj), (pj, pi)):
            m = inside["born"] & self.heavy[b]
            q = self._spline(d[m], self.ti[a[m]], self.tj[b[m]])
            beta = beta.index_add(0, a[m], -PIFAC * s[b[m]] * q)
        amin = 1.0 / I4_MAXA
        filt = torch.where(beta >= 0,
                           torch.sqrt(amin * amin
                                      + torch.clamp(beta, min=0.0) ** 2),
                           torch.full_like(beta, amin))
        born = 1.0 / filt
        q = self.charge
        gb_self = torch.sum(DIELECTRIC * q * q / born)
        m = inside["gb"]
        a, b, dd = pi[m], pj[m], d[m]
        bb = born[a] * born[b]
        d2 = dd * dd
        fgb = 1.0 / torch.sqrt(d2 + bb * torch.exp(-0.25 * d2 / bb))
        gb_pair = torch.sum(2.0 * DIELECTRIC * q[a] * q[b] * fgb)
        evdw = torch.sum(self.alpha / (born + HB_RADIUS) ** 3)
        return gb_self + gb_pair + evdw
