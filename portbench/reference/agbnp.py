"""Plain PyTorch reference of AGBNP1 implicit solvent + OPLS, any dtype.

Written for the benchmark from the published model, independent of the
program under test: it imports nothing of it and takes nothing it made.
Float64 is the reference; a lower dtype is the benchmark's control.

AGBNP1 (Gallicchio & Levy, J. Comput. Chem. 25, 479 (2004); the OpenMM
AGBNP plugin's Reference platform, ReferenceAGBNPKernels.cpp, and its
GaussVol overlap tree, gaussvol.cpp):

* GaussVol: atoms are Gaussians (exponent KFC / r^2, volume 4/3 pi r^3,
  hydrogens without volume); the overlap tree enumerates products of
  Gaussians order by order up to MAX_ORDER.  A node's children are its
  products with the last atoms of its younger siblings, kept when their
  switched volume s(V) V exceeds MIN_GVOL and ordered by descending
  switched volume.  Every node of order L contributes (-1)^(L+1) / L of
  its switched volume to each of its L atoms' self volumes and, times the
  sum of its atoms' gammas, to the volume energy.  The cavity energy is
  that energy with the radii grown by 0.05 nm and gamma / 0.05, plus the
  energy on the same tree with the vdW radii and -gamma / 0.05.
* Born radii: 1/B_i = 1/R_i - 1/(4 pi) sum_j s_j Q4(d_ij; R_i, R_j) over
  heavy screeners j within the descreening horizon, s_j = self volume /
  vdW sphere volume, Q4 from 16-node natural cubic splines of the I4
  integral switched to zero between 1 and 2 nm; 1/B soft-filtered.
* GB: sum_i f q_i^2 / B_i + sum_{i != j, d < cutoff} f q_i q_j /
  sqrt(d^2 + B_i B_j exp(-d^2 / 4 B_i B_j)), f = -0.5 (1 - 1/80) x
  138.9 kJ/mol nm (the plugin's 4.184 x 332 / 10).
* vdW dispersion: sum_i alpha_i / (B_i + 0.14 nm)^3.

OPLS from the DMS file: harmonic bonds and angles, the trigonometric
dihedral series, the 1-4 pair table, and LJ (geometric rules) + Coulomb
over the pairs within the cutoff that are not excluded, cut off sharply.

Forces are minus the gradient of the energy by autograd: the tree's
topology is fixed at the positions where it was built, as in the
analytic force chain of the plugin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .i4 import I4Tables

KFC = 2.2269859253          # sphere -> Gaussian exponent factor
MIN_GVOL = 1.1754943508222875e-38   # FLT_MIN, the tree's pruning volume
MAX_ORDER = 8
VOLMINA = 1e-5              # nm^3, the switching window of overlap volumes
VOLMINB = 1e-4
ROFFSET = 0.05              # nm, the cavity energy's radius increment
HB_RADIUS = 0.14            # nm, the vdW dispersion's Born radius offset
I4_MAXA = 2.0               # nm, the I4 tables' horizon
DIELECTRIC = 4.184 * 332.0 / 10.0 * -0.5 * (1.0 - 1.0 / 80.0)
PIFAC = 1.0 / (4.0 * math.pi)
COULOMB = 138.935456        # kJ mol^-1 nm e^-2, OpenMM's ONE_4PI_EPS0
# nm: a float32 distance near 1 nm computed from float32 coordinates is
# off by up to ~2e-7 nm (a few ulps of its square), so a pair this close
# to a sharp cut-off may fall on either side of it
CUT_BAND = 5e-7


def sphere_volume(r):
    return 4.0 / 3.0 * math.pi * r ** 3


def _switch(v):
    """The overlap volumes' quintic switch s(v): 0 below VOLMINA, 1 above
    VOLMINB."""
    u = ((v - VOLMINA) / (VOLMINB - VOLMINA)).clamp(0.0, 1.0)
    mid = u ** 3 * (10.0 - 15.0 * u + 6.0 * u * u)
    return torch.where(v > VOLMINB, torch.ones_like(v),
                       torch.where(v < VOLMINA, torch.zeros_like(v), mid))


def _product(v1, a1, c1, v2, a2, c2):
    """The product of Gaussians (v1, a1, c1) and (v2, a2, c2): its volume,
    exponent and centre, and its switched volume."""
    a12 = a1 + a2
    df = a1 * a2 / a12
    d2 = torch.sum((c2 - c1) ** 2, dim=-1)
    v = v1 * v2 * (df / math.pi) ** 1.5 * torch.exp(-df * d2)
    c12 = (c1 * a1[:, None] + c2 * a2[:, None]) / a12[:, None]
    return v, a12, c12, _switch(v) * v


def _pairs_within(pos, rmax, mask=None, block=2048):
    """Pairs i < j with |x_j - x_i| < rmax (of atoms in mask), found in
    row blocks: (i, j) int64 tensors."""
    n = pos.shape[0]
    ids = torch.arange(n, device=pos.device)
    out_i, out_j = [], []
    for s in range(0, n, block):
        rows = ids[s:s + block]
        d2 = torch.sum((pos[None, :, :] - pos[rows, None, :]) ** 2, dim=-1)
        keep = (d2 < rmax * rmax) & (ids[None, :] > rows[:, None])
        if mask is not None:
            keep &= mask[rows, None] & mask[None, :]
        r, c = torch.nonzero(keep, as_tuple=True)
        out_i.append(rows[r])
        out_j.append(c)
    return torch.cat(out_i), torch.cat(out_j)


def _order(parent, vol):
    """Stable order by parent, then by descending switched volume."""
    by_vol = torch.sort(-vol, stable=True).indices
    return by_vol[torch.sort(parent[by_vol], stable=True).indices]


class System:
    """One AGBNP1 + OPLS system prepared in a dtype on a device.

    sysd: read_dms's dict; cutoff: the GB and MM cutoff (nm, None: none);
    horizon: the Born sums' horizon (nm, None: the I4 tables' 2 nm);
    include_mm: add the OPLS force field."""

    def __init__(self, sysd, device, dtype=torch.float64, cutoff=None,
                 horizon=None, include_mm=True):
        self.device = torch.device(device)
        self.dtype = dtype
        self.n = sysd["n"]
        self.cutoff = cutoff
        self.horizon = I4_MAXA if horizon is None else min(horizon, I4_MAXA)
        self.include_mm = include_mm
        h = sysd["hydrogen"]
        r = sysd["radius"]
        gamma = np.where(h, 0.0, sysd["gamma"])

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x), dtype=dt,
                                   device=self.device)

        self.heavy = t(~h, torch.bool)
        self.radius = t(r)
        self.r_large = t(r + ROFFSET)
        self.vol_vdw = t(sphere_volume(r))
        self.v_large = t(np.where(h, 0.0, sphere_volume(r + ROFFSET)))
        self.v_vdw = t(np.where(h, 0.0, sphere_volume(r)))
        self.g_off = t(gamma / ROFFSET)
        self.charge = t(sysd["charge"])
        self.alpha = t(sysd["alpha"])
        tab = I4Tables(r, h)
        self.ti = t(tab.type_screened, torch.int64)
        self.tj = t(np.maximum(tab.type_screener, 0), torch.int64)
        self.ntj = tab.y.shape[1]
        self.spline_y = t(tab.y.reshape(-1))
        self.spline_y2 = t(tab.y2.reshape(-1))
        self.spline_h = tab.h
        # the largest distance at which two heavy atoms' large Gaussians
        # can reach VOLMINA (below it the switch is 0 and the pair pruned)
        rl = np.unique(r[~h] + ROFFSET)
        ai, aj = np.meshgrid(KFC / rl ** 2, KFC / rl ** 2)
        vi, vj = np.meshgrid(sphere_volume(rl), sphere_volume(rl))
        df = ai * aj / (ai + aj)
        arg = np.log(vi * vj * (df / math.pi) ** 1.5 / VOLMINA) / df
        self.tree_rmax = float(np.sqrt(np.maximum(arg, 0.0)).max()) + 1e-3
        if include_mm:
            self.mm = {k: t(sysd[k], torch.int64 if k.endswith("_idx")
                            else dtype)
                       for k in ("bond_idx", "bond_r0", "bond_k",
                                 "angle_idx", "angle_theta0", "angle_k",
                                 "dihedral_idx", "dihedral_phi0",
                                 "dihedral_fc", "pair_idx", "pair_aij",
                                 "pair_bij", "pair_qij")}
            self.sigma = t(sysd["sigma"])
            self.sqrt_eps = t(np.sqrt(sysd["epsilon"]))
            ex = np.sort(sysd["exclusions"], axis=1)
            self.excl_keys = torch.unique(t(ex[:, 0] * self.n + ex[:, 1],
                                            torch.int64))

    # -- the overlap tree ------------------------------------------------

    def _level1(self, pos, radius, vol):
        return vol, KFC / (radius * radius), pos

    def topology(self, pos):
        """The tree's nodes by order, built at pos with the large radii:
        a list of (parent index into the order below, last atom, atoms
        [M, L]) for L = 2 .. MAX_ORDER."""
        with torch.no_grad():
            gv1, ga1, gc1 = self._level1(pos, self.r_large, self.v_large)
            i, j = _pairs_within(pos, self.tree_rmax, self.heavy)
            v, a, c, sv = _product(gv1[i], ga1[i], gc1[i], gv1[j], ga1[j],
                                   gc1[j])
            keep = sv > MIN_GVOL
            i, j, v, a, c, sv = i[keep], j[keep], v[keep], a[keep], \
                c[keep], sv[keep]
            o = _order(i, sv)
            parent, atom = i[o], j[o]
            atoms = torch.stack([parent, atom], dim=1)
            v, a, c = v[o], a[o], c[o]
            levels = [(parent, atom, atoms)]
            for _ in range(3, MAX_ORDER + 1):
                m = parent.shape[0]
                if m == 0:
                    break
                # each node against the younger siblings after it
                start = torch.ones(m, dtype=torch.bool, device=pos.device)
                start[1:] = parent[1:] != parent[:-1]
                gid = torch.cumsum(start.long(), 0) - 1
                first = torch.nonzero(start, as_tuple=True)[0]
                size = torch.bincount(gid)
                rank = torch.arange(m, device=pos.device) - first[gid]
                younger = size[gid] - 1 - rank
                src = torch.repeat_interleave(
                    torch.arange(m, device=pos.device), younger)
                base = torch.cumsum(younger, 0) - younger
                q = src + 1 + (torch.arange(src.shape[0], device=pos.device)
                               - base[src])
                qa = atom[q]
                v2, a2, c2, sv2 = _product(v[src], a[src], c[src], gv1[qa],
                                           ga1[qa], gc1[qa])
                keep = sv2 > MIN_GVOL
                src, qa = src[keep], qa[keep]
                o = _order(src, sv2[keep])
                parent, atom = src[o], qa[o]
                atoms = torch.cat([atoms[parent], atom[:, None]], dim=1)
                v, a, c = v2[keep][o], a2[keep][o], c2[keep][o]
                levels.append((parent, atom, atoms))
        return levels

    def _tree_pass(self, pos, levels, radius, vol, gamma):
        """Volume energy and self volumes on a fixed tree: radius, vol,
        gamma per atom (vol 0 for hydrogens)."""
        gv, ga, gc = self._level1(pos, radius, vol)
        energy = torch.sum(gamma * gv)
        selfv = gv
        pv, pa, pc = gv, ga, gc
        for order, (parent, atom, atoms) in enumerate(levels, start=2):
            v, a, c, sv = _product(pv[parent], pa[parent], pc[parent],
                                   gv[atom], ga[atom], gc[atom])
            coef = (1.0 if order % 2 else -1.0) / order
            energy = energy + coef * torch.sum(gamma[atoms].sum(dim=1) * sv)
            selfv = selfv.index_add(
                0, atoms.reshape(-1),
                (coef * sv)[:, None].expand(atoms.shape).reshape(-1))
            pv, pa, pc = v, a, c
        return energy, selfv

    # -- pair terms --------------------------------------------------------

    def _spline(self, d, ti, tj):
        h = self.spline_h
        seg = torch.clamp(torch.floor(d / h).long(), 0, 14)
        base = (ti * self.ntj + tj) * 16 + seg
        y0, y1 = self.spline_y[base], self.spline_y[base + 1]
        z0, z1 = self.spline_y2[base], self.spline_y2[base + 1]
        a = (seg.to(d.dtype) * h + h - d) / h
        b = 1.0 - a
        return (a * y0 + b * y1
                + ((a ** 3 - a) * z0 + (b ** 3 - b) * z1) * (h * h) / 6.0)

    def agbnp_energy(self, pos, levels, pi, pj, d, inside):
        """AGBNP1 energy at pos on the tree `levels`, over the pairs (pi,
        pj) at distances d (every pair within the horizon and cutoff),
        `inside` their membership of the Born sums and the GB pair sum."""
        e1, _ = self._tree_pass(pos, levels, self.r_large, self.v_large,
                                self.g_off)
        e2, selfv = self._tree_pass(pos, levels, self.radius, self.v_vdw,
                                    -self.g_off)
        s = selfv / self.vol_vdw
        near = inside["born"]
        beta = 1.0 / self.radius
        for a, b in ((pi, pj), (pj, pi)):
            m = near & self.heavy[b]
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
        return e1 + e2 + gb_self + gb_pair + evdw

    def mm_energy(self, pos, pi, pj, d, inside):
        """OPLS: bonded terms, 1-4 pairs, LJ + Coulomb over the pairs
        within the cutoff that are not excluded."""
        mm = self.mm

        def at(idx, k):
            return pos[idx[:, k]]

        bi = mm["bond_idx"]
        r = torch.linalg.vector_norm(at(bi, 1) - at(bi, 0), dim=-1)
        e = torch.sum(mm["bond_k"] * (r - mm["bond_r0"]) ** 2)
        ai = mm["angle_idx"]
        u, w = at(ai, 0) - at(ai, 1), at(ai, 2) - at(ai, 1)
        cos = torch.sum(u * w, -1) / torch.sqrt(
            torch.sum(u * u, -1) * torch.sum(w * w, -1))
        theta = torch.arccos(torch.clamp(cos, -1.0, 1.0))
        e = e + torch.sum(mm["angle_k"] * (theta - mm["angle_theta0"]) ** 2)
        di = mm["dihedral_idx"]
        b1, b2, b3 = (at(di, 1) - at(di, 0), at(di, 2) - at(di, 1),
                      at(di, 3) - at(di, 2))
        n1, n2 = torch.linalg.cross(b1, b2), torch.linalg.cross(b2, b3)
        phi = torch.atan2(
            torch.sum(torch.linalg.cross(n1, n2) * b2, -1)
            / torch.linalg.vector_norm(b2, dim=-1), torch.sum(n1 * n2, -1))
        k = torch.arange(7, device=pos.device, dtype=pos.dtype)
        e = e + torch.sum(mm["dihedral_fc"] * torch.cos(
            k[None, :] * (phi - mm["dihedral_phi0"])[:, None]))
        p = mm["pair_idx"]
        r2 = torch.sum((at(p, 1) - at(p, 0)) ** 2, -1)
        inv6 = r2 ** -3
        e = e + torch.sum(mm["pair_aij"] * inv6 * inv6 - mm["pair_bij"] * inv6
                          + COULOMB * mm["pair_qij"] / torch.sqrt(r2))
        m = inside["mm"]
        a, b, dd = pi[m], pj[m], d[m]
        sr6 = (self.sigma[a] * self.sigma[b] / (dd * dd)) ** 3
        eps = self.sqrt_eps[a] * self.sqrt_eps[b]
        return e + torch.sum(4.0 * eps * (sr6 * sr6 - sr6)
                             + COULOMB * self.charge[a] * self.charge[b] / dd)

    def _pairs(self, pos):
        """The pairs within reach of a sum at pos, their distances, and
        whether each is inside the Born sums' horizon, the GB cutoff and
        (not excluded) the MM cutoff."""
        reach = math.inf if self.cutoff is None else max(self.horizon,
                                                          self.cutoff)
        with torch.no_grad():
            pi, pj = _pairs_within(pos.detach(), reach)
        d = torch.linalg.vector_norm(pos[pj] - pos[pi], dim=-1)
        inside = {"born": d < self.horizon}
        inside["gb"] = (d < self.cutoff if self.cutoff is not None
                        else torch.ones_like(inside["born"]))
        if self.include_mm:
            inside["mm"] = inside["gb"] & ~torch.isin(pi * self.n + pj,
                                                      self.excl_keys)
        return pi, pj, d, inside

    def energy(self, pos, flip=None):
        """The total energy at pos [N, 3] (differentiable in pos); flip
        (sum, pair): that pair's membership of that sum reversed."""
        levels = self.topology(pos.detach())
        pi, pj, d, inside = self._pairs(pos)
        if flip is not None:
            inside[flip[0]] = inside[flip[0]].clone()
            inside[flip[0]][flip[1]] ^= True
        e = self.agbnp_energy(pos, levels, pi, pj, d, inside)
        if self.include_mm:
            e = e + self.mm_energy(pos, pi, pj, d, inside)
        return e

    def energy_interval(self, pos):
        """(E, E_lo, E_hi) at pos: the energy, and the range a sum over
        the same pairs reaches when each pair within CUT_BAND of a sharp
        cut-off (the GB and MM cutoff, a Born horizon short of the
        tables') falls on its other side, as a float32 distance may put
        it (each pair's effect taken alone and the effects added)."""
        with torch.no_grad():
            e0 = float(self.energy(pos))
            pi, pj, d, inside = self._pairs(pos)
            cuts = {"gb": self.cutoff, "mm": self.cutoff,
                    "born": self.horizon if self.horizon < I4_MAXA else None}
            lo = hi = e0
            for name, cut in cuts.items():
                if cut is None or name not in inside:
                    continue
                band = torch.abs(d - cut) < CUT_BAND
                if name == "mm":
                    band &= ~torch.isin(pi * self.n + pj, self.excl_keys)
                if name == "born":
                    band &= self.heavy[pi] | self.heavy[pj]
                for k in torch.nonzero(band).flatten().tolist():
                    delta = float(self.energy(pos, (name, k))) - e0
                    lo, hi = lo + min(delta, 0.0), hi + max(delta, 0.0)
        return e0, lo, hi

    def energy_forces(self, pos):
        """(energy, force = -dE/dx) at pos [N, 3]."""
        with torch.enable_grad():
            x = pos.detach().to(self.dtype).requires_grad_(True)
            e = self.energy(x)
            (g,) = torch.autograd.grad(e, x)
        return e.detach(), -g
