"""Float64 oracle of AGBNP2 (version 2): molecular-surface solvent particles.

AGBNP2 augments the AGBNP1 pipeline with "MS" water-probe particles placed on
heavy-atom pairs: their Gaussian volumes capture solvent-excluded interstitial
space, a second overlap tree is built over them, and their self volumes are
added 50/50 to the parents before the Born-radius phase (reference:
platforms/reference/src/ReferenceAGBNPKernels.cpp:797-1793; MSParticle struct
ReferenceAGBNPKernels.h:105-121).  The reference marks AGBNP2 as work in
progress (README.md:9) and ships no golden outputs for it; this oracle
reproduces the shipped code's semantics (including its asymmetric mixed
U/W gamma assignment at cpp:1593-1600) and is validated by finite-difference
force checks, mirroring the reference's own (compiled-out) validation blocks.

Uses roffset = AGBNP2_RADIUS_INCREMENT (0.01 nm, AGBNPForce.h:27).

The port's own copy of the JAX package's models/oracle_agbnp2.py: numpy and
the port's models/ modules only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from .constants import (
    AGBNP2_RADIUS_INCREMENT,
    AGBNP_HB_RADIUS,
    AGBNP_I4LOOKUP_MAXA,
    DIELECTRIC_FACTOR,
    KFC,
    PI,
    PIFAC,
    SOLVENT_RADIUS,
    ANG3,
    sphere_volume,
)
from .i4_tables import I4LookupTables
from .oracle import AGBNPParams, GaussVol, agbnp_swf_invbr, ogauss_alpha, pol_switchfunc

# MS-sphere switching window (reference AGBNPForce.h:21-22)
VOLMINMSA = 0.25 * ANG3
VOLMINMSB = 1.00 * ANG3
FLT_MIN = 1.1754943508222875e-38
VOL_COEFF = 0.17  # reference cpp:899


@dataclasses.dataclass
class MSParticle:
    vol0: float
    pos: np.ndarray
    parent1: int
    parent2: int
    gder: np.ndarray
    hder: np.ndarray
    fms: float
    vol_large: float = 0.0
    ssp_large: float = 0.0
    G0_large: float = 0.0
    vol_vdw: float = 0.0
    ssp_vdw: float = 0.0
    G0_vdw: float = 0.0


def _make_ms_particles(params: AGBNPParams, pos):
    """Water-probe particles on overlapping heavy-atom pairs
    (reference cpp:895-980)."""
    radw = SOLVENT_RADIUS
    volw = sphere_volume(radw)
    out = []
    heavy = np.flatnonzero(params.ishydrogen == 0)
    rv = params.radii_vdw
    for a in range(len(heavy)):
        i = heavy[a]
        rad1 = rv[i]
        for b in range(a + 1, len(heavy)):
            j = heavy[b]
            rad2 = rv[j]
            q = math.sqrt(rad1 * rad2) / radw
            dist = pos[j] - pos[i]
            d = float(np.linalg.norm(dist))
            dms = rad1 + rad2 + 0.5 * radw
            volms0 = VOL_COEFF * q * q * volw
            sigma = 0.5 * math.sqrt(q) * radw
            volms = volms0 * math.exp(-0.5 * (d - dms) ** 2 / (sigma * sigma))
            s, sp = pol_switchfunc(volms, VOLMINMSA, VOLMINMSB)
            volmsw = volms * s
            sder = s + volms * sp
            if volmsw > FLT_MIN:
                fms = 0.5 * (1.0 + (rad1 - rad2) / d)
                posms = pos[j] * fms + pos[i] * (1.0 - fms)
                out.append(MSParticle(
                    vol0=volmsw, pos=posms, parent1=int(i), parent2=int(j),
                    gder=dist * (sder * (d - dms) * volms / (d * sigma * sigma)),
                    hder=dist * (0.5 * (rad1 - rad2) / (d ** 3)),
                    fms=fms))
    return out


def _ms_free_volumes(msps, params, pos, self_volume_large, self_volume_vdw):
    """Subtract self-volume-weighted atomic Gaussians from each MS sphere
    (reference cpp:1013-1070).  Returns the surviving particles."""
    radw = SOLVENT_RADIUS
    ams = KFC / (radw * radw)
    rl, rv = params.radii_large, params.radii_vdw
    survivors = []
    for msp in msps:
        fv_large = msp.vol0
        fv_vdw = msp.vol0
        G0_large = 0.0
        G0_vdw = 0.0
        for i in range(params.n):
            if params.ishydrogen[i] > 0 or i == msp.parent1 or i == msp.parent2:
                continue
            ai = KFC / (rl[i] * rl[i])
            sgv, gv, _, _, _, _, sfp = ogauss_alpha(
                msp.vol0, ams, msp.pos, self_volume_large[i], ai, pos[i])
            fv_large -= sgv
            G0_large += sfp * gv
            ai = KFC / (rv[i] * rv[i])
            sgv, gv, _, _, _, _, sfp = ogauss_alpha(
                msp.vol0, ams, msp.pos, self_volume_vdw[i], ai, pos[i])
            fv_vdw -= sgv
            G0_vdw += sfp * gv
        if fv_large > VOLMINMSA or fv_vdw > VOLMINMSA:
            s, sp = pol_switchfunc(fv_large, VOLMINMSA, VOLMINMSB)
            msp.vol_large = fv_large * s
            msp.ssp_large = s + sp * fv_large
            msp.G0_large = G0_large
            s, sp = pol_switchfunc(fv_vdw, VOLMINMSA, VOLMINMSB)
            msp.vol_vdw = fv_vdw * s
            msp.ssp_vdw = s + sp * fv_vdw
            msp.G0_vdw = G0_vdw
            survivors.append(msp)
    return survivors


def _ms_chain_forces(force, msps, pos, forces_ms, vol_dv_ms, params,
                     atom_self_vol, atom_radii, gvol, which: str,
                     pos_is_vdw_tree: bool):
    """The three MS->atom force chains shared by the MS passes
    (reference cpp:1226-1301, 1606-1670, 1703-1771):
      1. MS-position chain through the parent interpolation (hder/fms),
      2. MS-volume chain through the pair Gaussian (gder),
      3. MS-volume chain through atomic overlaps (direct + numsder gamma
         rescan on the atomic tree).
    Modifies `force` in place; returns numsder for the caller's rescan pass.
    """
    radw = SOLVENT_RADIUS
    ams = KFC / (radw * radw)
    n = params.n

    for ims, msp in enumerate(msps):
        i, j = msp.parent1, msp.parent2
        dist = pos[j] - pos[i]
        evprod = float(np.dot(forces_ms[ims], dist))
        gmsw = 1.0 - msp.fms
        force[i] += msp.hder * evprod + forces_ms[ims] * gmsw
        force[j] += msp.hder * (-evprod) + forces_ms[ims] * msp.fms

    for ims, msp in enumerate(msps):
        ssp = msp.ssp_vdw if which == "vdw" else msp.ssp_large
        G0m = msp.G0_vdw if which == "vdw" else msp.G0_large
        fv = ssp * vol_dv_ms[ims] * (1.0 - G0m / msp.vol0)
        force[msp.parent1] -= msp.gder * fv
        force[msp.parent2] += msp.gder * fv

    numsder = np.zeros(n)
    f_on_mspos = [np.zeros(3) for _ in msps]
    for i in range(n):
        if params.ishydrogen[i] > 0:
            continue
        voli = atom_self_vol[i]
        if which == "large" and voli <= 0:
            continue
        ai = KFC / (atom_radii[i] * atom_radii[i])
        for ims, msp in enumerate(msps):
            ssp = msp.ssp_vdw if which == "vdw" else msp.ssp_large
            sgv, gv, _, _, dVdr, _, sfp = ogauss_alpha(
                msp.vol0, ams, msp.pos, voli, ai, pos[i])
            w = (pos[i] - msp.pos) * (ssp * sfp * dVdr * vol_dv_ms[ims])
            force[i] += w
            # Newton pair: the same overlap depends on the MS position,
            # which rides the parents through the fms interpolation.  The
            # reference's WIP chain omits this leg (its FD checks are
            # compiled out); without it dE vs -F.dx fails at the few-percent
            # level.
            f_on_mspos[ims] -= w
            numsder[i] += ssp * sfp * gv * vol_dv_ms[ims]
        numsder[i] /= -voli if voli != 0 else 1.0

    for ims, msp in enumerate(msps):
        i, j = msp.parent1, msp.parent2
        dist = pos[j] - pos[i]
        evprod = float(np.dot(f_on_mspos[ims], dist))
        force[i] += msp.hder * evprod + f_on_mspos[ims] * (1.0 - msp.fms)
        force[j] += msp.hder * (-evprod) + f_on_mspos[ims] * msp.fms
    return numsder


def agbnp2_energy_forces(params_in: AGBNPParams, pos: np.ndarray,
                         i4_tables: I4LookupTables | None = None,
                         return_details: bool = False):
    """AGBNP2 (version 2) energy and analytic forces."""
    params = AGBNPParams(radius=params_in.radius, gamma=params_in.gamma,
                         alpha=params_in.alpha, charge=params_in.charge,
                         ishydrogen=params_in.ishydrogen,
                         roffset=AGBNP2_RADIUS_INCREMENT)
    n = params.n
    pos = np.asarray(pos, dtype=np.float64)
    if i4_tables is None:
        i4_tables = I4LookupTables(params.radii_vdw, params.ishydrogen)

    heavy_gammas = params.gamma[params.ishydrogen == 0]
    common_gamma = heavy_gammas[0] if len(heavy_gammas) else 0.0

    gv = GaussVol(n, params.ishydrogen)
    force = np.zeros((n, 3))
    energy = 0.0

    # atomic passes (cpp:813-885)
    gv.set_radii(params.radii_large)
    gv.set_gammas(params.gamma / params.roffset)
    vols_large = np.where(params.ishydrogen > 0, 0.0,
                          sphere_volume(params.radii_large))
    gv.set_volumes(vols_large)
    gv.compute_tree(pos)
    _, e1, f1, _, _, self_volume_large = gv.compute_volume(pos)
    force += f1
    energy += e1

    gv.set_radii(params.radii_vdw)
    gv.set_gammas(-params.gamma / params.roffset)
    gv.set_volumes(np.where(params.ishydrogen > 0, 0.0,
                            sphere_volume(params.radii_vdw)))
    gv.rescan_tree_volumes(pos)
    _, e2, f2, _, _, self_volume_vdw = gv.compute_volume(pos)
    force += f2
    energy += e2

    # MS particles (cpp:895-1070)
    msps = _make_ms_particles(params, pos)
    msps = _ms_free_volumes(msps, params, pos, self_volume_large,
                            self_volume_vdw)
    num_ms = len(msps)

    radw = SOLVENT_RADIUS
    self_volume = self_volume_vdw.copy()
    gvolms = None
    if num_ms > 0:
        pos_ms = np.array([m.pos for m in msps])
        gvolms = GaussVol(num_ms, np.zeros(num_ms, dtype=np.int64))
        gvolms.set_radii(np.full(num_ms, radw))
        gvolms.set_volumes(np.array([m.vol_vdw for m in msps]))
        gvolms.set_gammas(np.full(num_ms, -common_gamma / params.roffset))
        gvolms.compute_tree(pos_ms)
        _, e_ms2, fms_neg, dv_ms, _, selfvols_ms = gvolms.compute_volume(pos_ms)
        energy += e_ms2
        forces_ms = fms_neg  # already forces (negated gradient)

        numsder = _ms_chain_forces(force, msps, pos, forces_ms, dv_ms, params,
                                   self_volume_vdw, params.radii_vdw, gv,
                                   "vdw", True)
        gv.set_gammas(numsder)
        gv.rescan_tree_gammas()
        _, _, fW, _, _, _ = gv.compute_volume(pos)
        force += fW

        for ims, msp in enumerate(msps):
            self_volume[msp.parent1] += 0.5 * selfvols_ms[ims]
            self_volume[msp.parent2] += 0.5 * selfvols_ms[ims]

    # GB / vdW phases on the MS-augmented self volumes (cpp:1343-1557):
    # identical to AGBNP1 steps 5-12
    vol_vdw = sphere_volume(params.radii_vdw)
    s_factor = self_volume / vol_vdw

    inv_br_fp = np.zeros(n)
    born_radius = np.zeros(n)
    for i in range(n):
        b = 1.0 / params.radii_vdw[i]
        for j in range(n):
            if i == j or params.ishydrogen[j] > 0:
                continue
            d = float(np.linalg.norm(pos[j] - pos[i]))
            if d < AGBNP_I4LOOKUP_MAXA:
                b -= PIFAC * s_factor[j] * i4_tables.eval(
                    d, i4_tables.type_screened[i], i4_tables.type_screener[j])
        filt, fp = agbnp_swf_invbr(b)
        born_radius[i] = 1.0 / filt
        inv_br_fp[i] = fp

    egb_der_Y = np.zeros(n)
    gb_self = 0.0
    gb_pair = 0.0
    for i in range(n):
        gb_self += DIELECTRIC_FACTOR * params.charge[i] ** 2 / born_radius[i]
        for j in range(i + 1, n):
            dist = pos[j] - pos[i]
            d2 = float(np.dot(dist, dist))
            qqf = params.charge[j] * params.charge[i]
            qq = DIELECTRIC_FACTOR * qqf
            bb = born_radius[i] * born_radius[j]
            etij = math.exp(-0.25 * d2 / bb)
            fgb = 1.0 / math.sqrt(d2 + bb * etij)
            gb_pair += 2.0 * qq * fgb
            fgb3 = fgb ** 3
            mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
            g = dist * mw
            force[i] += g
            force[j] -= g
            ytij = qqf * (bb + 0.25 * d2) * etij * fgb3
            egb_der_Y[i] += ytij
            egb_der_Y[j] += ytij
    energy += gb_self + gb_pair

    evdw = float(np.sum(params.alpha / (born_radius + AGBNP_HB_RADIUS) ** 3))
    energy += evdw

    br = born_radius
    evdw_der_brw = (-PIFAC * 3.0 * params.alpha * br * br * inv_br_fp
                    / (br + AGBNP_HB_RADIUS) ** 4)
    egb_der_bru = (-PIFAC * DIELECTRIC_FACTOR
                   * (params.charge ** 2 + egb_der_Y * br) * inv_br_fp)

    evdw_der_W = np.zeros(n)
    egb_der_U = np.zeros(n)
    for i in range(n):
        for j in range(n):
            if i == j or params.ishydrogen[j] > 0:
                continue
            dist = pos[j] - pos[i]
            d = float(np.linalg.norm(dist))
            Qji = dQji = 0.0
            if d < AGBNP_I4LOOKUP_MAXA:
                ti = i4_tables.type_screened[i]
                tj = i4_tables.type_screener[j]
                Qji = i4_tables.eval(d, ti, tj)
                dQji = i4_tables.evalderiv(d, ti, tj)
            evdw_der_W[j] += evdw_der_brw[i] * Qji
            w = dist * (evdw_der_brw[i] * s_factor[j] * dQji / d)
            force[i] += w
            force[j] -= w
            egb_der_U[j] += egb_der_bru[i] * Qji
            w = dist * (egb_der_bru[i] * s_factor[j] * dQji / d)
            force[i] += w
            force[j] -= w

    gv.set_gammas(evdw_der_W / vol_vdw)
    gv.rescan_tree_gammas()
    _, _, fa, _, _, _ = gv.compute_volume(pos)
    force += fa
    gv.set_gammas(egb_der_U / vol_vdw)
    gv.rescan_tree_gammas()
    _, _, fb, _, _, _ = gv.compute_volume(pos)
    force += fb

    e_ms1 = 0.0
    if num_ms > 0:
        # GB/vdW derivatives through the MS self volumes (cpp:1589-1671);
        # the reference assigns each MS sphere half of parent1's U and half
        # of parent2's W (reproduced as-is)
        pos_ms = np.array([m.pos for m in msps])
        # NOTE: each MS self volume adds 0.5 to BOTH parents' self volumes,
        # so dE/d(selfvol_ms) = sum over both parents of half their U+W
        # sensitivities.  The reference's WIP code assigns only half of
        # parent1's U and half of parent2's W (cpp:1593-1600), which leaves
        # part of the gradient missing (its own FD checks are compiled out);
        # the complete chain rule is used here.
        gms = np.array([
            0.5 * (egb_der_U[m.parent1] + evdw_der_W[m.parent1])
            / sphere_volume(params.radii_vdw[m.parent1])
            + 0.5 * (egb_der_U[m.parent2] + evdw_der_W[m.parent2])
            / sphere_volume(params.radii_vdw[m.parent2])
            for m in msps])
        gvolms.set_gammas(gms)
        gvolms.rescan_tree_gammas()
        _, _, forces_ms, dv_ms, _, selfvols_ms = gvolms.compute_volume(pos_ms)
        numsder = _ms_chain_forces(force, msps, pos, forces_ms, dv_ms, params,
                                   self_volume_vdw, params.radii_vdw, gv,
                                   "vdw", True)
        gv.set_gammas(numsder)
        gv.rescan_tree_gammas()
        _, _, fc, _, _, _ = gv.compute_volume(pos)
        force += fc

        # MS pass with large-radius free volumes (cpp:1673-1771)
        gvolms.set_volumes(np.array([m.vol_large for m in msps]))
        gvolms.set_gammas(np.full(num_ms, common_gamma / params.roffset))
        gvolms.rescan_tree_volumes(pos_ms)
        _, e_ms1, forces_ms, dv_ms, _, selfvols_ms = gvolms.compute_volume(pos_ms)
        energy += e_ms1

        numsder = _ms_chain_forces(force, msps, pos, forces_ms, dv_ms, params,
                                   self_volume_large, params.radii_large, gv,
                                   "large", False)
        gv.set_gammas(numsder)
        gv.set_radii(params.radii_large)
        gv.set_volumes(vols_large)
        gv.rescan_tree_volumes(pos)
        _, _, fd, _, _, _ = gv.compute_volume(pos)
        force += fd

    if return_details:
        details = dict(e_vol1=e1, e_vol2=e2, gb_self=gb_self, gb_pair=gb_pair,
                       e_vdw=evdw, e_ms1=e_ms1, num_ms=num_ms,
                       born_radius=born_radius, self_volume=self_volume)
        return energy, force, details
    return energy, force
