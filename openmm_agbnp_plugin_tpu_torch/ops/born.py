"""Pairwise AGBNP1 phases: Born radii, GB energy, vdW dispersion, descreening.

Dense masked all-pairs formulations of the reference's O(N^2) sweeps
(reference: ReferenceAGBNPKernels.cpp:437-606 on CPU; AGBNPBornRadii.cl /
AGBNPGBEnergy.cl tile kernels on GPU).  The spline lookup is a plain gather
from the dense [ntypes_i, ntypes_j, NA] tables of models/i4_tables.py.
These back `AGBNPModel(pair_kernel=False)`; the per-atom tails
(`agbnp_swf_invbr`, `vdw_energy`, `born_chain_factors`) also serve the
kernel route.  `pair_phases_rows` runs all four phases on a row block of
screened atoms against every screener: the unit of the atom-sharded path
(parallel/sharding.py).
"""

from __future__ import annotations

import torch

from ..models.constants import (
    AGBNP_HB_RADIUS,
    AGBNP_I4LOOKUP_MAXA,
    AGBNP_I4LOOKUP_NA,
    DIELECTRIC_FACTOR,
    PIFAC,
)


def _spline_interp(d, seg, y0, y1, y20, y21, deriv):
    h = AGBNP_I4LOOKUP_MAXA / (AGBNP_I4LOOKUP_NA - 1)
    xk = seg.to(d.dtype) * h
    a = (xk + h - d) / h
    b = 1.0 - a
    val = (a * y0 + b * y1
           + ((a ** 3 - a) * y20 + (b ** 3 - b) * y21) * (h * h) / 6.0)
    if not deriv:
        return val, None
    dval = ((y1 - y0) / h
            + ((3.0 * b * b - 1.0) * y21 - (3.0 * a * a - 1.0) * y20) * h / 6.0)
    return val, dval


def spline_lookup(d, ti, tj, yflat, y2flat, ntypes_j, deriv: bool = False):
    """Natural-cubic-spline Q4 lookup on the uniform [0, 2] nm grid.

    d: [...] distances; ti, tj: radius-type indices broadcastable to d's
    shape; yflat/y2flat: [Ti*Tj*NA] flattened tables.  Returns (value, deriv
    or None).  Mirrors AGBNPLookupTable::eval/evalderiv via OpenMM's
    SplineFitter formulas (reference AGBNPUtils.h:99-120).
    """
    na = AGBNP_I4LOOKUP_NA
    h = AGBNP_I4LOOKUP_MAXA / (na - 1)
    seg = torch.clamp((d / h).to(torch.int64), 0, na - 2)
    base = (ti * ntypes_j + tj) * na + seg
    y0 = yflat[base]
    y1 = yflat[base + 1]
    y20 = y2flat[base]
    y21 = y2flat[base + 1]
    return _spline_interp(d, seg, y0, y1, y20, y21, deriv)


def agbnp_swf_invbr(beta):
    """Soft filter on the inverse Born radius; returns (filtered, fp).

    Branch-free version of reference ReferenceAGBNPKernels.cpp:41-55.
    """
    a = 1.0 / AGBNP_I4LOOKUP_MAXA
    a2 = a * a
    pos = beta >= 0.0
    beta_safe = torch.where(pos, beta, 0.0)
    t = torch.sqrt(a2 + beta_safe * beta_safe)
    fp = torch.where(pos, beta_safe / t, 0.0)
    return torch.where(pos, t, a), fp


def min_image(delta, box):
    """Minimum-image wrap of pair deltas [..., 3].

    box [3]: orthorhombic edge lengths (component-wise wrap).
    box [3, 3]: OpenMM-reduced triclinic row vectors a=(ax,0,0),
    b=(bx,by,0), c=(cx,cy,cz) — sequential wrap along c, then b, then a.
    """
    box = torch.as_tensor(box, dtype=delta.dtype, device=delta.device)
    if box.dim() == 1:
        return delta - box * torch.round(delta / box)
    a, b, c = box[0], box[1], box[2]
    delta = delta - torch.round(delta[..., 2:3] / c[2]) * c
    delta = delta - torch.round(delta[..., 1:2] / b[1]) * b
    delta = delta - torch.round(delta[..., 0:1] / a[0]) * a
    return delta


def _pair_geometry(pos, box=None):
    """dist[i,j] = pos[j] - pos[i]; d and 1/d with safe diagonal."""
    dist = pos[None, :, :] - pos[:, None, :]
    if box is not None:
        dist = min_image(dist, box)
    d2 = torch.sum(dist * dist, dim=-1)
    n = pos.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    d2_safe = torch.where(eye, 1.0, d2)
    d = torch.sqrt(d2_safe)
    return dist, d2, d, eye


def born_radii(pos, radii_vdw, s_factor, ishydrogen, type_i, type_j,
               yflat, y2flat, ntypes_j, box=None, horizon=None):
    """Inverse Born radii: 1/B_i = 1/R_i - (1/4pi) sum_j s_j Q4(d_ij).

    Heavy-atom screeners only; 2 nm table horizon
    (reference ReferenceAGBNPKernels.cpp:437-454).  `horizon` < 2 nm
    truncates the sums at that distance instead (the reference's OpenCL
    backend in cutoff mode, OpenCLAGBNPKernels.cpp:2258).
    Returns dict(born_radius, inv_br, inv_br_fp, Q, dQ, pair_mask, dist, d,
    d2, eye); Q/dQ are kept for the descreening derivative sweep.
    """
    dist, d2, d, eye = _pair_geometry(pos, box)
    screener = ishydrogen[None, :] == 0
    hmax = AGBNP_I4LOOKUP_MAXA if horizon is None \
        else min(horizon, AGBNP_I4LOOKUP_MAXA)
    pair_mask = (~eye) & screener & (d < hmax)

    tj_cols = torch.clamp(type_j, min=0)
    q, dq = spline_lookup(d, type_i[:, None], tj_cols[None, :], yflat,
                          y2flat, ntypes_j, deriv=True)
    q = torch.where(pair_mask, q, 0.0)
    dq = torch.where(pair_mask, dq, 0.0)

    beta = 1.0 / radii_vdw - PIFAC * torch.sum(s_factor[None, :] * q, dim=1)
    filt, fp = agbnp_swf_invbr(beta)
    return dict(born_radius=1.0 / filt, inv_br=beta, inv_br_fp=fp,
                Q=q, dQ=dq, pair_mask=pair_mask, dist=dist, d=d, d2=d2,
                eye=eye)


def gb_energy(pos, charge, born_radius, geom, cutoff=None):
    """GB self + pair energy, direct forces, Y accumulators.

    E_pair = sum_{i<j} 2 f_eps q_i q_j / sqrt(d^2 + B_i B_j exp(-d^2/4BiBj))
    (reference ReferenceAGBNPKernels.cpp:464-504).
    """
    dist, d2, eye = geom["dist"], geom["d2"], geom["eye"]
    bb = born_radius[:, None] * born_radius[None, :]
    etij = torch.exp(-0.25 * torch.where(eye, 0.0, d2) / bb)
    fgb = 1.0 / torch.sqrt(torch.where(eye, 1.0, d2 + bb * etij))
    mask = ~eye
    if cutoff is not None:
        mask = mask & (geom["d"] < cutoff)
    fmask = mask.to(pos.dtype)

    qq_f = charge[:, None] * charge[None, :]
    qq = DIELECTRIC_FACTOR * qq_f

    gb_self = torch.sum(DIELECTRIC_FACTOR * charge * charge / born_radius)
    gb_pair = torch.sum(fmask * qq * fgb)  # = sum_{i<j} 2 qq fgb

    fgb3 = fgb ** 3
    mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
    # ordered-pair contribution to force[i]: +dist_ij * mw; mw(i,j) ==
    # mw(j,i), so the row sum is the atom's whole pair force
    force = torch.sum(fmask[:, :, None] * dist * mw[:, :, None], dim=1)

    ytij = qq_f * (bb + 0.25 * d2) * etij * fgb3
    egb_der_Y = torch.sum(fmask * ytij, dim=1)
    return dict(gb_self=gb_self, gb_pair=gb_pair, force=force,
                egb_der_Y=egb_der_Y)


def vdw_energy(alpha, born_radius):
    """E_vdw = sum_i alpha_i / (B_i + rw)^3
    (reference ReferenceAGBNPKernels.cpp:513-521)."""
    return torch.sum(alpha / (born_radius + AGBNP_HB_RADIUS) ** 3, dim=-1)


def born_chain_factors(alpha, charge, born_radius, inv_br_fp, egb_der_Y):
    """Per-atom BrW (vdW) and BrU (GB) chain-rule factors
    (reference ReferenceAGBNPKernels.cpp:523-549)."""
    br = born_radius
    evdw_der_brw = (-PIFAC * 3.0 * alpha * br * br * inv_br_fp
                    / (br + AGBNP_HB_RADIUS) ** 4)
    egb_der_bru = (-PIFAC * DIELECTRIC_FACTOR
                   * (charge * charge + egb_der_Y * br) * inv_br_fp)
    return evdw_der_brw, egb_der_bru


def descreening_sweep(geom, s_factor, evdw_der_brw, egb_der_bru):
    """W/U accumulators + direct descreening forces
    (reference ReferenceAGBNPKernels.cpp:555-586).

    For each ordered pair (i, j) with j a heavy screener:
      W_j += BrW_i Q_ij,  U_j += BrU_i Q_ij,
      force_i += dist_ij * (BrW + BrU)_i s_j dQ_ij / d, force_j -= same.
    """
    q, dq, dist, d = geom["Q"], geom["dQ"], geom["dist"], geom["d"]
    mask = geom["pair_mask"].to(q.dtype)

    evdw_der_W = torch.sum(evdw_der_brw[:, None] * q, dim=0)
    egb_der_U = torch.sum(egb_der_bru[:, None] * q, dim=0)

    c = (evdw_der_brw + egb_der_bru)[:, None] * s_factor[None, :] * dq / d
    c = c * mask
    # force[k] = sum_j (c_kj + c_jk) * (pos_j - pos_k)
    csym = c + c.T
    force = torch.sum(csym[:, :, None] * dist, dim=1)
    return dict(evdw_der_W=evdw_der_W, egb_der_U=egb_der_U, force=force)


def _identity(x):
    return x


def pair_phases_rows(pos_blk, row_ids, pos, radii_vdw_blk, s_factor,
                     ishydrogen, type_i_blk, type_j, yflat, y2flat,
                     ntypes_j, charge_blk, charge, alpha_blk, cutoff=None,
                     box=None, psum=_identity, all_gather=_identity,
                     horizon=None):
    """All four pair phases (Born radii -> GB -> vdW -> descreening) for a
    row block of screened atoms against all screeners: the decomposition
    unit of the atom-sharded path (JAX ops/born.py::pair_phases_rows).

    The `_blk` arrays hold this rank's rows (global indices `row_ids`);
    everything else is whole.  `psum` sums partial results that take
    contributions from every row block (the scalar energies, the W/U
    screener accumulators, the screener-side forces); `all_gather` turns the
    block's Born radii into the full vector the GB pair term needs.  With
    the identity defaults and a full row block this is the dense path of
    born_radii, gb_energy and descreening_sweep.

    Returns dict(gb_self, gb_pair, e_vdw [whole scalars], born_radius
    [rows], born_radius_all [N, the gathered radii], row_force [rows, 3],
    col_force [N, 3, whole], evdw_der_W, egb_der_U [N, whole]).
    """
    n = pos.shape[0]
    dist = pos[None, :, :] - pos_blk[:, None, :]  # [nb, N, 3], j - i
    if box is not None:
        dist = min_image(dist, box)
    d2 = torch.sum(dist * dist, dim=-1)
    eye = row_ids[:, None] == torch.arange(n, device=pos.device)[None, :]
    d = torch.sqrt(torch.where(eye, 1.0, d2))
    # padded rows can land at raw distance 0 from a real atom after a
    # minimum-image wrap; every division below is masked, so only the
    # 0/0 -> NaN path needs the guard
    d_div = torch.where(d > 0.0, d, 1.0)

    screener = ishydrogen[None, :] == 0
    hmax = AGBNP_I4LOOKUP_MAXA if horizon is None \
        else min(horizon, AGBNP_I4LOOKUP_MAXA)
    pair_mask = (~eye) & screener & (d < hmax)
    tj_cols = torch.clamp(type_j, min=0)
    q, dq = spline_lookup(d, type_i_blk[:, None], tj_cols[None, :], yflat,
                          y2flat, ntypes_j, deriv=True)
    q = torch.where(pair_mask, q, 0.0)
    dq = torch.where(pair_mask, dq, 0.0)

    # Born radii (ReferenceAGBNPKernels.cpp:437-454): row-local sums
    beta = 1.0 / radii_vdw_blk - PIFAC * torch.sum(s_factor[None, :] * q,
                                                   dim=1)
    filt, fp = agbnp_swf_invbr(beta)
    br_blk = 1.0 / filt
    br = all_gather(br_blk)[:n]

    # GB energy (ReferenceAGBNPKernels.cpp:464-504).  mw/fmask are
    # symmetric, so each row's local sum is that atom's complete force.
    bb = br_blk[:, None] * br[None, :]
    etij = torch.exp(-0.25 * torch.where(eye, 0.0, d2) / bb)
    fgb = 1.0 / torch.sqrt(torch.where(eye, 1.0, d2 + bb * etij))
    mask = ~eye
    if cutoff is not None:
        mask = mask & (d < cutoff)
    fmask = mask.to(pos.dtype)
    qq_f = charge_blk[:, None] * charge[None, :]
    qq = DIELECTRIC_FACTOR * qq_f
    gb_self = psum(torch.sum(DIELECTRIC_FACTOR * charge_blk * charge_blk
                             / br_blk))
    gb_pair = psum(torch.sum(fmask * qq * fgb))
    fgb3 = fgb ** 3
    mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
    gb_force = torch.sum(fmask[:, :, None] * dist * mw[:, :, None], dim=1)
    egb_der_Y = torch.sum(fmask * qq_f * (bb + 0.25 * d2) * etij * fgb3,
                          dim=1)

    # vdW dispersion + chain factors (cpp:513-549)
    e_vdw = psum(vdw_energy(alpha_blk, br_blk))
    evdw_der_brw, egb_der_bru = born_chain_factors(
        alpha_blk, charge_blk, br_blk, fp, egb_der_Y)

    # descreening sweep (cpp:555-586): W/U are screener-side (column)
    # sums -> psum across row blocks; the direct force splits into a row
    # part (this block's screened atoms) and a column part (the reaction on
    # the screeners, which every block adds to -> psum)
    evdw_der_W = psum(torch.sum(evdw_der_brw[:, None] * q, dim=0))
    egb_der_U = psum(torch.sum(egb_der_bru[:, None] * q, dim=0))
    c = ((evdw_der_brw + egb_der_bru)[:, None] * s_factor[None, :]
         * dq / d_div)
    c = torch.where(pair_mask, c, 0.0)
    row_force = torch.sum(c[:, :, None] * dist, dim=1)
    col_force = psum(torch.sum(-c[:, :, None] * dist, dim=0))

    return dict(gb_self=gb_self, gb_pair=gb_pair, e_vdw=e_vdw,
                born_radius=br_blk, born_radius_all=br,
                row_force=gb_force + row_force, col_force=col_force,
                evdw_der_W=evdw_der_W, egb_der_U=egb_der_U)
