"""GVolSA / AGBNP1 energy and analytic forces over the flattened overlap tree.

Counterpart of the JAX package's models/agbnp_jax.py, evaluated eagerly with
PyTorch on any device:

  build tree (large radii) -> reduce -> E_vol1, F1
  rescan (vdW radii)       -> reduce -> E_vol2, F2, self volumes
  Born radii (spline LUT)  -> GB self/pair + vdW dispersion + direct forces
  BrW/BrU chain factors    -> descreening sweep -> W, U + direct forces
  gamma rescan (W + U)     -> tree-propagated self-volume gradient forces

Forces are the same closed-form reverse chain the reference derives by hand
(reference ReferenceAGBNPKernels.cpp:152-795).  The pair phases take one of
two routes: the kernel route (`pair_pad > 0`, the default) runs the three
sweeps of ops/kernels/pairs.py in Morton-permuted row space with
heavy-packed screener columns — CUDA kernels on the GPU, their plain twins
on the CPU; the plain route (`AGBNPModel(pair_kernel=False)`) runs the
dense [N, N] phases of ops/born.py in atom order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import born as B
from ..ops import tree as T
from ..ops.kernels import pairs as PK
from .constants import AGBNP_I4LOOKUP_NA, DIELECTRIC_FACTOR, PIFAC, \
    sphere_volume
from .i4_tables import I4LookupTables
from .params import AGBNPParams

# the kernel route keeps Q/dQ [NP, NHP] between the Born and descreening
# sweeps (models/agbnp_jax.py:250-251); above this many bytes for the pair
# the TPU recomputes the spline in its descreening kernel instead, which is
# not ported yet
QD_BYTES_LIMIT = 1 << 30

# integer arrays the CUDA kernels read as int32; every other integer array
# becomes int64 (torch's index type)
_KERNEL_INTS = ("hids_perm_pad", "type_rows_pad", "type_cols_hpad")


def _morton_order(pos, idx):
    """Order the atom subset idx by a 3D Morton (Z-curve) code of their
    positions: spatially adjacent atoms land in adjacent packed rows and
    columns of the pair sweeps."""
    q = np.asarray(pos)[idx]
    q = q - q.min(axis=0)
    span = max(float(q.max()), 1e-9)
    cells = np.minimum((q / span * 1023).astype(np.uint64), 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    code = (spread(cells[:, 0]) | (spread(cells[:, 1]) << np.uint64(1))
            | (spread(cells[:, 2]) << np.uint64(2)))
    return idx[np.argsort(code, kind="stable")]


def prepare_arrays(params: AGBNPParams, dtype=np.float64,
                   pairs: tuple | None = None, pair_pad: int = 0,
                   positions=None) -> dict:
    """Host-side (numpy) parameter and table arrays, the same dict the JAX
    package's prepare_arrays builds minus its TPU-only spline tables.

    pairs: optional (i, j[, valid]) candidate 2-body pairs; defaults to all
    i<j.  pair_pad > 0 adds the kernel route's layouts: the Morton row
    permutation (rperm/rinv, from `positions`), rows padded to pair_pad,
    and the heavy-packed screener columns (hids_pad atom ids,
    hids_perm_pad permuted-row ids for the self-pair test).
    """
    p = params
    n = p.n
    tables = I4LookupTables(p.radii_vdw, p.ishydrogen)
    if pairs is None:
        pairs = np.triu_indices(n, 1)
    extra = {}
    if pair_pad > 0:
        if positions is not None and n > 1:
            rperm = _morton_order(positions, np.arange(n))
        else:
            rperm = np.arange(n)
        rinv = np.empty(n, np.int32)
        rinv[rperm] = np.arange(n, dtype=np.int32)
        extra["rperm"] = rperm.astype(np.int32)
        extra["rinv"] = rinv
        extra["charge_pad"] = np.pad(np.asarray(p.charge)[rperm],
                                     (0, pair_pad - n)).astype(dtype)
        extra["radii_vdw_perm"] = np.asarray(p.radii_vdw)[rperm].astype(dtype)
        extra["alpha_perm"] = np.asarray(p.alpha)[rperm].astype(dtype)
        hidx = np.nonzero(np.asarray(p.ishydrogen) == 0)[0]
        if positions is not None and len(hidx) > 1:
            hidx = _morton_order(positions, hidx)
        nhpad = PK.pad_to(len(hidx), PK.pick_tile(n))
        hids = np.full(nhpad, -1, np.int32)
        hids[:len(hidx)] = hidx
        extra["hids_pad"] = hids
        hids_perm = np.full(nhpad, -1, np.int32)
        hids_perm[:len(hidx)] = rinv[hidx]
        extra["hids_perm_pad"] = hids_perm
    return dict(
        **extra,
        radii_large=np.asarray(p.radii_large, dtype),
        radii_vdw=np.asarray(p.radii_vdw, dtype),
        gamma=np.asarray(p.gamma, dtype),
        alpha=np.asarray(p.alpha, dtype),
        charge=np.asarray(p.charge, dtype),
        ishydrogen=np.asarray(p.ishydrogen, np.int32),
        vol_large=np.where(p.ishydrogen > 0, 0.0,
                           sphere_volume(p.radii_large)).astype(dtype),
        vol_vdw=np.where(p.ishydrogen > 0, 0.0,
                         sphere_volume(p.radii_vdw)).astype(dtype),
        vol_vdw_all=np.asarray(sphere_volume(p.radii_vdw), dtype),
        type_i=np.asarray(tables.type_screened, np.int32),
        type_j=np.asarray(tables.type_screener, np.int32),
        yflat=np.asarray(tables.yval.reshape(-1), dtype),
        y2flat=np.asarray(tables.y2val.reshape(-1), dtype),
        pairs_i=np.asarray(pairs[0], np.int32),
        pairs_j=np.asarray(pairs[1], np.int32),
        pairs_valid=(np.asarray(pairs[2])
                     if len(pairs) > 2 else np.ones(len(pairs[0]), bool)),
    )


def arrays_from_numpy(arrays: dict, device, dtype=torch.float64) -> dict:
    """Tensors on `device` from a prepare_arrays dict — this package's or
    the JAX package's (its TPU spline tables rowY_pad/cols_oh_hpad are
    ignored).  Floats become `dtype`; the kernel route's radius-type ids,
    [Ti, Tj, NA] tables and atom -> packed-column map are derived here."""
    a = {k: np.asarray(v) for k, v in arrays.items()
         if k not in ("rowY_pad", "cols_oh_hpad")}
    if "rperm" in a:
        n = a["type_i"].shape[0]
        npad = a["charge_pad"].shape[0]
        na = AGBNP_I4LOOKUP_NA
        ntj = int(a["type_j"].max()) + 1
        nti = a["yflat"].shape[0] // (ntj * na)
        a["ytab"] = a["yflat"].reshape(nti, ntj, na)
        a["y2tab"] = a["y2flat"].reshape(nti, ntj, na)
        a["type_rows_pad"] = np.pad(a["type_i"][a["rperm"]], (0, npad - n))
        hids = a["hids_pad"]
        hvalid = hids >= 0
        a["type_cols_hpad"] = np.where(hvalid,
                                       a["type_j"][np.clip(hids, 0, None)], 0)
        hinv = np.full(n, -1, np.int64)
        hinv[hids[hvalid]] = np.nonzero(hvalid)[0]
        a["hinv"] = hinv
    out = {}
    for k, v in a.items():
        if v.dtype == np.bool_:
            t = torch.as_tensor(v)
        elif np.issubdtype(v.dtype, np.floating):
            t = torch.as_tensor(v, dtype=dtype)
        elif k in _KERNEL_INTS:
            t = torch.as_tensor(v.astype(np.int32))
        else:
            t = torch.as_tensor(v.astype(np.int64))
        out[k] = t.to(device).contiguous()
    return out


def tree_passes(a: dict, pos, caps: T.TreeCaps, roffset: float,
                topology=None, pair_rows: bool = False):
    """Two-pass cavity evaluation (large radii, then vdW radii).

    With topology given (a T.tree_topology result from an earlier build),
    the build is replaced by a fixed-topology volume rescan of both
    parameterizations in one fused pass — the MD path between rebuilds.

    Returns (e_cav, f_cav, self_volume, levels_vdw, lvl1_vdw, diag, red1,
    red2) where levels_vdw feeds the W/U gamma pass.
    """
    gamma_dr = a["gamma"] / roffset
    lvl1_large = T.make_level1(pos, a["radii_large"], a["vol_large"],
                               gamma_dr, a["ishydrogen"])
    lvl1_vdw = T.make_level1(pos, a["radii_vdw"], a["vol_vdw"],
                             -gamma_dr, a["ishydrogen"])
    if topology is None:
        levels, diag = T.build_tree(lvl1_large, a["pairs_i"], a["pairs_j"],
                                    caps, pairs_valid=a["pairs_valid"],
                                    pair_rows=pair_rows)
        red1 = T.reduce_tree(levels, lvl1_large, with_selfvol=False)
        levels_vdw = T.rescan_volumes(levels, lvl1_vdw)
        red2 = T.reduce_tree(levels_vdw, lvl1_vdw, with_selfvol=True)
    else:
        dev = pos.device
        counts = torch.stack([torch.sum(t["valid"]) for t in topology])
        diag = dict(counts=counts,
                    caps=torch.tensor(caps.caps, device=dev),
                    max_siblings=torch.zeros(7, dtype=torch.int64,
                                             device=dev),
                    offs=torch.tensor(caps.offs + (0,), device=dev))
        levels_large, levels_vdw = T.rescan_volumes2(topology, lvl1_large,
                                                     lvl1_vdw)
        red1, red2 = T.reduce_tree2(levels_large, levels_vdw,
                                    lvl1_large, lvl1_vdw)

    e_cav = red1["energy"] + red2["energy"]
    f_cav = -(red1["dr"] + red2["dr"])
    return (e_cav, f_cav, red2["self_volume"], levels_vdw, lvl1_vdw, diag,
            red1, red2)


def _pair_phases_kernel(a, pos, s_factor, cutoff, box, pair_pad: int,
                        horizon=None, mm_nb=None):
    """Born/GB/descreening pair phases through the three sweeps of
    ops/kernels/pairs.py (counterpart of `_pair_phases_pallas` with the
    dense tile grid).  The block runs in Morton-permuted row space with
    heavy-packed screener columns; row outputs are gathered back to atom
    order at the end.  With mm_nb (sigma, epsq, excl_rows_perm), the OPLS
    LJ + Coulomb sum rides the GB sweep."""
    n = pos.shape[0]
    rperm, rinv = a["rperm"], a["rinv"]
    pos_pad = F.pad(pos[rperm], (0, 0, 0, pair_pad - n)).T.contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    hclip = torch.clamp(hids, min=0)
    pos_hpad = (pos[hclip] * hvalid[:, None]).T.contiguous()
    nhpad = hids.shape[0]
    if pair_pad * nhpad * 8 > QD_BYTES_LIMIT:
        raise ValueError(
            f"Q/dQ [{pair_pad}, {nhpad}] exceed the {QD_BYTES_LIMIT}-byte "
            "budget; the recomputing descreening kernel for systems this "
            "large is not ported yet")

    def padv(x):
        return F.pad(x, (0, pair_pad - n))

    s_h = torch.where(hvalid, s_factor[hclip], 0.0)
    raw, q, dq = PK.born_sums(pos_pad, pos_hpad, a["hids_perm_pad"],
                              a["type_rows_pad"], a["type_cols_hpad"],
                              a["ytab"], a["y2tab"], s_h, n, box=box,
                              horizon=horizon, save_qd=True)
    # perm-space per-atom chain: Born radii, GB self, vdW dispersion
    beta = 1.0 / a["radii_vdw_perm"] - PIFAC * raw[:n]
    filt, fp = B.agbnp_swf_invbr(beta)
    br_p = 1.0 / filt
    charge_p = a["charge_pad"][:n]

    sig_pad = epsq_pad = excl_pad = None
    if mm_nb is not None:
        sig_pad = padv(mm_nb["sigma"][rperm])
        epsq_pad = padv(mm_nb["epsq"][rperm])
        excl_pad = F.pad(mm_nb["excl_rows_perm"], (0, 0, 0, pair_pad - n),
                         value=-1)
    erow, yrow, gbf, mmrow = PK.gb_pair(pos_pad, a["charge_pad"], padv(br_p),
                                        n, box=box, cutoff=cutoff,
                                        sig_pad=sig_pad, epsq_pad=epsq_pad,
                                        excl_rows_pad=excl_pad)
    gb_self = torch.sum(DIELECTRIC_FACTOR * charge_p * charge_p / br_p)
    gb_pair_e = torch.sum(erow[:n])
    e_vdw = B.vdw_energy(a["alpha_perm"], br_p)
    evdw_der_brw, egb_der_bru = B.born_chain_factors(
        a["alpha_perm"], charge_p, br_p, fp, yrow[:n])
    w_h, u_h, swf_r, swf_c = PK.descreening(
        pos_pad, pos_hpad, s_h, padv(evdw_der_brw), padv(egb_der_bru),
        (q, dq), box=box)

    # back to atom order (gathers; every heavy atom owns one packed column)
    col = a["hinv"]
    heavy = col >= 0
    cclip = torch.clamp(col, min=0)
    swf_cols = torch.where(heavy[:, None], swf_c[cclip], 0.0)
    row_force = (gbf[:n] + swf_r[:n])[rinv]
    out = dict(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
               born_radius=br_p[rinv], pair_force=row_force + swf_cols,
               evdw_der_W=torch.where(heavy, w_h[cclip], 0.0),
               egb_der_U=torch.where(heavy, u_h[cclip], 0.0))
    if mm_nb is not None:
        out["e_mm_nb"] = 0.5 * torch.sum(mmrow[:n])
    return out


def energy_forces(a: dict, pos, caps: T.TreeCaps, version: int,
                  roffset: float, ntypes_j: int, cutoff=None, topology=None,
                  box=None, pair_pad: int = 0, pair_rows: bool = False,
                  mm_nb=None, descreen_horizon=None):
    """Full GVolSA (version 0) / AGBNP1 (version 1) energy + analytic forces.

    a: arrays_from_numpy dict; pos [N, 3] on the same device.  With box
    ([3] orthorhombic lengths or [3, 3] reduced triclinic rows), the pair
    phases use minimum-image deltas (CutoffPeriodic, AGBNPForce.h:55); the
    overlap tree keeps raw deltas like every reference backend.
    descreen_horizon < 2 nm truncates the Born-radius/descreening sums at
    that distance (the reference OpenCL backend's cutoff mode); None keeps
    the 2 nm table horizon.  pair_pad > 0 selects the kernel route.

    Returns dict(energy, force, diag, details).
    """
    e_cav, f_cav, self_volume, levels_vdw, lvl1_vdw, diag, red1, red2 = \
        tree_passes(a, pos, caps, roffset, topology=topology,
                    pair_rows=pair_rows)
    details = dict(e_vol1=red1["energy"], e_vol2=red2["energy"], e_cav=e_cav)
    if version == 0:
        return dict(energy=e_cav, force=f_cav, diag=diag, details=details)

    # volume scaling factors (ReferenceAGBNPKernels.cpp:420-430)
    s_factor = self_volume / a["vol_vdw_all"]
    e_mm_nb = None
    if pair_pad > 0:
        pp = _pair_phases_kernel(a, pos, s_factor, cutoff, box, pair_pad,
                                 horizon=descreen_horizon, mm_nb=mm_nb)
        gb_self, gb_pair_e, e_vdw = pp["gb_self"], pp["gb_pair"], pp["e_vdw"]
        br = pp["born_radius"]
        pair_force = pp["pair_force"]
        evdw_der_W, egb_der_U = pp["evdw_der_W"], pp["egb_der_U"]
        e_mm_nb = pp.get("e_mm_nb")
    else:
        if mm_nb is not None:
            raise ValueError("the fused MM sum rides the kernel route only")
        geom = B.born_radii(pos, a["radii_vdw"], s_factor, a["ishydrogen"],
                            a["type_i"], a["type_j"], a["yflat"], a["y2flat"],
                            ntypes_j, box=box, horizon=descreen_horizon)
        br = geom["born_radius"]
        gb = B.gb_energy(pos, a["charge"], br, geom, cutoff=cutoff)
        e_vdw = B.vdw_energy(a["alpha"], br)
        evdw_der_brw, egb_der_bru = B.born_chain_factors(
            a["alpha"], a["charge"], br, geom["inv_br_fp"], gb["egb_der_Y"])
        sweep = B.descreening_sweep(geom, s_factor, evdw_der_brw,
                                    egb_der_bru)
        gb_self, gb_pair_e = gb["gb_self"], gb["gb_pair"]
        pair_force = gb["force"] + sweep["force"]
        evdw_der_W, egb_der_U = sweep["evdw_der_W"], sweep["egb_der_U"]

    # self-volume gradient components via one gamma rescan over
    # gamma_W + gamma_U (the reference's two passes,
    # ReferenceAGBNPKernels.cpp:713-747, are linear in gamma)
    gamma_WU = (evdw_der_W + egb_der_U) / a["vol_vdw_all"]
    lvl1_WU = {**lvl1_vdw, "gamma1i": gamma_WU}
    red_WU = T.reduce_tree(T.rescan_gammas(levels_vdw, lvl1_WU), lvl1_WU,
                           with_selfvol=False)

    energy = e_cav + gb_self + gb_pair_e + e_vdw
    force = f_cav + pair_force - red_WU["dr"]
    details.update(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
                   born_radius=br, self_volume=self_volume, s_factor=s_factor)
    if e_mm_nb is not None:
        # the dense MM LJ/Coulomb sum rode the GB sweep; its forces are
        # inside pair_force, its energy is reported separately
        details["e_mm_nb"] = e_mm_nb
    return dict(energy=energy, force=force, diag=diag, details=details)


class AGBNPModel:
    """Prepared AGBNP system with an energy/forces entry point (what a
    Context bound to an AGBNPForce provides in the reference).

    device: where the arrays live and the evaluation runs (no default).
    pair_kernel: version 1 pair phases through the kernel route (CUDA
    kernels on a GPU, their plain twins on the CPU); False takes the dense
    ops/born.py route.  Tree capacities start from TreeCaps.for_natoms and
    grow through check_and_grow (the PanicButton).
    """

    def __init__(self, params: AGBNPParams, *, device, dtype=torch.float64,
                 caps: T.TreeCaps | None = None, version: int = 1,
                 cutoff: float | None = None, positions=None, box=None,
                 pair_kernel: bool = True, descreen_horizon=None):
        if version not in (0, 1):
            raise ValueError(f"version {version}: only 0 and 1 are ported")
        if params.n > 2000:
            raise ValueError(
                f"{params.n} atoms: the all-pairs tree candidates serve up to "
                "2000 atoms; the on-device neighbor-list path for larger "
                "systems is not ported yet")
        self.params = params
        self.version = version
        self.cutoff = cutoff
        self.device = torch.device(device)
        self.dtype = dtype
        if descreen_horizon == "cutoff":
            descreen_horizon = cutoff
        self.descreen_horizon = descreen_horizon
        self.box = (None if box is None
                    else torch.as_tensor(box, dtype=dtype, device=self.device))
        self.caps = caps if caps is not None else \
            T.TreeCaps.for_natoms(params.n)
        self.pair_kernel = bool(pair_kernel) and version == 1
        self.pair_pad = (PK.pad_to(params.n, PK.pick_tile(params.n))
                         if self.pair_kernel else 0)
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self.arrays_np = prepare_arrays(params, dtype=np_dtype,
                                        pair_pad=self.pair_pad,
                                        positions=positions)
        self.arrays = arrays_from_numpy(self.arrays_np, self.device, dtype)
        self.ntypes_j = int(np.max(self.arrays_np["type_j"]) + 1)

    def energy_forces(self, pos, with_details: bool = False):
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        out = energy_forces(self.arrays, pos, caps=self.caps,
                            version=self.version,
                            roffset=self.params.roffset,
                            ntypes_j=self.ntypes_j, cutoff=self.cutoff,
                            box=self.box, pair_pad=self.pair_pad,
                            descreen_horizon=self.descreen_horizon)
        if with_details:
            return out["energy"], out["force"], out
        return out["energy"], out["force"]

    def check_and_grow(self, diag) -> bool:
        """PanicButton: grow capacities if the last evaluation overflowed.
        Returns True if a re-evaluation is needed."""
        ov = T.check_overflow(diag)
        if not ov["any"]:
            return False
        self.caps = self.caps.grow(
            [bool(c) for c in ov["cap_overflow"]],
            [bool(s) for s in ov["sib_overflow"][:-1]])
        return True
