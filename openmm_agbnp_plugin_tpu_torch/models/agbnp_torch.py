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
sweeps in Morton-permuted row space with heavy-packed screener columns —
CUDA kernels on the GPU, their plain twins on the CPU — over
interacting-tile lists (ops/kernels/tiles.py, the default whenever the
model gets positions) or the dense tile grid (ops/kernels/pairs.py); the
plain route (`AGBNPModel(pair_kernel=False)`) runs the dense [N, N] phases
of ops/born.py in atom order.

Replicas (batched_energy_forces): B conformations [B, N, 3] of one system
evaluate as one batch.  The tree stage runs once over the disjoint union
of the replicas (atom b N + i; ops/tree.py, nrep), whose overlap tree is
the union of their trees; the pair phases run the kernels' replica axis,
one launch for the batch; energies are summed per replica.  One system
[N, 3] is a batch of one, its leading axis dropped from every result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import born as B
from ..ops import tree as T
from ..ops.kernels import pairs as PK
from ..ops.kernels import tiles as TL
from ..ops.neighbors import CellGrid, cell_neighbor_pairs, \
    half_neighbor_pairs, host_max_neighbors, tree_pair_cutoff
from . import capacity
from .constants import AGBNP_I4LOOKUP_MAXA, AGBNP_I4LOOKUP_NA, \
    DIELECTRIC_FACTOR, PIFAC, sphere_volume
from .i4_tables import I4LookupTables
from ..utils import profiling
from .params import AGBNPParams

# the kernel route shares Q/dQ between the Born and descreening sweeps
# when they fit this many bytes, counted at 8 per pair as the JAX package
# counts them (models/agbnp_jax.py:251, :276): [NP, NHP] on the dense grid,
# [lmax, T, T] on the lists.  Above it, or with share_qd=False, the
# descreening sweep recomputes the spline.
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


# the per-atom arrays the overlap tree reads: tiled over the replicas for
# the disjoint union
_TREE_ATOM_KEYS = ("radii_large", "vol_large", "gamma", "ishydrogen",
                   "radii_vdw", "vol_vdw", "vol_vdw_all")


def union_arrays(a: dict, nb: int, pairs: bool = True) -> dict:
    """The arrays of the disjoint union of nb replicas for the tree stage:
    the per-atom arrays tiled nb times and, with pairs, the arrays' own
    candidate pairs repeated with atom ids offset by b N (no pair crosses
    replicas).  One replica's union is the arrays themselves."""
    if nb == 1:
        return a
    n = a["radii_large"].shape[0]
    u = {**a, **{k: a[k].repeat(nb) for k in _TREE_ATOM_KEYS}}
    if pairs:
        off = n * torch.arange(nb, device=a["pairs_i"].device)[:, None]
        u.update(pairs_i=(a["pairs_i"][None, :] + off).reshape(-1),
                 pairs_j=(a["pairs_j"][None, :] + off).reshape(-1),
                 pairs_valid=a["pairs_valid"].repeat(nb))
    return u


def tree_passes(a: dict, pos, caps: T.TreeCaps, roffset: float,
                topology=None, pair_rows: bool = False, nrep: int = 1):
    """Two-pass cavity evaluation (large radii, then vdW radii).

    With topology given (a T.tree_topology result from an earlier build),
    the build is replaced by a fixed-topology volume rescan of both
    parameterizations in one fused pass — the MD path between rebuilds.

    nrep: a and pos [nrep N, 3] are the disjoint union of nrep replicas
    (union_arrays; 1 for one system); caps are per replica, the energies
    [nrep] and the diag's leaves [nrep, ...].

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
                                    pair_rows=pair_rows, nrep=nrep)
        red1 = T.reduce_tree(levels, lvl1_large, with_selfvol=False,
                             nrep=nrep)
        levels_vdw = T.rescan_volumes(levels, lvl1_vdw)
        red2 = T.reduce_tree(levels_vdw, lvl1_vdw, with_selfvol=True,
                             nrep=nrep)
    else:
        dev = pos.device
        diag = dict(counts=T.replica_counts(topology, nrep,
                                            pos.shape[0] // nrep),
                    max_siblings=torch.zeros((nrep, 7), dtype=torch.int64,
                                             device=dev),
                    **T.topology_caps_rows(topology, caps, nrep, dev))
        levels_large, levels_vdw = T.rescan_volumes2(topology, lvl1_large,
                                                     lvl1_vdw)
        red1, red2 = T.reduce_tree2(levels_large, levels_vdw,
                                    lvl1_large, lvl1_vdw, nrep=nrep)

    e_cav = red1["energy"] + red2["energy"]
    f_cav = -(red1["dr"] + red2["dr"])
    return (e_cav, f_cav, red2["self_volume"], levels_vdw, lvl1_vdw, diag,
            red1, red2)


def _pair_phases_kernel(a, pos, s_factor, cutoff, box, pair_pad: int,
                        horizon=None, mm_nb=None, pair_tiles=None,
                        share_qd: bool = True):
    """Born/GB/descreening pair phases through the sweeps of
    ops/kernels (counterpart of `_pair_phases_pallas`).  The block runs in
    Morton-permuted row space with heavy-packed screener columns; row
    outputs are gathered back to atom order at the end.  With mm_nb
    (sigma, epsq, excl_rows_perm), the OPLS LJ + Coulomb sum rides the GB
    sweep.

    pair_tiles: None for the dense tile grid, or the (lmax_born, lmax_gb)
    budgets of the interacting-tile lists built here per evaluation;
    lmax_gb None keeps the GB sweep dense (no cutoff, no distance bound).
    The in-range tile counts come back as "tile_counts".  On the dense grid
    the Born and descreening sweeps walk one chunk list (subtile_columns)
    per evaluation on the card: the Born kernel's own, handed on with its
    Q/dQ, or one built here for both when descreening recomputes the
    spline (the CPU twins read none).  Q/dQ are shared between the Born
    and descreening sweeps under share_qd and QD_BYTES_LIMIT; otherwise
    descreening recomputes the spline.

    pos [B, N, 3] and s_factor [B, N]: B replicas through the kernels'
    replica axis (one launch each for the batch), every output with a
    leading [B] axis (tile_counts [B, 2]); the budgets and the Q/dQ byte
    rule are per replica."""
    n = pos.shape[-2]
    tile = PK.pick_tile(n)
    rperm, rinv = a["rperm"], a["rinv"]
    pos_pad = F.pad(pos[..., rperm, :], (0, 0, 0, pair_pad - n)).transpose(
        -1, -2).contiguous()
    hids = a["hids_pad"]
    hvalid = hids >= 0
    hclip = torch.clamp(hids, min=0)
    pos_hpad = (pos[..., hclip, :] * hvalid[:, None]).transpose(
        -1, -2).contiguous()
    nhpad = hids.shape[0]

    def padv(x):
        return F.pad(x, (0, pair_pad - n))

    s_h = torch.where(hvalid, s_factor[..., hclip], 0.0)
    spline = PK.SplineArgs(a["hids_perm_pad"], a["type_rows_pad"],
                           a["type_cols_hpad"], a["ytab"], a["y2tab"], n,
                           horizon)
    born_args = (pos_pad, pos_hpad, *spline[:5], s_h, n)
    tile_counts = None
    if pair_tiles is not None:
        lb, lg = pair_tiles
        rvalid = torch.arange(pair_pad, device=pos.device) < n
        c_r, r_r = TL.tile_bounds(pos_pad, rvalid, tile)
        c_h, r_h = TL.tile_bounds(pos_hpad, hvalid, tile)
        tl_b, nv_b, cnt_b = TL.build_tile_list(c_r, r_r, c_h, r_h,
                                               PK._horizon(horizon), lb,
                                               box=box)
        cnt_g = torch.zeros_like(cnt_b)
        if lg is not None:
            tl_g, nv_g, cnt_g = TL.build_tile_list(c_r, r_r, c_r, r_r,
                                                   float(cutoff), lg,
                                                   triangular=True, box=box)
        tile_counts = torch.stack([cnt_b, cnt_g], dim=-1)
        save_qd = share_qd and lb * tile * tile * 8 <= QD_BYTES_LIMIT
        born_out = TL.born_sums_tiles(nv_b, tl_b, *born_args, tile, box=box,
                                      horizon=horizon, save_qd=save_qd)
    else:
        save_qd = share_qd and pair_pad * nhpad * 8 <= QD_BYTES_LIMIT
        chunks = None
        if pos.is_cuda and not save_qd:
            chunks = PK.subtile_columns(pos_pad, pos_hpad, spline.hids_perm,
                                        n, box=box, horizon=horizon)
        born_out = PK.born_sums(*born_args, box=box, horizon=horizon,
                                save_qd=save_qd, chunks=chunks)
    raw, qd = (born_out[0], born_out[1:]) if save_qd else (born_out, None)
    # perm-space per-atom chain: Born radii, GB self, vdW dispersion
    beta = 1.0 / a["radii_vdw_perm"] - PIFAC * raw[..., :n]
    filt, fp = B.agbnp_swf_invbr(beta)
    br_p = 1.0 / filt
    charge_p = a["charge_pad"][:n]

    mm_kw = {}
    if mm_nb is not None:
        mm_kw = dict(sig_pad=padv(mm_nb["sigma"][rperm]),
                     epsq_pad=padv(mm_nb["epsq"][rperm]),
                     excl_rows_pad=F.pad(mm_nb["excl_rows_perm"],
                                         (0, 0, 0, pair_pad - n), value=-1))
    gb_args = (pos_pad, a["charge_pad"], padv(br_p), n)
    if pair_tiles is not None and pair_tiles[1] is not None:
        erow, yrow, gbf, mmrow = TL.gb_pair_tiles(nv_g, tl_g, *gb_args, tile,
                                                  box=box, cutoff=cutoff,
                                                  **mm_kw)
    else:
        erow, yrow, gbf, mmrow = PK.gb_pair(*gb_args, box=box, cutoff=cutoff,
                                            **mm_kw)
    gb_self = torch.sum(DIELECTRIC_FACTOR * charge_p * charge_p / br_p,
                        dim=-1)
    gb_pair_e = torch.sum(erow[..., :n], dim=-1)
    e_vdw = B.vdw_energy(a["alpha_perm"], br_p)
    evdw_der_brw, egb_der_bru = B.born_chain_factors(
        a["alpha_perm"], charge_p, br_p, fp, yrow[..., :n])
    # qd: (Q, dQ), and on the card the list Born kernel's keep bits or the
    # dense one's chunks, which name the only places where it wrote Q/dQ
    desc_args = (pos_pad, pos_hpad, s_h, padv(evdw_der_brw),
                 padv(egb_der_bru), qd)
    if pair_tiles is not None:
        w_h, u_h, swf_r, swf_c = TL.descreening_tiles(
            nv_b, tl_b, *desc_args, tile, box=box, spline=spline)
    else:
        w_h, u_h, swf_r, swf_c = PK.descreening(*desc_args, box=box,
                                                spline=spline, chunks=chunks)

    # back to atom order (gathers; every heavy atom owns one packed column)
    col = a["hinv"]
    heavy = col >= 0
    cclip = torch.clamp(col, min=0)
    swf_cols = torch.where(heavy[:, None], swf_c[..., cclip, :], 0.0)
    row_force = (gbf[..., :n, :] + swf_r[..., :n, :])[..., rinv, :]
    out = dict(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
               born_radius=br_p[..., rinv], pair_force=row_force + swf_cols,
               evdw_der_W=torch.where(heavy, w_h[..., cclip], 0.0),
               egb_der_U=torch.where(heavy, u_h[..., cclip], 0.0))
    if mm_nb is not None:
        out["e_mm_nb"] = 0.5 * torch.sum(mmrow[..., :n], dim=-1)
    if tile_counts is not None:
        out["tile_counts"] = tile_counts
    return out


def _pair_phases_plain(a, pos, s_factor, cutoff, box, ntypes_j: int,
                       horizon=None, accum=None):
    """The same phases as _pair_phases_kernel (born sums, GB self/pair +
    vdW + direct forces, BrW/BrU, the descreening sweep) as the dense
    [N, N] torch ops of ops/born.py, in atom order: the plain route.
    accum (torch.float64 under `mixed`) widens the pair sums."""
    geom = B.born_radii(pos, a["radii_vdw"], s_factor, a["ishydrogen"],
                        a["type_i"], a["type_j"], a["yflat"], a["y2flat"],
                        ntypes_j, accum_dtype=accum, box=box,
                        horizon=horizon)
    br = geom["born_radius"]
    gb = B.gb_energy(pos, a["charge"], br, geom, cutoff=cutoff,
                     accum_dtype=accum)
    evdw_der_brw, egb_der_bru = B.born_chain_factors(
        a["alpha"], a["charge"], br, geom["inv_br_fp"], gb["egb_der_Y"])
    sweep = B.descreening_sweep(geom, s_factor, evdw_der_brw, egb_der_bru,
                                accum_dtype=accum)
    return dict(gb_self=gb["gb_self"], gb_pair=gb["gb_pair"],
                e_vdw=B.vdw_energy(a["alpha"], br), born_radius=br,
                pair_force=gb["force"] + sweep["force"],
                evdw_der_W=sweep["evdw_der_W"],
                egb_der_U=sweep["egb_der_U"])


def tree_candidates(a: dict, pos, neighbor_rcut: float = 0.0,
                    neighbor_kmax: int = 0, neighbor_grid=None):
    """The overlap tree's 2-body candidates for one evaluation: the arrays'
    own pair list, or with neighbor_kmax > 0 a half neighbor list within
    neighbor_rcut built on the device (through the cell grid when
    neighbor_grid is given).  Returns (arrays with the pair list to use,
    pair_rows, neighbor_max or None).  Positions [B, N, 3] give each
    replica's list in the ids of their disjoint union (neighbor_max [B]);
    the arrays' own list is then left to union_arrays."""
    if neighbor_kmax <= 0:
        return a, False, None
    heavy = a["ishydrogen"] == 0
    if neighbor_grid is not None:
        pi, pj, pv, nbmax = cell_neighbor_pairs(
            pos, heavy, neighbor_rcut, neighbor_kmax, grid=neighbor_grid)
    else:
        pi, pj, pv, nbmax = half_neighbor_pairs(pos, heavy, neighbor_rcut,
                                                neighbor_kmax)
    return {**a, "pairs_i": pi, "pairs_j": pj, "pairs_valid": pv}, True, nbmax


def energy_forces(a: dict, pos, caps: T.TreeCaps, version: int,
                  roffset: float, ntypes_j: int, **kw):
    """Full GVolSA (version 0) / AGBNP1 (version 1) energy + analytic forces
    of one system, pos [N, 3]: batched_energy_forces of a batch of one,
    the leading axis dropped from every result (energy, force, details,
    diag).  Positions [B, N, 3] pass to batched_energy_forces as they
    are."""
    if pos.dim() == 3:
        return batched_energy_forces(a, pos, caps, version, roffset,
                                     ntypes_j, **kw)
    out = batched_energy_forces(a, pos[None], caps, version, roffset,
                                ntypes_j, **kw)
    return dict(energy=out["energy"][0], force=out["force"][0],
                diag={k: v[0] for k, v in out["diag"].items()},
                details={k: v[0] for k, v in out["details"].items()})


def batched_energy_forces(a: dict, pos, caps: T.TreeCaps, version: int,
                          roffset: float, ntypes_j: int, cutoff=None,
                          topology=None, box=None, pair_pad: int = 0,
                          pair_rows: bool = False, mm_nb=None,
                          descreen_horizon=None, neighbor_rcut: float = 0.0,
                          neighbor_kmax: int = 0, neighbor_grid=None,
                          pair_tiles=None, share_qd: bool = True,
                          vdw_topology=None, wu_mode: str = "fused",
                          pair_shard=None, mixed: bool = False):
    """Energy and forces of B conformations pos [B, N, 3] of one system in
    one batched evaluation (counterpart of the JAX package's vmapped
    energy_forces, models/agbnp_jax.py:751-774): the overlap tree of the
    replicas' disjoint union (caps per replica), the pair kernels' replica
    axis.  Every result has a leading [B] axis: the energy [B], force [B,
    N, 3], the details (e_cav, e_vol1, e_vol2, gb_self, gb_pair, e_vdw,
    ...) and every diag leaf (pass it through batched_diag_max before a
    PanicButton check).

    a: arrays_from_numpy dict on pos's device.  With box
    ([3] orthorhombic lengths or [3, 3] reduced triclinic rows), the pair
    phases use minimum-image deltas (CutoffPeriodic, AGBNPForce.h:55); the
    overlap tree keeps raw deltas like every reference backend.
    descreen_horizon < 2 nm truncates the Born-radius/descreening sums at
    that distance (the reference OpenCL backend's cutoff mode); None keeps
    the 2 nm table horizon.  pair_pad > 0 selects the kernel route, and
    pair_tiles its interacting-tile-list budgets (None: the dense grid);
    share_qd=False makes descreening recompute the spline.

    With neighbor_kmax > 0 the tree's 2-body candidates are built on the
    device from a half neighbor list within neighbor_rcut (through the
    cell grid when neighbor_grid is given) instead of the arrays' pair
    list; the diag then carries neighbor_max and neighbor_kmax.

    The WU gamma-rescan force pass (version 1) runs over the full vdW
    levels, or over vdw_topology (a T.compact_topology result) when given.
    wu_mode: "fused" adds its force in; "split" returns it apart as
    details["force_wu"] (the mts_wu r-RESPA impulse); "skip" leaves the
    pass out (the impulse integrator's off-steps).  The energy never
    depends on this pass.  topology and vdw_topology are those of the
    replicas' union tree.

    pair_shard: fn(pos [N, 3], s_factor [N]) -> the pair phases' dict
    (parallel/sharding.py::sharded_pair_phases, the screened-atom rows in
    blocks over an atoms mesh) in place of the pair route; one system only.

    mixed: f32 pair math with f64 sums (JAX models/agbnp_jax.py:446): the
    plain route's pair sums accumulate in float64 when pos is not float64
    (ops/born.py::_sum1); the tree passes stay in pos's dtype.  It rides
    the plain route only: with pair_pad > 0 or pair_shard it raises, where
    the JAX package would drop it without a word.

    Returns dict(energy, force, diag, details).
    """
    if pos.dim() != 3:
        raise ValueError(f"positions [B, N, 3], got {tuple(pos.shape)}")
    if wu_mode not in ("fused", "split", "skip"):
        raise ValueError(f"wu_mode {wu_mode!r}: fused, split or skip")
    if mixed and (pair_pad > 0 or pair_shard is not None):
        raise ValueError(
            "mixed=True widens the plain route's pair sums only; the kernel "
            "route (pair_pad > 0) and the atoms mesh (pair_shard) sum in the "
            "working dtype")
    nb = pos.shape[0]
    if neighbor_kmax > 0:
        a, pair_rows, nbmax = tree_candidates(a, pos, neighbor_rcut,
                                              neighbor_kmax, neighbor_grid)
    # the tree stage: one tree over the replicas' disjoint union
    at = union_arrays(a, nb, pairs=neighbor_kmax <= 0 and topology is None)
    pos_t = pos.reshape(-1, 3)
    with profiling.span("eval.tree"):
        e_cav, f_cav, self_volume, levels_vdw, lvl1_vdw, diag, red1, red2 = \
            tree_passes(at, pos_t, caps, roffset, topology=topology,
                        pair_rows=pair_rows, nrep=nb)
    f_cav = f_cav.reshape(pos.shape)
    self_volume = self_volume.reshape(pos.shape[:-1])
    if neighbor_kmax > 0:
        diag = {**diag, "neighbor_max": nbmax,
                "neighbor_kmax": torch.full(nbmax.shape, neighbor_kmax)}
    details = dict(e_vol1=red1["energy"], e_vol2=red2["energy"], e_cav=e_cav)
    if version == 0:
        return dict(energy=e_cav, force=f_cav, diag=diag, details=details)

    # volume scaling factors (ReferenceAGBNPKernels.cpp:420-430)
    s_factor = self_volume / a["vol_vdw_all"]
    with profiling.span("eval.pairs"):
        if pair_shard is not None:
            if nb != 1:
                raise ValueError("pair_shard evaluates one system")
            pp = {k: v[None]
                  for k, v in pair_shard(pos[0], s_factor[0]).items()}
        elif pair_pad > 0:
            pp = _pair_phases_kernel(a, pos, s_factor, cutoff, box, pair_pad,
                                     horizon=descreen_horizon, mm_nb=mm_nb,
                                     pair_tiles=pair_tiles, share_qd=share_qd)
            if "tile_counts" in pp:
                budgets = np.asarray(
                    [pair_tiles[0],
                     -1 if pair_tiles[1] is None else pair_tiles[1]],
                    np.int32)
                diag = {**diag, "pair_tile_counts": pp["tile_counts"],
                        "pair_tile_budgets": np.tile(budgets, (nb, 1))}
        else:
            if mm_nb is not None:
                raise ValueError("the fused MM sum rides the kernel route "
                                 "only")
            # the plain route has no replica axis: one replica at a time
            accum = (torch.float64 if mixed and pos.dtype != torch.float64
                     else None)
            pp = PK.per_replica(
                _pair_phases_plain, nb, dict(pos=pos, s_factor=s_factor),
                a=a, cutoff=cutoff, box=box, ntypes_j=ntypes_j,
                horizon=descreen_horizon, accum=accum)
    gb_self, gb_pair_e, e_vdw = pp["gb_self"], pp["gb_pair"], pp["e_vdw"]
    br, pair_force = pp["born_radius"], pp["pair_force"]
    evdw_der_W, egb_der_U = pp["evdw_der_W"], pp["egb_der_U"]
    e_mm_nb = pp.get("e_mm_nb")

    energy = e_cav + gb_self + gb_pair_e + e_vdw
    force = f_cav + pair_force
    details.update(gb_self=gb_self, gb_pair=gb_pair_e, e_vdw=e_vdw,
                   born_radius=br, self_volume=self_volume, s_factor=s_factor)
    if e_mm_nb is not None:
        # the dense MM LJ/Coulomb sum rode the GB sweep; its forces are
        # inside pair_force, its energy is reported separately
        details["e_mm_nb"] = e_mm_nb
    if wu_mode == "skip":
        return dict(energy=energy, force=force, diag=diag, details=details)

    # self-volume gradient components via one gamma rescan over
    # gamma_W + gamma_U (the reference's two passes,
    # ReferenceAGBNPKernels.cpp:713-747, are linear in gamma)
    with profiling.span("eval.wu"):
        gamma_WU = ((evdw_der_W + egb_der_U)
                    / a["vol_vdw_all"]).reshape(-1)
        if vdw_topology is not None:
            # compacted WU pass: one rescan_volumes over the ancestor closure
            # of the vdW-live rows (T.compact_topology) recomputes the
            # volumes and carries the WU gammas down its packed chain
            lvl1_WU = T.make_level1(pos_t, at["radii_vdw"], at["vol_vdw"],
                                    gamma_WU, at["ishydrogen"])
            red_WU = T.reduce_tree(T.rescan_volumes(vdw_topology, lvl1_WU),
                                   lvl1_WU, with_selfvol=False, nrep=nb)
        else:
            lvl1_WU = {**lvl1_vdw, "gamma1i": gamma_WU}
            red_WU = T.reduce_tree(T.rescan_gammas(levels_vdw, lvl1_WU),
                                   lvl1_WU, with_selfvol=False, nrep=nb)
        f_wu = red_WU["dr"].reshape(pos.shape)
    if wu_mode == "split":
        details["force_wu"] = -f_wu
    else:
        force = force - f_wu
    return dict(energy=energy, force=force, diag=diag, details=details)


def batched_diag_max(diag) -> dict:
    """Reduce a batched diag (a leading replica axis on every leaf) to the
    worst case over the batch, so the PanicButton check (check_and_grow)
    sees the largest tree, list and tile count any replica built (JAX
    models/agbnp_jax.py:520-524)."""
    return {k: np.max(profiling.host_read(v, "batched_diag_max"), axis=0)
            for k, v in diag.items()}


class AGBNPModel:
    """Prepared AGBNP system with an energy/forces entry point (what a
    Context bound to an AGBNPForce provides in the reference).

    device: where the arrays live and the evaluation runs (no default).
    pair_kernel: version 1 pair phases through the kernel route (CUDA
    kernels on a GPU, their plain twins on the CPU); False takes the dense
    ops/born.py route; None (the default) is the kernel route unless
    `mixed`.  mixed=True: f32 pair math with f64 sums on the plain route
    (JAX's `mixed`; the pair sums of ops/born.py accumulate in float64 at
    a float32 dtype, the tree passes stay float32); it takes the plain
    route, and an explicit pair_kernel=True with it raises (JAX's kernel
    branch would drop it).  pair_tiles: the kernel route's
    interacting-tile-list budgets — None (auto: sized from `positions` when given, else the dense
    grid), False (the dense grid) or (lmax_born, lmax_gb) with lmax_gb None
    for a dense GB sweep.  share_qd=False makes descreening recompute the
    spline instead of reloading the Born sweep's Q/dQ (the JAX package's
    AGBNP_TILES_NO_QD=1).  Above 2000 atoms with positions given, the
    tree's candidate pairs are rebuilt on the device at every evaluation
    (through a cell grid above 3000 atoms); `pairs` (i, j[, valid]) gives
    the tree's candidates explicitly instead.  Without `caps`, the tree
    capacities are sized from `positions` by one tree build on the device
    (size_caps: counts x caps_boost, the JAX package's native pre-pass
    rules), or without positions from TreeCaps.for_natoms; they, the
    neighbor width and the tile budgets grow through check_and_grow (the
    PanicButton).
    """

    def __init__(self, params: AGBNPParams, *, device, dtype=torch.float64,
                 caps: T.TreeCaps | None = None, version: int = 1,
                 cutoff: float | None = None, pairs=None, positions=None,
                 box=None, pair_kernel: bool | None = None,
                 caps_boost: float = 1.6, descreen_horizon=None,
                 pair_tiles=None, share_qd: bool = True,
                 mixed: bool = False):
        if version not in (0, 1):
            raise ValueError(f"version {version}: only 0 and 1 are ported")
        if mixed and pair_kernel:
            raise ValueError(
                "mixed=True rides the plain pair route (pair_kernel=False): "
                "the CUDA pair kernels sum in float32")
        self.params = params
        self.mixed = bool(mixed)
        self.version = version
        self.cutoff = cutoff
        self.device = torch.device(device)
        self.dtype = dtype
        self.share_qd = bool(share_qd)
        if descreen_horizon == "cutoff":
            descreen_horizon = cutoff
        self.descreen_horizon = descreen_horizon
        self.box = (None if box is None
                    else torch.as_tensor(box, dtype=dtype, device=self.device))
        self.caps = caps if caps is not None else \
            T.TreeCaps.for_natoms(params.n, boost=max(1.0, caps_boost / 1.6))
        if pair_kernel is None:
            pair_kernel = not mixed
        self.pair_kernel = bool(pair_kernel) and version == 1
        self.pair_pad = (PK.pad_to(params.n, PK.pick_tile(params.n))
                         if self.pair_kernel else 0)
        # large systems: the tree's candidate pairs are built on the device
        # per evaluation (an all-pairs list is N^2/2 rows); small ones keep
        # the exact triangular list
        self.neighbor_rcut = 0.0
        self.neighbor_kmax = 0
        self.neighbor_grid = None
        if pairs is None and positions is not None and params.n > 2000:
            self.neighbor_rcut = tree_pair_cutoff(params.radii_large) + 0.05
            heavy = np.asarray(params.ishydrogen) == 0
            seen = host_max_neighbors(np.asarray(positions), heavy,
                                      self.neighbor_rcut)
            self.neighbor_kmax = capacity.kmax_for(seen)
            if params.n > 3000:
                self.neighbor_grid = CellGrid(np.asarray(positions),
                                              self.neighbor_rcut,
                                              heavy_mask=heavy)
            pairs = (np.zeros(1, np.int32), np.zeros(1, np.int32),
                     np.zeros(1, bool))  # placeholder; rebuilt on device
        np_dtype = np.float64 if dtype == torch.float64 else np.float32
        self._init_positions = (None if positions is None
                                else np.asarray(positions))
        self.arrays_np = prepare_arrays(params, dtype=np_dtype, pairs=pairs,
                                        pair_pad=self.pair_pad,
                                        positions=positions)
        self.arrays = arrays_from_numpy(self.arrays_np, self.device, dtype)
        self.ntypes_j = int(np.max(self.arrays_np["type_j"]) + 1)
        if pair_tiles is None:
            pair_tiles = self._init_positions is not None
        if pair_tiles is True:
            pair_tiles = self._sized_pair_tiles() if self.pair_kernel else None
        self.pair_tiles = (tuple(pair_tiles)
                           if pair_tiles and self.pair_kernel else None)
        if caps is None and positions is not None:
            self.caps = self.size_caps(positions, caps_boost)

    def size_caps(self, positions, boost: float = 1.6) -> T.TreeCaps:
        """Lean tree capacities for `positions`: the overlap tree is built
        once at the large radii on the model's device (from the model's own
        candidate pairs, capacities and neighbor width grown until the build
        is clean) and sized by the rules of the JAX package's native
        pre-pass (runtime/native.py::size_tree_caps): caps = level counts x
        boost, aligned to 128; sibling windows = (largest sibling
        group - 1) x max(boost, 1.6), at least 4, since sibling-group maxima
        fluctuate proportionally more than level counts.  Leaves self.caps
        as grown; the caller assigns the result."""
        a = self.arrays
        pos = torch.as_tensor(positions, dtype=self.dtype, device=self.device)
        lvl1 = T.make_level1(pos, a["radii_large"], a["vol_large"],
                             a["gamma"] / self.params.roffset, a["ishydrogen"])
        for _ in range(8):
            ap, pair_rows, nbmax = tree_candidates(
                a, pos, self.neighbor_rcut, self.neighbor_kmax,
                self.neighbor_grid)
            diag = {k: v[0] for k, v in T.build_tree(
                lvl1, ap["pairs_i"], ap["pairs_j"], self.caps,
                pairs_valid=ap["pairs_valid"], pair_rows=pair_rows)[1].items()}
            if nbmax is not None:
                diag["neighbor_max"] = nbmax
            if not self.check_and_grow(diag):
                break
        else:
            raise RuntimeError("tree sizing did not converge")
        return capacity.size_tree(diag["counts"].cpu().numpy(),
                                  diag["max_siblings"].cpu().numpy(), boost)

    def update_params(self, params: AGBNPParams) -> bool:
        """Parameter-only update (updateParametersInContext, reference
        AGBNPForce.cpp:76-78): rebuilds the parameter arrays and the spline
        tables from `params` and swaps them in on the device, keeping the
        candidate pairs, capacities, neighbor width, tile budgets and the
        pair layouts' row order.  Returns True when every array kept its
        shape and the radius-type table its dimensions (the case the JAX
        package serves without recompiling).  Above 2000 atoms the
        candidate cutoff follows the new radii (and the cell grid with
        it)."""
        old = self.arrays_np
        pairs = (old["pairs_i"], old["pairs_j"], old["pairs_valid"])
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        arrays_np = prepare_arrays(params, dtype=np_dtype, pairs=pairs,
                                   pair_pad=self.pair_pad,
                                   positions=self._init_positions)
        ntypes_j = int(np.max(arrays_np["type_j"]) + 1)
        same = (ntypes_j == self.ntypes_j and set(arrays_np) == set(old)
                and all(np.shape(arrays_np[k]) == np.shape(old[k])
                        for k in arrays_np))
        self.params = params
        self.arrays_np = arrays_np
        self.arrays = arrays_from_numpy(arrays_np, self.device, self.dtype)
        self.ntypes_j = ntypes_j
        if self.neighbor_kmax > 0:
            rcut = tree_pair_cutoff(params.radii_large) + 0.05
            if rcut != self.neighbor_rcut and self.neighbor_grid is not None:
                self.neighbor_grid = CellGrid(
                    self._init_positions, rcut,
                    heavy_mask=np.asarray(params.ishydrogen) == 0)
            self.neighbor_rcut = rcut
        return same

    def _sized_pair_tiles(self):
        """Initial (lmax_born, lmax_gb) tile-list budgets: the in-range
        tile count on the initial configuration x1.5 headroom (8-aligned,
        at most every tile pair), overflow-detected through the diag like
        the neighbor kmax (models/agbnp_jax.py:625-662)."""
        n = self.params.n
        tile = PK.pick_tile(n)
        pos = self._init_positions
        a = self.arrays_np
        pos_p = np.zeros((3, self.pair_pad))
        pos_p[:, :n] = pos[a["rperm"]].T
        rvalid = np.arange(self.pair_pad) < n
        hids = a["hids_pad"]
        hvalid = hids >= 0
        pos_h = np.zeros((3, hids.shape[0]))
        pos_h[:, hvalid] = pos[hids[hvalid]].T
        boxv = (None if self.box is None
                else self.box.double().cpu().numpy())
        heff = (AGBNP_I4LOOKUP_MAXA if self.descreen_horizon is None
                else min(self.descreen_horizon, AGBNP_I4LOOKUP_MAXA))

        nti = self.pair_pad // tile
        ntj = pos_h.shape[1] // tile
        cb = TL.host_tile_count(pos_p, rvalid, pos_h, hvalid, tile, heff,
                                box=boxv)
        lb = min(capacity.grow_past(cb, 1.5, 8, 8), nti * ntj)
        lg = None
        if self.cutoff is not None:
            cg = TL.host_tile_count(pos_p, rvalid, pos_p, rvalid, tile,
                                    float(self.cutoff), triangular=True,
                                    box=boxv)
            lg = min(capacity.grow_past(cg, 1.5, 8, 8), nti * (nti + 1) // 2)
        return (lb, lg)

    def _evaluate(self, pos, wu_mode: str) -> dict:
        pos = torch.as_tensor(pos, dtype=self.dtype, device=self.device)
        if pos.dim() != 2:
            raise ValueError(f"positions [N, 3], got {tuple(pos.shape)}; "
                             "batched_energy_forces takes [B, N, 3]")
        return self._run(pos, wu_mode)

    def _run(self, pos, wu_mode: str) -> dict:
        return energy_forces(self.arrays, pos, caps=self.caps,
                             version=self.version,
                             roffset=self.params.roffset,
                             ntypes_j=self.ntypes_j, cutoff=self.cutoff,
                             box=self.box, pair_pad=self.pair_pad,
                             descreen_horizon=self.descreen_horizon,
                             neighbor_rcut=self.neighbor_rcut,
                             neighbor_kmax=self.neighbor_kmax,
                             neighbor_grid=self.neighbor_grid,
                             pair_tiles=self.pair_tiles,
                             share_qd=self.share_qd, wu_mode=wu_mode,
                             mixed=self.mixed)

    def energy_forces(self, pos, with_details: bool = False):
        out = self._evaluate(pos, "fused")
        if with_details:
            return out["energy"], out["force"], out
        return out["energy"], out["force"]

    def batched_energy_forces(self, pos_batch):
        """Evaluate B conformations [B, N, 3] of this system in one batch
        (the batched-rescoring path; JAX AGBNPModel.batched_energy_forces,
        which the port also runs on the kernel route).  Returns the
        energy_forces dict with a leading [B] axis on every leaf; pass the
        diag through batched_diag_max before check_and_grow."""
        pos = torch.as_tensor(pos_batch, dtype=self.dtype, device=self.device)
        if pos.dim() != 3 or pos.shape[1:] != (self.params.n, 3):
            raise ValueError(f"positions [B, {self.params.n}, 3], got "
                             f"{tuple(pos.shape)}")
        return self._run(pos, "fused")

    def energy_only(self, pos, with_details: bool = False):
        """Energy without the WU gamma-rescan force pass (the pass carries
        force only: the includeForces=False evaluation of
        AGBNPForceImpl::calcForcesAndEnergy, reference
        openmmapi/src/AGBNPForceImpl.cpp:32-36).  Bitwise the energy of
        energy_forces."""
        out = self._evaluate(pos, "skip")
        if with_details:
            return out["energy"], out
        return out["energy"]

    def check_and_grow(self, diag) -> bool:
        """PanicButton (JAX models/agbnp_jax.py::check_and_grow): double
        each overflowed tree level and sibling window, widen the neighbor
        width (where the model builds a list) and the tile budgets past
        the counts that overflowed them.  Returns True if a re-evaluation
        is needed.  A neighbor overflow also doubles the cell grid's
        capacity: the grid reports a cell overflow as kmax + 1 through the
        same channel (the JAX model keeps its grid; its Simulation grows
        it, md/simulation.py:935-942)."""
        nbmax, seen = diag.get("neighbor_max"), diag.get("pair_tile_counts")
        old = (self.caps, self.neighbor_kmax, self.pair_tiles)
        self.caps = capacity.grow_tree(self.caps, diag)
        if nbmax is not None and self.neighbor_kmax:
            self.neighbor_kmax = capacity.widened(self.neighbor_kmax,
                                                  int(nbmax))
            if self.neighbor_kmax != old[1] and self.neighbor_grid is not None:
                self.neighbor_grid = self.neighbor_grid.grown()
        if seen is not None:
            self.pair_tiles = capacity.grow_tiles(
                self.pair_tiles, np.asarray(torch.as_tensor(seen).cpu()))
        return (self.caps, self.neighbor_kmax, self.pair_tiles) != old
