"""The three AGBNP1 pair sweeps: CUDA kernels and their plain PyTorch twins.

Counterpart of the JAX package's Pallas kernels
(openmm_agbnp_plugin_tpu/ops/pallas/pairs.py), with the same layouts at the
Python boundary: positions [3, NP] of Morton-permuted rows padded to the
tile, [3, NHP] heavy-atom screener columns with -1 ids on padding, and the
same returned tuples.  One change: instead of the TPU's row-contracted
spline tables and column one-hots, the sweeps take per-row and per-column
radius-type ids and the [Ti, Tj, NA] y/y2 spline tables.

  born_sums     raw_i = sum_j s_j Q4(d_ij), optionally saving Q and dQ/dd
  gb_pair       GB pair energy rows, Y rows, direct forces (+ OPLS LJ and
                Coulomb with in-kernel exclusion lists)
  descreening   W_j/U_j column sums + direct descreening forces from the
                saved Q/dQ, or (qd=None) with the spline recomputed

Each wrapper routes by the device of its tensors: on the CPU it returns its
plain twin (`*_reference`); on a CUDA device it checks every argument,
launches its kernel from csrc/pairs.cu (gb_pair and the reloading
descreening: from csrc/tiles.cu, over every tile pair) on the current
stream, raises if the launch failed, and adds one to its count in LAUNCHES.  There is no fallback
from the kernel to the twin.  tiles.py holds the same sweeps over
interacting-tile lists and rows.py the tree's row moves, counted here too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...models.constants import (
    AGBNP_I4LOOKUP_MAXA,
    AGBNP_I4LOOKUP_NA,
    DIELECTRIC_FACTOR,
)

_NA = AGBNP_I4LOOKUP_NA
_H = AGBNP_I4LOOKUP_MAXA / (_NA - 1)
KE = 138.935456  # kJ mol^-1 nm e^-2 (Coulomb constant, md/forces.py)


def pad_to(n: int, tile: int) -> int:
    return max(tile, (n + tile - 1) // tile * tile)


def pick_tile(n: int) -> int:
    """Row/column padding granule of the pair layouts."""
    return 128 if n <= 1024 else 256


def _horizon(horizon):
    return (AGBNP_I4LOOKUP_MAXA if horizon is None
            else min(float(horizon), AGBNP_I4LOOKUP_MAXA))


# launches of each CUDA kernel (one per wrapper call on a CUDA device); the
# two descreening variants of each route are counted apart; the last two
# are rows.py's
LAUNCHES = dict.fromkeys((
    "born_sums", "gb_pair", "descreening", "descreening_recompute",
    "born_sums_tiles", "gb_pair_tiles", "descreening_tiles",
    "descreening_tiles_recompute", "take_rows", "cumsum_rows"), 0)


def launch_counts() -> dict:
    return dict(LAUNCHES)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class SplineArgs(NamedTuple):
    """What a recomputing descreening sweep (qd=None) needs to re-evaluate
    the Born sweep's masked spline: born_sums' ids, types, tables, n and
    horizon."""
    hids_perm: torch.Tensor
    type_rows: torch.Tensor
    type_cols: torch.Tensor
    yval: torch.Tensor
    y2val: torch.Tensor
    n: int
    horizon: float | None = None


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _pair_geom(pos_r, pos_c, box):
    """Deltas dx, dy, dz [..., R, C] = pos_c - pos_r (min-image if box), d2,
    from pos_r [3, ..., R] and pos_c [3, ..., C].

    box: None, [3] orthorhombic lengths, or [3, 3] reduced triclinic rows
    (sequential c/b/a wrap, ops/born.py::min_image)."""
    dx = pos_c[0][..., None, :] - pos_r[0][..., :, None]
    dy = pos_c[1][..., None, :] - pos_r[1][..., :, None]
    dz = pos_c[2][..., None, :] - pos_r[2][..., :, None]
    if box is not None and box.dim() == 1:
        dx = dx - box[0] * torch.round(dx * (1.0 / box[0]))
        dy = dy - box[1] * torch.round(dy * (1.0 / box[1]))
        dz = dz - box[2] * torch.round(dz * (1.0 / box[2]))
    elif box is not None:
        k = torch.round(dz * (1.0 / box[2, 2]))
        dx, dy, dz = dx - k * box[2, 0], dy - k * box[2, 1], dz - k * box[2, 2]
        k = torch.round(dy * (1.0 / box[1, 1]))
        dx, dy = dx - k * box[1, 0], dy - k * box[1, 1]
        dx = dx - box[0, 0] * torch.round(dx * (1.0 / box[0, 0]))
    return dx, dy, dz, dx * dx + dy * dy + dz * dz


def _spline(d, ti, tj, yval, y2val):
    """Q and dQ/dd from the [Ti, Tj, NA] tables, as the kernels form them."""
    seg = torch.clamp((d * (1.0 / _H)).to(torch.int64), 0, _NA - 2)
    y0 = yval[ti, tj, seg]
    y1 = yval[ti, tj, seg + 1]
    y20 = y2val[ti, tj, seg]
    y21 = y2val[ti, tj, seg + 1]
    a = (seg.to(d.dtype) * _H + _H - d) * (1.0 / _H)
    b = 1.0 - a
    q = (a * y0 + b * y1
         + ((a ** 3 - a) * y20 + (b ** 3 - b) * y21) * (_H * _H) / 6.0)
    dq = ((y1 - y0) * (1.0 / _H)
          + ((3.0 * b * b - 1.0) * y21 - (3.0 * a * a - 1.0) * y20)
          * (_H / 6.0))
    return q, dq


def _born_qdq(d, gi, gj, n, horizon, trow, tcol, yval, y2val):
    """The Born sweep's masked Q and dQ/dd and its pair mask, for row ids
    gi, screener permuted-row ids gj and radius types broadcasting against
    the distances d."""
    mask = (gi != gj) & (gi < n) & (gj >= 0) & (d < _horizon(horizon))
    q, dq = _spline(d, trow, tcol, yval, y2val)
    return torch.where(mask, q, 0.0), torch.where(mask, dq, 0.0), mask


def born_sums_reference(pos_pad, pos_hpad, hids_perm, type_rows, type_cols,
                        yval, y2val, s_hpad, n, box=None, horizon=None,
                        save_qd=False):
    """Plain twin of born_sums (same arguments and results)."""
    npad = pos_pad.shape[1]
    _, _, _, d2 = _pair_geom(pos_pad, pos_hpad, box)
    d = torch.sqrt(d2)
    q, dq, _ = _born_qdq(d, torch.arange(npad, device=pos_pad.device)[:, None],
                         hids_perm.long()[None, :], n, horizon,
                         type_rows.long()[:, None], type_cols.long()[None, :],
                         yval, y2val)
    raw = torch.sum(q * s_hpad[None, :], dim=1)
    if save_qd:
        return raw, q, dq
    return raw


def gb_pair_reference(pos_pad, charge_pad, born_pad, n, box=None,
                      cutoff=None, sig_pad=None, epsq_pad=None,
                      excl_rows_pad=None):
    """Plain twin of gb_pair: the full [NP, NP] square, row sums."""
    npad = pos_pad.shape[1]
    dt = pos_pad.dtype
    dx, dy, dz, d2 = _pair_geom(pos_pad, pos_pad, box)
    ids = torch.arange(npad, device=pos_pad.device)
    gi, gj = ids[:, None], ids[None, :]
    mask = (gi != gj) & (gi < n) & (gj < n)
    if cutoff is not None:
        mask = mask & (d2 < cutoff * cutoff)
    fm = mask.to(dt)
    bb = born_pad[:, None] * born_pad[None, :]
    bb_safe = torch.where(mask, bb, 1.0)
    etij = torch.exp(-0.25 * torch.where(mask, d2, 0.0) / bb_safe)
    fgb = fm / torch.sqrt(torch.where(mask, d2 + bb * etij, 1.0))
    qq_f = charge_pad[:, None] * charge_pad[None, :]
    qq = DIELECTRIC_FACTOR * qq_f
    epair = qq * fgb
    fgb3 = fgb * fgb * fgb
    mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
    ypair = qq_f * (bb + 0.25 * d2) * etij * fgb3
    mmrow = None
    if sig_pad is not None:
        excluded = torch.zeros_like(mask)
        for e in range(excl_rows_pad.shape[1]):
            excluded = excluded | (excl_rows_pad[:, e:e + 1].long() == gj)
        fmm = fm * (~excluded).to(dt)
        d2s = torch.where(mask, d2, 1.0)
        inv2 = fmm / d2s
        sr2 = (sig_pad[:, None] * sig_pad[None, :]) * inv2
        sr6 = sr2 * sr2 * sr2
        epsij = epsq_pad[:, None] * epsq_pad[None, :]
        ecoul = KE * qq_f * (fmm / torch.sqrt(d2s))
        elj = 4.0 * epsij * (sr6 * sr6 - sr6)
        dmm = (4.0 * epsij * (-6.0 * sr6 * sr6 + 3.0 * sr6)
               - 0.5 * ecoul) * inv2
        mw = mw + 2.0 * dmm
        mmrow = torch.sum(elj + ecoul, dim=1)
    force = torch.stack([torch.sum(dx * mw, dim=1), torch.sum(dy * mw, dim=1),
                         torch.sum(dz * mw, dim=1)], dim=1)
    return torch.sum(epair, dim=1), torch.sum(ypair, dim=1), force, mmrow


def descreening_reference(pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad, qd,
                          box=None, spline=None):
    """Plain twin of descreening (same arguments and results)."""
    dx, dy, dz, d2 = _pair_geom(pos_pad, pos_hpad, box)
    d = torch.sqrt(d2)
    if qd is None:
        sp = need_spline(spline)
        q, dq, mask = _born_qdq(
            d, torch.arange(pos_pad.shape[1], device=d.device)[:, None],
            sp.hids_perm.long()[None, :], sp.n, sp.horizon,
            sp.type_rows.long()[:, None], sp.type_cols.long()[None, :],
            sp.yval, sp.y2val)
    else:
        q, dq = qd
        mask = d > 0.0
    return _descreen_sums(dx, dy, dz, d, mask, q, dq, s_hpad, brw_pad,
                          bru_pad)


def need_spline(spline):
    if spline is None:
        raise ValueError("qd=None needs spline=SplineArgs(...) to recompute "
                         "the Born sweep's spline")
    return spline


def _descreen_sums(dx, dy, dz, d, mask, q, dq, s_cols, brw_rows, bru_rows):
    """Descreening over [..., R, C] pairs: W and U column sums, and the
    direct forces c_ij * dist_ij on rows (+) and columns (-), with
    c_ij = (BrW + BrU)_i s_j dQ_ij / d_ij (1/d taken only where mask)."""
    inv_d = torch.where(mask, 1.0 / torch.where(mask, d, 1.0), 0.0)
    w = torch.sum(brw_rows[..., :, None] * q, dim=-2)
    u = torch.sum(bru_rows[..., :, None] * q, dim=-2)
    c = (brw_rows + bru_rows)[..., :, None] * s_cols[..., None, :] * dq * inv_d
    cx, cy, cz = c * dx, c * dy, c * dz
    f_rows = torch.stack([torch.sum(cx, dim=-1), torch.sum(cy, dim=-1),
                          torch.sum(cz, dim=-1)], dim=-1)
    f_cols = torch.stack([-torch.sum(cx, dim=-2), -torch.sum(cy, dim=-2),
                          -torch.sum(cz, dim=-2)], dim=-1)
    return w, u, f_rows, f_cols


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _check(name, t, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _box_arg(box, device):
    """(box_mode, device tensor of 9 floats or None) for the kernels."""
    if box is None:
        return 0, None
    b = torch.as_tensor(box, dtype=torch.float32, device=device)
    if b.shape == (3,):
        return 1, torch.cat([b, b.new_zeros(6)]).contiguous()
    if b.shape == (3, 3):
        return 2, b.reshape(9).contiguous()
    raise ValueError(f"box: shape {tuple(b.shape)}, expected [3] or [3, 3]")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _cuda_lib():
    from ...runtime.build import load_library

    return load_library()


def born_sums(pos_pad, pos_hpad, hids_perm, type_rows, type_cols, yval,
              y2val, s_hpad, n, box=None, horizon=None, save_qd=False):
    """raw_i = sum_j s_j Q4(d_ij) with the screener (column) axis packed to
    heavy atoms only (hydrogens never screen, reference
    AGBNPUtils.cpp:168-171).

    pos_pad [3, NP] (screened rows); pos_hpad [3, NHP] (heavy screeners);
    hids_perm [NHP] int32 permuted-row id of each packed column (-1
    padding), for the self-pair test; type_rows [NP] / type_cols [NHP] int32
    radius types; yval/y2val [Ti, Tj, NA]; s_hpad [NHP].  Pairs count within
    min(horizon, 2 nm).  Mirrors inverseBornRadii (reference
    AGBNPBornRadii.cl:181-490; CPU loop ReferenceAGBNPKernels.cpp:437-454).

    With save_qd, also returns the masked Q [NP, NHP] and dQ/dd [NP, NHP]
    so descreening reloads them instead of re-running the spline.
    """
    if pos_pad.device.type == "cpu":
        return born_sums_reference(pos_pad, pos_hpad, hids_perm, type_rows,
                                   type_cols, yval, y2val, s_hpad, n, box=box,
                                   horizon=horizon, save_qd=save_qd)
    dev = pos_pad.device
    f32, i32 = torch.float32, torch.int32
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    nti, ntj = yval.shape[0], yval.shape[1]
    _check("pos_pad", pos_pad, f32, (3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (3, nhpad), dev)
    _check("hids_perm", hids_perm, i32, (nhpad,), dev)
    _check("type_rows", type_rows, i32, (npad,), dev)
    _check("type_cols", type_cols, i32, (nhpad,), dev)
    _check("yval", yval, f32, (nti, ntj, _NA), dev)
    _check("y2val", y2val, f32, (nti, ntj, _NA), dev)
    _check("s_hpad", s_hpad, f32, (nhpad,), dev)
    box_mode, box_t = _box_arg(box, dev)
    raw = torch.empty(npad, dtype=f32, device=dev)
    q = dq = None
    if save_qd:
        q = torch.empty((npad, nhpad), dtype=f32, device=dev)
        dq = torch.empty((npad, nhpad), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_born_sums(
        pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad,
        hids_perm.data_ptr(), type_rows.data_ptr(), type_cols.data_ptr(),
        yval.data_ptr(), y2val.data_ptr(), nti, ntj, s_hpad.data_ptr(),
        int(n), _horizon(horizon), box_mode, _ptr(box_t), raw.data_ptr(),
        _ptr(q), _ptr(dq), stream)
    _launch_check("born_sums", rc)
    LAUNCHES["born_sums"] += 1
    if save_qd:
        return raw, q, dq
    return raw


def gb_pair(pos_pad, charge_pad, born_pad, n, box=None, cutoff=None,
            sig_pad=None, epsq_pad=None, excl_rows_pad=None):
    """GB pair sweep (reference ReferenceAGBNPKernels.cpp:464-504,
    GBPairEnergy kernel AGBNPGBEnergy.cl:58-383).

    Returns (gb_pair_energy_rows [NP], Y_rows [NP], force [NP, 3],
    mm_rows [NP] or None); the row energy sums count each unordered pair
    twice (once from each side), matching the reference's 2 f_eps qq fgb
    pair term when summed (halve the mm_rows sum for the MM energy).  With
    sig_pad/epsq_pad (sigma and sqrt(epsilon)) and excl_rows_pad [NP, E]
    int32 (-1 padded, permuted-row ids), the OPLS dense LJ + Coulomb sum
    and its forces ride the same sweep; excluded pairs are skipped inside.

    The kernel is tiles.py's list kernel over triangular_grid_list at the
    tile pick_tile(NP): each unordered pair once, deposited on both sides,
    the 32x32 sub-tile pairs beyond the cutoff skipped (none without one).
    Its scratch takes 1.5 T^2 bytes for every tile pair (96 KB at T 256).
    """
    if pos_pad.device.type == "cpu":
        return gb_pair_reference(pos_pad, charge_pad, born_pad, n, box=box,
                                 cutoff=cutoff, sig_pad=sig_pad,
                                 epsq_pad=epsq_pad,
                                 excl_rows_pad=excl_rows_pad)
    from .tiles import _gb_subtiles, triangular_grid_list

    npad = pos_pad.shape[1]
    tile = _grid_tile(npad)
    tl, nv = triangular_grid_list(npad // tile, pos_pad.device)
    out = _gb_subtiles("gb_pair", nv, tl, tile, pos_pad, charge_pad,
                       born_pad, n, box, cutoff, sig_pad, epsq_pad,
                       excl_rows_pad)
    LAUNCHES["gb_pair"] += 1
    return out


def _grid_tile(*extents):
    """The tile pick_tile gives the dense layouts of these padded extents,
    which it must divide."""
    tile = pick_tile(extents[0])
    if any(e % tile for e in extents):
        raise ValueError(f"padded extents {extents} are not multiples of the "
                         f"tile {tile}")
    return tile


def _check_spline(spline, npad, nhpad, dev):
    """Check a SplineArgs for the CUDA kernels; returns (nti, ntj)."""
    need_spline(spline)
    nti, ntj = spline.yval.shape[0], spline.yval.shape[1]
    _check("hids_perm", spline.hids_perm, torch.int32, (nhpad,), dev)
    _check("type_rows", spline.type_rows, torch.int32, (npad,), dev)
    _check("type_cols", spline.type_cols, torch.int32, (nhpad,), dev)
    _check("yval", spline.yval, torch.float32, (nti, ntj, _NA), dev)
    _check("y2val", spline.y2val, torch.float32, (nti, ntj, _NA), dev)
    return nti, ntj


def _spline_ptrs(sp):
    """The recomputing kernels' spline arguments."""
    return (sp.hids_perm.data_ptr(), sp.type_rows.data_ptr(),
            sp.type_cols.data_ptr(), sp.yval.data_ptr(), sp.y2val.data_ptr(),
            sp.yval.shape[0], sp.yval.shape[1], int(sp.n),
            _horizon(sp.horizon))


def descreening(pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad, qd, box=None,
                spline=None):
    """Descreening derivative sweep (reference
    ReferenceAGBNPKernels.cpp:555-586, VdWGBDerBorn
    AGBNPBornRadii.cl:872-1280) over the heavy-packed screener columns.

    With qd = (Q, dQ) from born_sums(save_qd=True) it reloads them; with
    qd=None it re-evaluates the Born sweep's masked spline from
    spline=SplineArgs(...) (the JAX package's _descreen_kernel, for when
    Q/dQ would exceed the memory budget or sharing is off).

    The reloading kernel is tiles.py's list kernel over full_grid_list at
    the tile pick_tile(NP): it skips the 32x32 sub-tile pairs that lie
    beyond the horizon of the spline (2 nm without one), which hold zero
    Q/dQ.

    Returns (W [NHP], U [NHP], force_rows [NP, 3], force_cols [NHP, 3]);
    the column-side quantities are in packed heavy layout.
    """
    if pos_pad.device.type == "cpu":
        return descreening_reference(pos_pad, pos_hpad, s_hpad, brw_pad,
                                     bru_pad, qd, box=box, spline=spline)
    dev = pos_pad.device
    f32 = torch.float32
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    if qd is not None:
        from .tiles import _descreen_subtiles, full_grid_list

        q, dq = qd
        _check("Q", q, f32, (npad, nhpad), dev)
        _check("dQ", dq, f32, (npad, nhpad), dev)
        tile = _grid_tile(npad, nhpad)
        tl, nv = full_grid_list(npad // tile, nhpad // tile, dev)
        out = _descreen_subtiles("descreening", nv, tl, tile, pos_pad,
                                 pos_hpad, s_hpad, brw_pad, bru_pad, q, dq,
                                 None, nhpad, True, box, spline)
        LAUNCHES["descreening"] += 1
        return out
    _check("pos_pad", pos_pad, f32, (3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (3, nhpad), dev)
    _check("s_hpad", s_hpad, f32, (nhpad,), dev)
    _check("brw_pad", brw_pad, f32, (npad,), dev)
    _check("bru_pad", bru_pad, f32, (npad,), dev)
    _check_spline(spline, npad, nhpad, dev)
    box_mode, box_t = _box_arg(box, dev)
    lib = _cuda_lib()
    partial = torch.empty((lib.agbnp_descreen_chunks(npad), 5, nhpad),
                          dtype=f32, device=dev)
    w = torch.empty(nhpad, dtype=f32, device=dev)
    u = torch.empty(nhpad, dtype=f32, device=dev)
    f_rows = torch.empty((npad, 3), dtype=f32, device=dev)
    f_cols = torch.empty((nhpad, 3), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.agbnp_descreening(
        pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad,
        s_hpad.data_ptr(), brw_pad.data_ptr(), bru_pad.data_ptr(), box_mode,
        _ptr(box_t), *_spline_ptrs(spline), partial.data_ptr(), w.data_ptr(),
        u.data_ptr(), f_rows.data_ptr(), f_cols.data_ptr(), stream)
    _launch_check("descreening", rc)
    LAUNCHES["descreening_recompute"] += 1
    return w, u, f_rows, f_cols
