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
                saved Q/dQ

Each wrapper routes by the device of its tensors: on the CPU it returns its
plain twin (`*_reference`); on a CUDA device it checks every argument,
launches its kernel from csrc/pairs.cu on the current stream, raises if the
launch failed, and adds one to its `launches` count.  There is no fallback
from the kernel to the twin.
"""

from __future__ import annotations

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


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _pair_geom(pos_r, pos_c, box):
    """Deltas dx, dy, dz [R, C] = pos_c - pos_r (min-image if box), d2.

    box: None, [3] orthorhombic lengths, or [3, 3] reduced triclinic rows
    (sequential c/b/a wrap, ops/born.py::min_image)."""
    dx = pos_c[0][None, :] - pos_r[0][:, None]
    dy = pos_c[1][None, :] - pos_r[1][:, None]
    dz = pos_c[2][None, :] - pos_r[2][:, None]
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


def born_sums_reference(pos_pad, pos_hpad, hids_perm, type_rows, type_cols,
                        yval, y2val, s_hpad, n, box=None, horizon=None,
                        save_qd=False):
    """Plain twin of born_sums (same arguments and results)."""
    npad = pos_pad.shape[1]
    dx, dy, dz, d2 = _pair_geom(pos_pad, pos_hpad, box)
    d = torch.sqrt(d2)
    gi = torch.arange(npad, device=pos_pad.device)[:, None]
    gj = hids_perm.long()[None, :]
    mask = (gi != gj) & (gi < n) & (gj >= 0) & (d < _horizon(horizon))
    q, dq = _spline(d, type_rows.long()[:, None], type_cols.long()[None, :],
                    yval, y2val)
    q = torch.where(mask, q, 0.0)
    dq = torch.where(mask, dq, 0.0)
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
                          box=None):
    """Plain twin of descreening (same arguments and results)."""
    q, dq = qd
    dx, dy, dz, d2 = _pair_geom(pos_pad, pos_hpad, box)
    d = torch.sqrt(d2)
    w = torch.sum(brw_pad[:, None] * q, dim=0)
    u = torch.sum(bru_pad[:, None] * q, dim=0)
    inv_d = torch.where(d > 0.0, 1.0 / torch.where(d > 0.0, d, 1.0), 0.0)
    c = (brw_pad + bru_pad)[:, None] * s_hpad[None, :] * dq * inv_d
    cx, cy, cz = c * dx, c * dy, c * dz
    f_rows = torch.stack([torch.sum(cx, dim=1), torch.sum(cy, dim=1),
                          torch.sum(cz, dim=1)], dim=1)
    f_cols = torch.stack([-torch.sum(cx, dim=0), -torch.sum(cy, dim=0),
                          -torch.sum(cz, dim=0)], dim=1)
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
    born_sums.launches += 1
    if save_qd:
        return raw, q, dq
    return raw


born_sums.launches = 0


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
    """
    if pos_pad.device.type == "cpu":
        return gb_pair_reference(pos_pad, charge_pad, born_pad, n, box=box,
                                 cutoff=cutoff, sig_pad=sig_pad,
                                 epsq_pad=epsq_pad,
                                 excl_rows_pad=excl_rows_pad)
    dev = pos_pad.device
    f32 = torch.float32
    npad = pos_pad.shape[1]
    _check("pos_pad", pos_pad, f32, (3, npad), dev)
    _check("charge_pad", charge_pad, f32, (npad,), dev)
    _check("born_pad", born_pad, f32, (npad,), dev)
    with_mm = sig_pad is not None
    ne = 0
    if with_mm:
        ne = excl_rows_pad.shape[1]
        _check("sig_pad", sig_pad, f32, (npad,), dev)
        _check("epsq_pad", epsq_pad, f32, (npad,), dev)
        _check("excl_rows_pad", excl_rows_pad, torch.int32, (npad, ne), dev)
    box_mode, box_t = _box_arg(box, dev)
    erow = torch.empty(npad, dtype=f32, device=dev)
    yrow = torch.empty(npad, dtype=f32, device=dev)
    force = torch.empty((npad, 3), dtype=f32, device=dev)
    mmrow = torch.empty(npad, dtype=f32, device=dev) if with_mm else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_gb_pair(
        pos_pad.data_ptr(), npad, charge_pad.data_ptr(), born_pad.data_ptr(),
        _ptr(sig_pad), _ptr(epsq_pad), _ptr(excl_rows_pad), ne, int(n),
        -1.0 if cutoff is None else float(cutoff) * float(cutoff), box_mode,
        _ptr(box_t), DIELECTRIC_FACTOR, KE, erow.data_ptr(), yrow.data_ptr(),
        force.data_ptr(), _ptr(mmrow), stream)
    _launch_check("gb_pair", rc)
    gb_pair.launches += 1
    return erow, yrow, force, mmrow


gb_pair.launches = 0


def descreening(pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad, qd, box=None):
    """Descreening derivative sweep (reference
    ReferenceAGBNPKernels.cpp:555-586, VdWGBDerBorn
    AGBNPBornRadii.cl:872-1280) over the heavy-packed screener columns,
    reloading born_sums' saved qd = (Q, dQ).

    Returns (W [NHP], U [NHP], force_rows [NP, 3], force_cols [NHP, 3]);
    the column-side quantities are in packed heavy layout.
    """
    if pos_pad.device.type == "cpu":
        return descreening_reference(pos_pad, pos_hpad, s_hpad, brw_pad,
                                     bru_pad, qd, box=box)
    dev = pos_pad.device
    f32 = torch.float32
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    q, dq = qd
    _check("pos_pad", pos_pad, f32, (3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (3, nhpad), dev)
    _check("s_hpad", s_hpad, f32, (nhpad,), dev)
    _check("brw_pad", brw_pad, f32, (npad,), dev)
    _check("bru_pad", bru_pad, f32, (npad,), dev)
    _check("Q", q, f32, (npad, nhpad), dev)
    _check("dQ", dq, f32, (npad, nhpad), dev)
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
        pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad, q.data_ptr(),
        dq.data_ptr(), s_hpad.data_ptr(), brw_pad.data_ptr(),
        bru_pad.data_ptr(), box_mode, _ptr(box_t), partial.data_ptr(),
        w.data_ptr(), u.data_ptr(), f_rows.data_ptr(), f_cols.data_ptr(),
        stream)
    _launch_check("descreening", rc)
    descreening.launches += 1
    return w, u, f_rows, f_cols


descreening.launches = 0

KERNELS = (born_sums, gb_pair, descreening)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
