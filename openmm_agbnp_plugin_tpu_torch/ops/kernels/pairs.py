"""The three AGBNP1 pair sweeps: CUDA kernels and their plain PyTorch twins.

Counterpart of the JAX package's Pallas kernels
(openmm_agbnp_plugin_tpu/ops/pallas/pairs.py), with the same layouts at the
Python boundary: positions [3, NP] of Morton-permuted rows padded to the
tile, [3, NHP] heavy-atom screener columns with -1 ids on padding, and the
same returned tuples.  One change: instead of the TPU's row-contracted
spline tables and column one-hots, the sweeps take per-row and per-column
radius-type ids and the [Ti, Tj, NA] y/y2 spline tables.

  subtile_columns  the Born and descreening sweeps' work list: for each
                   32-row sub-tile, the heavy columns that can hold a live
                   Born pair (Chunks); the Born kernel builds its own
                   unless it is given one
  born_sums        raw_i = sum_j s_j Q4(d_ij), optionally saving Q and dQ/dd
  gb_pair          GB pair energy rows, Y rows, direct forces (+ OPLS LJ
                   and Coulomb with in-kernel exclusion lists)
  descreening      W_j/U_j column sums + direct descreening forces from the
                   saved Q/dQ, or (qd=None) with the spline recomputed

Replicas: every wrapper also takes a batch of B replicas of one system,
positions [B, 3, NP] / [B, 3, NHP] and every other per-replica array with a
leading [B] axis (screening factors, Born radii, BrW/BrU, chunk lists,
Q/dQ), while the tables the replicas share (screener ids, radius types,
the spline, charges, LJ parameters, exclusion rows) keep their shapes; the
results then carry the [B] axis too.  On the card one launch serves the
batch, and replica b is bitwise its own B = 1 launch; the twins run each
replica as an unbatched call.  No pair crosses replicas.

Each wrapper routes by the device of its tensors: on the CPU it returns its
plain twin (`*_reference`); on a CUDA device it checks every argument,
launches its kernel from csrc/pairs.cu (gb_pair: from csrc/tiles.cu, over
every tile pair) on the current stream, raises if the launch failed, and
adds one to its count in LAUNCHES.  There is no fallback from the kernel
to the twin.  On the card born_sums and descreening walk the chunks of
subtile_columns in 32-column steps and keep Q/dQ in the chunk layout [NP /
32, NHP, 32]; `*_chunks_reference` are the torch mirrors of those walks,
and chunk_layout / chunk_slots say where a dense [NP, NHP] value lands and
which slots the Born kernel writes.  tiles.py holds the same sweeps over
interacting-tile lists, rows.py the tree's row moves and tree.py the
tree's fixed-topology passes, counted here too.
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
SUB = 32          # sub-tile edge: the rows of a chunk list entry, a chunk
# nm added to the horizon before a column is left off a sub-tile's chunk
# list: far above the f32 rounding of the box and the distances (tiles.py
# SUBTILE_MARGIN), so no pair the Born mask accepts is dropped
CHUNK_MARGIN = 1e-3
# the most warps a dense chunk sweep's block (one sub-tile) takes, and the
# most blocks a dense descreening sweep splits a sub-tile's chunks over
# (csrc/pairs.cu MAX_CHUNK_WARPS, MAX_CHUNK_PARTS)
MAX_CHUNK_WARPS = 16
MAX_CHUNK_PARTS = 4


def pad_to(n: int, tile: int) -> int:
    return max(tile, (n + tile - 1) // tile * tile)


def pick_tile(n: int) -> int:
    """Row/column padding granule of the pair layouts."""
    return 128 if n <= 1024 else 256


def _horizon(horizon):
    return (AGBNP_I4LOOKUP_MAXA if horizon is None
            else min(float(horizon), AGBNP_I4LOOKUP_MAXA))


# launches of each CUDA kernel (one per wrapper call on a CUDA device); the
# two descreening variants of each route are counted apart; take_rows and
# cumsum_rows are rows.py's, the last three tree.py's
LAUNCHES = dict.fromkeys((
    "subtile_columns", "born_sums", "gb_pair", "descreening",
    "descreening_recompute", "born_sums_tiles", "gb_pair_tiles",
    "descreening_tiles", "descreening_tiles_recompute", "take_rows",
    "cumsum_rows", "tree_rescan", "tree_reduce", "tree_deposit"), 0)


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


class Chunks(NamedTuple):
    """The dense Born and descreening sweeps' work list (subtile_columns):
    for each 32-row sub-tile a of the padded rows (S = NP / 32), the heavy
    columns j that can hold a pair the Born mask accepts with one of its
    rows.  cols [S, NHP] int32: the listed j in ascending order, -1 past
    ncols [S] int32; bits [S, NHP / 32] int32: bit c of word w set iff
    column 32 w + c is listed (the transposed list the column sums walk).
    The sweeps walk each list in chunks of 32 slots."""
    cols: torch.Tensor
    ncols: torch.Tensor
    bits: torch.Tensor


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def _pair_geom(pos_r, pos_c, box):
    """Deltas dx, dy, dz [..., R, C] = pos_c - pos_r (min-image if box), d2,
    from pos_r [3, ..., R] and pos_c [3, ..., C].

    box: None, [3] orthorhombic lengths, or [3, 3] reduced triclinic rows
    (sequential c/b/a wrap, ops/born.py::min_image)."""
    return _min_image_d2(pos_c[0][..., None, :] - pos_r[0][..., :, None],
                         pos_c[1][..., None, :] - pos_r[1][..., :, None],
                         pos_c[2][..., None, :] - pos_r[2][..., :, None], box)


def _min_image_d2(dx, dy, dz, box):
    """The minimum image of the deltas (as _pair_geom's) and d2, every
    product and sum rounded on its own: the order the chunk-list kernel
    reproduces bit for bit."""
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


def _chunk_lim(horizon) -> float:
    """The chunk list's bound on |x_j - c_a| - r_a: the Born mask's horizon
    plus CHUNK_MARGIN, the one float both the kernel and the twin compare
    with."""
    return _horizon(horizon) + CHUNK_MARGIN


def subtile_columns_reference(pos_pad, pos_hpad, hids_perm, n, box=None,
                              horizon=None):
    """Plain twin of subtile_columns (same arguments and result).  Each
    product, sum and square root is its own torch op, in the kernel's
    order, so on the card the two agree bit for bit."""
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    dev = pos_pad.device
    nsub = npad // SUB
    p = pos_pad.reshape(3, nsub, SUB)
    valid = (torch.arange(npad, device=dev) < n).reshape(1, nsub, SUB)
    has = torch.any(valid[0], dim=1)
    lo = torch.where(has[None, :], torch.amin(torch.where(valid, p, 1e30),
                                              dim=2), 0.0)
    hi = torch.where(has[None, :], torch.amax(torch.where(valid, p, -1e30),
                                              dim=2), 0.0)
    c = 0.5 * (lo + hi)
    e = hi - lo
    r = 0.5 * torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    dx, dy, dz, d2 = _pair_geom(c, pos_hpad, box)
    if box is not None and box.dim() == 2:
        # the sequential triclinic wrap need not find the nearest image:
        # the least of the 27 images one lattice step around it
        for kc in (-1, 0, 1):
            for kb in (-1, 0, 1):
                for ka in (-1, 0, 1):
                    sx = (dx + ka * box[0, 0]) + kb * box[1, 0] \
                        + kc * box[2, 0]
                    sy = (dy + kb * box[1, 1]) + kc * box[2, 1]
                    sz = dz + kc * box[2, 2]
                    d2 = torch.minimum(d2, sx * sx + sy * sy + sz * sz)
    ok = ((torch.sqrt(d2) - r[:, None] < _chunk_lim(horizon))
          & has[:, None] & (hids_perm >= 0)[None, :])
    ids = torch.arange(nhpad, dtype=torch.int32, device=dev)
    key = torch.sort(torch.where(ok, ids, nhpad), dim=1).values
    cols = torch.where(key < nhpad, key, -1).to(torch.int32).contiguous()
    words = torch.sum(ok.reshape(nsub, nhpad // SUB, SUB).long()
                      << torch.arange(SUB, device=dev), dim=2)
    bits = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return Chunks(cols, torch.sum(ok, dim=1).to(torch.int32),
                  bits.to(torch.int32).contiguous())


def chunk_slots(chunks):
    """[S, NHP] bool: the slots of the chunks a dense sweep walks (k <
    32 ceil(ncols / 32)), where the Born kernel writes Q/dQ (zero past
    ncols); elsewhere they are undefined on the card."""
    k = torch.arange(chunks.cols.shape[1], device=chunks.cols.device)
    walked = (chunks.ncols.long() + SUB - 1) // SUB * SUB
    return k[None, :] < walked[:, None]


def chunk_layout(x, chunks):
    """A dense [NP, NHP] array (Q or dQ) in the chunk layout [S, NHP, 32]:
    slot (a, k) of row 32 a + r holds x[32 a + r, cols[a, k]], zero where
    the slot lists no column."""
    nsub = x.shape[0] // SUB
    cols = chunks.cols.long()
    rows = x.reshape(nsub, SUB, -1).transpose(1, 2)       # [S, NHP, 32]
    out = torch.gather(rows, 1, cols.clamp(min=0)[:, :, None].expand(
        -1, -1, SUB))
    return torch.where((cols >= 0)[:, :, None], out, 0.0)


def _chunk_geom(chunks, pos_pad, pos_hpad, box):
    """Row ids [S, 1, 32], listed column ids [S, NHP, 1] (0 on dead
    slots), which slots list a column [S, NHP, 1], and the deltas dx, dy,
    dz [S, NHP, 32] = column - row (min-image if box) with d."""
    nsub = pos_pad.shape[1] // SUB
    cols = chunks.cols.long()
    live = (cols >= 0)[:, :, None]
    cj = cols.clamp(min=0)
    rows = torch.arange(nsub * SUB, device=cols.device).reshape(nsub, 1, SUB)
    dx, dy, dz, d2 = _min_image_d2(
        pos_hpad[0][cj][:, :, None] - pos_pad[0][rows],
        pos_hpad[1][cj][:, :, None] - pos_pad[1][rows],
        pos_hpad[2][cj][:, :, None] - pos_pad[2][rows], box)
    return rows, cj[:, :, None], live, dx, dy, dz, torch.sqrt(d2)


def _chunk_spline(chunks, pos_pad, pos_hpad, sp, box):
    """The Born sweep's masked Q, dQ/dd and mask on every chunk slot."""
    rows, cj, live, dx, dy, dz, d = _chunk_geom(chunks, pos_pad, pos_hpad,
                                                box)
    gj = torch.where(live, sp.hids_perm.long()[cj], -1)
    q, dq, mask = _born_qdq(d, rows, gj, sp.n, sp.horizon,
                            sp.type_rows.long()[rows],
                            sp.type_cols.long()[cj], sp.yval, sp.y2val)
    return q, dq, mask, (rows, cj, live, dx, dy, dz, d)


def born_sums_chunks_reference(chunks, pos_pad, pos_hpad, hids_perm,
                               type_rows, type_cols, yval, y2val, s_hpad, n,
                               box=None, horizon=None):
    """The Born kernel's walk of the chunks as torch ops: (raw [NP], Q, dQ
    [S, NHP, 32] in the chunk layout, zero past ncols)."""
    sp = SplineArgs(hids_perm, type_rows, type_cols, yval, y2val, n, horizon)
    q, dq, _, (_, cj, live, *_) = _chunk_spline(chunks, pos_pad, pos_hpad,
                                                sp, box)
    s_cols = torch.where(live, s_hpad[cj], 0.0)
    return torch.sum(q * s_cols, dim=1).reshape(-1), q, dq


def descreening_chunks_reference(chunks, pos_pad, pos_hpad, s_hpad, brw_pad,
                                 bru_pad, qd, box=None, spline=None):
    """The descreening kernel's walk of the chunks as torch ops: qd the
    (Q, dQ) in the chunk layout (born_sums_chunks_reference's, or the
    kernel's), reloaded with only d > 0 guarded as the kernel does, or
    None to recompute the spline from spline=SplineArgs(...).  Same
    results as descreening."""
    if qd is None:
        q, dq, mask, geom = _chunk_spline(chunks, pos_pad, pos_hpad,
                                          need_spline(spline), box)
        rows, cj, live, dx, dy, dz, d = geom
    else:
        rows, cj, live, dx, dy, dz, d = _chunk_geom(chunks, pos_pad,
                                                    pos_hpad, box)
        q, dq = qd[:2]
        mask = d > 0.0
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    # [S, 32 rows, NHP slots] for _descreen_sums
    t = (lambda x: x.transpose(1, 2))
    w, u, f_rows, f_cols = _descreen_sums(
        t(dx), t(dy), t(dz), t(d), t(mask & live), t(q), t(dq),
        torch.where(live[:, :, 0], s_hpad[cj[:, :, 0]], 0.0),
        brw_pad[rows[:, 0]], bru_pad[rows[:, 0]])
    ids = cj.reshape(-1)
    keep = live.reshape(-1)

    def to_cols(x):
        x = x.reshape((ids.shape[0],) + tuple(x.shape[2:]))
        x = torch.where(keep.reshape((-1,) + (1,) * (x.dim() - 1)), x, 0.0)
        return x.new_zeros((nhpad,) + tuple(x.shape[1:])).index_add_(0, ids, x)

    return to_cols(w), to_cols(u), f_rows.reshape(npad, 3), to_cols(f_cols)


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


def _stack(outs):
    """Stack the per-replica results of unbatched calls (tensors, tuples,
    NamedTuples and dicts of them, None) on a new leading axis."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    items = [_stack([o[i] for o in outs]) for i in range(len(first))]
    return type(first)(*items) if hasattr(first, "_fields") else tuple(items)


def _nested(x, f):
    """f applied to every tensor of x (a tensor, a tuple or NamedTuple of
    them, or None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return f(x)
    items = [_nested(v, f) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def per_replica(fn, nb: int, batched: dict, **shared):
    """Run an unbatched function once per replica: batched holds the
    keyword arguments with a leading [nb] axis, shared those every replica
    takes whole; the results are stacked.  How the twins take a replica
    axis."""
    return _stack([fn(**{k: _nested(v, lambda t: t[b])
                         for k, v in batched.items()}, **shared)
                   for b in range(nb)])


def _lead(x):
    """An unbatched argument as a batch of one (None stays None)."""
    return _nested(x, lambda t: t[None])


def _unlead(x):
    """The one replica of a batch of one."""
    return _nested(x, lambda t: t[0])


def _launch_check(name, rc):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _cuda_lib():
    from ...runtime.build import load_library

    return load_library()


def chunk_warps(nhpad: int) -> int:
    """The warps G of a dense chunk sweep's block (one 32-row sub-tile, its
    chunks dealt round-robin to the warps): MAX_CHUNK_WARPS, or the largest
    power of two up to the chunks a sub-tile can have.  Each warp's walk is
    a chain of dependent loads and spline steps, so the sweeps run fastest
    with the most warps a block (measured on an H100 at 1li2's and 2clr's
    shapes, profile_port_step.py --list-kernels).  It depends on the shape
    alone, so a model's sums keep one order on any card."""
    g = 1
    while 2 * g <= min(MAX_CHUNK_WARPS, nhpad // SUB):
        g *= 2
    return g


def chunk_parts(nhpad: int) -> int:
    """The blocks P a dense descreening sweep splits each sub-tile's chunks
    over (chunk c to block c // G mod P): as many as a sub-tile's most
    chunks, NHP / 32, fill at chunk_warps(nhpad) warps a block, at most
    MAX_CHUNK_PARTS, so that no warp walks more chunks than it must (the
    walk is the time); the row forces then add over the P blocks in a
    second pass.  It depends on the shape alone."""
    g = chunk_warps(nhpad)
    return max(1, min(MAX_CHUNK_PARTS, (nhpad // SUB + g - 1) // g))


def _check_chunks(chunks, nb, npad, nhpad, dev):
    if not isinstance(chunks, Chunks):
        raise TypeError(f"chunks: expected Chunks, got "
                        f"{type(chunks).__name__}")
    nsub = npad // SUB
    _check("chunks.cols", chunks.cols, torch.int32, (nb, nsub, nhpad), dev)
    _check("chunks.ncols", chunks.ncols, torch.int32, (nb, nsub), dev)
    _check("chunks.bits", chunks.bits, torch.int32, (nb, nsub, nhpad // SUB),
           dev)


def _replicas(pos_pad):
    """(B, batched): the replica count of positions [B, 3, NP], or 1 for
    an unbatched [3, NP]."""
    if pos_pad.dim() == 3:
        if not 1 <= pos_pad.shape[0] <= 65535:
            raise ValueError(f"{pos_pad.shape[0]} replicas: 1 to 65535")
        return pos_pad.shape[0], True
    return 1, False


def _check_pads(npad, nhpad):
    if npad % SUB or nhpad % SUB or npad < SUB or nhpad < SUB:
        raise ValueError(f"padded extents {npad}, {nhpad}: multiples of "
                         f"{SUB}")


def subtile_columns(pos_pad, pos_hpad, hids_perm, n, box=None, horizon=None):
    """The chunk list of the dense Born and descreening sweeps (Chunks):
    for each 32-row sub-tile a of pos_pad [3, NP], the heavy columns j of
    pos_hpad [3, NHP] with hids_perm[j] >= 0 and |x_j - c_a| - r_a <
    min(horizon, 2 nm) + CHUNK_MARGIN, c_a and r_a the center and half
    diagonal of the box of a's rows below n (with a box, to the nearest
    image of c_a: for a triclinic box the least of the 27 images one
    lattice step around the wrapped one); none for a sub-tile without such
    rows.  Every pair the Born mask
    accepts is listed.  The kernel writes every entry; it equals the twin
    bit for bit.  Batched positions [B, 3, NP] / [B, 3, NHP] give one list
    per replica, Chunks with a leading [B] axis."""
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        if batched:
            return per_replica(subtile_columns_reference, nb,
                               dict(pos_pad=pos_pad, pos_hpad=pos_hpad),
                               hids_perm=hids_perm, n=n, box=box,
                               horizon=horizon)
        return subtile_columns_reference(pos_pad, pos_hpad, hids_perm, n,
                                         box=box, horizon=horizon)
    if not batched:
        return _unlead(_subtile_columns_cuda(pos_pad[None], pos_hpad[None],
                                             hids_perm, n, box, horizon))
    return _subtile_columns_cuda(pos_pad, pos_hpad, hids_perm, n, box, horizon)


def _subtile_columns_cuda(pos_pad, pos_hpad, hids_perm, n, box, horizon):
    """subtile_columns' launch on a batch of CUDA tensors (a leading [B]
    axis); an unbatched call takes it as a batch of one."""
    nb, _ = _replicas(pos_pad)
    dev = pos_pad.device
    npad, nhpad = pos_pad.shape[2], pos_hpad.shape[2]
    _check_pads(npad, nhpad)
    _check("pos_pad", pos_pad, torch.float32, (nb, 3, npad), dev)
    _check("pos_hpad", pos_hpad, torch.float32, (nb, 3, nhpad), dev)
    _check("hids_perm", hids_perm, torch.int32, (nhpad,), dev)
    box_mode, box_t = _box_arg(box, dev)
    nsub = npad // SUB
    cols = torch.empty((nb, nsub, nhpad), dtype=torch.int32, device=dev)
    ncols = torch.empty((nb, nsub), dtype=torch.int32, device=dev)
    bits = torch.empty((nb, nsub, nhpad // SUB), dtype=torch.int32,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_subtile_columns(
        nb, pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad,
        hids_perm.data_ptr(), int(n), _chunk_lim(horizon), box_mode,
        _ptr(box_t), cols.data_ptr(), ncols.data_ptr(), bits.data_ptr(),
        stream)
    _launch_check("subtile_columns", rc)
    LAUNCHES["subtile_columns"] += 1
    return Chunks(cols, ncols, bits)


def born_sums(pos_pad, pos_hpad, hids_perm, type_rows, type_cols, yval,
              y2val, s_hpad, n, box=None, horizon=None, save_qd=False,
              chunks=None, qd_out=None):
    """raw_i = sum_j s_j Q4(d_ij) with the screener (column) axis packed to
    heavy atoms only (hydrogens never screen, reference
    AGBNPUtils.cpp:168-171).

    pos_pad [3, NP] (screened rows); pos_hpad [3, NHP] (heavy screeners);
    hids_perm [NHP] int32 permuted-row id of each packed column (-1
    padding), for the self-pair test; type_rows [NP] / type_cols [NHP] int32
    radius types; yval/y2val [Ti, Tj, NA]; s_hpad [NHP].  Pairs count within
    min(horizon, 2 nm).  Mirrors inverseBornRadii (reference
    AGBNPBornRadii.cl:181-490; CPU loop ReferenceAGBNPKernels.cpp:437-454).

    The twin (CPU tensors) returns raw, or with save_qd (raw, Q, dQ), the
    masked Q and dQ/dd [NP, NHP] that descreening reloads.  The kernel
    walks the chunks of subtile_columns: chunks, that list at this
    horizon, box and positions, or when None the list it builds itself in
    the same launch, equal to subtile_columns' bit for bit.  With save_qd
    it returns (raw, Q, dQ, chunks), Q/dQ in the chunk layout [NP / 32,
    NHP, 32] (chunk_layout of the twin's) on the slots chunk_slots names
    and undefined elsewhere; hand the whole tuple to descreening as qd, so
    the reload reads nothing else.  qd_out: optional (Q, dQ) buffers the
    kernel writes into.  Batched: pos_pad [B, 3, NP], pos_hpad [B, 3,
    NHP], s_hpad [B, NHP], chunks and qd_out with a leading [B] axis, and
    so are the results.
    """
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        if batched:
            return per_replica(
                born_sums_reference, nb,
                dict(pos_pad=pos_pad, pos_hpad=pos_hpad, s_hpad=s_hpad),
                hids_perm=hids_perm, type_rows=type_rows,
                type_cols=type_cols, yval=yval, y2val=y2val, n=n, box=box,
                horizon=horizon, save_qd=save_qd)
        return born_sums_reference(pos_pad, pos_hpad, hids_perm, type_rows,
                                   type_cols, yval, y2val, s_hpad, n, box=box,
                                   horizon=horizon, save_qd=save_qd)
    if not batched:
        return _unlead(_born_sums_cuda(
            pos_pad[None], pos_hpad[None], hids_perm, type_rows, type_cols,
            yval, y2val, s_hpad[None], n, box=box, horizon=horizon,
            save_qd=save_qd, chunks=_lead(chunks), qd_out=_lead(qd_out)))
    return _born_sums_cuda(pos_pad, pos_hpad, hids_perm, type_rows, type_cols,
                           yval, y2val, s_hpad, n, box=box, horizon=horizon,
                           save_qd=save_qd, chunks=chunks, qd_out=qd_out)


def _born_sums_cuda(pos_pad, pos_hpad, hids_perm, type_rows, type_cols, yval,
                    y2val, s_hpad, n, box, horizon, save_qd, chunks, qd_out):
    """born_sums' launch on a batch of CUDA tensors (a leading [B] axis);
    an unbatched call takes it as a batch of one."""
    nb, _ = _replicas(pos_pad)
    dev = pos_pad.device
    f32, i32 = torch.float32, torch.int32
    npad, nhpad = pos_pad.shape[2], pos_hpad.shape[2]
    nti, ntj = yval.shape[0], yval.shape[1]
    _check_pads(npad, nhpad)
    _check("pos_pad", pos_pad, f32, (nb, 3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (nb, 3, nhpad), dev)
    _check("hids_perm", hids_perm, i32, (nhpad,), dev)
    _check("type_rows", type_rows, i32, (npad,), dev)
    _check("type_cols", type_cols, i32, (nhpad,), dev)
    _check("yval", yval, f32, (nti, ntj, _NA), dev)
    _check("y2val", y2val, f32, (nti, ntj, _NA), dev)
    _check("s_hpad", s_hpad, f32, (nb, nhpad), dev)
    nsub = npad // SUB
    build = chunks is None
    if build:
        chunks = Chunks(
            torch.empty((nb, nsub, nhpad), dtype=i32, device=dev),
            torch.empty((nb, nsub), dtype=i32, device=dev),
            torch.empty((nb, nsub, nhpad // SUB), dtype=i32, device=dev))
    _check_chunks(chunks, nb, npad, nhpad, dev)
    box_mode, box_t = _box_arg(box, dev)
    raw = torch.empty((nb, npad), dtype=f32, device=dev)
    q = dq = None
    if save_qd:
        shape = (nb, nsub, nhpad, SUB)
        if qd_out is None:
            q = torch.empty(shape, dtype=f32, device=dev)
            dq = torch.empty(shape, dtype=f32, device=dev)
        else:
            q, dq = qd_out
            _check("Q", q, f32, shape, dev)
            _check("dQ", dq, f32, shape, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_born_sums(
        nb, pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad,
        hids_perm.data_ptr(), type_rows.data_ptr(), type_cols.data_ptr(),
        yval.data_ptr(), y2val.data_ptr(), nti, ntj, s_hpad.data_ptr(),
        int(n), _horizon(horizon), box_mode, _ptr(box_t),
        _chunk_lim(horizon), int(build), chunks.cols.data_ptr(),
        chunks.ncols.data_ptr(), chunks.bits.data_ptr(), chunk_warps(nhpad),
        raw.data_ptr(), _ptr(q), _ptr(dq), stream)
    _launch_check("born_sums", rc)
    LAUNCHES["born_sums"] += 1
    if save_qd:
        return raw, q, dq, chunks
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
    Its scratch takes 1.5 T^2 bytes for every tile pair (96 KB at T 256)
    and replica.  Batched: pos_pad [B, 3, NP] and born_pad [B, NP] (the
    charges, LJ parameters and exclusion rows are shared), results [B,
    ...]; the replicas share the list.
    """
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        kw = dict(charge_pad=charge_pad, n=n, box=box, cutoff=cutoff,
                  sig_pad=sig_pad, epsq_pad=epsq_pad,
                  excl_rows_pad=excl_rows_pad)
        if batched:
            return per_replica(gb_pair_reference, nb,
                               dict(pos_pad=pos_pad, born_pad=born_pad), **kw)
        return gb_pair_reference(pos_pad, born_pad=born_pad, **kw)
    from .tiles import _gb_subtiles, triangular_grid_list

    npad = pos_pad.shape[-1]
    tile = _grid_tile(npad)
    tl, nv = triangular_grid_list(npad // tile, pos_pad.device)
    out = _gb_subtiles("gb_pair", nv, tl, tile, pos_pad, charge_pad,
                       born_pad, n, box, cutoff, sig_pad, epsq_pad,
                       excl_rows_pad, shared_list=True)
    LAUNCHES["gb_pair"] += 1
    return out


def _grid_tile(npad):
    """The tile pick_tile gives the dense layout of padded extent npad,
    which it must divide."""
    tile = pick_tile(npad)
    if npad % tile:
        raise ValueError(f"padded extent {npad} is not a multiple of the "
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
                spline=None, chunks=None):
    """Descreening derivative sweep (reference
    ReferenceAGBNPKernels.cpp:555-586, VdWGBDerBorn
    AGBNPBornRadii.cl:872-1280) over the heavy-packed screener columns.

    With qd = born_sums(save_qd=True)[1:] it reloads the saved Q/dQ; with
    qd=None it re-evaluates the Born sweep's masked spline from
    spline=SplineArgs(...) (the JAX package's _descreen_kernel, for when
    Q/dQ would exceed the memory budget or sharing is off).

    On the CPU qd is the twin's dense (Q, dQ) [NP, NHP] and chunks is not
    read.  On the card qd must be the kernel's (Q, dQ, chunks): the reload
    walks exactly the chunks the Born kernel wrote; the recompute walks
    chunks (subtile_columns at the spline's horizon; built here when
    None).

    Returns (W [NHP], U [NHP], force_rows [NP, 3], force_cols [NHP, 3]);
    the column-side quantities are in packed heavy layout.  Batched: every
    argument but the spline with a leading [B] axis (positions [B, 3, ...],
    qd and chunks from a batched born_sums), and so are the results.
    """
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        if batched:
            return per_replica(
                descreening_reference, nb,
                dict(pos_pad=pos_pad, pos_hpad=pos_hpad, s_hpad=s_hpad,
                     brw_pad=brw_pad, bru_pad=bru_pad, qd=qd),
                box=box, spline=spline)
        return descreening_reference(pos_pad, pos_hpad, s_hpad, brw_pad,
                                     bru_pad, qd, box=box, spline=spline)
    if not batched:
        return _unlead(_descreening_cuda(
            pos_pad[None], pos_hpad[None], s_hpad[None], brw_pad[None],
            bru_pad[None], _lead(qd), box=box, spline=spline,
            chunks=_lead(chunks)))
    return _descreening_cuda(pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad, qd,
                             box=box, spline=spline, chunks=chunks)


def _descreening_cuda(pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad, qd, box,
                      spline, chunks):
    """descreening's launch on a batch of CUDA tensors (a leading [B] axis);
    an unbatched call takes it as a batch of one."""
    nb, _ = _replicas(pos_pad)
    dev = pos_pad.device
    f32 = torch.float32
    npad, nhpad = pos_pad.shape[2], pos_hpad.shape[2]
    _check_pads(npad, nhpad)
    _check("pos_pad", pos_pad, f32, (nb, 3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (nb, 3, nhpad), dev)
    _check("s_hpad", s_hpad, f32, (nb, nhpad), dev)
    _check("brw_pad", brw_pad, f32, (nb, npad), dev)
    _check("bru_pad", bru_pad, f32, (nb, npad), dev)
    q = dq = None
    if qd is not None:
        if len(qd) != 3:
            raise ValueError("qd: on a CUDA device, the (Q, dQ, chunks) "
                             "that born_sums(save_qd=True) returns")
        q, dq, chunks = qd
        shape = (nb, npad // SUB, nhpad, SUB)
        _check("Q", q, f32, shape, dev)
        _check("dQ", dq, f32, shape, dev)
        for what, x in (("Q", q), ("dQ", dq)):
            if x.data_ptr() % 16:
                raise ValueError(f"{what}: data not 16-byte aligned")
        sp_args = (None,) * 5 + (0, 0, 0, 0.0)
    else:
        _check_spline(spline, npad, nhpad, dev)
        sp_args = _spline_ptrs(spline)
        if chunks is None:
            chunks = subtile_columns(pos_pad, pos_hpad, spline.hids_perm,
                                     spline.n, box=box,
                                     horizon=spline.horizon)
    _check_chunks(chunks, nb, npad, nhpad, dev)
    box_mode, box_t = _box_arg(box, dev)
    pcol = torch.empty((nb, npad // SUB, 5, nhpad), dtype=f32, device=dev)
    parts = chunk_parts(nhpad)
    f_part = (torch.empty((nb, parts, npad, 3), dtype=f32, device=dev)
              if parts > 1 else None)
    w = torch.empty((nb, nhpad), dtype=f32, device=dev)
    u = torch.empty((nb, nhpad), dtype=f32, device=dev)
    f_rows = torch.empty((nb, npad, 3), dtype=f32, device=dev)
    f_cols = torch.empty((nb, nhpad, 3), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_descreening(
        nb, pos_pad.data_ptr(), npad, pos_hpad.data_ptr(), nhpad, _ptr(q),
        _ptr(dq), s_hpad.data_ptr(), brw_pad.data_ptr(), bru_pad.data_ptr(),
        box_mode, _ptr(box_t), *sp_args, chunks.cols.data_ptr(),
        chunks.ncols.data_ptr(), chunks.bits.data_ptr(),
        chunk_warps(nhpad), parts, pcol.data_ptr(), _ptr(f_part),
        w.data_ptr(), u.data_ptr(), f_rows.data_ptr(), f_cols.data_ptr(),
        stream)
    _launch_check("descreening", rc)
    LAUNCHES["descreening" if qd is not None
             else "descreening_recompute"] += 1
    return w, u, f_rows, f_cols
