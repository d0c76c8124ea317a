"""Interacting-tile lists and the three pair sweeps over them: CUDA kernels
and their plain PyTorch twins.

Counterpart of the tile-list half of the JAX package's Pallas kernels
(openmm_agbnp_plugin_tpu/ops/pallas/pairs.py:230-346 and 760-1125).  Per
evaluation, each [tile] block of Morton-permuted rows and of heavy-packed
screener columns is bounded by its AABB; tile pairs whose AABB lower
distance bound is inside the interaction range are compacted into an
i-major (ti; tj) list of static length lmax (the budget), and the sweeps
visit the list instead of the whole tile grid.  The in-range count stays on
the device and rides the diagnostics, so the PanicButton regrows the budget
when it overflows (the reference's neighbor-tile rebind,
OpenCLAGBNPKernels.cpp:3521-3530).

  tile_bounds, build_tile_list   torch ops on the device
  triangular_grid_list           every tile pair ti <= tj of a square grid
                                 (the dense GB sweep runs the list kernel
                                 over it)
  host_tile_count                numpy, for sizing the budget at model init
  born_sums_tiles                born_sums over the list, optionally saving
                                 per-entry [lmax, T, T] Q/dQ tiles
  gb_pair_tiles                  gb_pair over the triangular list
  descreening_tiles              descreening over the Born list, reloading
                                 the saved tiles or (qd=None) recomputing
  subtile_live, exclusion_bits   torch mirrors of what the list kernels
                                 decide inside: which 32x32 sub-tile pairs
                                 of an entry they visit, and the per-row
                                 exclusion bit masks
  keep_flags                     the Born kernel's keep bits as the same
                                 sub-tile flags
  column_groups                  how the Born and descreening kernels split
                                 their work units

The sweeps take the same arguments as their dense counterparts in pairs.py
with (nv, tl) in front and the tile size after n, and return the same
results.  Each wrapper runs its plain twin on CPU tensors and its kernel
from csrc/tiles.cu on CUDA tensors, counted in pairs.LAUNCHES.

Replicas, as in pairs.py: positions [B, 3, ...] make tile_bounds and
build_tile_list work per replica (tl [B, 2, lmax], nv [B, 1], count [B];
one budget lmax for all), and the sweeps take those lists with every
per-replica array batched; one launch serves the batch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...models.constants import DIELECTRIC_FACTOR
from ..born import min_image
from .pairs import (KE, LAUNCHES, _born_qdq, _box_arg, _check, _check_spline,
                    _cuda_lib, _descreen_sums, _horizon, _launch_check,
                    _lead, _NA, _pair_geom, _ptr, _replicas, _spline_ptrs,
                    _unlead, need_spline, per_replica)

SUB = 32              # sub-tile edge of the GB and descreening list kernels
# nm added to a list's range before the kernels drop a sub-tile pair: far
# above the f32 rounding of the boxes and of the pair distances (a few ulp
# of the coordinates; ulp(100 nm) = 7.6e-6 nm), so no pair that a sweep's
# own mask accepts is dropped (csrc/tiles.cu SUBTILE_MARGIN)
SUBTILE_MARGIN = 1e-3
# warps for each SM that the Born and descreening list kernels aim for (an
# H100 at 1li2's and 2clr's list shapes: held to 16 resident warps an SM by
# its registers, the descreening sweep runs fastest at about two warps of
# work a slot); the GB sweep always runs one warp per sub-tile pair, its
# fastest split there
DS_WARPS_PER_SM = 32


# ---------------------------------------------------------------------------
# The lists
# ---------------------------------------------------------------------------

def tile_bounds(pos_pad, valid, tile: int):
    """Per-tile AABB (center [3, NT], half-diagonal radius [NT]) of the
    valid atoms in each contiguous block of `tile` packed columns.  Empty
    tiles get radius -1e30 so every distance test excludes them.  Leading
    replica axes of pos_pad (and of valid, when it has them) carry
    through: [B, 3, NP] gives [B, 3, NT] and [B, NT]."""
    nt = pos_pad.shape[-1] // tile
    p = pos_pad.reshape(pos_pad.shape[:-1] + (nt, tile))
    v = valid.reshape(valid.shape[:-1] + (1, nt, tile))
    big = 1e30
    lo = torch.amin(torch.where(v, p, big), dim=-1)
    hi = torch.amax(torch.where(v, p, -big), dim=-1)
    has = torch.any(v, dim=-1)
    lo = torch.where(has, lo, 0.0)
    hi = torch.where(has, hi, 0.0)
    center = 0.5 * (lo + hi)
    rad = torch.where(has[..., 0, :],
                      0.5 * torch.sqrt(torch.sum((hi - lo) ** 2, dim=-2)),
                      -big)
    return center, rad


def build_tile_list(ci, ri, cj, rj, rng_dist: float, lmax: int,
                    triangular: bool = False, box=None):
    """Compact the in-range tile pairs into an i-major list, on the device.

    ci/ri, cj/rj: tile_bounds of the row and column packings.  A tile pair
    survives iff |c_i - c_j| - r_i - r_j (min-image on centers when box is
    given) is < rng_dist; conservative, it never drops a pair the sweeps'
    own masks would accept.  With triangular, only tj >= ti pairs are
    listed (the GB sweep's unordered pairs).

    Returns (tl [2, lmax] int32 (ti; tj), nv [1] int32 = min(count, lmax),
    count [] int32).  Entries past nv are (0; 0).  count > lmax means the
    budget overflowed; nothing here reads it on the host.  With a leading
    replica axis on the bounds (tile_bounds of [B, 3, NP] positions), each
    replica gets its own list: tl [B, 2, lmax], nv [B, 1], count [B].
    """
    nti, ntj = ri.shape[-1], rj.shape[-1]
    dev = ri.device
    lead = ri.shape[:-1]
    dc = (ci.transpose(-1, -2)[..., :, None, :]
          - cj.transpose(-1, -2)[..., None, :, :])
    if box is not None:
        dc = min_image(dc, box)
    dmin = (torch.sqrt(torch.sum(dc * dc, dim=-1)) - ri[..., :, None]
            - rj[..., None, :])
    ok = dmin < rng_dist
    if triangular:
        ok = ok & (torch.arange(ntj, device=dev)[None, :]
                   >= torch.arange(nti, device=dev)[:, None])
    ntot = nti * ntj
    ok = ok.reshape(lead + (ntot,))
    key = torch.where(ok, torch.arange(ntot, dtype=torch.int32, device=dev),
                      ntot)
    if ntot < lmax:
        key = F.pad(key, (0, lmax - ntot), value=ntot)
    order = torch.sort(key, dim=-1, stable=True).values[..., :lmax]
    count = torch.sum(ok, dim=-1).to(torch.int32)
    order = torch.where(order < ntot, order, 0)
    tl = torch.stack([order // ntj, order % ntj], dim=-2).to(
        torch.int32).contiguous()
    return tl, torch.clamp(count, max=lmax)[..., None], count


@functools.lru_cache(maxsize=None)
def triangular_grid_list(ntiles: int, device):
    """Every tile pair ti <= tj of a square dense grid, i-major, as a GB
    list: (tl [2, L] int32, nv [1] int32 = L), L = ntiles (ntiles + 1) / 2.
    Built once per shape and device."""
    ti, tj = torch.triu_indices(ntiles, ntiles, device=device)
    tl = torch.stack([ti, tj]).to(torch.int32).contiguous()
    return tl, torch.full((1,), tl.shape[1], dtype=torch.int32,
                          device=device)


def host_tile_count(pos_row, valid_row, pos_col, valid_col, tile: int,
                    rng_dist: float, triangular: bool = False,
                    box=None) -> int:
    """NumPy twin of build_tile_list's count, for sizing the static budget
    from the initial configuration at model init."""

    def bounds(p, v):
        nt = p.shape[1] // tile
        pp = p.reshape(3, nt, tile)
        vv = v.reshape(1, nt, tile)
        lo = np.min(np.where(vv, pp, 1e30), axis=2)
        hi = np.max(np.where(vv, pp, -1e30), axis=2)
        has = np.any(vv[0], axis=1)
        lo = np.where(has[None], lo, 0.0)
        hi = np.where(has[None], hi, 0.0)
        c = 0.5 * (lo + hi)
        r = np.where(has, 0.5 * np.sqrt(((hi - lo) ** 2).sum(0)), -1e30)
        return c, r

    ci, ri = bounds(np.asarray(pos_row, np.float64), np.asarray(valid_row))
    cj, rj = bounds(np.asarray(pos_col, np.float64), np.asarray(valid_col))
    dc = ci.T[:, None, :] - cj.T[None, :, :]
    if box is not None:
        b = np.asarray(box, np.float64).reshape(-1, 3)
        if b.shape[0] == 1:
            b = b[0]
            dc = dc - b * np.round(dc / b)
        else:
            a_, b_, c_ = b
            dc = dc - np.round(dc[..., 2:3] / c_[2]) * c_
            dc = dc - np.round(dc[..., 1:2] / b_[1]) * b_
            dc = dc - np.round(dc[..., 0:1] / a_[0]) * a_
    dmin = np.sqrt((dc ** 2).sum(-1)) - ri[:, None] - rj[None, :]
    ok = dmin < rng_dist
    if triangular:
        ok &= (np.arange(rj.shape[0])[None, :]
               >= np.arange(ri.shape[0])[:, None])
    return int(ok.sum())


def subtile_live(nv, tl, pos_r, valid_r, pos_c, valid_c, tile: int,
                 rng_dist, box=None, triangular: bool = False):
    """Which 32x32 sub-tile pairs of each list entry the list kernels
    visit: [lmax, S, S] bool (S = tile // 32), True where entry l (l < nv)
    pairs its row sub-tile a with its column sub-tile b.

    The torch mirror of the kernels' in-warp test: the 32-atom boxes of
    tile_bounds(pos, valid, 32), and the list's own rule with a margin,
    |c_a - c_b| - r_a - r_b < rng_dist + SUBTILE_MARGIN (min-image on the
    centers when box is given).  rng_dist is the range the list was built
    with (None: no range).  A sub-tile without a valid atom is never
    visited; with triangular (the GB list) neither is a column sub-tile
    before the row sub-tile, which holds no pair with gi < gj."""
    s = tile // SUB
    cr, rr = tile_bounds(pos_r, valid_r, SUB)
    cc, rc = tile_bounds(pos_c, valid_c, SUB)
    sub = torch.arange(s, device=tl.device)
    gi = tl[0].long()[:, None] * s + sub
    gj = tl[1].long()[:, None] * s + sub
    dc = (cc.T[gj][:, None, :, :] - cr.T[gi][:, :, None, :])
    if box is not None:
        dc = min_image(dc, box)
    dist = torch.sqrt(torch.sum(dc * dc, dim=-1))
    live = (rr[gi] >= 0)[:, :, None] & (rc[gj] >= 0)[:, None, :]
    if rng_dist is not None:
        live = live & (dist - rr[gi][:, :, None] - rc[gj][:, None, :]
                       < float(rng_dist) + SUBTILE_MARGIN)
    if triangular:
        live = live & (gj[:, None, :] >= gi[:, :, None])
    entries = torch.arange(tl.shape[1], device=tl.device) < nv[0]
    return live & entries[:, None, None]


def keep_flags(keep, nv):
    """The keep bits a list kernel writes, keep [lmax, S, ng] int32 with
    bit b of keep[l, a, g] set where it visited sub-tile pair (a, b), as
    subtile_live's [lmax, S, S] flags.  Bits of entries past nv are
    undefined and read as False."""
    lmax, s, _ = keep.shape
    # each column group sets bits of its own sub-tiles only: the sum is an or
    bits = torch.sum(keep.long(), dim=2)
    b = torch.arange(s, device=keep.device)
    flags = ((bits[:, :, None] >> b) & 1).bool()
    entries = torch.arange(lmax, device=keep.device) < nv[0]
    return flags & entries[:, None, None]


def exclusion_bits(excl_rows_pad, tl, tile: int):
    """The GB kernel's exclusion masks: [lmax, T, S] int64 whose bit c of
    (entry l, row r, column sub-tile b) is set iff row ti T + r lists
    column tj T + 32 b + c in its E-wide exclusion row (-1 padded)."""
    s = tile // SUB
    rows = tl[0].long()[:, None] * tile + torch.arange(tile, device=tl.device)
    off = excl_rows_pad.long()[rows] - (tl[1].long() * tile)[:, None, None]
    inside = (off >= 0) & (off < tile)
    off = torch.where(inside, off, 0)
    bits = torch.zeros(rows.shape + (s,), dtype=torch.int64,
                       device=tl.device)
    for e in range(off.shape[2]):
        o = off[:, :, e:e + 1]
        one = torch.where(inside[:, :, e:e + 1],
                          torch.bitwise_left_shift(torch.ones_like(o),
                                                   o % SUB), 0)
        bits = bits | torch.zeros_like(bits).scatter_(2, o // SUB, one)
    return bits


def _expand_subtiles(keep):
    """[L, S, S] sub-tile flags as [L, T, T] pair flags."""
    return keep.repeat_interleave(SUB, 1).repeat_interleave(SUB, 2)


# ---------------------------------------------------------------------------
# Plain twins: every list entry as one [T, T] block of a batched sweep
# ---------------------------------------------------------------------------

def _entries(nv, tl, tile):
    """Global row and column ids [L, T] of each entry, and which entries
    are valid (l < nv) as [L, 1, 1]."""
    r = torch.arange(tile, device=tl.device)
    rows = tl[0].long()[:, None] * tile + r
    cols = tl[1].long()[:, None] * tile + r
    live = torch.arange(tl.shape[1], device=tl.device) < nv[0]
    return rows, cols, live[:, None, None]


def _tile_sum(x, ids, size):
    """Add the per-entry sums x [L, T(, 3)] into a zero [size(, 3)] at
    ids [L, T]."""
    out = x.new_zeros((size,) + tuple(x.shape[2:]))
    return out.index_add_(0, ids.reshape(-1), x.reshape((-1,) + out.shape[1:]))


def born_sums_tiles_reference(nv, tl, pos_pad, pos_hpad, hids_perm,
                              type_rows, type_cols, yval, y2val, s_hpad, n,
                              tile, box=None, horizon=None, save_qd=False,
                              keep=None):
    """Plain twin of born_sums_tiles (same arguments; Q/dQ written in full,
    no keep bits).  keep: optional [lmax, S, S] sub-tile flags
    (subtile_live) outside which pairs add nothing and Q/dQ are zero."""
    rows, cols, live = _entries(nv, tl, tile)
    _, _, _, d2 = _pair_geom(pos_pad[:, rows], pos_hpad[:, cols], box)
    d = torch.sqrt(d2)
    q, dq, mask = _born_qdq(d, rows[:, :, None],
                            hids_perm.long()[cols][:, None, :], n, horizon,
                            type_rows.long()[rows][:, :, None],
                            type_cols.long()[cols][:, None, :], yval, y2val)
    if keep is not None:
        live = live & _expand_subtiles(keep)
    q = torch.where(live, q, 0.0)
    dq = torch.where(live, dq, 0.0)
    raw = _tile_sum(torch.sum(q * s_hpad[cols][:, None, :], dim=2), rows,
                    pos_pad.shape[1])
    if save_qd:
        return raw, q, dq
    return raw


def gb_pair_tiles_reference(nv, tl, pos_pad, charge_pad, born_pad, n, tile,
                            box=None, cutoff=None, sig_pad=None,
                            epsq_pad=None, excl_rows_pad=None, keep=None):
    """Plain twin of gb_pair_tiles: each entry's pairs deposited on both
    its row and its column tile.  keep: optional [lmax, S, S] sub-tile
    flags (subtile_live) outside which pairs add nothing, as in the
    kernel."""
    npad = pos_pad.shape[1]
    dt = pos_pad.dtype
    rows, cols, live = _entries(nv, tl, tile)
    dx, dy, dz, d2 = _pair_geom(pos_pad[:, rows], pos_pad[:, cols], box)
    gi, gj = rows[:, :, None], cols[:, None, :]
    mask = (gi < gj) & (gj < n) & live
    if keep is not None:
        mask = mask & _expand_subtiles(keep)
    if cutoff is not None:
        mask = mask & (d2 < cutoff * cutoff)
    fm = mask.to(dt)
    bb = born_pad[rows][:, :, None] * born_pad[cols][:, None, :]
    bb_safe = torch.where(mask, bb, 1.0)
    etij = torch.exp(-0.25 * torch.where(mask, d2, 0.0) / bb_safe)
    fgb = fm / torch.sqrt(torch.where(mask, d2 + bb * etij, 1.0))
    qq_f = charge_pad[rows][:, :, None] * charge_pad[cols][:, None, :]
    qq = DIELECTRIC_FACTOR * qq_f
    epair = qq * fgb
    fgb3 = fgb * fgb * fgb
    mw = -2.0 * qq * (1.0 - 0.25 * etij) * fgb3
    ypair = qq_f * (bb + 0.25 * d2) * etij * fgb3
    mmpair = None
    if sig_pad is not None:
        ex = excl_rows_pad.long()[rows]
        excluded = torch.zeros_like(mask)
        for e in range(ex.shape[2]):
            excluded = excluded | (ex[:, :, e:e + 1] == gj)
        fmm = fm * (~excluded).to(dt)
        d2s = torch.where(mask, d2, 1.0)
        inv2 = fmm / d2s
        sr2 = (sig_pad[rows][:, :, None] * sig_pad[cols][:, None, :]) * inv2
        sr6 = sr2 * sr2 * sr2
        epsij = epsq_pad[rows][:, :, None] * epsq_pad[cols][:, None, :]
        ecoul = KE * qq_f * (fmm / torch.sqrt(d2s))
        mmpair = 4.0 * epsij * (sr6 * sr6 - sr6) + ecoul
        dmm = (4.0 * epsij * (-6.0 * sr6 * sr6 + 3.0 * sr6)
               - 0.5 * ecoul) * inv2
        mw = mw + 2.0 * dmm
    c = torch.stack([dx * mw, dy * mw, dz * mw], dim=-1)

    def both(x, sign=1.0):
        return (_tile_sum(torch.sum(x, dim=2), rows, npad)
                + sign * _tile_sum(torch.sum(x, dim=1), cols, npad))

    mmrow = None if mmpair is None else both(mmpair)
    return both(epair), both(ypair), both(c, -1.0), mmrow


def descreening_tiles_reference(nv, tl, pos_pad, pos_hpad, s_hpad, brw_pad,
                                bru_pad, qd, tile, box=None, spline=None,
                                keep=None):
    """Plain twin of descreening_tiles (same arguments and results; keep
    bits in qd are not needed).  keep: optional [lmax, S, S] sub-tile flags
    (subtile_live) outside which pairs add nothing, as in the kernel."""
    rows, cols, live = _entries(nv, tl, tile)
    dx, dy, dz, d2 = _pair_geom(pos_pad[:, rows], pos_hpad[:, cols], box)
    d = torch.sqrt(d2)
    if qd is None:
        sp = need_spline(spline)
        q, dq, mask = _born_qdq(d, rows[:, :, None],
                                sp.hids_perm.long()[cols][:, None, :], sp.n,
                                sp.horizon,
                                sp.type_rows.long()[rows][:, :, None],
                                sp.type_cols.long()[cols][:, None, :],
                                sp.yval, sp.y2val)
    else:
        q, dq = qd[:2]
        mask = d > 0.0
    if keep is not None:
        live = live & _expand_subtiles(keep)
        mask = mask & live
    q = torch.where(live, q, 0.0)
    dq = torch.where(live, dq, 0.0)
    w, u, f_rows, f_cols = _descreen_sums(dx, dy, dz, d, mask, q, dq,
                                          s_hpad[cols], brw_pad[rows],
                                          bru_pad[rows])
    npad, nhpad = pos_pad.shape[1], pos_hpad.shape[1]
    return (_tile_sum(w, cols, nhpad), _tile_sum(u, cols, nhpad),
            _tile_sum(f_rows, rows, npad), _tile_sum(f_cols, cols, nhpad))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def column_groups(lmax: int, tile: int, dev) -> int:
    """How many column groups split each (entry, row sub-tile) unit of the
    Born and descreening list kernels: the least power of two, at most
    T / 32, that gives DS_WARPS_PER_SM warps for every SM of the card, so a
    short list (1li2's 18 entries: 144 units) still reaches every SM and a
    long one is cut only as far as it pays.  It depends only on the budget,
    the tile and the card, so a model's sums keep one order, and the Born
    sweep's keep bits have the reload's layout."""
    s = tile // SUB
    want = DS_WARPS_PER_SM * _sm_count(dev)
    ng = 1
    while ng < s and lmax * s * ng < want:
        ng *= 2
    return ng


def _check_list(nv, tl, tile, dev, nb, *extents):
    """Check the list and the tile size against the padded extents; returns
    lmax.  nb: the replicas, each with its list (nv [nb, 1], tl [nb, 2,
    lmax]); None for one list that every replica shares (nv [1], tl [2,
    lmax])."""
    if tile % 32 or not 32 <= tile <= 256:
        raise ValueError(f"tile {tile}: a multiple of 32 up to 256")
    lead = () if nb is None else (nb,)
    lmax = tl.shape[-1] if tl.dim() == len(lead) + 2 else -1
    _check("tl", tl, torch.int32, lead + (2, max(lmax, 1)), dev)
    _check("nv", nv, torch.int32, lead + (1,), dev)
    for e in extents:
        if e % tile:
            raise ValueError(f"padded extent {e} is not a multiple of the "
                             f"tile {tile}")
    return lmax


def born_sums_tiles(nv, tl, pos_pad, pos_hpad, hids_perm, type_rows,
                    type_cols, yval, y2val, s_hpad, n, tile, box=None,
                    horizon=None, save_qd=False, qd_out=None):
    """born_sums over the compacted interacting-tile list (tl, nv) from
    build_tile_list, built with the horizon as its range (2 nm without
    one).  Returns raw [NP], or with save_qd also the [lmax, T, T]
    per-entry Q/dQ tiles that descreening_tiles reloads by list index.

    The twin (CPU tensors) returns (raw, Q, dQ), Q/dQ the spline value
    where the Born mask accepts a pair and zero everywhere else.  The
    kernel returns (raw, Q, dQ, keep): it visits only the 32x32 sub-tile
    pairs that subtile_live keeps at the horizon (rows below n, columns
    with hids_perm >= 0) and writes Q/dQ, as the twin's, only inside them;
    everywhere else, entries past nv included, Q/dQ are undefined.  keep
    [lmax, T/32, ng] int32 names the kept sub-tile pairs (keep_flags reads
    it); hand the whole (Q, dQ, keep) to descreening_tiles as qd, so the
    reload reads nothing else.  qd_out: optional (Q, dQ) buffers the
    kernel writes into.  Batched: nv [B, 1], tl [B, 2, lmax], pos_pad [B,
    3, NP], pos_hpad [B, 3, NHP], s_hpad [B, NHP] (and qd_out [B, ...]); the
    results carry the [B] axis."""
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        kw = dict(hids_perm=hids_perm, type_rows=type_rows,
                  type_cols=type_cols, yval=yval, y2val=y2val, n=n,
                  tile=tile, box=box, horizon=horizon, save_qd=save_qd)
        if batched:
            return per_replica(
                born_sums_tiles_reference, nb,
                dict(nv=nv, tl=tl, pos_pad=pos_pad, pos_hpad=pos_hpad,
                     s_hpad=s_hpad), **kw)
        return born_sums_tiles_reference(nv, tl, pos_pad, pos_hpad,
                                         s_hpad=s_hpad, **kw)
    if not batched:
        return _unlead(_born_sums_tiles_cuda(
            nv[None], tl[None], pos_pad[None], pos_hpad[None], hids_perm,
            type_rows, type_cols, yval, y2val, s_hpad[None], n, tile,
            box=box, horizon=horizon, save_qd=save_qd,
            qd_out=_lead(qd_out)))
    return _born_sums_tiles_cuda(nv, tl, pos_pad, pos_hpad, hids_perm,
                                 type_rows, type_cols, yval, y2val, s_hpad, n,
                                 tile, box=box, horizon=horizon,
                                 save_qd=save_qd, qd_out=qd_out)


def _born_sums_tiles_cuda(nv, tl, pos_pad, pos_hpad, hids_perm, type_rows,
                          type_cols, yval, y2val, s_hpad, n, tile, box,
                          horizon, save_qd, qd_out):
    """born_sums_tiles' launch on a batch of CUDA tensors (a leading [B]
    axis); an unbatched call takes it as a batch of one."""
    nb, _ = _replicas(pos_pad)
    dev = pos_pad.device
    f32, i32 = torch.float32, torch.int32
    npad, nhpad = pos_pad.shape[2], pos_hpad.shape[2]
    nti, ntj = yval.shape[0], yval.shape[1]
    lmax = _check_list(nv, tl, tile, dev, nb, npad, nhpad)
    _check("pos_pad", pos_pad, f32, (nb, 3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (nb, 3, nhpad), dev)
    _check("hids_perm", hids_perm, i32, (nhpad,), dev)
    _check("type_rows", type_rows, i32, (npad,), dev)
    _check("type_cols", type_cols, i32, (nhpad,), dev)
    _check("yval", yval, f32, (nti, ntj, _NA), dev)
    _check("y2val", y2val, f32, (nti, ntj, _NA), dev)
    _check("s_hpad", s_hpad, f32, (nb, nhpad), dev)
    box_mode, box_t = _box_arg(box, dev)
    ng = column_groups(lmax, tile, dev)
    prow = torch.empty((nb, lmax, ng, 1, tile), dtype=f32, device=dev)
    keep = torch.empty((nb, lmax, tile // SUB, ng), dtype=torch.int32,
                       device=dev)
    raw = torch.empty((nb, npad), dtype=f32, device=dev)
    q = dq = None
    if save_qd and qd_out is not None:
        q, dq = qd_out
        _check("Q", q, f32, (nb, lmax, tile, tile), dev)
        _check("dQ", dq, f32, (nb, lmax, tile, tile), dev)
    elif save_qd:
        q = torch.empty((nb, lmax, tile, tile), dtype=f32, device=dev)
        dq = torch.empty((nb, lmax, tile, tile), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_born_sums_tiles(
        nb, nv.data_ptr(), tl.data_ptr(), lmax, tile, ng, pos_pad.data_ptr(),
        npad, pos_hpad.data_ptr(), nhpad, hids_perm.data_ptr(),
        type_rows.data_ptr(), type_cols.data_ptr(), yval.data_ptr(),
        y2val.data_ptr(), nti, ntj, s_hpad.data_ptr(), int(n),
        _horizon(horizon), box_mode, _ptr(box_t), prow.data_ptr(),
        keep.data_ptr(), raw.data_ptr(), _ptr(q), _ptr(dq), stream)
    _launch_check("born_sums_tiles", rc)
    LAUNCHES["born_sums_tiles"] += 1
    if save_qd:
        return raw, q, dq, keep
    return raw


def gb_pair_tiles(nv, tl, pos_pad, charge_pad, born_pad, n, tile, box=None,
                  cutoff=None, sig_pad=None, epsq_pad=None,
                  excl_rows_pad=None):
    """gb_pair over the compacted triangular interacting-tile list (each
    unordered pair once, deposited on both sides).  Same contract as
    gb_pair.  The kernel visits only the 32x32 sub-tile pairs that
    subtile_live(nv, tl, pos_pad, rows < n, pos_pad, rows < n, tile, cutoff,
    box, triangular=True) keeps: the list must have been built with this
    cutoff (or none).  Batched: nv [B, 1], tl [B, 2, lmax], pos_pad [B, 3,
    NP] and born_pad [B, NP]; the results carry the [B] axis."""
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        kw = dict(charge_pad=charge_pad, n=n, tile=tile, box=box,
                  cutoff=cutoff, sig_pad=sig_pad, epsq_pad=epsq_pad,
                  excl_rows_pad=excl_rows_pad)
        if batched:
            return per_replica(gb_pair_tiles_reference, nb,
                               dict(nv=nv, tl=tl, pos_pad=pos_pad,
                                    born_pad=born_pad), **kw)
        return gb_pair_tiles_reference(nv, tl, pos_pad, born_pad=born_pad,
                                       **kw)
    out = _gb_subtiles("gb_pair_tiles", nv, tl, tile, pos_pad, charge_pad,
                       born_pad, n, box, cutoff, sig_pad, epsq_pad,
                       excl_rows_pad)
    LAUNCHES["gb_pair_tiles"] += 1
    return out


def _gb_subtiles(name, nv, tl, tile, pos_pad, charge_pad, born_pad, n, box,
                 cutoff, sig_pad, epsq_pad, excl_rows_pad,
                 shared_list: bool = False):
    """Check the arguments and launch the GB list kernel: over a list from
    build_tile_list (one per replica when batched), or with shared_list
    over one list for every replica (triangular_grid_list for the dense
    sweep)."""
    nb, batched = _replicas(pos_pad)
    if not batched:
        lists = (nv, tl) if shared_list else (nv[None], tl[None])
        return _unlead(_gb_subtiles(name, *lists, tile, pos_pad[None],
                                    charge_pad, born_pad[None], n, box,
                                    cutoff, sig_pad, epsq_pad, excl_rows_pad,
                                    shared_list))
    dev = pos_pad.device
    f32 = torch.float32
    npad = pos_pad.shape[2]
    lmax = _check_list(nv, tl, tile, dev, None if shared_list else nb, npad)
    _check("pos_pad", pos_pad, f32, (nb, 3, npad), dev)
    _check("charge_pad", charge_pad, f32, (npad,), dev)
    _check("born_pad", born_pad, f32, (nb, npad), dev)
    with_mm = sig_pad is not None
    ne = 0
    if with_mm:
        ne = excl_rows_pad.shape[1]
        _check("sig_pad", sig_pad, f32, (npad,), dev)
        _check("epsq_pad", epsq_pad, f32, (npad,), dev)
        _check("excl_rows_pad", excl_rows_pad, torch.int32, (npad, ne), dev)
    box_mode, box_t = _box_arg(box, dev)
    ng = tile // SUB  # one warp per sub-tile pair
    prow = torch.empty((nb, lmax, ng, 6, tile), dtype=f32, device=dev)
    pcol = torch.empty((nb, lmax, tile // SUB, 6, tile), dtype=f32,
                       device=dev)
    keep = torch.empty((nb, lmax, tile // SUB, ng), dtype=torch.int32,
                       device=dev)
    erow = torch.empty((nb, npad), dtype=f32, device=dev)
    yrow = torch.empty((nb, npad), dtype=f32, device=dev)
    force = torch.empty((nb, npad, 3), dtype=f32, device=dev)
    mmrow = (torch.empty((nb, npad), dtype=f32, device=dev) if with_mm
             else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_gb_pair_tiles(
        nb, int(shared_list), nv.data_ptr(), tl.data_ptr(), lmax, tile, ng,
        pos_pad.data_ptr(),
        npad, charge_pad.data_ptr(), born_pad.data_ptr(), _ptr(sig_pad),
        _ptr(epsq_pad), _ptr(excl_rows_pad), ne, int(n),
        -1.0 if cutoff is None else float(cutoff) * float(cutoff),
        float("inf") if cutoff is None else float(cutoff), box_mode,
        _ptr(box_t), DIELECTRIC_FACTOR, KE, prow.data_ptr(), pcol.data_ptr(),
        keep.data_ptr(), erow.data_ptr(), yrow.data_ptr(), force.data_ptr(),
        _ptr(mmrow), stream)
    _launch_check(name, rc)
    return erow, yrow, force, mmrow


def descreening_tiles(nv, tl, pos_pad, pos_hpad, s_hpad, brw_pad, bru_pad,
                      qd, tile, box=None, spline=None):
    """Descreening sweep over the same list as born_sums_tiles (identical
    geometry and horizon, so the list is shared).  Same contract as
    descreening: qd from born_sums_tiles(save_qd=True) is reloaded, (Q, dQ,
    keep) from the kernel or (Q, dQ) [lmax, T, T]; with qd=None the spline
    is recomputed from spline=SplineArgs(...).

    With keep bits in qd, the kernel visits exactly the 32x32 sub-tile
    pairs they name, the only ones where the Born kernel wrote Q/dQ.
    Otherwise it visits those that subtile_live keeps at the list's range:
    spline.horizon (2 nm without a spline), rows below spline.n and columns
    with spline.hids_perm >= 0 (every row and column without a spline); a
    reloaded (Q, dQ) must then be zero outside the Born mask wherever those
    reach, as a twin's are.  Batched: nv, tl, positions, s_hpad, brw_pad,
    bru_pad and qd with a leading [B] axis (from batched lists and a batched
    born_sums_tiles), and so are the results."""
    nb, batched = _replicas(pos_pad)
    if pos_pad.device.type == "cpu":
        if batched:
            return per_replica(
                descreening_tiles_reference, nb,
                dict(nv=nv, tl=tl, pos_pad=pos_pad, pos_hpad=pos_hpad,
                     s_hpad=s_hpad, brw_pad=brw_pad, bru_pad=bru_pad, qd=qd),
                tile=tile, box=box, spline=spline)
        return descreening_tiles_reference(nv, tl, pos_pad, pos_hpad, s_hpad,
                                           brw_pad, bru_pad, qd, tile,
                                           box=box, spline=spline)
    if not batched:
        return _unlead(_descreening_tiles_cuda(
            nv[None], tl[None], pos_pad[None], pos_hpad[None], s_hpad[None],
            brw_pad[None], bru_pad[None], _lead(qd), tile, box=box,
            spline=spline))
    return _descreening_tiles_cuda(nv, tl, pos_pad, pos_hpad, s_hpad,
                                   brw_pad, bru_pad, qd, tile, box=box,
                                   spline=spline)


def _descreening_tiles_cuda(nv, tl, pos_pad, pos_hpad, s_hpad, brw_pad,
                            bru_pad, qd, tile, box, spline):
    """descreening_tiles' launch on a batch of CUDA tensors (a leading [B]
    axis); an unbatched call takes it as a batch of one."""
    nb, _ = _replicas(pos_pad)
    dev = pos_pad.device
    f32 = torch.float32
    npad, nhpad = pos_pad.shape[2], pos_hpad.shape[2]
    lmax = _check_list(nv, tl, tile, dev, nb, npad, nhpad)
    q = dq = keep = None
    if qd is not None:
        q, dq = qd[:2]
        _check("Q", q, f32, (nb, lmax, tile, tile), dev)
        _check("dQ", dq, f32, (nb, lmax, tile, tile), dev)
        keep = qd[2] if len(qd) > 2 else None
    _check("pos_pad", pos_pad, f32, (nb, 3, npad), dev)
    _check("pos_hpad", pos_hpad, f32, (nb, 3, nhpad), dev)
    _check("s_hpad", s_hpad, f32, (nb, nhpad), dev)
    _check("brw_pad", brw_pad, f32, (nb, npad), dev)
    _check("bru_pad", bru_pad, f32, (nb, npad), dev)
    ng = column_groups(lmax, tile, dev)
    if keep is not None:
        # the Born sweep split the same list into the same column groups
        _check("keep", keep, torch.int32, (nb, lmax, tile // SUB, ng), dev)
    if q is None:
        _check_spline(spline, npad, nhpad, dev)
        sp_args = _spline_ptrs(spline)
    else:
        if spline is None:
            sp_args = (None,) * 5 + (0, 0, npad, _horizon(None))
        else:
            _check("hids_perm", spline.hids_perm, torch.int32, (nhpad,), dev)
            sp_args = ((spline.hids_perm.data_ptr(),) + (None,) * 4
                       + (0, 0, int(spline.n), _horizon(spline.horizon)))
    # the kernel reads these as 16-byte vectors
    vectors = dict(pos_hpad=pos_hpad, s_hpad=s_hpad, Q=q, dQ=dq)
    if spline is not None:
        vectors.update(hids_perm=spline.hids_perm,
                       type_cols=spline.type_cols)
    for what, x in vectors.items():
        if x is not None and x.data_ptr() % 16:
            raise ValueError(f"{what}: data not 16-byte aligned")
    box_mode, box_t = _box_arg(box, dev)
    prow = torch.empty((nb, lmax, ng, 3, tile), dtype=f32, device=dev)
    pcol = torch.empty((nb, lmax, tile // SUB, 5, tile), dtype=f32,
                       device=dev)
    kept = torch.empty((nb, lmax, tile // SUB, ng), dtype=torch.int32,
                       device=dev)
    w = torch.empty((nb, nhpad), dtype=f32, device=dev)
    u = torch.empty((nb, nhpad), dtype=f32, device=dev)
    f_rows = torch.empty((nb, npad, 3), dtype=f32, device=dev)
    f_cols = torch.empty((nb, nhpad, 3), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_descreening_tiles(
        nb, nv.data_ptr(), tl.data_ptr(), lmax, tile, ng, pos_pad.data_ptr(),
        npad, pos_hpad.data_ptr(), nhpad, _ptr(q), _ptr(dq), _ptr(keep),
        s_hpad.data_ptr(), brw_pad.data_ptr(), bru_pad.data_ptr(), box_mode,
        _ptr(box_t),
        *sp_args, sp_args[-1],  # the list's range: the horizon
        prow.data_ptr(), pcol.data_ptr(),
        kept.data_ptr(), w.data_ptr(), u.data_ptr(), f_rows.data_ptr(),
        f_cols.data_ptr(), stream)
    _launch_check("descreening_tiles", rc)
    LAUNCHES["descreening_tiles" if qd is not None
             else "descreening_tiles_recompute"] += 1
    return w, u, f_rows, f_cols
