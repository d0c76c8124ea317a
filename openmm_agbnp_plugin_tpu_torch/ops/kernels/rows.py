"""Row moves of the overlap tree's passes: CUDA kernels and their plain twins.

Counterpart of the two Pallas probes of the JAX package's
benchmarks/micro_pallas_gather.py, which ask whether a hand kernel beats
the stock row gather that every tree level runs (ops/tree.py::
_parent_gather):

  take_rows     out[r] = table[ids[r]]: the parent -> child broadcast itself
  cumsum_rows   inclusive prefix sum down the rows of [R, C]; with
                boundary_diffs it is the gather-free form of the broadcast:
                cumsum_rows(boundary_diffs(v, starts, R)) ~ take_rows(v, ids)
                for nondecreasing ids (exact up to the float roundoff of the
                running sum, which broadcast_deviation reports)

Each wrapper routes by the device of its tensors: on the CPU it returns its
plain twin (`*_reference`); on a CUDA device it checks every argument,
launches its kernel from csrc/rows.cu on the current stream, raises if the
launch failed, and adds one to its count in pairs.LAUNCHES.  There is no
fallback from the kernel to the twin.  take_rows is the row gather of the
tree's passes (ops/tree.py::_parent_gather and the per-atom gathers beside
it); cumsum_rows is a probe that tools time (profile_port_step.py
--row-probes).
"""

from __future__ import annotations

import numpy as np
import torch

from .pairs import LAUNCHES, _check, _cuda_lib, _launch_check

MAX_COLS = 256  # at least one thread a column of a cumsum tile
# cumsum_rows' layout (csrc/rows.cu): a block of SCAN_THREADS threads scans
# a tile of SCAN_THREADS // C parts of PART_ROWS rows; its carry adds the
# totals of every tile before it while ntiles * C <= FLAT_VALUES, else the
# group totals of GROUP_TILES tiles and the tile totals inside its group
SCAN_THREADS, PART_ROWS, GROUP_TILES, FLAT_VALUES = 256, 32, 32, 4096


def make_segments(rows: int, parents: int, seed: int = 0) -> np.ndarray:
    """Nondecreasing segment ids [rows] int32 with a tree-like width
    distribution (mean 3.4 rows a parent), cut or padded with the last id to
    `rows`: the probe input of benchmarks/micro_pallas_gather.py, from the
    same numpy stream."""
    rng = np.random.RandomState(seed)
    widths = rng.choice([1, 1, 2, 2, 3, 4, 6, 8], size=parents)
    ids = np.repeat(np.arange(parents), widths)
    if len(ids) >= rows:
        ids = ids[:rows]
    else:
        ids = np.concatenate([ids, np.full(rows - len(ids), ids[-1])])
    return ids.astype(np.int32)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------

def take_rows_reference(table, ids):
    """Plain twin of take_rows (table [P, C] or [P])."""
    ok = (ids >= 0) & (ids < table.shape[0])
    rows = table[torch.where(ok, ids, 0).long()]
    return torch.where(ok if table.dim() == 1 else ok[:, None], rows, 0.0)


def cumsum_rows_reference(d):
    """Plain twin of cumsum_rows."""
    return torch.cumsum(d, dim=0)


def cumsum_layout(ncols: int) -> tuple[int, int]:
    """(parts, tile rows) of cumsum_rows' tiles for ncols columns: 256 //
    ncols parts of 32 rows."""
    parts = max(1, SCAN_THREADS // ncols)
    return parts, PART_ROWS * parts


def _warp_tree(v):
    """What the kernel's warp_tree gives for the values v [n, C] of one
    column set: lane j adds v[j], v[j + 32], ... to 0.0 in order, then the
    lanes meet in an xor butterfly (offsets 16, 8, 4, 2, 1).  Returns [C]."""
    n, ncols = v.shape
    blocks = max(1, -(-n // 32))
    lanes = v.new_zeros((blocks * 32, ncols))
    lanes[:n] = v
    acc = v.new_zeros((32, ncols))
    for k in range(blocks):
        acc = acc + lanes[32 * k:32 * (k + 1)]
    lane = torch.arange(32, device=v.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[lane ^ off]
    return acc[0]


def cumsum_rows_mirror(d):
    """cumsum_rows' summation order in plain torch (the kernel's bits, where
    both run in float32): per tile, a running sum down each part's 32 rows
    from 0.0, a Hillis-Steele scan of the part totals over the parts, the
    tile's carry (while ntiles * C <= FLAT_VALUES the warp tree of the tile
    totals before it, else the warp tree of the group totals before its
    group plus the warp tree of its group's tile totals before it; a group
    total is the warp tree of its 32 tile totals), and each output = the
    running sum + (the parts before + the carry).  Rows past the end count
    as zeros."""
    nrows, ncols = d.shape
    parts, tile_rows = cumsum_layout(ncols)
    ntiles = max(1, -(-nrows // tile_rows))
    x = d.new_zeros((ntiles * tile_rows, ncols))
    x[:nrows] = d
    x = x.view(ntiles, parts, PART_ROWS, ncols)
    run = torch.empty_like(x)
    acc = d.new_zeros((ntiles, parts, ncols))
    for i in range(PART_ROWS):
        acc = acc + x[:, :, i]
        run[:, :, i] = acc
    o = 1
    while o < parts:
        nxt = acc.clone()
        nxt[:, o:] = acc[:, o:] + acc[:, :-o]
        acc = nxt
        o *= 2
    totals = acc[:, -1]
    flat = ntiles * ncols <= FLAT_VALUES
    groups = [] if flat else [_warp_tree(totals[k:k + GROUP_TILES])
              for k in range(0, ntiles - GROUP_TILES + 1, GROUP_TILES)]
    carry = []
    for b in range(ntiles):
        if flat:
            carry.append(_warp_tree(totals[:b]))
            continue
        g = b // GROUP_TILES
        before = (torch.stack(groups[:g]) if g
                  else totals.new_zeros((0, ncols)))
        carry.append(_warp_tree(before)
                     + _warp_tree(totals[g * GROUP_TILES:b]))
    carry = torch.stack(carry)
    pre = torch.cat([acc.new_zeros((ntiles, 1, ncols)), acc[:, :-1]], dim=1)
    out = run + (pre + carry[:, None])[:, :, None]
    return out.reshape(ntiles * tile_rows, ncols)[:nrows]


# ---------------------------------------------------------------------------
# The piecewise-constant broadcast around cumsum_rows (plain torch)
# ---------------------------------------------------------------------------

def row_starts(ids):
    """Segment starts of nondecreasing ids [R]: (start_rows [S], start_ids
    [S]) int64, the rows where the id changes and the ids there.  Fixed per
    tree topology (one host read for S), like the ids themselves."""
    change = torch.ones_like(ids, dtype=torch.bool)
    change[1:] = ids[1:] != ids[:-1]
    start_rows = torch.nonzero(change)[:, 0]
    return start_rows, ids[start_rows].long()


def boundary_diffs(v, starts, nrows: int):
    """[nrows, C] matrix whose running sum down the rows is v[ids]: at each
    segment start the step from the previous segment's table row to this
    one's (the first start carries its row whole), zero elsewhere.  starts:
    row_starts(ids).  The per-evaluation part of the broadcast: a gather of
    S table rows, a subtraction and a scatter."""
    start_rows, start_ids = starts
    vs = v[start_ids]
    dv = torch.cat([vs[:1], vs[1:] - vs[:-1]])
    diffs = v.new_zeros((nrows, v.shape[1]))
    diffs[start_rows] = dv
    return diffs


def broadcast_deviation(v, ids) -> float:
    """max |cumsum_rows(boundary_diffs(v)) - take_rows(v, ids)|: what the
    gather-free broadcast loses to the running sum's roundoff.  Each of the
    R additions rounds a partial sum no larger than max|v|, and each step
    was itself rounded once, so it is at most R * eps * max|v|."""
    out = cumsum_rows(boundary_diffs(v, row_starts(ids), ids.shape[0]))
    return float(torch.max(torch.abs(out - take_rows(v, ids))))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def take_rows(table, ids):
    """out[r] = table[ids[r]] for table [P, C] (or [P], out [R]) and ids [R]
    int32; a row whose id lies outside [0, P) is zero.  The ids need not be
    sorted.

    On a CUDA device a float32 table of any width C >= 1 goes through the
    kernel, which moves the widest pieces (16, 8 or 4 bytes) that divide a
    row and that table and out are aligned to; bitwise the twin.  The
    kernel moves 32-bit words: a float64 table moves as the float32 view
    of its rows (two words a value, so the same bits), which lets the
    tree's passes run in f64 on the card; a table of another dtype there
    raises.

    Gradients: when grad mode is on and the table requires grad, the
    gather runs inside TakeRows (an autograd.Function; the same forward
    route, kernel or twin), whose backward adds each output row's gradient
    into its parent row by the deterministic segment sum."""
    if torch.is_grad_enabled() and table.requires_grad:
        return TakeRows.apply(table, ids)
    return _take_rows(table, ids)


def take_rows_backward(grad, ids, nparents: int):
    """The gradient of take_rows with respect to its table: the rows of
    grad [R, ...] added into [nparents, ...] by ids, rows whose id lies
    outside [0, nparents) adding nothing.  Each parent's rows are summed
    in row order (a stable sort, then torch.segment_reduce): no float
    atomics, the same bits on every run."""
    from ..tree import segment_sum  # ops/tree.py imports this module

    ok = (ids >= 0) & (ids < nparents)
    seg = torch.where(ok, ids.long(), nparents)
    flat = grad.reshape(grad.shape[0], -1)
    out = segment_sum(flat, seg, nparents)
    return out.reshape((nparents,) + tuple(grad.shape[1:]))


class TakeRows(torch.autograd.Function):
    """take_rows with a backward: the forward is take_rows' own route (the
    kernel on a card, the twin on the CPU), the backward
    take_rows_backward, a plain-torch scatter-add as the JAX package's
    jnp.take has (no backward kernel)."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.nparents = table.shape[0]
        ctx.save_for_backward(ids)
        return _take_rows(table, ids)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return take_rows_backward(grad, ids, ctx.nparents), None


def _take_rows(table, ids):
    """take_rows without autograd: the twin on the CPU, else the kernel."""
    if table.device.type == "cpu":
        return take_rows_reference(table, ids)
    dev = table.device
    if table.dim() not in (1, 2):
        raise ValueError(f"table: shape {tuple(table.shape)}, expected [P, C] "
                         "or [P]")
    if table.dtype == torch.float64:
        if not table.is_contiguous():
            raise ValueError("table: not contiguous")
        words = table.detach().reshape(table.shape[0], -1).view(
            torch.float32)
        return _take_rows(words, ids).view(torch.float64).reshape(
            (ids.shape[0],) + tuple(table.shape[1:]))
    nparents = table.shape[0]
    ncols = table.shape[1] if table.dim() == 2 else 1
    nrows = ids.shape[0]
    _check("table", table, torch.float32, table.shape, dev)
    _check("ids", ids, torch.int32, (nrows,), dev)
    if ncols == 0:
        raise ValueError("table: no columns")
    out = torch.empty((nrows,) + tuple(table.shape[1:]), dtype=torch.float32,
                      device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _cuda_lib().agbnp_take_rows(table.data_ptr(), nparents, ncols,
                                     ids.data_ptr(), nrows, out.data_ptr(),
                                     stream)
    _launch_check("take_rows", rc)
    LAUNCHES["take_rows"] += 1
    return out


def take_rows_piece_bytes(table, out) -> int:
    """The bytes of the pieces (16, 8 or 4) in which take_rows moves the
    rows of table into out: the widest that divides a float32 row and that
    both are aligned to (csrc/rows.cu makes the same choice)."""
    ncols = table.shape[1] if table.dim() == 2 else 1
    where = table.data_ptr() | out.data_ptr()
    if ncols % 4 == 0 and where % 16 == 0:
        return 16
    if ncols % 2 == 0 and where % 8 == 0:
        return 8
    return 4


# per (device, stream): the int32 ticket, done count and flags of
# cumsum_rows, zero between calls (the kernel's last tile clears them)
_SCAN_STATE: dict = {}


def _scan_state(dev, stream: int, need: int):
    """The stream's zeroed cumsum_rows state of at least `need` ints: two
    calls in flight on two streams never share one, and calls on one stream
    run one after another.  A larger call than any before zero-fills a new
    buffer (one fill launch); otherwise nothing is cleared."""
    key = (dev.index, stream)
    st = _SCAN_STATE.get(key)
    if st is None or st.numel() < need:
        st = torch.zeros(max(need, 1024), dtype=torch.int32, device=dev)
        _SCAN_STATE[key] = st
    return st


def cumsum_rows(d):
    """Inclusive prefix sum down the rows of d [R, C], per column.

    On a CUDA device: float32, 1 <= C <= 256, any R; one launch (none for
    R = 0).  Tiles of 32 (256 // C) rows take tickets in order, publish
    their column totals and add up those of the tiles before them in an
    order the shapes alone fix (cumsum_rows_mirror): every launch gives the
    same bits, on any stream.  Against the twin (another summation order)
    it agrees to float32 roundoff of the column sums."""
    if d.device.type == "cpu":
        return cumsum_rows_reference(d)
    dev = d.device
    if d.dim() != 2:
        raise ValueError(f"d: shape {tuple(d.shape)}, expected [R, C]")
    nrows, ncols = d.shape
    _check("d", d, torch.float32, (nrows, ncols), dev)
    if not 1 <= ncols <= MAX_COLS:
        raise ValueError(f"d: {ncols} columns, expected 1..{MAX_COLS}")
    if nrows >= 2 ** 31 // ncols:
        raise ValueError(f"d: {nrows} rows x {ncols} columns, expected "
                         "fewer than 2^31 values")
    out = torch.empty_like(d)
    if nrows == 0:
        return out
    lib = _cuda_lib()
    tile_rows = lib.agbnp_cumsum_tile_rows(ncols)
    if tile_rows != cumsum_layout(ncols)[1]:
        raise RuntimeError("cumsum_rows: csrc/rows.cu and cumsum_layout "
                           "disagree on the tile")
    ntiles = -(-nrows // tile_rows)
    ngroups = -(-ntiles // GROUP_TILES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = _scan_state(dev, stream,
                        lib.agbnp_cumsum_state_ints(nrows, ncols))
    scratch = torch.empty((ntiles + ngroups) * ncols, dtype=torch.float32,
                          device=dev)
    rc = lib.agbnp_cumsum_rows(d.data_ptr(), nrows, ncols, state.data_ptr(),
                               scratch.data_ptr(), out.data_ptr(), stream)
    _launch_check("cumsum_rows", rc)
    LAUNCHES["cumsum_rows"] += 1
    return out
