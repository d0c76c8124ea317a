"""Padded half neighbor lists for the tree build and MD loop.

The reference relies on OpenMM's neighbor-list tiles for its 2-body overlap
candidates (reference GVolOverlapTree.cl:127-313).  Here the analogue is a
fixed-width half list [N, kmax] rebuilt on the device: candidate (i, j>i)
pairs within rcut, heavy atoms only (hydrogen Gaussians carry zero volume
and can never form a surviving overlap, gaussvol.cpp:132), padded with a
validity mask and an overflow indicator.  `half_neighbor_pairs` tests all
pairs; `cell_neighbor_pairs` scans the 27 cells around each atom of a
static `CellGrid` (the O(N) build for large systems).  Both also build
the lists of B replicas of one system at once, from positions [B, N, 3]:
each replica's list within its own atoms, with atom ids offset by b N (the
ids of the replicas' disjoint union, which the overlap tree is built over)
and one max_neighbors per replica.

The tree's 2-body survival criterion implies a hard geometric cutoff:
s(V12) V12 > MIN_GVOL requires V12 > VOLMINA, i.e.
d^2 < ln(v1 v2 (df/pi)^1.5 / VOLMINA) / df; `tree_pair_cutoff` evaluates it
for the worst-case (largest) radii so the list provably misses no overlap.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.constants import KFC, PI, VOLMINA, sphere_volume


def tree_pair_cutoff(radii_large) -> float:
    """Max distance at which a 2-body overlap (largest radii) can survive."""
    rmax = float(np.max(np.asarray(radii_large)))
    v = sphere_volume(rmax)
    a = KFC / (rmax * rmax)
    df = 0.5 * a
    pref = v * v * (df / PI) ** 1.5
    if pref <= VOLMINA:
        return 0.0
    return math.sqrt(math.log(pref / VOLMINA) / df)


def host_max_neighbors(pos, heavy, rcut, chunk: int = 2048):
    """Max half-list neighbor count (numpy), row-chunked so host memory
    stays O(N*chunk) — the sizing pass for kmax."""
    n = pos.shape[0]
    jj = np.arange(n)
    best = 0
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = np.sum((pos[s:e, None, :] - pos[None, :, :]) ** 2, axis=-1)
        ok = ((jj[None, :] > jj[s:e, None]) & (d2 < rcut * rcut)
              & heavy[s:e, None] & heavy[None, :])
        best = max(best, int(ok.sum(axis=1).max()))
    return best


class CellGrid:
    """Static cell-grid plan for the O(N) neighbor build (counterpart of the
    JAX package's ops/neighbors.py:40-89).

    The grid's dimensions and cell capacity are static (sized on the host
    from initial positions, like the reference's CPU sizing pre-pass) while
    its origin follows the solute on the device (the min of the current
    heavy-atom positions), so rigid drift never invalidates the plan.  Atoms
    beyond the static extent clamp to edge cells: clamping only reduces
    cell-index separation, so no close pair is missed, but it can overflow
    a cell's capacity, which cell_neighbor_pairs reports through the
    neighbor-overflow channel for the PanicButton to regrow.
    """

    def __init__(self, positions, rcut: float, margin: float = 0.5,
                 ccap: int | None = None, heavy_mask=None):
        pos = np.asarray(positions)
        pos_h = pos[np.asarray(heavy_mask)] if heavy_mask is not None else pos
        lo = pos.min(axis=0) - margin
        hi = pos.max(axis=0) + margin
        self.rcut = float(rcut)
        self.margin = float(margin)
        self.origin = lo
        self.dims = np.maximum(np.ceil((hi - lo) / rcut).astype(int), 1)
        if ccap is None:
            # measured occupancy on the initial configuration + headroom
            c = np.clip(((pos_h - lo) / rcut).astype(int), 0, self.dims - 1)
            cid = (c[:, 0] * self.dims[1] + c[:, 1]) * self.dims[2] + c[:, 2]
            seen = int(np.bincount(cid).max()) if len(cid) else 1
            ccap = max(8, int(np.ceil(seen * 1.5 / 8) * 8))
        self.ccap = int(ccap)
        self.ncells = int(self.dims.prod())
        # static 27-cell stencil
        self.stencil = np.array([(dx, dy, dz) for dx in (-1, 0, 1)
                                 for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                                np.int32)
        self._on = {}  # device -> (dims, stencil) tensors (on)

    def on(self, device):
        """(dims, stencil) as int64 tensors on device, made from the host
        once a device and kept: a neighbor build after its first copies
        nothing from the host (md/graphs.py::BuildGraph captures it)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(torch.as_tensor(x, dtype=torch.int64,
                                                     device=device)
                                     for x in (self.dims, self.stencil))
        return self._on[device]

    def grown(self) -> "CellGrid":
        """Doubled cell capacity (PanicButton regrow)."""
        g = CellGrid.__new__(CellGrid)
        g.rcut, g.origin, g.dims = self.rcut, self.origin, self.dims
        g.margin = self.margin
        g.ccap = self.ccap * 2
        g.ncells, g.stencil = self.ncells, self.stencil
        g._on = self._on
        return g


def _batch(pos):
    """(positions [B, N, 3], B, whether they came batched)."""
    if pos.dim() == 3:
        return pos, pos.shape[0], True
    return pos[None], 1, False


def cell_neighbor_pairs(pos, heavy_mask, rcut: float, kmax: int,
                        grid: CellGrid):
    """O(N) half neighbor list through the cell grid.

    Same contract as half_neighbor_pairs: flat i-major (pairs_i, pairs_j,
    pairs_valid, max_neighbors) with invalid slots j == i; max_neighbors
    is at least kmax + 1 when a cell overflowed its capacity (pairs may
    then be missing, so the window must be retried).  Positions [B, N, 3]:
    one grid table per replica (each with its own solute-following origin),
    the lists of the disjoint union, max_neighbors [B].
    """
    pos, nb, batched = _batch(pos)
    n = pos.shape[1]
    nt = nb * n
    dev = pos.device
    dims, stencil = grid.on(dev)
    ncells, ccap = grid.ncells, grid.ccap
    heavy = heavy_mask[None, :]

    # solute-following origin: rigid drift costs nothing; only expansion
    # beyond the static extent clamps (and overflow-detects)
    origin = torch.amin(torch.where(heavy[..., None], pos,
                                    torch.amax(pos, dim=1)[:, None, :]),
                        dim=1) - grid.margin
    c = ((pos - origin[:, None, :]) / grid.rcut).to(torch.int64)
    c = torch.minimum(torch.clamp(c, min=0), dims - 1)
    cid = (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
    # hydrogens go to a trash cell: they never appear as candidates
    cid = torch.where(heavy, cid, ncells)
    # replica b's cells are rows b (ncells + 1) + cell of one table
    rows = ncells + 1
    cid = (cid + rows * torch.arange(nb, device=dev)[:, None]).reshape(-1)

    # bincount would read its length from the device; every id is below
    # nb * rows
    counts = torch.zeros(nb * rows, dtype=torch.int64,
                         device=dev).index_add_(0, cid, torch.ones_like(cid))
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(cid, stable=True)
    cid_o = cid[order]
    rank = torch.arange(nt, device=dev) - starts[cid_o]
    # a clamped rank can only collide in an overflowing cell, which the
    # flag below reports for a retry with a grown capacity
    slot = cid_o * ccap + torch.clamp(rank, max=ccap - 1)
    table = torch.full((nb * rows * ccap,), nt, dtype=torch.int64,
                       device=dev)
    table[slot] = order
    table = table.reshape(nb, rows, ccap)
    table[:, ncells].fill_(nt)
    table = table.reshape(nb * rows, ccap)

    # 27-cell stencil; out-of-grid stencil cells point at the trash row
    nbr = c[:, :, None, :] + stencil[None, None, :, :]
    in_grid = torch.all((nbr >= 0) & (nbr < dims), dim=-1)
    nbr_cid = (nbr[..., 0] * dims[1] + nbr[..., 1]) * dims[2] + nbr[..., 2]
    nbr_cid = torch.where(in_grid, nbr_cid, ncells)
    nbr_cid = nbr_cid + rows * torch.arange(nb, device=dev)[:, None, None]

    cand = table[nbr_cid].reshape(nt, 27 * ccap)
    jj = torch.arange(nt, device=dev)
    flat = pos.reshape(nt, 3)
    delta = flat[torch.clamp(cand, max=nt - 1)] - flat[:, None, :]
    d2 = torch.sum(delta * delta, dim=-1)
    ok = ((cand < nt) & (cand > jj[:, None]) & (d2 < rcut * rcut)
          & heavy_mask.repeat(nb)[:, None])

    key = torch.where(ok, cand, nt)
    pj = torch.sort(key, dim=1).values[:, :kmax]
    valid = pj < nt
    pi = jj[:, None].expand(nt, pj.shape[1])
    pj = torch.where(valid, pj, pi)
    cell_over = torch.amax(counts.reshape(nb, rows)[:, :ncells], dim=1) > ccap
    max_neighbors = torch.maximum(
        torch.amax(torch.sum(ok, dim=1).reshape(nb, n), dim=1),
        torch.where(cell_over, kmax + 1, 0))
    if not batched:
        max_neighbors = max_neighbors[0]
    return pi.reshape(-1), pj.reshape(-1), valid.reshape(-1), max_neighbors


# elements of the largest [B, rows, N] temporary of a row block of
# half_neighbor_pairs (its distance block holds three times as many)
HALF_LIST_BLOCK = 1 << 26


def half_neighbor_pairs(pos, heavy_mask, rcut: float, kmax: int):
    """Fixed-width half neighbor list as flat i-major candidate pairs.

    Returns (pairs_i [N*kmax], pairs_j, pairs_valid, max_neighbors), all on
    pos.device.  Invalid slots have pairs_j == pairs_i (masked out
    downstream).  max_neighbors > kmax signals overflow.  Positions [B, N,
    3]: each replica's list within its own atoms, ids offset by b N,
    max_neighbors [B]; heavy_mask [N] or, per replica, [B, N].

    The list is built in blocks of as many rows as keep B x rows x N
    within HALF_LIST_BLOCK, so the temporaries stay bounded; a row's sort
    sees only its own row, so the result is bitwise the one-block list's.
    """
    pos, nb, batched = _batch(pos)
    n = pos.shape[1]
    dev = pos.device
    heavy = heavy_mask if heavy_mask.dim() == 2 else heavy_mask[None]
    block_rows = max(1, HALF_LIST_BLOCK // max(nb * n, 1))
    jj = torch.arange(n, device=dev)
    width = min(kmax, n)
    pj = torch.empty((nb, n, width), dtype=torch.int64, device=dev)
    counts = torch.empty((nb, n), dtype=torch.int64, device=dev)
    for s in range(0, n, block_rows):
        e = min(s + block_rows, n)
        dist = pos[:, None, :, :] - pos[:, s:e, None, :]
        d2 = torch.sum(dist * dist, dim=-1)
        pair_ok = ((jj[None, :] > jj[s:e, None])
                   & (d2 < rcut * rcut)
                   & heavy[:, s:e, None] & heavy[:, None, :])
        # ascending-j order with invalid slots pushed to the end: the key IS
        # the neighbor index, so a value sort yields pj directly
        key = torch.where(pair_ok, jj[None, :], n)
        pj[:, s:e] = torch.sort(key, dim=-1).values[..., :kmax]
        counts[:, s:e] = torch.sum(pair_ok, dim=-1)
    valid = pj < n
    pi = jj[:, None].expand(n, width)
    pj = torch.where(valid, pj, pi)
    off = n * torch.arange(nb, device=dev)[:, None, None]
    max_neighbors = torch.amax(counts, dim=-1)
    if not batched:
        max_neighbors = max_neighbors[0]
    return ((pi + off).reshape(-1), (pj + off).reshape(-1), valid.reshape(-1),
            max_neighbors)
